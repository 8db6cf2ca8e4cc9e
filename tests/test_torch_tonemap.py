"""The port's tone mappers and display pass against vpt_tpu.

All ten mappers and the plain display pass must agree with JAX at atol 1e-6
(the curves call pow/exp, which differ in the last bits between the
libraries; values are O(1)).  The CUDA kernel against the plain version runs
on a GPU only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import tonemap as jtm
from vpt_tpu.pallas import tonemap_kernel as jkernel
from vpt_tpu_torch import tonemap as ttm
from vpt_tpu_torch.kernels import tonemap_kernel


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


IMG = np.random.default_rng(0).uniform(0, 4, (16, 32, 4)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jtm.TONE_MAPPERS))
def test_mapper_matches_jax(name):
    kwargs = {} if name in ("artistic", "range") else {"exposure": 1.3,
                                                        "gamma": 2.0}
    want = np.asarray(jtm.get(name)(jnp.asarray(IMG), **kwargs))
    got = ttm.get(name)(torch.from_numpy(IMG), **kwargs).numpy()
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(jtm.RAW_CURVES))
def test_plain_display_pass_matches_pallas(name):
    want = np.asarray(jkernel.tonemap(jnp.asarray(IMG), name, exposure=1.3,
                                      gamma=2.2, interpret=True))
    got = tonemap_kernel.tonemap(torch.from_numpy(IMG), name, exposure=1.3,
                                 gamma=2.2).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[..., 3] == 1.0)


def test_curve_tables_agree():
    assert list(ttm.RAW_CURVES) == list(jtm.RAW_CURVES)
    assert sorted(ttm.TONE_MAPPERS) == sorted(jtm.TONE_MAPPERS)
    assert float(ttm.uncharted2_white_scale()) == float(
        jtm._uncharted2_curve(jnp.float32(11.2)))


def test_unsupported_names_raise():
    with pytest.raises(ValueError):
        tonemap_kernel.tonemap(torch.zeros(8, 128, 4), "artistic")
    with pytest.raises(ValueError):
        ttm.get("nope")
    with pytest.raises(ValueError):
        tonemap_kernel.tonemap(torch.zeros(8, 128, 3), "reinhard")


def test_tone_mapper_object_on_cpu():
    img = torch.from_numpy(IMG)
    for name in ("reinhard", "artistic"):
        got = ttm.ToneMapper(name)(img)
        assert torch.equal(got, ttm.get(name)(img))
