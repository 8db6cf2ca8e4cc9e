"""vpt_tpu_torch.skipgrid against vpt_tpu.skipgrid: the cheb-skip tracking
table must be equal to JAX's, cell for cell; the auto policy must decline in
the same cases."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as js
from vpt_tpu import skipgrid as jskip
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu_torch import skipgrid as tskip


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _srgb_ramp(alpha=0.8):
    return np.asarray(jtransfer.to_gl_texture(
        jtransfer.gray_ramp(alpha_scale=alpha), srgb=True, quantize=True))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [12, 16])
def test_pack_tracking_volume_equal(n):
    vol = np.asarray(jvolume.sphere_volume(n).data)
    tf = _srgb_ramp()
    want = jskip.pack_tracking_volume(jnp.asarray(vol), jnp.asarray(tf))
    got = tskip.pack_tracking_volume(_t(vol), _t(tf))
    assert want is not None and got is not None
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] < -0.5).any() and (got[:, 0] >= 0).any()


def test_cell_empty_mask_equal():
    vol = np.asarray(jvolume.blobs_volume(12, seed=4).data)
    tf = _srgb_ramp(0.5)
    packed = np.asarray(js.pack_corner_volume(vol))
    want = np.asarray(jskip.cell_empty_mask(jnp.asarray(packed),
                                            jnp.asarray(tf)))
    got = tskip.cell_empty_mask(_t(packed), _t(tf)).numpy()
    assert np.array_equal(got, want) and want.any() and not want.all()


@pytest.mark.parametrize("cap", [3, 64])
def test_chebyshev_distance_equal(cap):
    occ = np.random.default_rng(cap).uniform(size=(9, 10, 11)) > 0.97
    want = np.asarray(jskip.chebyshev_distance(jnp.asarray(occ), cap=cap))
    got = tskip.chebyshev_distance(_t(occ), cap=cap).numpy()
    assert np.array_equal(got, want)


def test_chebyshev_distance_empty_volume():
    occ = np.zeros((4, 4, 4), bool)
    got = tskip.chebyshev_distance(_t(occ), cap=5).numpy()
    assert np.array_equal(got, np.full((4, 4, 4), 5.0, np.float32))


@pytest.mark.parametrize("case", ["sparse", "dense", "threshold", "negative",
                                  "multichannel"])
def test_auto_decline_matches(case):
    vol = np.asarray(jvolume.sphere_volume(12).data)
    tf = _srgb_ramp()
    frac = 0.05
    if case == "dense":
        tf = np.asarray(jtransfer.gray_ramp(alpha_scale=0.8))  # alpha > 0
    elif case == "threshold":
        frac = 0.99
    elif case == "negative":
        vol = vol - 0.1
    elif case == "multichannel":
        vol = np.concatenate([vol, vol], axis=-1)
    want = jskip.pack_tracking_volume(jnp.asarray(vol), jnp.asarray(tf),
                                      min_empty_fraction=frac)
    got = tskip.pack_tracking_volume(_t(vol), _t(tf),
                                     min_empty_fraction=frac)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_empty_fraction_equal():
    vol = np.asarray(jvolume.sphere_volume(16).data)
    tf = _srgb_ramp()
    want = jskip.empty_fraction(jskip.pack_tracking_volume(
        jnp.asarray(vol), jnp.asarray(tf)))
    got = tskip.empty_fraction(tskip.pack_tracking_volume(_t(vol), _t(tf)))
    assert got == want and 0.05 < got < 1.0
