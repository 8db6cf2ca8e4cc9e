"""The ``tf_mxu`` TF lookup of the port against vpt_tpu's
``sample_transfer_1d_mxu``, the lookup of every ``make_scene(tf_mxu=True)``
scene (the headline's included).

JAX evaluates it as a one-hot matmul whose weights are cast to the table
dtype.  With a bfloat16 table every product of a bf16 weight and a bf16
texel is exact in float32, so the port must agree bit for bit.  With a
float32 table the matmul may contract the two products into one fused
multiply-add: agreement within 1.2e-7 (one ulp at 1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as js
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, transfer, volume
from vpt_tpu_torch.kernels import tf1d
from vpt_tpu_torch.renderers import make_scene


def _values(n=4096, seed=0):
    r = np.random.default_rng(seed)
    v = r.uniform(-0.1, 1.1, n).astype(np.float32)
    v[:6] = [0.0, 1.0, 0.5 / 256, 255.5 / 256, 0.25, 0.75]   # edges, knots
    return v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mxu_lookup_matches_jax(dtype):
    r = np.random.default_rng(1)
    tf = r.uniform(0, 1, (2, 256, 4)).astype(np.float32)
    jtable = js.pack_mxu_transfer(jnp.asarray(tf), getattr(jnp, dtype))
    values = _values()
    want = np.asarray(js.sample_transfer_1d_mxu(jtable, jnp.asarray(values)))
    table = interop.tensor_from_numpy(np.asarray(jtable)).to(torch.float32)
    got = tf1d.lookup(table, torch.from_numpy(values),
                      getattr(torch, dtype)).numpy()
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
    else:
        assert np.allclose(got, want, rtol=0, atol=1.2e-7)
    # the bf16 weights are not the bilinear ones
    bilinear = tf1d.lookup(table, torch.from_numpy(values)).numpy()
    assert (dtype == "bfloat16") == (not np.array_equal(bilinear, want))


def test_mxu_mode_rejects_unknown():
    with pytest.raises(ValueError):
        tf1d.lookup(torch.zeros(4, 4), torch.zeros(3), torch.float16)


def _headline_scenes(n=24):
    kwargs = dict(tf_srgb=True, tracking="auto", tf_mxu=True)
    jscene = jmake_scene(jvolume.sphere_volume(n),
                         jtransfer.gray_ramp(alpha_scale=0.8),
                         pack_dtype=jnp.bfloat16, **kwargs)
    tscene = make_scene(volume.sphere_volume(n),
                        transfer.gray_ramp(alpha_scale=0.8),
                        pack_dtype=torch.bfloat16, **kwargs)
    return jscene, tscene


def test_headline_scene_samples_like_jax():
    """The headline scene (bf16 tables, tf_mxu, sRGB TF, cheb-skip): the
    port's ``sample_color`` and ``sample_color_tracking`` against JAX's at
    2048 positions.  The sRGB decode (pow) may differ by one ulp before the
    bf16 rounding of the TF, which moves a colour by at most one bf16 step
    of the row (2^-8 relative); alpha and the cheb distance are exact."""
    jscene, tscene = _headline_scenes()
    assert tscene.tf_mxu == torch.bfloat16
    pos = np.random.default_rng(2).uniform(-0.05, 1.05, (2048, 3)).astype(
        np.float32)
    want = np.asarray(jscene.sample_color(jnp.asarray(pos)))
    got = tscene.sample_color(torch.from_numpy(pos)).numpy()
    assert np.array_equal(got[:, 3], want[:, 3])
    assert np.allclose(got, want, rtol=2 ** -8, atol=0)
    jvs, jcheb = jscene.sample_color_tracking(jnp.asarray(pos))
    tvs, tcheb = tscene.sample_color_tracking(torch.from_numpy(pos))
    assert np.array_equal(tcheb.numpy(), np.asarray(jcheb))
    assert np.array_equal(tvs.numpy()[:, 3], np.asarray(jvs)[:, 3])
    assert np.allclose(tvs.numpy(), np.asarray(jvs), rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("pack_dtype", [None, "bfloat16"])
def test_interop_carries_the_mode(pack_dtype):
    """Through interop the TF row is JAX's own mxu table, so the lookups
    agree bit for bit, also where the sRGB decode differs by one ulp."""
    jscene = jmake_scene(jvolume.sphere_volume(16),
                         jtransfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                         tf_mxu=True, pack_dtype=pack_dtype
                         and getattr(jnp, pack_dtype))
    tscene = interop.scene_from_numpy(interop.scene_fields(jscene))
    want_dtype = torch.bfloat16 if pack_dtype else torch.float32
    assert tscene.tf_mxu == want_dtype
    values = _values(seed=3)
    want = np.asarray(js.sample_transfer_1d_mxu(jscene.transfer_mxu,
                                                jnp.asarray(values)))
    got = tf1d.lookup(tscene.transfer_1d, torch.from_numpy(values),
                      tscene.tf_mxu).numpy()
    if pack_dtype:
        assert np.array_equal(got, want)
    else:
        assert np.allclose(got, want, rtol=0, atol=1.2e-7)
    plain = interop.scene_from_numpy(interop.scene_fields(
        jmake_scene(jvolume.sphere_volume(16), jtransfer.gray_ramp())))
    assert plain.tf_mxu is None


def test_make_scene_records_the_mode():
    vol, tf = volume.sphere_volume(8), transfer.gray_ramp()
    assert make_scene(vol, tf).tf_mxu is None
    assert make_scene(vol, tf, tf_mxu=True).tf_mxu == torch.float32
    unpacked = make_scene(vol, tf, tf_mxu=True, pack=False,
                          pack_dtype=torch.bfloat16)
    # JAX's mxu table is bf16 even when the volume is not packed
    assert unpacked.tf_mxu == torch.bfloat16
    row = unpacked.transfer_1d
    assert torch.equal(row, row.to(torch.bfloat16).to(torch.float32))
