"""vpt_tpu_torch.sampling against vpt_tpu.sampling.

JAX runs op by op here (no jit), so no fused multiply-add changes its
rounding, and the port must match the fetches and packings bit for bit.
Functions that draw random numbers must leave the same RNG state; their
float outputs pass through sqrt/cos/sin and agree to 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import rng as jrng
from vpt_tpu import sampling as js
from vpt_tpu import volume as jvolume
from vpt_tpu.scene import CameraState, default_camera
from vpt_tpu_torch import interop, utils
from vpt_tpu_torch import rng as trng
from vpt_tpu_torch import sampling as ts


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RNG = np.random.default_rng(5)
POSITIONS = RNG.uniform(-0.1, 1.1, (2048, 3)).astype(np.float32)
STATES = RNG.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)


def _volume():
    return np.asarray(jvolume.blobs_volume(12, seed=2).data)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pixel_ndc_equal():
    got = ts.pixel_ndc(6, 10).numpy()
    assert np.array_equal(got, np.asarray(js.pixel_ndc(6, 10)))


def test_pack_corner_volume_equal():
    vol = _volume()
    got = ts.pack_corner_volume(_t(vol)).numpy()
    assert np.array_equal(got, np.asarray(js.pack_corner_volume(vol)))


def test_sample_volume_equal():
    vol = _volume()
    want = np.asarray(js.sample_volume(jnp.asarray(vol),
                                       jnp.asarray(POSITIONS)))
    got = ts.sample_volume(_t(vol), _t(POSITIONS)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_volume_packed_equal(dtype):
    vol = _volume()
    jpacked = js.pack_corner_volume(vol).astype(dtype)
    tpacked = interop.tensor_from_numpy(np.asarray(jpacked), device="cpu")
    assert tpacked.dtype == getattr(torch, dtype)
    want = np.asarray(js.sample_volume_packed(jpacked, vol.shape,
                                              jnp.asarray(POSITIONS)))
    got = ts.sample_volume_packed(tpacked, vol.shape, _t(POSITIONS)).numpy()
    assert np.array_equal(got, want)


def test_texture2d_samplers_equal():
    tex = RNG.uniform(0, 1, (3, 40, 4)).astype(np.float32)
    uv = RNG.uniform(-0.1, 1.1, (512, 2)).astype(np.float32)
    want = np.asarray(js.sample_texture2d(jnp.asarray(tex), jnp.asarray(uv)))
    assert np.array_equal(ts.sample_texture2d(_t(tex), _t(uv)).numpy(), want)
    jpacked = js.pack_corner_texture2d(jnp.asarray(tex))
    tpacked = ts.pack_corner_texture2d(_t(tex))
    assert np.array_equal(tpacked.numpy(), np.asarray(jpacked))
    want = np.asarray(js.sample_texture2d_packed(jpacked, tex.shape,
                                                 jnp.asarray(uv)))
    got = ts.sample_texture2d_packed(tpacked, tex.shape, _t(uv)).numpy()
    assert np.array_equal(got, want)


def test_sample_environment_close():
    env = RNG.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    d = RNG.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(js.sample_environment(jnp.asarray(env), jnp.asarray(d)))
    got = ts.sample_environment(_t(env), _t(d)).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-5)


def test_intersect_cube_equal_including_axis_rays():
    origin = RNG.uniform(-1, 2, (512, 3)).astype(np.float32)
    d = RNG.normal(size=(512, 3)).astype(np.float32)
    d[:8, 0] = 0.0              # rays parallel to a slab: ±inf and NaN
    origin[:4, 0] = 0.0          # 0/0 on the x slab
    want = np.asarray(js.intersect_cube(jnp.asarray(origin), jnp.asarray(d)))
    got = ts.intersect_cube(_t(origin), _t(d)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert np.isnan(got[:4]).any()   # NaN propagates like jnp.minimum


def test_unproject_rand_state_bitwise_rays_close():
    cam = CameraState.from_nodes(default_camera())
    mvp = np.asarray(cam.mvp_inverse)
    ndc = RNG.uniform(-1, 1, (2048, 2)).astype(np.float32)
    inv_res = np.array([1 / 64, 1 / 48], np.float32)
    js_, jf, jt = js.unproject_rand(jnp.asarray(STATES), jnp.asarray(ndc),
                                    jnp.asarray(mvp), jnp.asarray(inv_res),
                                    jnp.float32(0.05))
    ts_, tf, tt = ts.unproject_rand(_t(STATES.astype(np.int64)), _t(ndc),
                                    _t(mvp), _t(inv_res), 0.05)
    assert np.array_equal(np.asarray(js_).astype(np.int64), ts_.numpy())
    assert np.allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    assert np.allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g", [0.3, -0.6, 0.0])
def test_henyey_greenstein_state_bitwise_directions_close(g):
    d = RNG.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js_, jd = js.henyey_greenstein(jnp.asarray(STATES), jnp.float32(g),
                                   jnp.asarray(d))
    ts_, td = ts.henyey_greenstein(_t(STATES.astype(np.int64)), g, _t(d))
    assert np.array_equal(np.asarray(js_).astype(np.int64), ts_.numpy())
    assert np.allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-5)
    # the isotropic case draws the sphere's 2 uniforms, the HG case 3
    draws = 2 if g == 0.0 else 3
    s = _t(STATES.astype(np.int64))
    for _ in range(draws):
        s = trng.pcg(s)
    assert torch.equal(ts_, s)


def test_max3():
    v = _t(RNG.normal(size=(64, 3)).astype(np.float32))
    assert torch.equal(ts.max3(v), v.max(-1).values)
    assert np.array_equal(ts.max3(v).numpy(),
                          np.asarray(js.max3(jnp.asarray(v.numpy()))))


def test_disk_feeds_unproject_in_glsl_order():
    # unproject_rand draws the disk's 2 uniforms before the square's 2
    s = _t(STATES[:16].astype(np.int64))
    s_disk, _ = trng.disk(s)
    s_sq, _ = trng.square(s_disk)
    cam = CameraState.from_nodes(default_camera())
    out, _, _ = ts.unproject_rand(s, torch.zeros(16, 2),
                                  _t(np.asarray(cam.mvp_inverse)),
                                  torch.tensor([0.1, 0.1]), 0.0)
    assert torch.equal(out, s_sq)
    assert np.array_equal(np.asarray(jrng.square(jrng.disk(
        jnp.asarray(STATES[:16]))[0])[0]).astype(np.int64), s_sq.numpy())


def _filter_coords_per_call(position, dims):
    """The filter coordinate with its bounds built at every call (the
    port's code before the bounds were cached)."""
    dims_t = torch.tensor(dims, dtype=torch.float32)
    u = torch.clamp(position * dims_t - 0.5, min=torch.zeros_like(dims_t),
                    max=dims_t - 1.0)
    i0 = torch.floor(u)
    maxi = torch.tensor(dims, dtype=torch.int64) - 1
    return torch.minimum(torch.clamp(i0.to(torch.int64), min=0), maxi), \
        u - i0


@pytest.mark.parametrize("dims", [(12, 7, 5), (40, 3)])
def test_cached_bounds_are_the_per_call_ones(dims):
    """The per-axis bounds come from a cache, built once per (sizes,
    device); the cells and fractions stay bit for bit those of bounds
    built at every call, at edges, beyond them, at inf and at NaN."""
    pos = RNG.uniform(-0.2, 1.2, (2048, len(dims))).astype(np.float32)
    pos[:4, 0] = [np.nan, np.inf, -np.inf, 0.5 / dims[0]]
    pos = _t(pos)
    i0f, f = ts._filter_coords(pos, dims)
    idx = ts._clamp_index(i0f, dims)
    want_idx, want_f = _filter_coords_per_call(pos, dims)
    assert torch.equal(idx, want_idx)
    assert torch.equal(f.isnan(), want_f.isnan())
    assert torch.equal(f.nan_to_num(), want_f.nan_to_num())
    assert idx[0, 0] == 0 and idx[1, 0] == dims[0] - 1 and idx[2, 0] == 0
    cpu = torch.device("cpu")
    assert ts._max_index(dims, cpu) is ts._max_index(dims, cpu)
    assert utils.constant(tuple(dims), torch.float32, cpu) \
        is utils.constant(tuple(dims), torch.float32, cpu)
