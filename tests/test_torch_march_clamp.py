"""The port's march clamps (``make_scene(march_clamp=True)``,
``iso_clamp_min``) against vpt_tpu's, on the CPU.

- ``sampling.intersect_box``, ``skipgrid.occupied_aabb`` and
  ``skipgrid.iso_value_aabb`` equal JAX's, the degenerate [0.5]³ box and
  the None cases included.
- Clamped EAM, MIP, Depth and ISO frames against JAX's (two eager
  ``render_frame``s, 32², the state after each) on blobs 24³ (seed 7) with
  the sRGB TF, whose alpha is exactly 0 for the low values, so the boxes
  cut the rays: the tolerances of ``tests/test_torch_march.py`` (float32
  tables within 1e-6; bf16 tables with ``tf_mxu``: 99% of the values
  within 1e-6 and all within 4e-3).  Measured after two frames: float32
  within 1.9e-7 (Depth equal), bf16 99.85-100% of the values within 1e-6
  and all within 8.6e-6.  ISO with ``iso_clamp_min=0.1`` at isovalue
  0.05 (its box does not hold) and 0.5 (it does).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as jsampling
from vpt_tpu import skipgrid as jskip
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
import vpt_tpu.renderers as jrenderers
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, sampling, skipgrid, transfer, volume
import vpt_tpu_torch.renderers as trenderers
from vpt_tpu_torch.renderers import iso, make_scene

from test_torch_march import assert_close


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MARCH = ("eam", "mip", "depth", "iso")


def _sparse_tf():
    """The gray ramp with an exactly-zero alpha floor
    (``tests/test_march_clamp.py``)."""
    tf = np.asarray(jtransfer.gray_ramp(alpha_scale=0.8)).copy()
    tf[:, :8, 3] = 0.0
    return tf


def _t(a):
    return torch.from_numpy(np.array(a))


def test_intersect_box_equal():
    """Origins inside, outside and on the box, directions with zero
    components (NaN and infinite slabs): equal to JAX's, NaN for NaN."""
    r = np.random.default_rng(3)
    origin = r.uniform(-1.0, 2.0, (4096, 3)).astype(np.float32)
    origin[:64] = [0.25, 0.5, 0.75]
    direction = r.normal(size=(4096, 3)).astype(np.float32)
    direction[np.arange(512, 1024), r.integers(0, 3, 512)] = 0.0
    lo = np.array([0.140625, 0.2, 0.0], np.float32)
    hi = np.array([0.859375, 0.8, 1.0], np.float32)
    origin[512:576] = lo                  # 0 / 0 on the zero components
    want = np.asarray(jsampling.intersect_box(
        jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(lo),
        jnp.asarray(hi)))
    got = sampling.intersect_box(_t(origin), _t(direction), _t(lo),
                                 _t(hi)).numpy()
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isnan(want).any() and np.isfinite(want).mean() > 0.5


@pytest.mark.parametrize("case", ["sphere", "slab", "blobs", "dense",
                                  "invisible", "multichannel"])
def test_occupied_aabb_equal(case):
    tf = _sparse_tf()
    if case == "sphere":
        vol = np.asarray(jvolume.sphere_volume(16).data)
        tf = np.asarray(jtransfer.to_gl_texture(
            jtransfer.gray_ramp(alpha_scale=0.8), srgb=True, quantize=True))
    elif case == "slab":
        vol = np.zeros((16, 16, 16, 1), np.float32)
        vol[:, :, 4:8] = 0.9
    elif case == "blobs":
        vol = np.asarray(jvolume.blobs_volume(24, seed=7).data)
    elif case == "dense":
        vol = np.asarray(jvolume.sphere_volume(16).data)
        tf = np.asarray(jtransfer.gray_ramp(alpha_scale=0.8))
    elif case == "invisible":
        vol = np.zeros((8, 8, 8, 1), np.float32)
    else:
        vol = np.zeros((8, 8, 8, 2), np.float32)
    want = jskip.occupied_aabb(jnp.asarray(vol), jnp.asarray(tf))
    got = skipgrid.occupied_aabb(_t(vol), _t(tf))
    assert (got is None) == (want is None)
    if case in ("dense", "multichannel"):
        assert got is None
        return
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if case == "invisible":
        assert np.array_equal(got.numpy(), np.full((2, 3), 0.5, np.float32))
    if case == "slab":
        assert np.array_equal(got.numpy(), [[3.5 / 16, 0, 0],
                                            [8.5 / 16, 1, 1]])


@pytest.mark.parametrize("alpha_min", [0.05, 0.3, 0.79, 0.99])
def test_iso_value_aabb_equal(alpha_min):
    """Boxes that shrink as the floor rises, the degenerate box where no
    cell reaches it; None where every cell does (a constant volume whose
    alpha, 0.72, reaches the lower floors)."""
    vol = np.asarray(jvolume.blobs_volume(24, seed=7).data)
    tf = _sparse_tf()
    want = jskip.iso_value_aabb(jnp.asarray(vol), jnp.asarray(tf),
                                alpha_min)
    got = skipgrid.iso_value_aabb(_t(vol), _t(tf), alpha_min)
    assert np.array_equal(got.numpy(), np.asarray(want))
    full = np.full((8, 8, 8, 1), 0.9, np.float32)
    want = jskip.iso_value_aabb(jnp.asarray(full), jnp.asarray(tf),
                                alpha_min)
    got = skipgrid.iso_value_aabb(_t(full), _t(tf), alpha_min)
    assert (got is None) == (want is None) == (alpha_min < 0.72)
    if want is not None:
        assert np.array_equal(got.numpy(), np.asarray(want))


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """blobs 24³ under the sRGB TF (alpha 0 for low values) with both
    boxes, float32 and bf16 tables."""
    out = {}
    for kind in ("f32", "bf16"):
        extra = {} if kind == "f32" else dict(pack_dtype=jnp.bfloat16,
                                              tf_mxu=True)
        jscene = jmake_scene(jvolume.blobs_volume(24, seed=7),
                             jtransfer.gray_ramp(alpha_scale=0.9),
                             tf_srgb=True, pack=True, march_clamp=True,
                             iso_clamp_min=0.1, **extra)
        assert jscene.occupied_aabb is not None
        assert jscene.iso_aabb is not None
        out[kind] = (jscene, _port(jscene))
    return out


def _params(module, jparams, **kw):
    return module.Params(**{f.name: getattr(jparams, f.name)
                            for f in dataclasses.fields(jparams)}, **kw)


def _first_state(key, frame):
    """The state that one ``render_frame`` from ``reset`` leaves, from
    ``generate``'s frame: ISO keeps its hits over the cleared -1; EAM's
    mean with weight 1 and MIP's max over 0 are the frame."""
    if key == "iso":
        return torch.where(frame[..., 3:] > 0.0, frame, -1.0)
    return frame


def _frame_of(key, state):
    """The part of a state that a frame fills: Depth's channel 0."""
    state = np.asarray(state)
    return state[..., 0] if key == "depth" else state


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("key", MARCH)
def test_clamped_frames_agree_with_jax(scenes, key, kind):
    """Two eager ``render_frame``s from ``reset`` on the clamped scene,
    against JAX's after each; the port's ``generate`` against JAX's first
    state, which holds its frame; and the clamp moves the frame (the
    unclamped scene's differs)."""
    jscene, tscene = scenes[kind]
    jm, tm = getattr(jrenderers, key), getattr(trenderers, key)
    # Depth's default threshold (0.1) is reached nowhere on this scene
    jparams = jm.Params(threshold=0.02) if key == "depth" else jm.Params()
    tparams = _params(tm, jparams)
    tframe = tm.generate(tscene, tparams, 0.37, 32, 32)
    bare = dataclasses.replace(tscene, occupied_aabb=None, iso_aabb=None)
    assert not torch.equal(tm.generate(bare, tparams, 0.37, 32, 32), tframe)

    jstate = jm.reset(jparams, 32, 32, jscene)
    tstate = tm.reset(tparams, 32, 32, tscene)
    for n, seed in ((1, 0.37), (2, 0.81)):
        jstate = jm.render_frame(jstate, jscene, jparams, jnp.float32(seed),
                                 jnp.int32(n))
        tm.render_frame(tstate, tscene, tparams, seed, n)
        assert_close(tstate, jstate, kind)
        if n == 1:
            assert_close(_first_state(key, tframe), _frame_of(key, jstate),
                         kind)


@pytest.mark.parametrize("isovalue,boxes", [(0.05, 1), (0.5, 2)])
def test_iso_box_holds_by_isovalue(scenes, isovalue, boxes):
    """``iso_clamp_min=0.1``: at isovalue 0.05 only the occupied box
    applies, at 0.5 both; the frames equal JAX's (float32 tables)."""
    jscene, tscene = scenes["f32"]
    jparams = jrenderers.iso.Params(isovalue=isovalue)
    tparams = iso.Params(isovalue=isovalue)
    assert len(iso.boxes(tscene, tparams)) == boxes
    jframe = jrenderers.iso.generate(jscene, jparams, jnp.float32(0.52), 32,
                                     32)
    tframe = iso.generate(tscene, tparams, 0.52, 32, 32)
    assert_close(tframe, jframe, "f32")
    assert (np.asarray(jframe)[..., 3] > 0).any()
    no_occ = dataclasses.replace(tscene, occupied_aabb=None)
    assert len(iso.boxes(no_occ, tparams)) == boxes - 1
    assert len(iso.boxes(tscene, iso.Params(isovalue=0.0))) == 0


def test_make_scene_builds_jax_boxes():
    """The port's own make_scene builds JAX's boxes and floor; a dense
    scene's clamp is None and its frame the unclamped one."""
    kw = dict(tf_srgb=True, march_clamp=True, iso_clamp_min=0.3)
    jscene = jmake_scene(jvolume.blobs_volume(24, seed=7),
                         jtransfer.gray_ramp(alpha_scale=0.9), **kw)
    tscene = make_scene(volume.blobs_volume(24, seed=7, device="cpu"),
                        transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                        device="cpu", **kw)
    assert np.array_equal(tscene.occupied_aabb.numpy(),
                          np.asarray(jscene.occupied_aabb))
    assert np.array_equal(tscene.iso_aabb.numpy(),
                          np.asarray(jscene.iso_aabb))
    assert tscene.iso_clamp_min == jscene.iso_clamp_min == 0.3
    dense = make_scene(volume.sphere_volume(16, device="cpu"),
                       transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                       march_clamp=True, device="cpu")
    assert dense.occupied_aabb is None
    eam = trenderers.eam
    plain = dataclasses.replace(dense, occupied_aabb=None)
    assert torch.equal(eam.generate(dense, eam.Params(), 0.3, 16, 16),
                       eam.generate(plain, eam.Params(), 0.3, 16, 16))
