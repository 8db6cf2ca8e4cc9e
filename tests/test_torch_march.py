"""The port's march renderers (EAM, MIP, Depth, ISO) against vpt_tpu's.

- ``generate`` and ``render_frame`` of each renderer against vpt_tpu's,
  called eagerly, on the same scene (blobs 24³, seed 7), at 32² and 128²,
  where the jitted ``pixel_ndc`` rounding fault (ROADMAP queue 3) moves no
  pixel.  Float32 tables: every value within 1e-6 (measured: at most
  2.1e-7; Depth equal).  bf16 tables with ``tf_mxu``, ``tf_srgb`` and
  ``tracking="auto"``: the bf16 lerp weights of the TF lookup round a
  one-ulp change of a fetched value to a step of 2^-8, so the bounds are a
  share of values within 1e-6 and a cap on the rest (measured below).
- The slice end to end: ``make_renderer(key).render_progressive`` against
  vpt_tpu's, and against ``tests/goldens/{key}.npz`` (48², 2 frames, seed0
  11).  At 48² jitted JAX rounds 31% of the NDCs differently, but these
  four renderers' images still agree within 2e-5 in every pixel, so every
  pixel is asserted.
- The reference's own oracles: the numpy GLSL emulations of
  ``tests/test_glsl_emulation.py`` run with the port's ``generate`` in
  place of vpt_tpu's (monkeypatched for the test), so the port is held to
  them on every pixel at that file's 1e-4; and the behavioural checks of
  ``tests/test_renderers.py``.
"""

import dataclasses
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_glsl_emulation as glsl
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
import vpt_tpu.renderers as jrenderers
from vpt_tpu.renderers import make_renderer as jmake_renderer
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, transfer, volume
from vpt_tpu_torch.kernels import iso_shade, march
from vpt_tpu_torch.renderers import factory, make_renderer, make_scene
import vpt_tpu_torch.renderers as trenderers


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
GOLDENS = pathlib.Path(__file__).parent / "goldens"


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


def _params(module, jparams):
    """The port's Params with the fields of a vpt_tpu Params."""
    return module.Params(**{f.name: getattr(jparams, f.name)
                            for f in dataclasses.fields(jparams)})


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for kind in ("f32", "bf16"):
        extra = {} if kind == "f32" else dict(
            pack_dtype=jnp.bfloat16, tf_mxu=True, tf_srgb=True,
            tracking="auto")
        jscene = jmake_scene(jvolume.blobs_volume(24, seed=7),
                             jtransfer.gray_ramp(alpha_scale=0.9), pack=True,
                             **extra)
        out[kind] = (jscene, _port(jscene))
    assert out["bf16"][1].tracking_packed is not None
    assert out["bf16"][1].tf_mxu == torch.bfloat16
    return out


def assert_close(got, want, kind):
    """float32 tables: within 1e-6 (measured: 84-100% equal, at most
    2.1e-7 apart).  bf16 + tf_mxu: at least 99% of the values within 1e-6
    and all within 4e-3 (measured: 91-100% equal, 99.7-100% within 1e-6,
    the largest difference 2.0e-3, in one MIP pixel at 128²)."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    if kind == "f32":
        assert diff.max() <= 1e-6, diff.max()
    else:
        assert (diff <= 1e-6).mean() >= 0.99, (diff <= 1e-6).mean()
        assert diff.max() <= 4e-3, diff.max()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("res", [32, 128])
@pytest.mark.parametrize("key", MARCH)
def test_generate_and_render_frame_agree_with_jax(scenes, key, res, kind):
    """One eager ``generate`` and two ``render_frame``s from ``reset``
    (frames 1 and 2: the integrate's replace and its mean, max or
    nearer hit) on the same scene and seeds."""
    jscene, tscene = scenes[kind]
    jm, tm = getattr(jrenderers, key), getattr(trenderers, key)
    jparams = jm.Params()
    tparams = _params(tm, jparams)
    jframe = jm.generate(jscene, jparams, jnp.float32(0.37), res, res)
    tframe = tm.generate(tscene, tparams, 0.37, res, res)
    assert tframe.shape == jframe.shape
    assert_close(tframe, jframe, kind)

    jstate = jm.reset(jparams, res, res, jscene)
    tstate = tm.reset(tparams, res, res, tscene)
    assert np.array_equal(tstate.numpy(), np.asarray(jstate))
    for n, seed in ((1, 0.37), (2, 0.81)):
        jstate = jm.render_frame(jstate, jscene, jparams, jnp.float32(seed),
                                 jnp.int32(n))
        out = tm.render_frame(tstate, tscene, tparams, seed, n)
        assert out is tstate                 # updated in place
    assert_close(tstate, jstate, kind)


def test_march_chunk_does_not_change_the_fold(scenes):
    """The fold is sequential: sampling 1, 5 or 64 slices a call gives the
    same carry."""
    from vpt_tpu_torch.renderers import _march, eam

    _, tscene = scenes["f32"]
    _, _, start, end = _march.rays(tscene, 16, 16)
    ts = _march.schedule(np.float32(0.01), np.float32(1 / 64), 64, "cpu")

    def composite(acc, t, color):
        return acc * 0.5 + color[..., 3] * t

    outs = [_march.march(tscene, start, end, ts, composite,
                         torch.zeros(16, 16), chunk=c) for c in (1, 5, 64)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert eam.Params().slices == 64


@pytest.mark.parametrize("key", MARCH)
def test_render_progressive_agrees_with_jax(scenes, key):
    """The slice end to end at 32²: the port's factory renderer against
    vpt_tpu's (jitted, where 32² moves no NDC), 3 frames from seed0 5."""
    jscene, tscene = scenes["f32"]
    want = jmake_renderer(key, height=32, width=32).render_progressive(
        jscene, frames=3, seed0=5)
    got = make_renderer(key, height=32, width=32).render_progressive(
        tscene, frames=3, seed0=5)
    assert got.shape == (32, 32, 4)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


@pytest.mark.parametrize("key,golden", [("eam", "eam"), ("mip", "mip"),
                                        ("depth", "depth"), ("iso", "iso"),
                                        ("eam", "eam_srgb")])
def test_golden_through_render_progressive(key, golden):
    """tests/goldens/{golden}.npz: 48², blobs 24³ seed 7, gray_ramp(0.9),
    float32 tables (``eam_srgb``: the sRGB TF texture), 2 frames, seed0
    11, through the port's public path.  Measured: every pixel within
    2e-5 (at most 7.1e-6, ISO's shade).  Asserted: every pixel."""
    scene = make_scene(volume.blobs_volume(24, seed=7, device="cpu"),
                       transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                       pack=True, tf_srgb=golden.endswith("srgb"),
                       device="cpu")
    img = make_renderer(key, height=48, width=48).render_progressive(
        scene, frames=2, seed0=11).numpy()
    want = np.load(GOLDENS / f"{golden}.npz")["image"]
    assert img.shape == want.shape
    assert (np.abs(img - want).max(-1) <= 2e-5).all(), \
        np.abs(img - want).max()


@pytest.fixture
def glsl_scene():
    """The emulation file's scene: a 16³ sphere, gray_ramp(0.9)."""
    return jmake_scene(jvolume.sphere_volume(16),
                       jtransfer.gray_ramp(alpha_scale=0.9))


def port_generate(key):
    """vpt_tpu's ``generate`` signature over the port's, for the oracle
    tests: the JAX scene and Params cross to the port, the frame comes
    back as numpy."""
    tm = getattr(trenderers, key)

    def generate(scene, params, seed, height, width):
        return tm.generate(_port(scene), _params(tm, params),
                           np.float32(seed), height, width).numpy()

    return generate


@pytest.mark.parametrize("key,oracle", [
    ("eam", glsl.test_eam_matches_sequential_emulation),
    ("mip", glsl.test_mip_matches_sequential_emulation),
    ("iso", glsl.test_iso_matches_sequential_emulation),
    ("depth", glsl.test_depth_matches_sequential_emulation)],
    ids=["eam", "mip", "iso", "depth"])
def test_matches_sequential_glsl_emulation(monkeypatch, glsl_scene, key,
                                           oracle):
    """The emulation file's own check (every pixel at 33², atol 1e-4) with
    the port's generate in vpt_tpu's place."""
    jm = getattr(jrenderers, key)
    monkeypatch.setattr(jm, "generate", port_generate(key))
    oracle(glsl_scene)


# -- the behavioural checks of tests/test_renderers.py ------------------

@pytest.fixture(scope="module")
def sphere32():
    return make_scene(volume.sphere_volume(32, device="cpu"),
                      transfer.gray_ramp(alpha_scale=1.0, device="cpu"),
                      device="cpu")


def test_mip_center_value(sphere32):
    """The centre ray crosses the sphere's centre, value 1, alpha 1; the
    corner ray misses."""
    img = make_renderer("mip", height=33, width=33).render_progressive(
        sphere32, frames=4, seed0=0).numpy()
    assert img[16, 16, 0] > 0.95
    assert img[0, 0, 0] == 0.0


def test_mip_progressive_monotone(sphere32):
    r = make_renderer("mip", height=16, width=16)
    r.reset(sphere32)
    prev = None
    for i in range(3):
        r.render(sphere32, 0.1 * (i + 1))
        cur = r.state.clone()
        if prev is not None:
            assert bool((cur >= prev).all())
        prev = cur


def test_eam_homogeneous_analytic():
    """Unit density, alpha 0.5 everywhere: the centre pixel composites
    per-step opacity a = 0.5 · (1/64) · 100 front to back until alpha
    passes 0.99."""
    from vpt_tpu_torch.renderers import eam

    tf = torch.zeros(2, 256, 4)
    tf[..., :3] = 1.0
    tf[..., 3] = 0.5
    scene = make_scene(volume.Volume(torch.ones(8, 8, 8, 1)), tf,
                       device="cpu")
    frame = eam.generate(scene, eam.Params(random=False), 0.0, 65, 65)
    a_step = 0.5 * (1.0 / 64) * 100
    acc_rgb, acc_a, t = 0.0, 0.0, 0.0
    while t < 1.0 and acc_a < 0.99:
        acc_rgb += (1 - acc_a) * a_step
        acc_a += (1 - acc_a) * a_step
        t += 1 / 64
    if acc_a > 1.0:
        acc_rgb /= acc_a
    assert abs(float(frame[32, 32, 0]) - acc_rgb) <= 1e-3


def test_eam_running_mean(sphere32):
    from vpt_tpu_torch.renderers import eam

    params = eam.Params()
    f1 = eam.generate(sphere32, params, 0.1, 16, 16)
    f2 = eam.generate(sphere32, params, 0.7, 16, 16)
    state = eam.reset(params, 16, 16, sphere32)
    eam.render_frame(state, sphere32, params, 0.1, 1)
    eam.render_frame(state, sphere32, params, 0.7, 2)
    assert torch.allclose(state, (f1 + f2) / 2, rtol=0, atol=1e-6)


def test_iso_hit_depth(sphere32):
    """The centre ray meets the isosurface near the sphere's front (radius
    0.3; the camera looks down −z from +z); the corner ray misses."""
    r = make_renderer("iso", height=33, width=33)
    r.render(sphere32, 0.5)
    closest = r.state.numpy()
    pos = closest[16, 16, :3]
    assert closest[16, 16, 3] > 0
    assert abs(np.linalg.norm(pos - 0.5) - 0.3) < 0.05
    assert pos[2] > 0.5
    assert closest[0, 0, 3] == -1.0


def test_iso_integrate_keeps_nearer():
    """A hit replaces no hit; the nearer of two hits stays; no hit keeps
    the accumulated one."""
    from vpt_tpu_torch.renderers import iso

    state = torch.tensor([[[-1.0] * 4, [0.1, 0.2, 0.3, 0.6],
                           [0.4, 0.5, 0.6, 0.3]]])
    frame = torch.tensor([[[0.5, 0.5, 0.5, 0.4], [0.7, 0.7, 0.7, 0.4],
                           [-1.0] * 4]])
    iso.integrate(state, frame, 3)
    assert torch.equal(state, torch.tensor([[[0.5, 0.5, 0.5, 0.4],
                                             [0.7, 0.7, 0.7, 0.4],
                                             [0.4, 0.5, 0.6, 0.3]]]))


def test_depth_values_in_bounds(sphere32):
    img = make_renderer("depth", height=32, width=32).render_progressive(
        sphere32, frames=1, seed0=0).numpy()
    d = img[..., 0]
    hit = d >= 0
    assert hit.sum() > 0
    assert (d[hit] <= 1.0).all()
    assert (d[~hit] == -1.0).all()


def test_display_shapes_and_alpha(sphere32):
    """Every march renderer displays (H, W, 4) with alpha 1, and the
    display is not the state itself (the port updates states in place)."""
    for key in MARCH:
        r = make_renderer(key, height=12, width=20)
        img = r.render_progressive(sphere32, frames=2, seed0=1)
        assert img.shape == (12, 20, 4) and bool(torch.isfinite(img).all())
        assert bool((img[..., 3] == 1.0).all()), key
        assert img.data_ptr() != r.state.data_ptr()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_iso_display_matches_jax(scenes, kind):
    """ISO's display (the deferred shade) on the same hit buffer: the
    port's plain shade against vpt_tpu's display, within 1e-5 and
    :func:`assert_close`'s bounds.  Measured at 32²: float32 tables equal;
    bf16 tables with ``tf_mxu`` and sRGB at most 3.0e-8 apart (99.93% of
    the values equal): each tap's difference is divided by 2h = 0.01, but
    no fetch differs by enough to leave the bounds."""
    jscene, tscene = scenes[kind]
    jm = jrenderers.iso
    state = jm.render_frame(jm.reset(jm.Params(), 32, 32, jscene), jscene,
                            jm.Params(), jnp.float32(0.4), jnp.int32(1))
    want = np.asarray(jm.display(state, jscene, jm.Params()))
    got = trenderers.iso.display(
        interop.state_from_numpy(np.asarray(state), device="cpu"), tscene,
        trenderers.iso.Params())
    assert (np.asarray(state)[..., 3] > 0).any()
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert_close(got, want, kind)


def test_light_direction_matches_jax(scenes):
    jscene, tscene = scenes["f32"]
    from vpt_tpu import math3d as jm4

    inv = jm4.invert(jscene.model_view)
    light = jm4.transform_point(inv, jnp.asarray((2.0, -3.0, -5.0)))
    light = light / jnp.sqrt(jnp.maximum(jnp.sum(light * light), 1e-12))
    got = trenderers.iso.light_direction(tscene, trenderers.iso.Params())
    assert np.allclose(got.numpy(), np.asarray(light), rtol=0, atol=1e-6)


@pytest.mark.parametrize("key", MARCH)
def test_interop_carries_each_state(scenes, key):
    """A renderer state that is one array crosses both ways bit for bit,
    with the shape the port's reset gives."""
    jscene, tscene = scenes["f32"]
    jm, tm = getattr(jrenderers, key), getattr(trenderers, key)
    jstate = jm.render_frame(jm.reset(jm.Params(), 8, 6, jscene), jscene,
                             jm.Params(), jnp.float32(0.2), jnp.int32(1))
    t = interop.state_from_numpy(np.asarray(jstate), device="cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert t.shape == tm.reset(_params(tm, jm.Params()), 8, 6, tscene).shape
    assert np.array_equal(interop.state_to_numpy(t), np.asarray(jstate))


def test_factory_makes_every_ported_renderer():
    for key in ("mcm", "eam", "mip", "depth", "iso", "mcs", "dos", "lao"):
        r = factory.make_renderer(key, height=4, width=4)
        assert r.module is factory.get_module(key)


def test_cpu_frames_launch_nothing(sphere32):
    before = (march.LAUNCHES, iso_shade.LAUNCHES)
    for key in MARCH:
        make_renderer(key, height=8, width=8).render_progressive(
            sphere32, frames=1)
    assert (march.LAUNCHES, iso_shade.LAUNCHES) == before


def test_wrappers_refuse_unknown_modes(sphere32):
    state = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError):
        march.march_frame("dos", state, sphere32, None, 0.1, 1)


def test_scene_preparation_is_kept_and_lets_the_scene_go(scenes):
    """The kernels' wrappers keep the last scene's launch arguments: the
    same object while the scene and its tables stay, a new one when a
    table is replaced, and none once the scene goes."""
    import gc

    scene = make_scene(volume.sphere_volume(8, device="cpu"),
                       transfer.gray_ramp(device="cpu"), device="cpu")
    cache = march._scene_cache
    key = ("eam", trenderers.eam.Params(), 4, 4)
    prepared = cache.get(scene, key)
    assert cache.get(scene, key) is prepared
    args = prepared.args
    assert args.table == scene.volume_packed.data_ptr() \
        and (args.d, args.h, args.w) == (8,) * 3
    scene.volume_packed = scene.volume_packed.clone()
    assert cache.get(scene, key) is not prepared
    del prepared, args, scene
    gc.collect()
    assert cache._last is None


def test_unpacked_scene_raises_for_the_kernels():
    """What the CUDA wrappers take from a scene: an unpacked scene
    raises before any launch."""
    scene = make_scene(volume.sphere_volume(8, device="cpu"),
                       transfer.gray_ramp(device="cpu"), pack=False,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="pack=True"):
        march._scene_cache.get(scene,
                               ("eam", trenderers.eam.Params(), 4, 4))
