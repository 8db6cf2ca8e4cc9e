"""The port's MCS renderer against vpt_tpu's.

- ``generate`` and ``render_frame`` against vpt_tpu's, called eagerly, on
  blobs 24³ (seed 7) at 32² and 128².  A pixel's free path is a chain of
  float comparisons, so a last-bit difference (in ``log``, or in the cos
  and sin of the frame's scatter direction) can send it down another path:
  the bounds are 99% of the pixels within 1e-6 and, with float32 tables,
  the image means within 1e-4 (measured at extinction 8: float32 tables,
  every pixel within 1e-6 and 97-98% equal, the means equal; bf16 +
  ``tf_mxu`` + cheb-skip, 99.6-99.8% of the pixels within 1e-6).
- The slice end to end against ``tests/goldens/mcs.npz`` (48², 4 frames,
  seed0 11): jitted JAX rounds 31% of the 48² NDCs differently, and those
  pixels hash to other streams (ROADMAP queue 3).  Measured: 96.6% of the
  pixels within 2e-5, means 1.6e-4 apart.  Bound: 92% and 2e-3.
- The reference's own oracle: ``tests/test_glsl_emulation.py``'s
  sequential GLSL emulation of MCS (one frame, and three progressive
  frames) with the port in vpt_tpu's place (monkeypatched for the test),
  every pixel at that file's 1e-4; and the escaped-ray check of
  ``tests/test_renderers.py``.
"""

import dataclasses
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_glsl_emulation as glsl
from vpt_tpu import environment as jenvironment
from vpt_tpu import rng as jrng
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcs as jmcs
from vpt_tpu_torch import environment, interop, transfer, volume
from vpt_tpu_torch.kernels import mcs_frame
from vpt_tpu_torch.renderers import make_renderer, make_scene
from vpt_tpu_torch.renderers import mcs as tmcs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


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
    return out


def assert_pixels_agree(got, want, kind):
    close = (np.abs(np.asarray(got) - np.asarray(want)) <= 1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    if kind == "f32":
        assert abs(float(np.asarray(got).mean())
                   - float(np.asarray(want).mean())) <= 1e-4


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("res", [32, 128])
def test_generate_and_render_frame_agree_with_jax(scenes, res, kind):
    jscene, tscene = scenes[kind]
    jparams, tparams = jmcs.Params(extinction=8.0), tmcs.Params(
        extinction=8.0)
    jframe = jmcs.generate(jscene, jparams, jnp.float32(0.37), res, res)
    tframe = tmcs.generate(tscene, tparams, 0.37, res, res)
    assert tframe.shape == (res, res, 4)
    assert_pixels_agree(tframe, jframe, kind)

    jstate = jmcs.reset(jparams, res, res, jscene)
    tstate = tmcs.reset(tparams, res, res, tscene)
    assert np.array_equal(tstate.numpy(), np.asarray(jstate))
    for n, seed in ((1, 0.37), (2, 0.81), (3, 0.55)):
        jstate = jmcs.render_frame(jstate, jscene, jparams,
                                   jnp.float32(seed), jnp.int32(n))
        assert tmcs.render_frame(tstate, tscene, tparams, seed, n) is tstate
    assert_pixels_agree(tstate, jstate, kind)


def test_render_progressive_agrees_with_jax(scenes):
    """The slice end to end at 32²: the factory renderers, vpt_tpu's
    jitted (where 32² moves no NDC), 3 frames from seed0 5, extinction 8.
    Measured: every pixel within 1e-6.  Bound: 99%."""
    from vpt_tpu.renderers import make_renderer as jmake_renderer

    jscene, tscene = scenes["f32"]
    want = jmake_renderer("mcs", jmcs.Params(extinction=8.0), 32, 32) \
        .render_progressive(jscene, frames=3, seed0=5)
    got = make_renderer("mcs", tmcs.Params(extinction=8.0), 32, 32) \
        .render_progressive(tscene, frames=3, seed0=5)
    assert got.shape == (32, 32, 4)
    assert_pixels_agree(got, want, "f32")


@pytest.mark.parametrize("seed", [0.0, 0.29, 0.88])
def test_scatter_direction_matches_jax(seed):
    """sphere(pcg(bits(seed) ^ 0x9E3779B9)), a unit vector."""
    state = jrng.pcg(jrng.float_bits_to_uint(jnp.float32(seed))
                     ^ jnp.uint32(0x9E3779B9))
    _, want = jrng.sphere(state)
    got = tmcs.scatter_direction(seed)
    assert all(isinstance(x, np.float32) for x in got)
    assert np.allclose(np.array(got), np.asarray(want), rtol=0, atol=1e-6)
    assert abs(float(np.linalg.norm(np.array(got))) - 1.0) < 1e-5


def test_golden_through_render_progressive():
    scene = make_scene(volume.blobs_volume(24, seed=7, device="cpu"),
                       transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                       pack=True, device="cpu")
    img = make_renderer("mcs", height=48, width=48).render_progressive(
        scene, frames=4, seed0=11).numpy()
    golden = np.load(pathlib.Path(__file__).parent / "goldens"
                     / "mcs.npz")["image"]
    assert img.shape == golden.shape
    close = np.abs(img - golden).max(-1) <= 2e-5
    assert close.mean() >= 0.92, close.mean()
    assert abs(img.mean() - golden.mean()) < 2e-3


@pytest.fixture
def glsl_scene():
    """The emulation file's scene: a 16³ sphere, gray_ramp(0.9)."""
    return jmake_scene(jvolume.sphere_volume(16),
                       jtransfer.gray_ramp(alpha_scale=0.9))


def _params(jparams):
    return tmcs.Params(**{f.name: getattr(jparams, f.name)
                          for f in dataclasses.fields(jparams)})


def test_matches_sequential_glsl_emulation(monkeypatch, glsl_scene):
    """One frame at 9², every pixel at 1e-4: the emulation file's check
    with the port's generate in vpt_tpu's place."""
    monkeypatch.setattr(jmcs, "generate", lambda scene, params, seed, h, w:
                        tmcs.generate(_port(scene), _params(params),
                                      np.float32(seed), h, w).numpy())
    glsl.test_mcs_matches_sequential_emulation(glsl_scene)


def test_progressive_integrate_matches_glsl_emulation(monkeypatch,
                                                      glsl_scene):
    """Three progressive frames, the incremental mean, every pixel at
    1e-4: the emulation file's check with the port's reset and
    render_frame (the state a torch tensor, updated in place)."""
    tscene = _port(glsl_scene)
    monkeypatch.setattr(jmcs, "reset", lambda params, h, w, scene=None:
                        tmcs.reset(_params(params), h, w, tscene))
    monkeypatch.setattr(
        jmcs, "render_frame", lambda state, scene, params, seed, n:
        tmcs.render_frame(state, tscene, _params(params), np.float32(seed),
                          int(n)))
    glsl.test_mcs_progressive_integrate_matches_emulation(glsl_scene)


def test_escaped_rays_see_environment():
    """A transparent volume: every ray escapes to the constant
    environment."""
    scene = make_scene(volume.Volume(torch.zeros(8, 8, 8, 1)),
                       torch.zeros(2, 2, 4),
                       environment=environment.constant(
                           [0.25, 0.5, 0.75], device="cpu"), device="cpu")
    img = make_renderer("mcs", height=8, width=8).render_progressive(
        scene, frames=2, seed0=0)
    assert torch.allclose(img[..., :3], torch.tensor([0.25, 0.5, 0.75]),
                          rtol=0, atol=1e-5)


def test_escaped_rays_match_jax_environment():
    """The same transparent scene through vpt_tpu: equal images."""
    env = jenvironment.constant([0.25, 0.5, 0.75])
    jscene = jmake_scene(jvolume.Volume(jnp.zeros((8, 8, 8, 1))),
                         jnp.zeros((2, 2, 4)), environment=env)
    want = jmcs.render_frame(jmcs.reset(jmcs.Params(), 8, 8, jscene), jscene,
                             jmcs.Params(), jnp.float32(0.4), jnp.int32(1))
    tscene = _port(jscene)
    state = tmcs.reset(tmcs.Params(), 8, 8, tscene)
    tmcs.render_frame(state, tscene, tmcs.Params(), 0.4, 1)
    assert np.array_equal(state.numpy(), np.asarray(want))


def test_cheb_skip_renders_the_same_estimator():
    """A sphere in empty space (with the sRGB TF the cheb-skip table marks
    77% of the cells empty): with the table the free paths hop the empty cells and take
    other draws, so the images differ, but they estimate the same thing.
    Over 16 frames at 32² the means agree within the noise (measured
    6.1e-4 apart)."""
    means, images = [], []
    for tracking in ("none", "cheb"):
        scene = make_scene(volume.sphere_volume(24, device="cpu"),
                           transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                           tf_srgb=True, tracking=tracking, device="cpu")
        assert (scene.tracking_packed is not None) == (tracking == "cheb")
        img = make_renderer("mcs", tmcs.Params(extinction=8.0), 32, 32) \
            .render_progressive(scene, frames=16, seed0=2)
        images.append(img)
        means.append(float(img[..., :3].mean()))
    assert not torch.equal(images[0], images[1])
    assert abs(means[0] - means[1]) < 0.01, means


def test_interop_carries_the_state(scenes):
    jscene, tscene = scenes["f32"]
    jstate = jmcs.render_frame(jmcs.reset(jmcs.Params(), 6, 8, jscene),
                               jscene, jmcs.Params(), jnp.float32(0.2),
                               jnp.int32(1))
    t = interop.state_from_numpy(np.asarray(jstate), device="cpu")
    assert t.shape == tmcs.reset(tmcs.Params(), 6, 8, tscene).shape
    assert np.array_equal(interop.state_to_numpy(t), np.asarray(jstate))


def test_cpu_frame_launches_nothing(scenes):
    _, tscene = scenes["bf16"]
    before = mcs_frame.LAUNCHES
    make_renderer("mcs", height=8, width=8).render_progressive(tscene,
                                                               frames=1)
    assert mcs_frame.LAUNCHES == before


def test_integrate_divides_by_a_tensor():
    """acc + (frame − acc) / n is the IEEE quotient (float64 division
    rounded to float32 is the correctly rounded float32 one)."""
    g = torch.Generator().manual_seed(5)
    state = torch.rand(16, 16, 4, generator=g)
    frame = torch.rand(16, 16, 4, generator=g)
    want = (state + ((frame - state).double() / 7.0).float())
    tmcs.integrate(state, frame, 7)
    assert torch.equal(state, want)


def test_gradient_sky_frames_agree_with_jax():
    """An equirect map larger than 1×1 (``gradient_sky(16, 32)``) lights
    the scattered paths along the frame's scatter direction and colors
    the misses and escapes along the view ray: 3 frames at 32² on a 16³
    sphere against vpt_tpu's jitted frames (32² moves no NDC), every
    value within 2e-6 (measured: within 1.2e-7)."""
    import jax

    sky = jenvironment.gradient_sky(16, 32)
    jscene = jmake_scene(jvolume.sphere_volume(16),
                         jtransfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                         environment=sky)
    tscene = _port(jscene)
    assert tuple(tscene.environment.shape) == (16, 32, 4)
    params = jmcs.Params(extinction=8.0)
    jstate = jmcs.reset(params, 32, 32, jscene)
    tstate = tmcs.reset(tmcs.Params(extinction=8.0), 32, 32, tscene)
    frame = jax.jit(jmcs.render_frame)
    for n, seed in enumerate((0.23, 0.57, 0.91), start=1):
        jstate = frame(jstate, jscene, params, jnp.float32(seed),
                       jnp.int32(n))
        tmcs.render_frame(tstate, tscene, tmcs.Params(extinction=8.0), seed,
                          n)
    diff = np.abs(tstate.numpy() - np.asarray(jstate))
    assert diff.max() <= 2e-6, diff.max()
    assert np.unique(np.asarray(jstate)[..., 2]).size > 100
