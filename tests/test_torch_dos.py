"""The port's DOS renderer against vpt_tpu's.

- The reset's pieces: the disk offsets and the depth range within 1e-6
  (measured: the offsets 6.0e-8 apart, the mean's summation order; the
  depths equal).
- The disk taps (``_shifted_occlusion_taps``) on JAX's offsets against
  JAX's, on square and non-square buffers at scales that clip whole rows
  (the width clamp of both axes included), and against the gather sampler
  (the port of ``tests/test_renderers.py:331``).
- Three ``render_frame``s from a JAX ``reset`` carried across by
  ``interop.state_from_numpy``, against vpt_tpu's jitted frame (the path
  of its Renderer), on blobs 24³ at 32²; float32 tables and bf16 tables
  with ``tf_mxu``, sRGB and cheb-skip.  XLA contracts products into fused
  multiply-adds under jit and the port does not, and exp differs in the
  last bit: the bounds are stated at the test with what was measured.
- ``display``; the slice end to end against ``tests/goldens/dos.npz``
  (48², 2 frames, seed0 11) on JAX's scene carried across and on the
  port's own (whose inverse MVP is JAX's, bit for bit); the
  reference's sequential GLSL emulation (``tests/test_glsl_emulation.py``)
  with the port's ``reset``/``render_frame``/``display`` in vpt_tpu's
  place, at that file's 1e-4; ``test_dos_background_white``.

JAX's frame is compiled once per scene (module-scope fixtures).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_glsl_emulation as glsl
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import dos as jdos
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, sampling, transfer, volume
from vpt_tpu_torch.kernels import dos_sweep
from vpt_tpu_torch.renderers import dos, factory, make_renderer, make_scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDENS = pathlib.Path(__file__).parent / "goldens"
RES = 32


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


def _params(jparams):
    """The port's Params with the fields of a vpt_tpu Params."""
    return dos.Params(**{f.name: getattr(jparams, f.name)
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
    return out


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """vpt_tpu's reset and three jitted frames on each scene, as numpy."""
    frame = jax.jit(jdos.render_frame)
    out = {}
    for kind, (jscene, _) in scenes.items():
        params = jdos.Params()
        state = jdos.reset(params, RES, RES, jscene)
        states = [{k: np.asarray(v) for k, v in state.items()}]
        for n in range(1, 4):
            state = frame(state, jscene, params, jnp.float32(0.1 * n),
                          jnp.int32(n))
            states.append({k: np.asarray(v) for k, v in state.items()})
        out[kind] = states
    return out


@pytest.mark.parametrize("samples", [8, 3])
def test_occlusion_samples_and_depth_range_match_jax(scenes, samples):
    jscene, tscene = scenes["f32"]
    got = dos._occlusion_samples(samples).numpy()
    want = np.asarray(jdos._occlusion_samples(samples))
    assert got.shape == (samples, 2)
    assert np.abs(got - want).max() <= 1e-6
    assert abs(got.mean(0)).max() <= 1e-6
    lo, hi = dos._depth_range(tscene.model_view)
    jlo, jhi = jdos._depth_range(jscene.model_view)
    assert abs(float(lo) - float(jlo)) <= 1e-6
    assert abs(float(hi) - float(jhi)) <= 1e-6
    assert 0.0 <= float(lo) < float(hi)


SCALES = ([0.01, 0.015], [0.2, 0.3], [1.5, 1.5], [-0.4, 0.9])


@pytest.mark.parametrize("h,w", [(24, 24), (20, 28), (28, 20)],
                         ids=["24x24", "20x28", "28x20"])
def test_shifted_taps_match_jax(h, w):
    """On JAX's offsets, every scale: the port's taps within 1e-6 of
    JAX's (measured: equal), the width clamp of the y shift included
    (28x20 at scale 1.5 clips it)."""
    occ = np.random.default_rng(4).uniform(0, 1, (h, w)).astype(np.float32)
    offsets = jdos._occlusion_samples(8)
    for scale in SCALES:
        sc = np.asarray(scale, np.float32)
        want = np.asarray(jdos._shifted_occlusion_taps(
            jnp.asarray(occ), offsets, jnp.asarray(sc)))
        got = dos._shifted_occlusion_taps(
            torch.from_numpy(occ), torch.from_numpy(np.array(offsets)),
            torch.from_numpy(sc)).numpy()
        assert np.abs(got - want).max() <= 1e-6, scale


@pytest.mark.parametrize("h,w,scales", [
    (24, 24, SCALES), (20, 28, SCALES[:2]), (28, 20, SCALES[:2])],
    ids=["24x24", "20x28", "28x20"])
def test_shifted_taps_match_gather_sampler(h, w, scales):
    """The port of ``test_dos_shifted_taps_match_gather_sampler``: the
    gather-free taps against per-tap ``sample_texture2d`` fetches (edges
    and offsets that clip whole rows), within 1e-6.  On a non-square
    buffer only at scales whose shifts stay within the width: beyond it
    vpt_tpu clamps the y shift by the width, which the sampler does not."""
    occ = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (h, w)).astype(np.float32))
    offsets = dos._occlusion_samples(8)
    mapped = sampling.pixel_ndc(h, w) * 0.5 + 0.5
    for scale in scales:
        sc = torch.tensor(scale, dtype=torch.float32)
        got = dos._shifted_occlusion_taps(occ, offsets, sc)
        taps = mapped[None] + offsets[:, None, None, :] * sc
        ref = sampling.sample_texture2d(occ[..., None], taps)[..., 0].mean(0)
        assert torch.allclose(got, ref, rtol=0, atol=1e-6), scale


def test_reset_matches_jax(scenes):
    jscene, tscene = scenes["f32"]
    want = jdos.reset(jdos.Params(), 8, 6, jscene)
    got = dos.reset(dos.Params(), 8, 6, tscene)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32
        assert np.abs(got[k].numpy() - np.asarray(v)).max() <= 1e-6, k
    with pytest.raises(ValueError):
        dos.reset(dos.Params(), 8, 6)


def assert_state_close(got, want, kind):
    """float32 tables: colour and occlusion within 3e-5, 99% of the values
    within 1e-6 (measured over the 3 frames: at most 5.3e-6 apart,
    99.4-100% within 1e-6).  bf16 tables + ``tf_mxu``: within 5e-4, 85%
    within 1e-6 and 95% within 1e-5 (measured: at most 9.8e-5; the
    occlusion 88.1-88.6% within 1e-6 and 97.2-99.7% within 1e-5, the
    colour 99.0-99.2% and 99.5-99.6%): the bf16 lerp weights turn a
    last-bit difference of a fetched value into a step of 2^-8 of a TF
    value (ROADMAP queue 3), which the transmittance carries into the
    occlusion.  The depths, the slice distance and the offsets equal."""
    cap, shares = (3e-5, (0.99, 0.99)) if kind == "f32" \
        else (5e-4, (0.85, 0.95))
    for key in ("color", "occlusion"):
        diff = np.abs(got[key].numpy() - want[key])
        assert diff.max() <= cap, (key, diff.max())
        assert (diff <= 1e-6).mean() >= shares[0], (key, diff)
        assert (diff <= 1e-5).mean() >= shares[1], (key, diff)
    for key in ("depth", "max_depth", "slice_distance", "offsets"):
        assert np.array_equal(got[key].numpy(), want[key]), key


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_render_frames_match_jax(scenes, jax_frames, kind):
    """Three frames of the port chained from JAX's reset carried across,
    each against JAX's chained frame; the sweep (200 slices, 50 a frame)
    is not over after three."""
    _, tscene = scenes[kind]
    states = jax_frames[kind]
    state = interop.state_from_numpy(states[0], device="cpu")
    for n in range(1, 4):
        out = dos.render_frame(state, tscene, dos.Params(), 0.1 * n, n)
        assert out is state
        assert_state_close(state, states[n], kind)
    assert float(state["depth"]) <= float(state["max_depth"])
    back = interop.state_to_numpy(state)
    assert set(back) == set(states[3])
    assert back["depth"].shape == ()


def test_display_matches_jax(scenes, jax_frames):
    _, tscene = scenes["f32"]
    jstate = jax_frames["f32"][3]
    want = np.asarray(jdos.display(jstate, None, jdos.Params()))
    got = dos.display(interop.state_from_numpy(jstate, device="cpu"),
                      tscene, dos.Params())
    assert got.shape == (RES, RES, 4)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    assert bool((got[..., 3] == 1.0).all())


@pytest.mark.parametrize("built", ["jax", "port"])
def test_golden_through_render_progressive(built):
    """tests/goldens/dos.npz: 48², blobs 24³ seed 7, gray_ramp(0.9),
    float32 tables, 2 frames, seed0 11, through the port's public path.

    ``jax``: vpt_tpu's scene carried across; ``port``: the port's own
    ``make_scene``, whose inverse MVP is JAX's bit for bit (LAPACK's float32
    LU; with ``torch.linalg.inv``, 2.9e-6 apart, only 60.9% of the pixels
    were within 2e-5, since DOS unprojects every slice near the far plane,
    where w is small).  Measured: every pixel within 2.4e-6 for both;
    asserted: every pixel within 2e-5 (the golden file's own bound)."""
    if built == "jax":
        scene = _port(jmake_scene(jvolume.blobs_volume(24, seed=7),
                                  jtransfer.gray_ramp(alpha_scale=0.9),
                                  pack=True))
    else:
        scene = make_scene(volume.blobs_volume(24, seed=7, device="cpu"),
                           transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                           pack=True, device="cpu")
    img = make_renderer("dos", height=48, width=48).render_progressive(
        scene, frames=2, seed0=11).numpy()
    want = np.load(GOLDENS / "dos.npz")["image"]
    assert img.shape == want.shape
    diff = np.abs(img - want).max(-1)
    assert diff.max() <= 2e-5, diff.max()


def _state_numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def test_matches_sequential_glsl_emulation(monkeypatch):
    """``test_dos_matches_sequential_emulation`` (every pixel at 33², 3
    progressive frames, atol 1e-4) with the port's reset, render_frame and
    display in vpt_tpu's place: the JAX scene and Params cross to the port
    and the states come back as tensors the emulation reads with
    ``np.asarray``."""
    def reset(params, height, width, scene):
        return dos.reset(_params(params), height, width,
                         _port(scene))

    def render_frame(state, scene, params, seed, frame_number):
        return dos.render_frame(state, _port(scene),
                                _params(params), float(seed),
                                int(frame_number))

    def display(state, scene, params):
        return dos.display(state, None, None)

    monkeypatch.setattr(jdos, "reset", reset)
    monkeypatch.setattr(jdos, "render_frame", render_frame)
    monkeypatch.setattr(jdos, "display", display)
    glsl.test_dos_matches_sequential_emulation(
        jmake_scene(jvolume.sphere_volume(16),
                    jtransfer.gray_ramp(alpha_scale=0.9)))


def test_dos_background_white():
    """tests/test_renderers.py:135 on the port: the empty corner is white,
    the occluded centre darker."""
    scene = make_scene(volume.sphere_volume(32, device="cpu"),
                       transfer.gray_ramp(alpha_scale=1.0, device="cpu"),
                       device="cpu")
    img = make_renderer("dos", height=32, width=32).render_progressive(
        scene, frames=4, seed0=0).numpy()
    assert np.allclose(img[0, 0, :3], 1.0, atol=1e-4)
    assert img[16, 16, :3].mean() < 0.9


def test_the_sweep_ends_and_depth_advances_by_active_slices(scenes):
    """An odd ``steps`` over a short sweep: the depth advances by the
    active slices' count times the slice distance (not by repeated
    additions), stops past the far depth, and later frames change
    nothing; the CPU path launches no kernel."""
    _, tscene = scenes["f32"]
    params = dos.Params(steps=7, slices=12, samples=3)
    state = dos.reset(params, 12, 10, tscene)
    before = dos_sweep.LAUNCHES
    depth0, sd = state["depth"].clone(), state["slice_distance"]
    table = dos.slice_table(state, tscene, params)
    assert table.shape == (7, dos.TABLE_HEAD + 4 * 3)
    dos.render_frame(state, tscene, params, 0.1, 1)
    assert torch.equal(state["depth"], depth0 + 7.0 * sd)
    for n in range(2, 5):
        dos.render_frame(state, tscene, params, 0.1, n)
    assert float(state["depth"]) > float(state["max_depth"])
    done = {k: v.clone() for k, v in state.items()}
    dos.render_frame(state, tscene, params, 0.1, 5)
    assert all(torch.equal(done[k], state[k]) for k in state)
    assert float(state["color"][..., 3].max()) > 0.0
    assert dos_sweep.LAUNCHES == before


def test_sharding_hooks_raise(scenes):
    """The sharding hooks run on the CPU (``parallel/dos_halo.py`` is
    ported): the whole image's NDC with no tap hook is the plain sweep;
    a row window alone still raises, naming the sharded frames (the hooks
    raise on the card: ``tests/test_torch_cuda.py``)."""
    _, tscene = scenes["f32"]
    params = dos.Params(steps=6, slices=12, samples=3)
    state = dos.reset(params, 4, 4, tscene)
    hooked = {k: v.clone() for k, v in state.items()}
    dos.render_frame(hooked, tscene, params, 0.1, 1,
                     ndc=sampling.pixel_ndc(4, 4))
    dos.render_frame(state, tscene, params, 0.1, 1)
    for key in state:
        assert torch.equal(hooked[key], state[key]), key
    with pytest.raises(ValueError, match="dos_halo.sharded_render_frame"):
        dos.render_frame(state, tscene, params, 0.1, 2, window=(0, 8))
    assert factory.get_module("dos") is dos
