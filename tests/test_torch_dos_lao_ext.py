"""DOS and LAO on two-channel and filtered volumes, and LAO's baked
gradient, in the port against vpt_tpu's, on the CPU.

- ``sampling.raw_gradient`` and ``volume.with_lao_gradient`` against
  vpt_tpu's: equal bit for bit (measured: no value differs), on a linear
  and a cubic volume (the filter is kept), in one pass and in chunks of a
  few z-slices.
- DOS on a two-channel volume (bf16 tables and the 2D TF of two bumps)
  and on ``nearest`` and ``cubic`` volumes: two frames of the port chained
  from vpt_tpu's reset carried across (``interop.state_from_numpy``), each
  against vpt_tpu's jitted frame, 12³ blobs at 16², 25 of 50 slices a
  frame.  Measured: the two-channel and nearest states within 2.4e-7 in
  every value; cubic's colour within 3.5e-6, 99.7% of the values within
  1e-6 (the cubic warp's division and XLA's fused multiply-adds move a
  fetched value by an ulp, which the TF lookup and exp carry).  Asserted:
  ``tests/test_torch_dos.py``'s float32 bound, every value within 3e-5 and
  99% within 1e-6.
- LAO's ``generate`` on the same scenes, and with ``baked_gradient`` on
  ``with_lao_gradient`` volumes (float32 and bf16 tables, and cubic),
  against vpt_tpu's, with 5 AO taps and 24 slices (``JLAO``).  Measured:
  every value within 1.3e-7.  Asserted:
  ``tests/test_torch_lao.py``'s bound, every value within 1e-5 and 99% of
  the pixels within 1e-6.
- ``baked_gradient`` on a one-channel volume raises vpt_tpu's
  ``ValueError`` in both packages, before any launch; ``render_frame`` on
  the CPU runs the plain frame and launches nothing.

JAX's frames are computed once per scene (module-scope fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import dos as jdos
from vpt_tpu.renderers import lao as jlao
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, sampling, volume
from vpt_tpu_torch.kernels import dos_sweep, lao_march
from vpt_tpu_torch.renderers import dos, lao


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RES = 16
N = 12
#: a 2D TF of two bumps over (value, gradient magnitude)
BUMPS = [
    {"position": {"x": 0.3, "y": 0.15}, "size": {"x": 0.25, "y": 0.3},
     "color": {"r": 0.9, "g": 0.6, "b": 0.2, "a": 0.8}},
    {"position": {"x": 0.6, "y": 0.5}, "size": {"x": 0.3, "y": 0.4},
     "color": {"r": 0.2, "g": 0.7, "b": 0.9, "a": 1.0}},
]
#: DOS's Params: two frames cover the sweep
JDOS = jdos.Params(steps=25, slices=50)
TDOS = dos.Params(steps=25, slices=50)
#: LAO's Params: 5 AO taps (vpt_tpu's tests/test_lao_baked.py's step) and
#: 24 slices keep JAX's unrolled taps, and its compile, small
JLAO = dict(lao_step_size=0.2, slices=24)
KINDS = ("rg", "nearest", "cubic")
BAKED = ("baked-f32", "baked-bf16", "baked-cubic")


def _port(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


def _jscene(kind):
    """vpt_tpu's scene of ``kind``: "rg" a two-channel volume in bf16
    tables with the 2D TF, "nearest"/"cubic" a filtered one with the gray
    ramp, "baked-*" a ``with_lao_gradient`` volume with the 2D TF."""
    blobs = jvolume.blobs_volume(N, seed=7)
    tf2 = jtransfer.rasterize(jtransfer.TransferFunctionBumps.from_list(
        BUMPS))
    if kind == "rg":
        return jmake_scene(jvolume.with_gradient_magnitude(blobs), tf2,
                           pack_dtype=jnp.bfloat16)
    if kind in ("nearest", "cubic"):
        return jmake_scene(jvolume.Volume(blobs.data, kind),
                           jtransfer.gray_ramp(alpha_scale=0.9))
    baked = jvolume.with_lao_gradient(
        jvolume.Volume(blobs.data, "cubic" if kind == "baked-cubic"
                       else "linear"))
    return jmake_scene(baked, tf2, pack_dtype=jnp.bfloat16
                       if kind == "baked-bf16" else None)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for kind in KINDS + BAKED:
        jscene = _jscene(kind)
        out[kind] = (jscene, _port(jscene))
    return out


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_dos(scenes):
    """vpt_tpu's reset and two jitted frames on each scene, as numpy."""
    frame = jax.jit(jdos.render_frame)
    out = {}
    for kind in KINDS:
        jscene = scenes[kind][0]
        state = jdos.reset(JDOS, RES, RES, jscene)
        states = [_np(state)]
        for n in (1, 2):
            state = frame(state, jscene, JDOS, jnp.float32(0.1 * n),
                          jnp.int32(n))
            states.append(_np(state))
        out[kind] = states
    return out


@pytest.fixture(scope="module")
def jax_lao(scenes):
    out = {}
    for kind in KINDS + BAKED:
        params = jlao.Params(baked_gradient=kind.startswith("baked"),
                             **JLAO)
        out[kind] = np.asarray(jlao.generate(scenes[kind][0], params,
                                             jnp.float32(0.0), RES, RES))
    return out


@pytest.mark.parametrize("filt", ["linear", "cubic"])
def test_with_lao_gradient_equals_jax(filt, monkeypatch):
    """The baked channel equals vpt_tpu's bit for bit, channel 0 is the
    volume's, the filter is kept; chunks of 3 z-slices give the same
    volume as one pass."""
    jvol = jvolume.Volume(jvolume.blobs_volume(N, seed=3).data, filt)
    want = jvolume.with_lao_gradient(jvol)
    got = volume.with_lao_gradient(volume.Volume(
        torch.from_numpy(np.array(jvol.data)), filt))
    assert got.filter == want.filter == filt and got.channels == 2
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    monkeypatch.setattr(volume, "LAO_BAKE_CHUNK", 3 * N * N)
    chunked = volume.with_lao_gradient(volume.Volume(
        torch.from_numpy(np.array(jvol.data)), filt))
    assert torch.equal(chunked.data, got.data)


def test_raw_gradient_equals_jax():
    """``sampling.raw_gradient`` of channel 0 at random positions (in and
    around the cube) equals vpt_tpu's bit for bit."""
    data = np.array(jvolume.blobs_volume(N, seed=5).data)
    pos = np.random.default_rng(3).uniform(-0.1, 1.1, (9, 11, 3)).astype(
        np.float32)
    want = np.asarray(jsampling.raw_gradient(jnp.asarray(data),
                                             jnp.asarray(pos), 1.0 / 32.0))
    got = sampling.raw_gradient(torch.from_numpy(data), torch.from_numpy(pos),
                                1.0 / 32.0)
    assert np.array_equal(got.numpy(), want)


def assert_state_close(got, want):
    """``tests/test_torch_dos.py``'s float32 bound: colour and occlusion
    within 3e-5, 99% of the values within 1e-6; the depths, the slice
    distance and the offsets equal."""
    for key in ("color", "occlusion"):
        diff = np.abs(got[key].numpy() - want[key])
        assert diff.max() <= 3e-5, (key, diff.max())
        assert (diff <= 1e-6).mean() >= 0.99, (key, (diff <= 1e-6).mean())
    for key in ("depth", "max_depth", "slice_distance", "offsets"):
        assert np.array_equal(got[key].numpy(), want[key]), key


@pytest.mark.parametrize("kind", KINDS)
def test_dos_frames_match_jax(scenes, jax_dos, kind):
    """Two DOS frames chained from JAX's reset, each against JAX's jitted
    frame; the sweep composites something."""
    tscene = scenes[kind][1]
    assert (tscene.channels, tscene.filter) == (
        (2, "linear") if kind == "rg" else (1, kind))
    states = jax_dos[kind]
    state = interop.state_from_numpy(states[0], device="cpu")
    before = dos_sweep.LAUNCHES
    for n in (1, 2):
        assert dos.render_frame(state, tscene, TDOS, 0.1 * n, n) is state
        assert_state_close(state, states[n])
    assert dos_sweep.LAUNCHES == before
    assert float(state["color"][..., 3].max()) > 0.0


@pytest.mark.parametrize("kind", KINDS + BAKED)
def test_lao_generate_matches_jax(scenes, jax_lao, kind):
    """``generate`` (``baked_gradient`` on the baked volumes) against
    vpt_tpu's: every value within 1e-5, 99% of the pixels within 1e-6;
    ``render_frame`` on the CPU writes the same frame and launches
    nothing."""
    tscene = scenes[kind][1]
    params = lao.Params(baked_gradient=kind.startswith("baked"), **JLAO)
    got = lao.generate(tscene, params, 0.0, RES, RES)
    diff = np.abs(got.numpy() - jax_lao[kind])
    assert diff.max() <= 1e-5, diff.max()
    assert (diff.max(-1) <= 1e-6).mean() >= 0.99
    assert float(got[..., :3].max()) > 0.0
    state = lao.reset(params, RES, RES, tscene)
    before = lao_march.LAUNCHES
    lao.render_frame(state, tscene, params, 0.3, 1)
    assert lao_march.LAUNCHES == before
    assert torch.equal(state, got)


def test_baked_and_exact_lao_stay_close(scenes):
    """The baked image against the exact seven-tap one on the same baked
    volume: within tests/test_lao_baked.py's bounds (max 0.03, mean
    0.004), and not equal (the 2D TF reads |∇|)."""
    tscene = scenes["baked-f32"][1]
    baked = lao.generate(tscene, lao.Params(baked_gradient=True), 0.0, RES,
                         RES)
    exact = lao.generate(tscene, lao.Params(), 0.0, RES, RES)
    diff = (baked - exact).abs()
    assert float(diff.max()) < 0.03 and float(diff.mean()) < 0.004
    assert not torch.equal(baked, exact)


def test_baked_gradient_needs_two_channels(scenes):
    """One channel: vpt_tpu's ValueError from both packages, from the plain
    frame and from the kernel's preparation (before any launch)."""
    jscene, tscene = scenes["cubic"]
    with pytest.raises(ValueError, match="2-channel"):
        jlao.generate(jscene, jlao.Params(baked_gradient=True),
                      jnp.float32(0.0), 4, 4)
    params = lao.Params(baked_gradient=True)
    with pytest.raises(ValueError, match="2-channel"):
        lao.generate(tscene, params, 0.0, 4, 4)
    with pytest.raises(ValueError, match="2-channel"):
        lao_march._prepare(tscene, (params, 4, 4))
    with pytest.raises(ValueError, match="2-channel"):
        lao.render_frame(lao.reset(params, 4, 4, tscene), tscene, params,
                         0.1, 1)
    # a two-channel scene takes it
    two = dataclasses.replace(scenes["rg"][1])
    assert lao.generate(two, params, 0.0, 4, 4).shape == (4, 4, 4)
