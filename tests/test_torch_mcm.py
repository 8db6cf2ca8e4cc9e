"""The port's MCM renderer against vpt_tpu's.

- Phases on identical inputs: ``interact_phase`` must reproduce JAX's branch
  decisions, sample counts, bounce counts and RNG state exactly (those are
  integer work and comparisons of identically computed floats; JAX runs op
  by op here).  Positions and directions after a reset or a scatter pass
  through log/sqrt/cos/sin and agree to 1e-5.
- Whole frames: JAX runs its jitted ``render_frame``; a pixel whose stream
  parts (a last-bit difference flips a float comparison) takes another path
  from then on, so frames are compared by the fraction of pixels whose
  ``samples`` agree, with a bound below the measured fraction.
- The CUDA event kernel against the plain event loop runs on a GPU only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import interop, transfer, volume
from vpt_tpu_torch import sampling as tsampling
from vpt_tpu_torch.kernels import mcm_event
from vpt_tpu_torch.renderers import factory, make_renderer, make_scene
from vpt_tpu_torch.renderers import mcm as tmcm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RES = 32
JPARAMS = jmcm.Params(extinction=20.0, anisotropy=0.3, steps=8)
TPARAMS = tmcm.Params(extinction=20.0, anisotropy=0.3, steps=8)


def _scenes(tracking, pack_dtype=None, n=16):
    jscene = jmake_scene(jvolume.sphere_volume(n),
                         jtransfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                         tracking=tracking, pack_dtype=pack_dtype)
    return jscene, interop.scene_from_numpy(interop.scene_fields(jscene),
                                            device="cpu")


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def frame_inputs():
    """A JAX state one frame in (so bounces and samples vary), per mode."""
    out = {}
    frame = jax.jit(jmcm.render_frame, static_argnums=(2,))
    for tracking in ("none", "auto"):
        jscene, tscene = _scenes(tracking)
        state = jmcm.reset(JPARAMS, RES, RES, jscene)
        state = frame(state, jscene, JPARAMS, jnp.float32(0.61),
                      jnp.int32(1))
        out[tracking] = (jscene, tscene, _np(state))
    return out


@pytest.mark.parametrize("tracking,max_bounces", [("none", 8), ("auto", 8),
                                                  ("none", 1)])
def test_interact_phase_exact_on_identical_inputs(frame_inputs, tracking,
                                                  max_bounces):
    """max_bounces 1 caps the photons that scattered in the first frame, so
    their scatter probability is 0."""
    jscene, tscene, state = frame_inputs[tracking]
    use_skip = tracking == "auto"
    jparams = jmcm.Params(extinction=20.0, anisotropy=0.3, steps=8,
                          max_bounces=max_bounces, blur=0.02)
    tparams = tmcm.Params(extinction=20.0, anisotropy=0.3, steps=8,
                          max_bounces=max_bounces, blur=0.02)
    if max_bounces == 1:
        assert (state["bounces"] >= 1).any()
    assert (jscene.tracking_packed is not None) == use_skip
    r = np.random.default_rng(3)
    rstate = r.integers(0, 1 << 32, (RES, RES), dtype=np.uint64).astype(
        np.uint32)
    jph = {k: jnp.asarray(v) for k, v in state.items()}
    cell = jmcm.skip_cell_size(jscene) if use_skip else None
    _, position = jmcm.flight_phase(jph, jnp.asarray(rstate), jparams,
                                    use_skip, cell)
    if use_skip:
        vs, cheb = jscene.sample_color_tracking(position)
    else:
        vs, cheb = jscene.sample_color(position), None
    ndc = jsampling.pixel_ndc(RES, RES)
    inv_res = jnp.array([1.0 / RES, 1.0 / RES], jnp.float32)
    jnew, jrs = jmcm.interact_phase(jph, jnp.asarray(rstate), position, vs,
                                    cheb, jscene, jparams, ndc, inv_res,
                                    use_skip)

    tph = interop.state_from_numpy(state, device="cpu")
    tnew, trs = tmcm.interact_phase(
        tph, torch.from_numpy(rstate.astype(np.int64)),
        torch.tensor(np.asarray(position)), torch.tensor(np.asarray(vs)),
        None if cheb is None else torch.tensor(np.asarray(cheb)),
        tscene, tparams, tsampling.pixel_ndc(RES, RES),
        tmcm.inverse_resolution(RES, RES, "cpu"), use_skip)
    jnew, tnew = _np(jnew), interop.state_to_numpy(tnew)

    assert np.array_equal(trs.numpy(), np.asarray(jrs).astype(np.int64))
    exact = ("samples", "bounces") + (("cheb",) if use_skip else ())
    for key in exact:
        assert np.array_equal(tnew[key], jnew[key]), key
    deposit = jnew["samples"] != state["samples"]
    scatter = jnew["bounces"] == state["bounces"] + 1.0
    oob = (np.asarray(position) > 1.0).any(-1) | (np.asarray(position)
                                                  < 0.0).any(-1)
    # every branch is exercised: escape, absorption, scattering, null
    assert oob.any() and (deposit & ~oob).any() and scatter.any()
    assert (~deposit & ~scatter).any()
    assert not (scatter & (state["bounces"] >= max_bounces)).any()
    for key in ("radiance", "transmittance"):
        assert np.allclose(tnew[key], jnew[key], rtol=0, atol=1e-6), key
    for key in ("position", "direction"):
        assert np.allclose(tnew[key], jnew[key], rtol=0, atol=1e-5), key


@pytest.mark.parametrize("tracking", ["none", "auto"])
def test_flight_phase_and_reset_close(frame_inputs, tracking):
    jscene, tscene, state = frame_inputs[tracking]
    use_skip = tracking == "auto"
    rstate = np.random.default_rng(4).integers(
        0, 1 << 32, (RES, RES), dtype=np.uint64).astype(np.uint32)
    cell = jmcm.skip_cell_size(jscene) if use_skip else None
    jrs, jpos = jmcm.flight_phase({k: jnp.asarray(v) for k, v in
                                   state.items()}, jnp.asarray(rstate),
                                  JPARAMS, use_skip, cell)
    trs, tpos = tmcm.flight_phase(interop.state_from_numpy(state,
                                                          device="cpu"),
                                  torch.from_numpy(rstate.astype(np.int64)),
                                  TPARAMS, use_skip,
                                  tmcm.skip_cell_size(tscene)
                                  if use_skip else None)
    assert np.array_equal(trs.numpy(), np.asarray(jrs).astype(np.int64))
    assert np.allclose(tpos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)

    jreset = _np(jmcm.reset(JPARAMS, RES, RES, jscene, seed=0.25))
    treset = interop.state_to_numpy(tmcm.reset(TPARAMS, RES, RES, tscene,
                                               seed=0.25))
    assert sorted(treset) == sorted(jreset)
    for key in jreset:
        assert np.allclose(treset[key], jreset[key], rtol=0, atol=1e-5), key


@pytest.mark.parametrize("tracking", ["none", "auto"])
def test_render_frame_agrees_with_jax(tracking):
    """One whole jitted JAX frame against the port's plain frame (32²,
    16³ sphere, steps 8, float32 tables).  Measured: samples agree on
    1024 of 1024 pixels in both modes.  Bound: 97%."""
    jscene, tscene = _scenes(tracking)
    state = jmcm.reset(JPARAMS, RES, RES, jscene)
    tstate = interop.state_from_numpy(_np(state), device="cpu")
    jout = _np(jax.jit(jmcm.render_frame, static_argnums=(2,))(
        state, jscene, JPARAMS, jnp.float32(0.37), jnp.int32(1)))
    out = tmcm.render_frame(tstate, tscene, TPARAMS, 0.37, 1)
    assert out is tstate                     # updated in place
    tout = interop.state_to_numpy(tstate)
    match = tout["samples"] == jout["samples"]
    assert match.mean() >= 0.97, match.mean()
    assert jout["samples"].mean() > 1.0
    for key in ("radiance", "position"):
        assert np.allclose(tout[key][match], jout[key][match], rtol=0,
                           atol=1e-5), key


def test_golden_through_render_progressive():
    """tests/goldens/mcm.npz (48², blobs 24³ seed 7, gray_ramp(0.9), float32
    tables, 4 frames, seed0 11) through the port's public path.

    The golden comes from JAX's jitted frame, where XLA evaluates
    pixel_ndc's division by 48 as a multiply by the reciprocal: 31% of the
    mapped pixel positions differ by one ulp from the true quotient the
    port (and eager JAX) use, and those pixels hash to other streams
    (ROADMAP queue 3; at 32², 128² and 512² the two agree).  Measured:
    93.2% of the pixels within 2e-5 of the golden, image means 2.7e-5
    apart.  Bound: 88% within 2e-5, and the means within 2e-3."""
    import pathlib

    golden = np.load(pathlib.Path(__file__).parent / "goldens"
                     / "mcm.npz")["image"]
    scene = make_scene(volume.blobs_volume(24, seed=7, device="cpu"),
                       transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                       pack=True, device="cpu")
    r = make_renderer("mcm", height=48, width=48)
    img = r.render_progressive(scene, frames=4, seed0=11).numpy()
    assert img.shape == golden.shape
    close = np.abs(img - golden).max(-1) <= 2e-5
    assert close.mean() >= 0.88, close.mean()
    assert abs(img.mean() - golden.mean()) < 2e-3


def test_interop_round_trip():
    r = np.random.default_rng(8)
    state = {"position": r.uniform(size=(4, 5, 3)).astype(np.float32),
             "samples": r.uniform(size=(4, 5)).astype(np.float32)}
    back = interop.state_to_numpy(interop.state_from_numpy(state,
                                                         device="cpu"))
    assert all(np.array_equal(back[k], state[k]) for k in state)
    table = jnp.asarray(r.uniform(size=(64, 8)).astype(np.float32)).astype(
        jnp.bfloat16)
    t = interop.tensor_from_numpy(np.asarray(table), device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(table).view(np.int16))
    assert np.array_equal(interop.tensor_to_numpy(t),
                          np.asarray(table.astype(jnp.float32)))


@pytest.mark.parametrize("tracking", ["none", "auto"])
def test_scene_from_numpy_matches_make_scene(tracking):
    """Building the scene in the port gives the tables JAX builds (bf16
    included) and the bf16-rounded TF row JAX samples."""
    jscene, via_interop = _scenes(tracking, pack_dtype=jnp.bfloat16)
    own = make_scene(volume.sphere_volume(16, device="cpu"),
                     transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                     tf_srgb=True, tracking=tracking,
                     pack_dtype=torch.bfloat16, device="cpu")
    for name in ("volume_packed", "tracking_packed"):
        a, b = getattr(own, name), getattr(via_interop, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # sRGB decode (pow) may differ by one ulp before the bf16 rounding
    assert torch.allclose(own.transfer_1d, via_interop.transfer_1d,
                          rtol=1e-2, atol=0)
    assert torch.equal(own.transfer_1d[:, 3], via_interop.transfer_1d[:, 3])


def test_cheb_carry_threads_through_a_non_tracking_scene():
    _, tscene = _scenes("auto")
    _, plain_scene = _scenes("none")
    state = tmcm.reset(TPARAMS, 16, 16, tscene)
    state["cheb"].fill_(3.0)
    without = {k: v.clone() for k, v in state.items() if k != "cheb"}
    tmcm.render_frame(state, plain_scene, TPARAMS, 0.5)
    tmcm.render_frame(without, plain_scene, TPARAMS, 0.5)
    assert torch.equal(state["cheb"], torch.full((16, 16), 3.0))
    assert all(torch.equal(state[k], without[k]) for k in without)


def test_renderer_display_and_params():
    scene = make_scene(volume.sphere_volume(12, device="cpu"),
                       transfer.gray_ramp(device="cpu"), tf_srgb=True,
                       tracking="auto", device="cpu")
    r = make_renderer("mcm", tmcm.Params(steps=4), height=16, width=24)
    img = r.render_progressive(scene, frames=2, seed0=1)
    assert img.shape == (16, 24, 4) and torch.isfinite(img).all()
    assert torch.equal(img[..., 3], torch.ones(16, 24))
    assert r.frame_number == 2 and "cheb" in r.state
    with pytest.raises(Exception):
        r.params.steps = 2                    # frozen dataclass


@pytest.mark.parametrize("kwargs", [
    {"multichannel": True}, {"filter": "nearest"},
])
def test_unported_options_raise(kwargs):
    """The two options that raised before they were ported, a two-channel
    volume and the nearest filter, now build vpt_tpu's scene (the same
    tables, or none) and render its MCM frame: ``samples`` agree on at
    least 97% of the pixels, :func:`test_render_frame_agrees_with_jax`'s
    bound."""
    jvol = jvolume.sphere_volume(8)
    if kwargs.get("multichannel"):
        jvol = jvolume.with_gradient_magnitude(jvol)
    jvol = jvolume.Volume(jvol.data, kwargs.get("filter", "linear"))
    jscene = jmake_scene(jvol, jtransfer.gray_ramp(alpha_scale=0.8),
                         tf_srgb=True)
    tscene = make_scene(
        volume.Volume(torch.from_numpy(np.array(jvol.data)), jvol.filter),
        transfer.gray_ramp(alpha_scale=0.8, device="cpu"), tf_srgb=True,
        device="cpu")
    assert tscene.filter == jscene.filter
    assert tuple(tscene.volume.shape) == tuple(jscene.volume.shape)
    assert (tscene.volume_packed is None) == (jscene.volume_packed is None)
    if jscene.volume_packed is not None:
        assert np.array_equal(tscene.volume_packed.numpy(),
                              np.asarray(jscene.volume_packed))
    state = jmcm.reset(JPARAMS, 16, 16, jscene)
    tstate = interop.state_from_numpy(_np(state), device="cpu")
    jout = _np(jax.jit(jmcm.render_frame, static_argnums=(2,))(
        state, jscene, JPARAMS, jnp.float32(0.37), jnp.int32(1)))
    tmcm.render_frame(tstate, tscene, TPARAMS, 0.37, 1)
    match = interop.state_to_numpy(tstate)["samples"] == jout["samples"]
    assert match.mean() >= 0.97, match.mean()


@pytest.mark.parametrize("kwargs", [
    {"majorant_grid": 8}, {"tracking": "grid"}, {"march_clamp": True},
    {"iso_clamp_min": 0.1},
])
def test_scene_options_build_jax_fields(kwargs):
    """The options that raised before they were ported build the fields
    JAX's make_scene builds, equal: the majorant grid (``tracking="grid"``
    means N = 16), the occupied box and the ISO box with its floor.  The
    sRGB TF gives alpha exactly 0 to the low values, so the boxes exist."""
    jscene = jmake_scene(jvolume.sphere_volume(16),
                         jtransfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                         **kwargs)
    tscene = make_scene(volume.sphere_volume(16, device="cpu"),
                        transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                        tf_srgb=True, device="cpu", **kwargs)
    built = 0
    for name in ("majorant", "occupied_aabb", "iso_aabb"):
        want, got = getattr(jscene, name), getattr(tscene, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert np.array_equal(got.numpy(), np.asarray(want)), name
            built += 1
    assert built == 1
    assert tscene.iso_clamp_min == jscene.iso_clamp_min
    assert tscene.tracking_packed is None


def test_factory_keys():
    """Every renderer key of vpt_tpu resolves in the port."""
    import vpt_tpu.renderers as jrenderers
    from vpt_tpu_torch.renderers import eam

    assert factory.get_module("mcm") is tmcm
    assert factory.get_module("eam") is eam
    assert set(jrenderers.MODULES) <= set(factory.MODULES)
    for key in jrenderers.MODULES:
        assert factory.get_module(key).__name__ \
            == f"vpt_tpu_torch.renderers.{key}"
    with pytest.raises(ValueError):
        factory.get_module("nope")
    with pytest.raises(ValueError):
        make_scene(volume.sphere_volume(8, device="cpu"),
                   transfer.gray_ramp(device="cpu"), tracking="bogus",
                   device="cpu")


def test_cpu_frame_launches_nothing():
    scene = make_scene(volume.sphere_volume(8, device="cpu"),
                       transfer.gray_ramp(device="cpu"), device="cpu")
    state = tmcm.reset(TPARAMS, 8, 8, scene)
    before = mcm_event.LAUNCHES
    tmcm.render_frame(state, scene, TPARAMS, 0.1)
    assert mcm_event.LAUNCHES == before


def test_gradient_sky_frames_agree_with_jax():
    """An equirect map larger than 1×1 (``gradient_sky(16, 32)``), the only
    light of an MC render, on a 16³ sphere at 32², 3 jitted JAX frames
    against the port's plain frames: a map value reaches only the radiance,
    not the RNG chain, so ``samples`` are equal in every pixel and the
    radiance is within 2e-6 (measured: samples equal, radiance within
    4.8e-7)."""
    from vpt_tpu import environment as jenvironment

    sky = jenvironment.gradient_sky(16, 32)
    jscene = jmake_scene(jvolume.sphere_volume(16),
                         jtransfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                         environment=sky)
    tscene = interop.scene_from_numpy(interop.scene_fields(jscene),
                                      device="cpu")
    assert tuple(tscene.environment.shape) == (16, 32, 4)
    jstate = jmcm.reset(JPARAMS, RES, RES, jscene)
    tstate = interop.state_from_numpy(_np(jstate), device="cpu")
    frame = jax.jit(jmcm.render_frame, static_argnums=(2,))
    for n, seed in enumerate((0.23, 0.57, 0.91), start=1):
        jstate = frame(jstate, jscene, JPARAMS, jnp.float32(seed),
                       jnp.int32(n))
        tmcm.render_frame(tstate, tscene, TPARAMS, np.float32(seed))
    want, got = _np(jstate), interop.state_to_numpy(tstate)
    assert np.array_equal(got["samples"], want["samples"])
    diff = np.abs(got["radiance"] - want["radiance"])
    assert diff.max() <= 2e-6, diff.max()
    # the sky, not a constant: escaped paths see more than one color
    assert np.unique(want["radiance"][..., 2]).size > 100
