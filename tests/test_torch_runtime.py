"""The port's serving layer against vpt_tpu's, on the CPU.

- ``transfer.rasterize`` and the bump JSON, ``math3d``'s quaternion and
  view helpers, the orbit and circle animators, ``colorspaces`` and
  ``utils``: equal, or within 1e-6 where a transcendental (sin, cos, exp,
  sqrt) or a 3-term product in another order is involved.
- ``RenderingContext`` against vpt_tpu's on the same inputs (blobs 24³
  seed 7, ``gray_ramp(0.9)``, ``tf_srgb``, cheb-skip ``auto``, 32²).  The
  port inverts the camera with LAPACK's float32 LU as JAX does, so both
  contexts hold equal camera matrices.  EAM and MIP: ``exact`` within 1e-5
  with at least 99% of the values within 1e-6 (measured: every value
  within 4.2e-7); ``fast`` (bf16 tables and TF weights) the bf16 bounds of
  ``tests/test_torch_march.py``: 99% within 1e-6, all within 4e-3
  (measured 99.3–99.7%, at most 1.7e-3; without ``tf_srgb`` EAM measured
  97.5–98.6%, ROADMAP queue 3).  MCM: the bounds of
  ``tests/test_torch_mcm.py``: ``samples`` equal in at least 97% of the
  pixels, radiance within 1e-5 where they are.  DOS is left out (its
  sensitivity to the camera's last bits, queue 3).
- Camera motion and TF changes reset the accumulation, and a camera move
  changes the next image.  Checkpoints cross both ways (displays within
  1e-6), a resumed port render equals an uninterrupted one bit for bit,
  ``photon_stats`` equals JAX's on a state carried across.
- The large-volume rule of ``make_scene`` on the card (float32 tables, the
  ``tf_mxu`` weights and the tracking table in ``pack_dtype``) against
  JAX's unpacked scene, on the CPU with the rule's threshold lowered.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import colorspaces as jcolor
from vpt_tpu import math3d as jm4
from vpt_tpu import scene as jscene
from vpt_tpu import transfer as jtransfer
from vpt_tpu import utils as jutils
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import make_renderer as jmake_renderer
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu.runtime import CircleAnimator as JCircle
from vpt_tpu.runtime import OrbitCameraAnimator as JOrbit
from vpt_tpu.runtime import RenderingContext as JContext
from vpt_tpu.runtime import profiler as jprofiler
from vpt_tpu_torch import colorspaces as tcolor
from vpt_tpu_torch import interop
from vpt_tpu_torch import math3d as tm4
from vpt_tpu_torch import scene as tscene
from vpt_tpu_torch import transfer as ttransfer
from vpt_tpu_torch import utils as tutils
from vpt_tpu_torch import volume as tvolume
from vpt_tpu_torch.renderers import base as tbase
from vpt_tpu_torch.renderers import make_renderer, make_scene
from vpt_tpu_torch.renderers import mcm as tmcm
from vpt_tpu_torch.runtime import CircleAnimator as TCircle
from vpt_tpu_torch.runtime import OrbitCameraAnimator as TOrbit
from vpt_tpu_torch.runtime import RenderingContext as TContext
from vpt_tpu_torch.runtime import checkpoint as tcheckpoint
from vpt_tpu_torch.runtime import profiler as tprofiler


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
THREE_BUMPS = [
    {"position": {"x": 0.2, "y": 0.3}, "size": {"x": 0.1, "y": 0.4},
     "color": {"r": 0.9, "g": 0.2, "b": 0.1, "a": 0.6}},
    {"position": {"x": 0.55, "y": 0.5}, "size": {"x": 0.3, "y": 0.2},
     "color": {"r": 0.1, "g": 0.8, "b": 0.3, "a": 0.9}},
    {"position": {"x": 0.8, "y": 0.7}, "size": {"x": 0.05, "y": 0.15},
     "color": {"r": 0.4, "g": 0.4, "b": 1.0, "a": 0.3}},
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, atol=1e-6, rtol=0.0):
    return np.allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def close_matrices(got, want):
    """Camera matrices: within 1e-6 relative and absolute (ROADMAP queue
    3: the quaternions' sin and cos differ in the last bit)."""
    return close(got, want, atol=1e-6, rtol=1e-6)


# -- transfer functions, math3d, colorspaces, utils --------------------------

@pytest.mark.parametrize("bumps", [None, THREE_BUMPS],
                         ids=["default", "three"])
def test_rasterize_matches_jax(bumps):
    """In bump order, within 1e-6 (exp differs in the last bit)."""
    if bumps is None:
        jb, tb = (jtransfer.TransferFunctionBumps.default(),
                  ttransfer.TransferFunctionBumps.default(device="cpu"))
    else:
        jb = jtransfer.TransferFunctionBumps.from_list(bumps)
        tb = ttransfer.TransferFunctionBumps.from_list(bumps, device="cpu")
    for h, w in ((256, 256), (2, 64), (37, 53)):
        want = np.asarray(jtransfer.rasterize(jb, h, w))
        got = ttransfer.rasterize(tb, h, w)
        assert got.shape == (h, w, 4) and got.dtype == torch.float32
        assert close(got, want), np.abs(_np(got) - want).max()


def test_bump_json_round_trip():
    tb = ttransfer.TransferFunctionBumps.from_list(THREE_BUMPS, device="cpu")
    jb = jtransfer.TransferFunctionBumps.from_list(THREE_BUMPS)
    assert tb.num_bumps == 3
    assert tb.to_list() == jb.to_list()
    assert json.loads(tb.to_json()) == json.loads(jb.to_json())
    back = ttransfer.TransferFunctionBumps.from_json(tb.to_json(),
                                                     device="cpu")
    for name in ("positions", "sizes", "colors"):
        assert torch.equal(getattr(back, name), getattr(tb, name))
    # a port file read by JAX, and JAX's read by the port
    from_port = jtransfer.TransferFunctionBumps.from_json(tb.to_json())
    assert np.array_equal(np.asarray(from_port.colors), tb.colors.numpy())
    from_jax = ttransfer.TransferFunctionBumps.from_json(jb.to_json(),
                                                         device="cpu")
    assert np.array_equal(from_jax.positions.numpy(),
                          np.asarray(jb.positions))


def test_quaternion_and_view_helpers_match_jax():
    r = np.random.default_rng(5)
    for _ in range(20):
        axis = r.normal(size=3)
        angle = float(r.uniform(-4, 4))
        qa = tm4.quat_from_axis_angle(axis, angle)
        assert close(qa, jm4.quat_from_axis_angle(axis, angle))
        q1, q2 = (r.normal(size=4).astype(np.float32) for _ in range(2))
        for name in ("quat_normalize", "quat_invert", "mat4_from_quat"):
            assert close(getattr(tm4, name)(torch.from_numpy(q1)),
                         getattr(jm4, name)(jnp.asarray(q1))), name
        assert close(tm4.quat_multiply(q1, q2),
                     jm4.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
        euler = r.uniform(-180, 180, size=3)
        assert close(tm4.quat_from_euler(*euler), jm4.quat_from_euler(*euler))
        eye, center = r.normal(size=3) * 3, r.normal(size=3) * 0.2
        assert close(tm4.look_at(eye, center, (0.0, 1.0, 0.0)),
                     jm4.look_at(eye, center, (0.0, 1.0, 0.0)), atol=2e-6)
        v = r.normal(size=(5, 3)).astype(np.float32)
        assert close(tm4.normalize(torch.from_numpy(v)),
                     jm4.normalize(jnp.asarray(v)))
        assert close(tm4.cross(v[0], v[1]), jm4.cross(v[0], v[1]))
        assert close(tm4.dot(v, v[::-1].copy()), jm4.dot(v, v[::-1]))
        m = r.normal(size=(4, 4)).astype(np.float32)
        p4 = r.normal(size=(7, 4)).astype(np.float32)
        assert np.array_equal(
            tm4.transform_homogeneous(torch.from_numpy(m), p4).numpy(),
            np.asarray(jm4.transform_homogeneous(jnp.asarray(m), p4)))
        # the LAPACK float32 inverse of vpt_tpu, bit for bit
        assert np.array_equal(tm4.invert(torch.from_numpy(m)).numpy(),
                              np.asarray(jm4.invert(jnp.asarray(m))))
    t = (0.3, -1.0, 2.5)
    assert np.array_equal(tm4.translation(t).numpy(),
                          np.asarray(jm4.translation(t)))
    assert np.array_equal(tm4.scaling(t).numpy(), np.asarray(jm4.scaling(t)))
    assert np.array_equal(tm4.vec3(1.0, 2.0, 3.0).numpy(),
                          np.asarray(jm4.vec3(1.0, 2.0, 3.0)))


def _camera_matrices(node):
    t = node.transform
    return (t.local_rotation, t.local_translation, t.global_matrix,
            t.inverse_global_matrix)


def test_orbit_animator_matches_jax():
    """The orbit's angles, distance and focus (numpy float64) equal, and
    the camera's rotation, translation, matrix and view matrix after each
    kind of move within 1e-6 relative and absolute.  (The projection's
    inverse amplifies the quaternions' last bits: the inverse MVPs differ
    by up to 7e-6 relative after a rotate, measured.)"""
    jcam, tcam = jscene.default_camera(), tscene.default_camera()
    jo, to = JOrbit(jcam), TOrbit(tcam)
    moves = [("rotate", (0.3, 0.2)), ("pan", (0.05, -0.02)),
             ("zoom", (-0.3,)), ("fly", (0.1, 0.05, -0.02)),
             ("roll_by", (0.4,)), ("rotate", (-0.7, -0.4)),
             ("zoom", (0.2,))]
    for name, args in moves:
        getattr(jo, name)(*args)
        getattr(to, name)(*args)
        assert (to.yaw, to.pitch, to.distance, to.roll) \
            == (jo.yaw, jo.pitch, jo.distance, jo.roll), name
        assert np.array_equal(to.focus, jo.focus), name
        for got, want in zip(_camera_matrices(tcam), _camera_matrices(jcam)):
            assert close_matrices(got, want), name


def test_circle_animator_matches_jax():
    jcam, tcam = jscene.default_camera(), tscene.default_camera()
    ja = JCircle(jcam, center=(0, 0, 2), radius=0.5, frequency=1.3)
    ta = TCircle(tcam, center=(0, 0, 2), radius=0.5, frequency=1.3)
    for t in (0.0, 0.1, 0.37, 0.5, 2.9):
        ja.update(t)
        ta.update(t)
        assert np.array_equal(tcam.transform.local_translation.numpy(),
                              np.asarray(jcam.transform.local_translation))
        for got, want in zip(_camera_matrices(tcam), _camera_matrices(jcam)):
            assert close_matrices(got, want), t


def test_colorspaces_match_jax():
    r = np.random.default_rng(2)
    rgb = r.uniform(size=(64, 3)).astype(np.float32)
    t = torch.from_numpy(rgb)
    for name in ("rgb2xyz", "xyz2rgb"):
        assert close(getattr(tcolor, name)(t),
                     getattr(jcolor, name)(rgb)), name
    for std in ("bt601", "bt709"):
        assert close(tcolor.rgb2yuv(t, std), jcolor.rgb2yuv(rgb, std))
        assert close(tcolor.yuv2rgb(t, std), jcolor.yuv2rgb(rgb, std))
    xyz = np.asarray(jcolor.rgb2xyz(rgb)) + 0.01
    assert np.array_equal(tcolor.xyz2xyY(torch.from_numpy(xyz)).numpy(),
                          np.asarray(jcolor.xyz2xyY(xyz)))
    assert np.array_equal(tcolor.xyY2xyz(torch.from_numpy(xyz)).numpy(),
                          np.asarray(jcolor.xyY2xyz(xyz)))
    x = r.uniform(size=200).astype(np.float32)
    for name in ("hue", "float_to_rgba", "encode_float"):
        assert np.array_equal(getattr(tcolor, name)(torch.from_numpy(x))
                              .numpy(), np.asarray(getattr(jcolor, name)(x)))
    packed = np.asarray(jcolor.float_to_rgba(x))
    assert np.array_equal(tcolor.rgba_to_float(packed).numpy(),
                          np.asarray(jcolor.rgba_to_float(packed)))
    specials = np.array([-3.5, 1e-30, 7.0, -0.0, np.inf, 3.4e38],
                        np.float32)
    enc = np.asarray(jcolor.encode_float(specials))
    assert np.array_equal(tcolor.encode_float(specials).numpy(), enc)
    assert np.array_equal(tcolor.decode_float(enc).numpy().view(np.uint32),
                          specials.view(np.uint32))


def test_utils_match_jax(tmp_path):
    for s in ("#000000", "#ff8000", "3c7f1a"):
        assert tutils.hex2rgb(s) == jutils.hex2rgb(s)
    for rgb in ((0.0, 0.5, 1.0), (-0.2, 0.999, 1.7), (0.1234, 0.5, 0.75)):
        assert tutils.rgb2hex(*rgb) == jutils.rgb2hex(*rgb)
    x = np.linspace(-0.5, 1.5, 41, dtype=np.float32)
    t = torch.from_numpy(x)
    assert np.array_equal(tutils.smoothstep(0.2, 0.8, t).numpy(),
                          np.asarray(jutils.smoothstep(0.2, 0.8, x)))
    assert np.array_equal(tutils.step(0.5, t).numpy(),
                          np.asarray(jutils.step(0.5, x)))
    obj = {"bumps": THREE_BUMPS, "name": "tf"}
    tutils.download_json(obj, tmp_path / "a.json")
    jutils.download_json(obj, tmp_path / "b.json")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json") \
        .read_text()
    assert tutils.read_json(tmp_path / "b.json") == obj


# -- the rendering context ----------------------------------------------------

def _contexts(renderer, precision):
    j = JContext(resolution=RES, precision=precision, tf_srgb=True)
    j.set_volume(jvolume.blobs_volume(24, seed=7))
    j.set_transfer_function(jtransfer.gray_ramp(alpha_scale=0.9))
    j.choose_renderer(renderer)
    j.choose_tone_mapper("reinhard")
    t = TContext(resolution=RES, precision=precision, tf_srgb=True,
                 device="cpu")
    t.set_volume(tvolume.blobs_volume(24, seed=7, device="cpu"))
    t.set_transfer_function(ttransfer.gray_ramp(alpha_scale=0.9,
                                                device="cpu"))
    t.choose_renderer(renderer)
    t.choose_tone_mapper("reinhard")
    return j, t


def assert_march_close(got, want, precision):
    diff = np.abs(_np(got) - _np(want))
    if precision == "exact":
        assert diff.max() <= 1e-5, diff.max()
        assert (diff <= 1e-6).mean() >= 0.99, (diff <= 1e-6).mean()
    else:
        assert (diff <= 1e-6).mean() >= 0.99, (diff <= 1e-6).mean()
        assert diff.max() <= 4e-3, diff.max()


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("renderer", ["eam", "mip"])
def test_context_march_matches_jax(renderer, precision):
    """Two frames at the start pose, where both contexts hold equal camera
    matrices: the HDR and the display image.  Then an orbit move and two
    more frames.  The move's quaternion differs from JAX's in the last
    bits, which ``exact`` keeps within its bounds; on ``fast`` scenes the
    bf16 weights amplify it (EAM measured 98.4% of the values within
    1e-6, ROADMAP queue 3), so there only the 4e-3 cap is asserted."""
    j, t = _contexts(renderer, precision)
    js, ts = j.get_scene(), t.get_scene()
    assert np.array_equal(ts.mvp_inverse.numpy(), np.asarray(js.mvp_inverse))
    fast = precision == "fast"
    assert ts.tf_mxu == (torch.bfloat16 if fast else None)
    assert ts.volume_packed.dtype == (torch.bfloat16 if fast
                                      else torch.float32)
    j.render(frames=2)
    t.render(frames=2)
    assert t.renderer.frame_number == j.renderer.frame_number == 2
    assert_march_close(t.get_hdr_image(), j.get_hdr_image(), precision)
    # the display's gamma (x^(1/2.2)) steepens near 0: on fast scenes EAM's
    # display measured 98.7% of the values within 1e-6
    display = np.abs(_np(t.get_display_image())
                     - _np(j.get_display_image()))
    if fast:
        assert display.max() <= 4e-3, display.max()
    else:
        assert_march_close(display, 0.0 * display, precision)
    j.camera_animator.rotate(0.1, 0.05)
    t.camera_animator.rotate(0.1, 0.05)
    j.render(frames=2)
    t.render(frames=2)
    assert t.renderer.frame_number == 2
    got, want = t.get_hdr_image(), j.get_hdr_image()
    if fast:
        assert np.abs(_np(got) - _np(want)).max() <= 4e-3
    else:
        assert_march_close(got, want, precision)


@pytest.fixture(scope="module")
def mcm_contexts():
    j, t = _contexts("mcm", "exact")
    j.render(frames=2)
    t.render(frames=2)
    return j, t


def test_context_mcm_matches_jax(mcm_contexts):
    """Two MCM frames through both contexts (float32 tables, as the
    bounds were measured on, cheb-skip, steps 8).  Measured: samples equal
    in 1024 of 1024 pixels."""
    j, t = mcm_contexts
    jstate = {k: np.asarray(v) for k, v in j.renderer.state.items()}
    tstate = interop.state_to_numpy(t.renderer.state)
    assert sorted(tstate) == sorted(jstate) and "cheb" in tstate
    match = tstate["samples"] == jstate["samples"]
    assert match.mean() >= 0.97, match.mean()
    for key in ("radiance", "position"):
        assert np.allclose(tstate[key][match], jstate[key][match], rtol=0,
                           atol=1e-5), key
    hdr = np.abs(t.get_hdr_image().numpy() - np.asarray(j.get_hdr_image()))
    assert (hdr.max(-1) <= 1e-5)[match].all()


def test_photon_stats_matches_jax(mcm_contexts):
    """Histogram, sample counts and extremes equal; the float32 means of
    two libraries within 1e-6 relative (their sums may run in other
    orders)."""
    j, _ = mcm_contexts
    want = jprofiler.photon_stats(j.renderer.state)
    got = tprofiler.photon_stats(interop.state_from_numpy(
        {k: np.asarray(v) for k, v in j.renderer.state.items()},
        device="cpu"))
    assert got["bounce_histogram"] == want["bounce_histogram"]
    assert got["samples_per_pixel"]["min"] == want["samples_per_pixel"]["min"]
    assert got["samples_per_pixel"]["max"] == want["samples_per_pixel"]["max"]
    for a, b in ((got["mean_bounces"], want["mean_bounces"]),
                 (got["samples_per_pixel"]["mean"],
                  want["samples_per_pixel"]["mean"]),
                 (got["mean_transmittance"], want["mean_transmittance"]),
                 (got["mean_radiance"], want["mean_radiance"])):
        assert abs(a - b) <= 1e-6 * max(abs(b), 1.0), (a, b)


def _port_context(renderer="mcm", precision="exact", res=16):
    t = TContext(resolution=res, precision=precision, device="cpu")
    t.set_volume(tvolume.sphere_volume(16, device="cpu"))
    t.set_transfer_function(ttransfer.gray_ramp(device="cpu"))
    t.choose_renderer(renderer, params=tmcm.Params(steps=4)
                      if renderer == "mcm" else None)
    t.choose_tone_mapper("reinhard")
    return t


def test_changes_reset_accumulation_and_a_camera_move_shows():
    """Every change that JAX resets on resets here; a camera move keeps
    the scene's tables, gives the scene new matrices and changes the
    next image; the profiler counts frames and events."""
    t = _port_context()
    t.render(frames=1)
    before = t.get_hdr_image().clone()
    scene = t.get_scene()
    t.camera_animator.rotate(0.2, 0.0)
    assert t.renderer.state is None
    t.render(frames=1)
    moved = t.get_scene()
    assert moved is not scene
    assert moved.volume_packed is scene.volume_packed
    assert moved.tracking_packed is scene.tracking_packed
    assert not torch.equal(moved.mvp_inverse, scene.mvp_inverse)
    assert t.renderer.frame_number == 1
    assert not torch.equal(t.get_hdr_image(), before)
    for change in (
            lambda: t.set_transfer_function(ttransfer.gray_ramp(
                alpha_scale=0.5, device="cpu")),
            lambda: t.set_transfer_function(THREE_BUMPS),
            lambda: t.set_volume(tvolume.shell_volume(16, device="cpu")),
            lambda: t.set_environment_map(torch.ones(1, 1, 4) * 0.5),
            lambda: setattr(t.volume_transform, "local_scale",
                            (1.0, 1.1, 0.9))):
        t.render(frames=1)
        assert t.renderer.state is not None
        change()
        assert t.renderer.state is None
    t.render(frames=2)
    stats = t.profiler.stages["render_frame"]
    assert stats.calls == 9
    assert t.profiler.events == 9 * 16 * 16 * 4


@pytest.mark.parametrize("renderer", ["eam", "mcm"])
def test_checkpoints_cross_between_the_packages(tmp_path, renderer):
    """A JAX checkpoint resumes in the port and a port checkpoint in JAX:
    frame number, seed0, renderer and Params carry over, and the resumed
    displays agree within 1e-6."""
    j, t = _contexts(renderer, "exact")
    j.seed0 = t.seed0 = 3
    j.render(frames=2)
    t.render(frames=3)
    j.save_checkpoint(tmp_path / "jax.npz")
    t.save_checkpoint(tmp_path / "port.npz")

    jt, tj = _contexts(renderer, "exact")
    tj.load_checkpoint(tmp_path / "jax.npz")
    jt.load_checkpoint(tmp_path / "port.npz")
    assert (tj.renderer.frame_number, tj.seed0) == (2, 3)
    assert (jt.renderer.frame_number, jt.seed0) == (3, 3)
    assert tj.renderer_key == jt.renderer_key == renderer
    assert dataclasses.asdict(tj.renderer.params) \
        == dataclasses.asdict(j.renderer.params)
    assert close(tj.get_display_image(), j.get_display_image())
    assert close(jt.get_display_image(), t.get_display_image())
    meta = json.loads(str(np.load(tmp_path / "port.npz")["__meta__"]))
    jmeta = json.loads(str(np.load(tmp_path / "jax.npz")["__meta__"]))
    assert sorted(meta) == sorted(jmeta)
    assert meta["treedef"] == jmeta["treedef"]


@pytest.mark.parametrize("renderer", ["eam", "mcm", "dos"])
def test_resumed_render_is_bit_identical(tmp_path, renderer):
    """2 frames, a checkpoint, a fresh context's load, 2 more frames: the
    HDR image of 4 uninterrupted frames, bit for bit."""
    whole = _port_context(renderer)
    whole.render(frames=4)
    part = _port_context(renderer)
    part.render(frames=2)
    part.save_checkpoint(tmp_path / "c.npz")
    resumed = _port_context(renderer)
    resumed.load_checkpoint(tmp_path / "c.npz")
    resumed.render(frames=2)
    assert resumed.renderer.frame_number == 4
    assert torch.equal(resumed.get_hdr_image(), whole.get_hdr_image())


def test_checkpoint_load_and_refusals(tmp_path):
    t = _port_context("mcm")
    t.render(frames=1)
    t.save_checkpoint(tmp_path / "c.npz")
    key, state, frame, meta = tcheckpoint.load(
        tmp_path / "c.npz", state_example=t.renderer.state, device="cpu")
    assert (key, frame) == ("mcm", 1) and meta["extra"]["seed0"] == 0
    assert all(torch.equal(state[k], t.renderer.state[k]) for k in state)
    _, leaves, _, _ = tcheckpoint.load(tmp_path / "c.npz", device="cpu")
    assert len(leaves) == len(state)
    tcheckpoint.save(tmp_path / "bare.npz", "mcm", t.renderer.state, 1)
    with pytest.raises(ValueError, match="state_keys"):
        tcheckpoint.resume_renderer(tmp_path / "bare.npz", device="cpu")
    # the sharded checkpoint (torch.distributed.checkpoint), one process
    tcheckpoint.save_sharded(tmp_path / "sharded", "mcm", t.renderer.state,
                             1, extra={"seed0": 0})
    key, sharded, frame, meta = tcheckpoint.load_sharded(
        tmp_path / "sharded", device="cpu")
    assert (key, frame, meta["extra"]) == ("mcm", 1, {"seed0": 0})
    assert all(torch.equal(sharded[k], t.renderer.state[k]) for k in state)


def test_record_animation_writes_png_frames(tmp_path):
    """PNG frames, and since ``io/video.py`` is ported a video of them
    (``video=`` raised NotImplementedError before): the GIF holds the
    frames' pixels."""
    from PIL import Image

    t = _port_context("eam", res=12)
    out = t.record_animation(tmp_path / "anim", frames=3, spp=1)
    files = sorted(p.name for p in out.iterdir())
    assert files == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert np.asarray(Image.open(out / files[0])).shape == (12, 12, 3)
    t.record_animation(tmp_path / "v", frames=2, spp=1,
                       video=tmp_path / "v.gif")
    gif = Image.open(tmp_path / "v.gif")
    assert gif.n_frames == 2
    assert np.array_equal(np.asarray(gif.convert("RGB")), np.asarray(
        Image.open(tmp_path / "v" / "frame_0000.png")))


# -- make_scene above the packing threshold ----------------------------------

@pytest.fixture(scope="module")
def large_rule_scenes():
    """JAX's unpacked bf16-weight scene, and the port's scene on the
    card's rule for it, built on the CPU with the threshold at 0 voxels."""
    kwargs = dict(tf_srgb=True, tracking="auto", tf_mxu=True)
    jscene_ = jmake_scene(jvolume.blobs_volume(16, seed=7),
                          jtransfer.gray_ramp(alpha_scale=0.9), pack=False,
                          pack_dtype=jnp.bfloat16, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbase, "PACK_MAX_VOXELS", 0)
        cpu_rule = make_scene(tvolume.blobs_volume(16, seed=7, device="cpu"),
                              ttransfer.gray_ramp(alpha_scale=0.9,
                                                  device="cpu"),
                              pack_dtype=torch.bfloat16, device="cpu",
                              **kwargs)
        mp.setattr(tbase, "kernels_sample", lambda device: True)
        card_rule = make_scene(tvolume.blobs_volume(16, seed=7,
                                                    device="cpu"),
                               ttransfer.gray_ramp(alpha_scale=0.9,
                                                   device="cpu"),
                               pack_dtype=torch.bfloat16, device="cpu",
                               **kwargs)
    return jscene_, cpu_rule, card_rule


def test_large_volume_rule_builds_float32_tables(large_rule_scenes):
    jscene_, cpu_rule, card_rule = large_rule_scenes
    assert jscene_.volume_packed is None
    # the CPU keeps JAX's rule: no corner tables above the threshold
    assert cpu_rule.volume_packed is None and cpu_rule.transfer_packed is None
    assert card_rule.volume_packed.dtype == torch.float32
    assert card_rule.transfer_packed.dtype == torch.float32
    assert card_rule.tracking_packed.dtype == torch.bfloat16
    assert card_rule.tf_mxu == torch.bfloat16
    assert np.array_equal(card_rule.transfer_1d.numpy(),
                          np.asarray(jscene_.transfer_mxu
                                     .astype(jnp.float32)))
    assert torch.equal(card_rule.tracking_packed.view(torch.int16),
                       cpu_rule.tracking_packed.view(torch.int16))
    tables = tbase.sampling.pack_corner_volume(card_rule.volume)
    assert torch.equal(card_rule.volume_packed, tables)


def test_large_volume_rule_renders_jax_unpacked_eam(large_rule_scenes):
    """EAM, 2 frames at 32²: the bf16 bounds of tests/test_torch_march.py
    (99% within 1e-6, all within 4e-3)."""
    jscene_, _, card_rule = large_rule_scenes
    want = jmake_renderer("eam", height=RES, width=RES).render_progressive(
        jscene_, frames=2, seed0=5)
    got = make_renderer("eam", height=RES, width=RES).render_progressive(
        card_rule, frames=2, seed0=5)
    assert_march_close(got, want, "fast")


def test_large_volume_rule_renders_jax_unpacked_mcm(large_rule_scenes):
    """One MCM frame (cheb-skip on the bf16 tracking table, bf16 TF
    weights): the bounds of tests/test_torch_mcm.py."""
    jscene_, _, card_rule = large_rule_scenes
    params = jmcm.Params(extinction=20.0, anisotropy=0.3, steps=8)
    state = jmcm.reset(params, RES, RES, jscene_)
    tstate = interop.state_from_numpy({k: np.asarray(v)
                                       for k, v in state.items()},
                                      device="cpu")
    jout = jax.jit(jmcm.render_frame, static_argnums=(2,))(
        state, jscene_, params, jnp.float32(0.37), jnp.int32(1))
    tmcm.render_frame(tstate, card_rule, tmcm.Params(
        extinction=20.0, anisotropy=0.3, steps=8), 0.37, 1)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    tout = interop.state_to_numpy(tstate)
    match = tout["samples"] == jout["samples"]
    assert match.mean() >= 0.97, match.mean()
    assert jout["samples"].mean() > 1.0
    for key in ("radiance", "position"):
        assert np.allclose(tout[key][match], jout[key][match], rtol=0,
                           atol=1e-5), key
