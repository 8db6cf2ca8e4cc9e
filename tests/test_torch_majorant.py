"""The port's majorant-grid tracking (``make_scene(tracking="grid")``)
against vpt_tpu's, on the CPU.

- ``skipgrid.build_majorant_grid`` and ``skipgrid.flight_step`` equal
  JAX's: the grid's min, max and texel cover and the flight's cell, DDA
  boundary and hop are exact float32 work.
- Grid MCM frames: JAX's jitted ``render_frame`` (32², where the jitted
  NDC rounding moves no pixel) against the port's plain frames, 3 frames
  on a 32³ sphere.  The bounds are ``samples`` equal in at least 99% of the
  pixels and the radiance of those pixels within 2e-5 (measured: samples
  equal in every pixel, radiance within 2.4e-7 with N = 16 and within
  5.4e-7 with N = 8, float32 tables).
- The property oracles of ``tests/test_skipgrid.py`` on the plain port:
  the majorant bounds the sampled alpha, a flight's bound keeps it where
  the majorant holds, and a homogeneous medium converges to the analytic
  transmittance.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import skipgrid as jskip
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import interop, skipgrid, transfer, volume
from vpt_tpu_torch.renderers import make_renderer, make_scene
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


def _srgb_ramp(alpha=0.8):
    return np.asarray(jtransfer.to_gl_texture(
        jtransfer.gray_ramp(alpha_scale=alpha), srgb=True, quantize=True))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind,n", [("sphere", 4), ("sphere", 16),
                                    ("blobs", 8)])
def test_build_majorant_grid_equal(kind, n):
    """Min, max, the texel cover and the distance field are exact: the
    grid equals JAX's, with empty cells and distances beyond 1."""
    vol = np.asarray((jvolume.sphere_volume(32) if kind == "sphere"
                      else jvolume.blobs_volume(32, seed=3)).data)
    tf = _srgb_ramp()
    want = np.asarray(jskip.build_majorant_grid(jnp.asarray(vol),
                                                jnp.asarray(tf), n))
    got = skipgrid.build_majorant_grid(_t(vol), _t(tf), n)
    assert got.dtype == torch.float32 and got.shape == (n, n, n, 2)
    assert np.array_equal(got.numpy(), want)
    if kind == "sphere" and n == 16:
        assert (want[..., 0] == 0).any() and want[..., 1].max() >= 2


def test_build_majorant_grid_unsupported():
    """Multi-channel volumes and dims N does not divide give None, as in
    JAX."""
    tf = _t(_srgb_ramp())
    assert skipgrid.build_majorant_grid(torch.ones(8, 8, 8, 2), tf,
                                        4) is None
    assert skipgrid.build_majorant_grid(torch.ones(12, 12, 12, 1), tf,
                                        5) is None
    assert jskip.build_majorant_grid(jnp.ones((12, 12, 12, 1)),
                                     jnp.asarray(tf.numpy()), 5) is None


def test_flight_step_equal():
    """Random positions and directions, positions on cell faces and
    outside the cube, and directions with zero components (divided only
    where non-zero): the majorant and the boundary equal JAX's."""
    vol = np.asarray(jvolume.sphere_volume(32).data)
    grid = np.asarray(jskip.build_majorant_grid(
        jnp.asarray(vol), jnp.asarray(_srgb_ramp()), 8))
    r = np.random.default_rng(11)
    pos = r.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    pos[:512] = np.round(pos[:512] * 8) / 8                 # on faces
    dirs = r.normal(size=(4096, 3)).astype(np.float32)
    dirs[np.arange(1024, 1536), r.integers(0, 3, 512)] = 0.0  # a zero
    dirs[1536:1600] = [[0.0, 0.0, 1.0], [0.0, -1.0, 0.0]] * 32
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want_mu, want_t = jskip.flight_step(jnp.asarray(grid), jnp.asarray(pos),
                                        jnp.asarray(dirs))
    got_mu, got_t = skipgrid.flight_step(_t(grid), _t(pos), _t(dirs))
    assert np.array_equal(got_mu.numpy(), np.asarray(want_mu))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    # hops through empty space reach past the cell's own boundary
    assert (np.asarray(want_t) > 1.0 / 8).any()


@pytest.fixture(scope="module")
def grid_frames():
    """JAX's and the port's states after 3 frames, per grid size."""
    out = {}
    frame = jax.jit(jmcm.render_frame, static_argnums=(2,))
    for kind, extra in (("grid16", dict(tracking="grid")),
                        ("grid8", dict(majorant_grid=8))):
        jscene = jmake_scene(jvolume.sphere_volume(32),
                             jtransfer.gray_ramp(alpha_scale=0.8),
                             tf_srgb=True, **extra)
        tscene = interop.scene_from_numpy(interop.scene_fields(jscene),
                                          device="cpu")
        jstate = jmcm.reset(JPARAMS, RES, RES, jscene)
        tstate = interop.state_from_numpy(
            {k: np.asarray(v) for k, v in jstate.items()}, device="cpu")
        for n, seed in enumerate((0.13, 0.47, 0.82), start=1):
            jstate = frame(jstate, jscene, JPARAMS, jnp.float32(seed),
                           jnp.int32(n))
            tmcm.render_frame(tstate, tscene, TPARAMS, np.float32(seed), n)
        out[kind] = (jscene, tscene,
                     {k: np.asarray(v) for k, v in jstate.items()},
                     interop.state_to_numpy(tstate))
    return out


@pytest.mark.parametrize("kind", ["grid16", "grid8"])
def test_grid_frames_agree_with_jax(grid_frames, kind):
    jscene, tscene, want, got = grid_frames[kind]
    assert tscene.majorant is not None and tscene.tracking_packed is None
    assert np.array_equal(tscene.majorant.numpy(),
                          np.asarray(jscene.majorant))
    assert sorted(got) == sorted(want)             # no cheb carry
    same = got["samples"] == want["samples"]
    assert same.mean() >= 0.99, same.mean()
    diff = np.abs(got["radiance"] - want["radiance"])[same]
    assert diff.max() <= 2e-5, diff.max()
    assert want["samples"].sum() > RES * RES


def test_grid_scene_tracks_without_cheb():
    """A grid scene's reset adds no cheb carry and frames do not use the
    cheb-skip machine; a tracking-era state's carry threads through a grid
    frame unchanged."""
    scene = make_scene(volume.sphere_volume(16, device="cpu"),
                       transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                       tf_srgb=True, tracking="grid", device="cpu")
    assert scene.majorant.shape == (16, 16, 16, 2)
    state = tmcm.reset(TPARAMS, 8, 8, scene)
    assert "cheb" not in state and not tmcm.uses_skip(state, scene)
    state["cheb"] = torch.full((8, 8), 3.0)
    assert not tmcm.uses_skip(state, scene)
    tmcm.render_frame(state, scene, TPARAMS, 0.4)
    assert torch.equal(state["cheb"], torch.full((8, 8), 3.0))


def test_grid_options_raise_and_warn_as_jax():
    """cheb together with a grid raises; a grid the volume's dims do not
    divide warns under ``tracking="grid"`` and falls back to the exact
    machine (no table, no grid), as in JAX."""
    vol = volume.sphere_volume(12, device="cpu")
    tf = transfer.gray_ramp(device="cpu")
    with pytest.raises(ValueError, match="cheb"):
        make_scene(vol, tf, tracking="cheb", majorant_grid=4, device="cpu")
    with pytest.raises(ValueError, match="tracking"):
        make_scene(vol, tf, tracking="majorant", device="cpu")
    with pytest.warns(UserWarning, match="grid"):
        scene = make_scene(vol, tf, tracking="grid", device="cpu")
    assert scene.majorant is None and scene.tracking_packed is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet = make_scene(vol, tf, majorant_grid=5, device="cpu")
    assert quiet.majorant is None


def _sphere_scene(n=32, majorant_grid=None):
    return make_scene(volume.sphere_volume(n, device="cpu"),
                      transfer.gray_ramp(device="cpu"),
                      majorant_grid=majorant_grid, device="cpu")


def test_majorant_bounds_sampled_alpha():
    """For any position, the interpolated TF alpha never exceeds the
    majorant of the cell that holds it (tests/test_skipgrid.py)."""
    sc = _sphere_scene(32, majorant_grid=8)
    n = sc.majorant.shape[0]
    pos = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (8192, 3)).astype(np.float32))
    cell = torch.clamp((pos * n).to(torch.int64), 0, n - 1)
    flat = (cell[..., 2] * n + cell[..., 1]) * n + cell[..., 0]
    mu = sc.majorant.reshape(-1, 2)[flat][..., 0]
    alpha = sc.sample_color(pos)[..., 3]
    assert bool((alpha <= mu + 1e-6).all())


def test_flight_step_bounds_stay_in_cell():
    """Along a flight up to its bound the sampled alpha never exceeds the
    flight's majorant inside the cube: the bound leaves the cell only
    through exactly-empty space (tests/test_skipgrid.py)."""
    sc = _sphere_scene(32, majorant_grid=8)
    r = np.random.default_rng(7)
    pos = torch.from_numpy(r.uniform(0, 1, (4096, 3)).astype(np.float32))
    dirs = r.normal(size=(4096, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1,
                                                  keepdims=True))
    mu, t_bound = skipgrid.flight_step(sc.majorant, pos, dirs)
    assert bool((t_bound >= 0.0).all())
    frac = torch.linspace(0.0, 1.0, 17)
    pts = pos[:, None, :] + (t_bound[:, None] * frac[None, :])[..., None] \
        * dirs[:, None, :]
    alpha = sc.sample_color(pts)[..., 3]
    inside = ((pts >= 0) & (pts <= 1)).all(-1)
    assert not bool(((alpha > mu[:, None] + 1e-6) & inside).any())


def test_majorant_homogeneous_analytic():
    """A homogeneous absorbing medium, where maxalpha equals alpha: the
    grid machine has no null collisions, and the converged center pixel
    estimates exp(-sigma L) = exp(-1.6) (tests/test_skipgrid.py, there
    over 100 frames).  20 frames of 64 events give the center pixel 539
    paths, whose mean has a standard error of 0.017: the bound 0.1 is
    about six of them."""
    tf = torch.zeros(2, 256, 4)
    tf[..., 3] = 0.4
    sc = make_scene(volume.Volume(torch.ones(8, 8, 8, 1)), tf,
                    majorant_grid=4, device="cpu")
    assert torch.allclose(sc.majorant[..., 0], torch.tensor(0.4))
    params = tmcm.Params(extinction=4.0, anisotropy=0.0, steps=64)
    img = make_renderer("mcm", params=params, height=9, width=9) \
        .render_progressive(sc, frames=20, seed0=7)
    assert abs(float(img[4, 4, 0]) - np.exp(-1.6)) < 0.1
