"""The nearest and cubic volume filters in the port against vpt_tpu's.

- The samplers (``sampling.sample_volume_nearest``, ``sample_volume_cubic``,
  ``volume_rg``, ``sample_volume_color``) at positions that include texel
  centres, the fraction-0.5 boundaries of the linear cell (and one ulp on
  each side), the faces and points far outside: equal to vpt_tpu's bit for
  bit (measured: no value differs, so no tolerance is needed).
- The kernels' twin of each filter (``csrc/ray.cuh``): nearest takes the
  linear cell with each fraction snapped to 0 or 1 (1 iff it is at least
  0.5) and lerps the float32 corner row; cubic warps the position
  (``sampling.cubic_warp``) and fetches the row linearly.  Both are held to
  the samplers bit for bit here, so the kernels' fetch is exact, not
  approximate.
- ``make_scene``'s rules for a filtered volume (no packed samplers, no
  cheb-skip table, no clamp boxes, a majorant grid all the same) and their
  warnings, against vpt_tpu's.
- The renderers on ``nearest`` and ``cubic`` volumes (16³ blobs, 32²) and
  MCM with ``tracking="grid"`` and a filter, to the bounds of the
  single-channel linear tests of the same renderer
  (``test_torch_mcm.py``, ``test_torch_march.py``, ``test_torch_mcs.py``).
- ``RenderingContext.set_filter`` then a frame, against vpt_tpu's context.
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
import vpt_tpu.renderers as jrenderers
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.runtime import RenderingContext as JContext
from vpt_tpu_torch import interop, sampling, transfer, volume
from vpt_tpu_torch.kernels import mcm_event
from vpt_tpu_torch.renderers import make_scene
import vpt_tpu_torch.renderers as trenderers
from vpt_tpu_torch.runtime import RenderingContext


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FILTERS = ("nearest", "cubic")
RES = 32

def _positions(dims):
    """(N, 3) float32 positions in a volume of ``dims`` = (W, H, D): random
    points in [-0.2, 1.2]³, the texel centres, the linear cell's 0.5
    boundaries (integer multiples of 1/N) with the floats one ulp either
    side, the faces and points far outside."""
    r = np.random.default_rng(11)
    n = np.array(dims, np.float32)
    idx = r.integers(-1, np.max(dims) + 2, size=(1500, 3)).astype(np.float32)
    bounds = idx / n
    pts = [r.uniform(-0.2, 1.2, size=(1500, 3)).astype(np.float32),
           (idx + np.float32(0.5)) / n, bounds,
           np.nextafter(bounds, np.float32(np.inf)),
           np.nextafter(bounds, np.float32(-np.inf)),
           np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [-40, 7, 0.5],
                     [1e6, -1e6, 2.0]], np.float32)]
    return np.concatenate(pts).astype(np.float32)


@pytest.fixture(scope="module")
def grids():
    r = np.random.default_rng(5)
    out = {c: r.uniform(size=(16, 12, 10, c)).astype(np.float32)
           for c in (1, 2)}
    return out, _positions((10, 12, 16))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", ["sample_volume_nearest",
                                  "sample_volume_cubic"])
def test_filtered_samplers_equal_jax(grids, name, channels):
    vols, p = grids
    want = np.asarray(getattr(jsampling, name)(jnp.asarray(vols[channels]),
                                               jnp.asarray(p)))
    got = getattr(sampling, name)(torch.from_numpy(vols[channels]),
                                  torch.from_numpy(p)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("filt", ["linear", "nearest", "cubic"])
def test_volume_rg_and_sample_volume_color_equal_jax(grids, filt):
    """(value, channel 1) through each filter (channel 1 reads 0 for one
    channel; a four-channel volume reads its first two), and the 2D TF
    lookup of it."""
    vols, p = grids
    r = np.random.default_rng(6)
    four = r.uniform(size=(16, 12, 10, 4)).astype(np.float32)
    for data in (vols[1], vols[2], four):
        want = np.asarray(jsampling.volume_rg(jnp.asarray(data),
                                              jnp.asarray(p), filt))
        got = sampling.volume_rg(torch.from_numpy(data), torch.from_numpy(p),
                                 filt).numpy()
        assert got.shape == (len(p), 2)
        assert np.array_equal(got, want)
    tf = r.uniform(size=(8, 32, 4)).astype(np.float32)
    want = np.asarray(jsampling.sample_volume_color(
        jnp.asarray(vols[2]), jnp.asarray(tf), jnp.asarray(p), filt))
    got = sampling.sample_volume_color(torch.from_numpy(vols[2]),
                                       torch.from_numpy(tf),
                                       torch.from_numpy(p), filt).numpy()
    assert np.array_equal(got, want)


def _kernel_twin(table, shape, p, filt):
    """The fetch of the kernels' ext instances (``vpt_cell_filtered``,
    ``vpt_lerp_rg``): cubic warps the positions, nearest snaps the linear
    cell's fractions to 0 or 1; then the float32 corner row's lerp chain."""
    d, h, w, c = shape
    if filt == "cubic":
        p = sampling.cubic_warp(p, (w, h, d))
    cell, f = sampling.corner_cells(p, shape)
    if filt == "nearest":
        f = (f >= 0.5).to(torch.float32)
    rows = table[cell].reshape(cell.shape + (8, c))
    return sampling.trilerp_chain(rows, f)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("filt", FILTERS)
def test_kernel_fetch_twin_is_exact(grids, filt, channels):
    """The kernels' filtered fetch from the float32 corner table equals the
    sampler bit for bit at every position, out-of-range ones included:
    for nearest, ``x − 0.5`` is exact for the in-range ``x = p·N``, and the
    clamps of the linear cell and of ``sample_volume_nearest`` pick the
    same texel at both faces.  The fixed points: a fraction of exactly 0.5
    takes the +1 corner, one ulp below it the cell's own."""
    vols, p = grids
    data = torch.from_numpy(vols[channels])
    pos = torch.from_numpy(p)
    table = sampling.pack_corner_volume(data)
    want = getattr(sampling, f"sample_volume_{filt}")(data, pos)
    got = _kernel_twin(table, tuple(data.shape), pos, filt)
    assert torch.equal(got, want)
    if filt == "nearest":
        # x = 3.0 (fraction 0.5 in cell 2) → texel 3; just below → 2
        col = data[0, 0, :, 0]
        for x, texel in ((np.float32(3.0), 3),
                         (np.nextafter(np.float32(3.0), np.float32(0)), 2)):
            q = torch.tensor([[x / np.float32(10), 0.01, 0.01]])
            assert float(_kernel_twin(table, tuple(data.shape), q,
                                      filt)[0, 0]) == float(col[texel])


def _scenes(filt, n=16, **kw):
    jvol = jvolume.blobs_volume(n, seed=7)
    jscene = jmake_scene(jvolume.Volume(jvol.data, filt),
                         jtransfer.gray_ramp(alpha_scale=0.9), **kw)
    return jscene, interop.scene_from_numpy(interop.scene_fields(jscene),
                                            device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return {f: _scenes(f) for f in FILTERS}


@pytest.mark.parametrize("filt", FILTERS)
def test_scene_samplers_equal_jax(scenes, grids, filt):
    """``Scene.sample_value``, ``sample_volume_rg``, ``sample_color`` and
    ``value_gradient`` of a filtered scene (unpacked, as vpt_tpu builds
    it), and the port's own make_scene builds the same fields."""
    jscene, tscene = scenes[filt]
    _, p = grids
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    assert tscene.filter == filt and tscene.volume_packed is None
    for name in ("sample_value", "sample_volume_rg", "sample_color"):
        want = np.asarray(getattr(jscene, name)(jp))
        assert np.array_equal(getattr(tscene, name)(tp).numpy(), want), name
    want = np.asarray(jscene.value_gradient(jp, 0.005))
    got = tscene.value_gradient(tp, 0.005).numpy()
    assert np.array_equal(got, want)
    own = make_scene(volume.Volume(volume.blobs_volume(
        16, seed=7, device="cpu").data, filt),
        transfer.gray_ramp(alpha_scale=0.9, device="cpu"), device="cpu")
    assert own.volume_packed is None and own.transfer_packed is None
    assert torch.equal(own.volume, tscene.volume)
    assert torch.equal(own.transfer_1d, tscene.transfer_1d)


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, sorted(str(w.message) for w in caught)


@pytest.mark.parametrize("kwargs", [
    {"tracking": "cheb"}, {"tracking": "auto"}, {"tracking": "grid"},
    {"march_clamp": True}, {"iso_clamp_min": 0.1},
    {"tf_mxu": True, "pack_dtype": "bf16"}],
    ids=["cheb", "auto", "grid", "march_clamp", "iso_clamp_min", "mxu"])
def test_make_scene_rules_and_warnings_equal_jax(kwargs):
    """A cubic volume: cheb-skip warns and builds no table, ``auto`` is
    silent, the grid is built, both clamps warn and build no box, and
    ``tf_mxu`` rounds the TF row to ``pack_dtype`` — each as vpt_tpu."""
    jkw, tkw = dict(kwargs), dict(kwargs)
    if kwargs.get("pack_dtype"):
        jkw["pack_dtype"], tkw["pack_dtype"] = jnp.bfloat16, torch.bfloat16
    jvol = jvolume.Volume(jvolume.sphere_volume(16).data, "cubic")
    jscene, jwarn = _warned(lambda: jmake_scene(
        jvol, jtransfer.gray_ramp(alpha_scale=0.8), tf_srgb=True, **jkw))
    tscene, twarn = _warned(lambda: make_scene(
        volume.Volume(volume.sphere_volume(16, device="cpu").data, "cubic"),
        transfer.gray_ramp(alpha_scale=0.8, device="cpu"), tf_srgb=True,
        device="cpu", **tkw))
    assert twarn == jwarn
    assert (jwarn != []) == (kwargs.get("tracking") == "cheb"
                             or "march_clamp" in kwargs
                             or "iso_clamp_min" in kwargs)
    for name in ("volume_packed", "tracking_packed", "majorant",
                 "occupied_aabb", "iso_aabb"):
        want, got = getattr(jscene, name), getattr(tscene, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert np.array_equal(got.numpy(), np.asarray(want)), name
    assert (tscene.majorant is not None) == (kwargs.get("tracking") == "grid")
    if "tf_mxu" in kwargs:
        assert tscene.tf_mxu == torch.bfloat16
        assert np.array_equal(
            tscene.transfer_1d.numpy(),
            np.asarray(jscene.transfer_mxu.astype(jnp.float32)))


# -- the renderers ----------------------------------------------------------

def _params(module, jparams):
    return module.Params(**{f.name: getattr(jparams, f.name)
                            for f in dataclasses.fields(jparams)})


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso"])
def test_march_renderers_agree_with_jax(scenes, key, filt):
    """One eager ``render_frame`` from ``reset`` (the ``generate`` that
    samples the new fetch, then the integrate), and
    ISO's display of JAX's last state: within 1e-6 (Depth equal), the
    bound of ``test_torch_march.py``'s float32 scenes."""
    jscene, tscene = scenes[filt]
    jm, tm = getattr(jrenderers, key), getattr(trenderers, key)
    jparams = jm.Params()
    tparams = _params(tm, jparams)
    jstate = jm.reset(jparams, RES, RES, jscene)
    tstate = tm.reset(tparams, RES, RES, tscene)
    jstate = jm.render_frame(jstate, jscene, jparams, jnp.float32(0.37),
                             jnp.int32(1))
    tm.render_frame(tstate, tscene, tparams, 0.37, 1)
    diff = np.abs(tstate.numpy() - np.asarray(jstate))
    assert diff.max() <= (0.0 if key == "depth" else 1e-6), diff.max()
    if key == "iso":
        # the display of the same hit buffer (JAX's), as
        # test_torch_march.py's test_iso_display_matches_jax
        assert (np.asarray(jstate)[..., 3] > 0).any()
        want = np.asarray(jm.display(jstate, jscene, jparams))
        got = tm.display(interop.state_from_numpy(np.asarray(jstate),
                                                  device="cpu"),
                         tscene, tparams).numpy()
        assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("filt", FILTERS)
def test_mcs_agrees_with_jax(scenes, filt):
    """Two frames at extinction 8: 99% of the pixels within 1e-6 and the
    image means within 1e-4, ``test_torch_mcs.py``'s float32 bounds."""
    jscene, tscene = scenes[filt]
    jm, tm = jrenderers.mcs, trenderers.mcs
    jparams, tparams = jm.Params(extinction=8.0), tm.Params(extinction=8.0)
    jstate = jm.reset(jparams, RES, RES, jscene)
    tstate = tm.reset(tparams, RES, RES, tscene)
    for n, seed in ((1, 0.37), (2, 0.81)):
        jstate = jm.render_frame(jstate, jscene, jparams, jnp.float32(seed),
                                 jnp.int32(n))
        tm.render_frame(tstate, tscene, tparams, seed, n)
    got, want = tstate.numpy(), np.asarray(jstate)
    close = (np.abs(got - want) <= 1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(float(got.mean()) - float(want.mean())) <= 1e-4


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("tracking", ["none", "grid"])
@pytest.mark.parametrize("filt", FILTERS)
def test_mcm_frame_agrees_with_jax(filt, tracking):
    """One whole jitted JAX frame (steps 8, extinction 20) against the
    port's plain frame on a filtered scene, with the global majorant or
    the 16³ grid (8³ here, the volume being 16³): ``samples`` agree on at
    least 97% of the pixels, radiance and positions within 1e-5 where
    they do, ``test_torch_mcm.py``'s bound."""
    kw = {"majorant_grid": 8} if tracking == "grid" else {}
    jscene, tscene = _scenes(filt, **kw)
    assert (tscene.majorant is not None) == (tracking == "grid")
    jm, tm = jrenderers.mcm, trenderers.mcm
    jparams = jm.Params(extinction=20.0, anisotropy=0.3, steps=8)
    tparams = tm.Params(extinction=20.0, anisotropy=0.3, steps=8)
    state = jm.reset(jparams, RES, RES, jscene)
    tstate = interop.state_from_numpy(_np(state), device="cpu")
    jout = _np(jax.jit(jm.render_frame, static_argnums=(2,))(
        state, jscene, jparams, jnp.float32(0.37), jnp.int32(1)))
    before = mcm_event.LAUNCHES
    tm.render_frame(tstate, tscene, tparams, 0.37, 1)
    assert mcm_event.LAUNCHES == before
    tout = interop.state_to_numpy(tstate)
    match = tout["samples"] == jout["samples"]
    assert match.mean() >= 0.97, match.mean()
    assert jout["samples"].mean() > 0.5
    for key in ("radiance", "position"):
        assert np.allclose(tout[key][match], jout[key][match], rtol=0,
                           atol=1e-5), key


@pytest.mark.parametrize("filt", FILTERS)
def test_plain_kernel_versions_take_filtered_scenes(scenes, filt):
    """The kernels' plain versions (the oracle on the card) on a filtered
    scene are the renderers' CPU frames: equal, launching nothing."""
    from vpt_tpu_torch.kernels import iso_shade, march, mcs_frame

    _, tscene = scenes[filt]
    for key in ("eam", "iso"):
        module = getattr(trenderers, key)
        a = module.reset(module.Params(), 8, 8, tscene)
        b = a.clone()
        module.render_frame(a, tscene, module.Params(), 0.4, 1)
        march.march_frame_plain(key, b, tscene, module.Params(), 0.4, 1)
        assert torch.equal(a, b)
    assert torch.equal(iso_shade.iso_shade_plain(b, tscene,
                                                 trenderers.iso.Params()),
                       trenderers.iso.display(b, tscene,
                                              trenderers.iso.Params()))
    a = trenderers.mcs.reset(trenderers.mcs.Params(), 8, 8, tscene)
    b = a.clone()
    trenderers.mcs.render_frame(a, tscene, trenderers.mcs.Params(), 0.4, 1)
    mcs_frame.mcs_frame_plain(b, tscene, trenderers.mcs.Params(), 0.4, 1)
    assert torch.equal(a, b)
    params = trenderers.mcm.Params(steps=4)
    a = trenderers.mcm.reset(params, 8, 8, tscene)
    b = {k: v.clone() for k, v in a.items()}
    trenderers.mcm.render_frame(a, tscene, params, 0.4)
    mcm_event.event_frame_plain(b, tscene, params, 0.4)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_context_set_filter_then_render_agrees_with_jax():
    """``RenderingContext.set_filter("nearest")`` after a volume is set:
    the next scene is a nearest scene and the next frame agrees with
    vpt_tpu's context in ``samples`` on at least 97% of the pixels (the
    MCM frame bound), the exact precision on both sides."""
    contexts = []
    for ctx, vol in ((JContext(resolution=RES, precision="exact"),
                      jvolume.blobs_volume(16, seed=7)),
                     (RenderingContext(resolution=RES, precision="exact",
                                       device="cpu"),
                      volume.blobs_volume(16, seed=7, device="cpu"))):
        ctx.set_volume(vol)
        ctx.choose_renderer("mcm")
        ctx.set_filter("nearest")
        ctx.render(1)
        assert ctx.get_scene().filter == "nearest"
        contexts.append(ctx)
    jctx, tctx = contexts
    want = np.asarray(jctx.renderer.state["samples"])
    got = tctx.renderer.state["samples"].numpy()
    assert (got == want).mean() >= 0.97
