"""The port's ``inpaint.py`` against ``vpt_tpu.inpaint`` on the CPU.

Bounds, each measured on these inputs:
- ``resize`` (the port's ``jax.image.resize(..., "trilinear")``) within
  1e-6 of JAX's, up, down and non-cubic (measured 4.8e-7: the weights are
  equal, the contractions sum in another order);
- ``optical_depth_min6`` and ``optical_depth_views`` within 1e-5 relative
  to the field's maximum (measured 5.9e-7 for the cumulative sums);
- ``unobserved_mask`` and ``complete_occluded``'s mask equal;
- ``biharmonic_fill`` within 1e-5 of JAX's (measured 4.7e-6 on the
  quadratic field at 40 CG iterations a level, 7.2e-7 or less elsewhere:
  CG's float32 dot products sum in another order, and the iterations
  carry the difference);
- ``select_tau_blind``'s chosen tau and filled fractions equal, on a case
  whose every row lies at least 5% from the admissibility threshold, so
  that a last-bit difference cannot flip the choice; its held-out MSEs
  within 1e-3 relative (measured 9.6e-5, on the row whose fill covers 45%
  of the voxels: the fills' CG differences, rendered).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import inpaint as jinpaint
from vpt_tpu import train as jtrain
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import eam as jeam
from vpt_tpu.runtime.animators import OrbitCameraAnimator as JOrbit
from vpt_tpu.scene import CameraState as JCameraState
from vpt_tpu.scene import default_camera as jdefault_camera
from vpt_tpu_torch import inpaint, train
from vpt_tpu_torch.renderers import eam


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FILL_BOUND = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def blobs():
    """tests/test_inpaint.py's config-3 scene family at 24³: the truth, the
    unseen set at extinction 25 and tau 2, and the truth damaged there."""
    truth = np.array(jvolume.blobs_volume(24, seed=3, count=6).data[..., 0])
    mask = np.array(jinpaint.unobserved_mask(jnp.asarray(truth), 25.0, 2.0))
    damaged = np.where(mask, 0.45 * truth, truth).astype(np.float32)
    return truth, mask, damaged


def _ball(n, r):
    g = (np.arange(n) + 0.5) / n
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < r * r


@pytest.mark.parametrize("shape_in,shape_out", [
    ((8, 8, 8), (16, 16, 16)), ((16, 16, 16), (8, 8, 8)),
    ((24, 40, 40), (10, 17, 17)), ((10, 17, 17), (24, 40, 40)),
    ((32, 32, 32), (32, 16, 8))])
def test_resize_matches_jax(shape_in, shape_out):
    x = np.random.default_rng(0).uniform(-4.0, 1.0, shape_in).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape_out,
                                       "trilinear"))
    got = inpaint.resize(_t(x), shape_out).numpy()
    assert got.shape == shape_out
    assert np.abs(got - want).max() <= 1e-6


def test_optical_depth_min6_and_mask_match_jax(blobs):
    truth, mask, _ = blobs
    for ext in (10.0, 25.0):
        want = np.asarray(jinpaint.optical_depth_min6(jnp.asarray(truth),
                                                      ext))
        got = inpaint.optical_depth_min6(_t(truth), ext).numpy()
        assert _rel(got, want) <= 1e-5
    got = inpaint.unobserved_mask(_t(truth)[..., None], 25.0, 2.0).numpy()
    assert mask.any() and np.array_equal(got, mask)


def test_camera_position_and_view_depths_match_jax():
    cs = JCameraState.from_nodes(jdefault_camera())
    want = np.asarray(jinpaint.camera_position(cs.model_view))
    got = inpaint.camera_position(_t(cs.model_view)).numpy()
    np.testing.assert_allclose(got, [0.5, 0.5, 2.5], atol=1e-5)
    assert np.abs(got - want).max() <= 1e-6

    # non-cubic, computed on a 20-voxel grid: resized down and up again
    # (test_select_tau_blind_matches_jax holds the native grid and several
    # cameras)
    block = np.zeros((24, 40, 40), np.float32)
    block[8:16, 16:28, 16:28] = 0.9
    cam = np.array([[0.5, 0.5, 3.0]], np.float32)
    want = np.asarray(jinpaint.optical_depth_views(
        jnp.asarray(block), 10.0, jnp.asarray(cam), n_steps=32, grid=20))
    got = inpaint.optical_depth_views(_t(block), 10.0, _t(cam), n_steps=32,
                                      grid=20).numpy()
    assert got.shape == (24, 40, 40)
    assert _rel(got, want) <= 1e-5
    assert got[4, 22, 22] > got[20, 22, 22]


@pytest.mark.parametrize("log_space", [False, True])
def test_biharmonic_fill_matches_jax(log_space):
    """A quadratic field (exact in linear space) and a Gaussian core (exact
    in log space), damaged inside a ball, filled coarse-to-fine from 8³."""
    n = 24
    g = (np.arange(n) + 0.5) / n
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    if log_space:
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
        truth = (0.9 * np.exp(-r2 / (2 * 0.15 ** 2))).astype(np.float32)
    else:
        truth = (0.3 + 0.5 * x - 0.2 * y + 0.8 * z * z
                 - 0.4 * x * y).astype(np.float32)
    mask = _ball(n, 0.2)
    damaged = np.where(mask, 0.4 * truth, truth).astype(np.float32)
    kw = dict(log_space=log_space, coarsest=8, cg_iters=40,
              clip=log_space)
    want = np.asarray(jinpaint.biharmonic_fill(jnp.asarray(damaged),
                                               jnp.asarray(mask), **kw))
    got = inpaint.biharmonic_fill(_t(damaged)[..., None], _t(mask),
                                  **kw).numpy()
    assert got.shape == (n, n, n, 1)
    assert np.abs(got[..., 0] - want).max() <= FILL_BOUND
    np.testing.assert_array_equal(got[..., 0][~mask], damaged[~mask])
    # the fill recovers most of the damage, as in tests/test_inpaint.py
    err0 = np.mean((damaged - truth)[mask] ** 2)
    assert np.mean((got[..., 0] - truth)[mask] ** 2) < 0.25 * err0


def test_complete_occluded_matches_jax(blobs):
    truth, mask, damaged = blobs
    kw = dict(coarsest=8, cg_iters=20)
    for tau in (2.0, None):        # None: the proxy's default, 0.15
        want, wmask = jinpaint.complete_occluded(jnp.asarray(damaged),
                                                 extinction=25.0, tau=tau,
                                                 **kw)
        got, gmask = inpaint.complete_occluded(_t(damaged), extinction=25.0,
                                               tau=tau, **kw)
        assert np.array_equal(gmask.numpy(), np.asarray(wmask))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= FILL_BOUND
    assert np.asarray(wmask).mean() > 0.1     # tau 0.15 masks the shell
    # a visibility field: the default tau is 1
    depth = np.array(jinpaint.optical_depth_min6(jnp.asarray(damaged), 25.0))
    want, wmask = jinpaint.complete_occluded(jnp.asarray(damaged),
                                             depth=jnp.asarray(depth), **kw)
    got, gmask = inpaint.complete_occluded(_t(damaged), depth=_t(depth),
                                           **kw)
    assert np.array_equal(gmask.numpy(), np.asarray(wmask))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= FILL_BOUND
    with pytest.raises(ValueError, match="depth or extinction"):
        inpaint.complete_occluded(_t(damaged))


def test_select_tau_blind_matches_jax(blobs):
    truth, mask, fitted = blobs
    tf = np.array(jtransfer.gray_ramp(alpha_scale=1.0))
    jparams = jeam.Params(extinction=40.0, slices=24, random=False)
    tparams = eam.Params(extinction=40.0, slices=24, random=False)

    def cams(yaws):
        out = []
        for yaw in yaws:
            node = jdefault_camera()
            orbit = JOrbit(node)
            orbit.yaw = np.deg2rad(yaw)
            orbit._update_camera()
            cs = JCameraState.from_nodes(node)
            out.append(tuple(np.array(m) for m in (
                cs.mvp_inverse, cs.model_view, cs.projection)))
        return out

    fit_cams, held_cams = cams([0, 72, 144, 216, 288]), cams([36, 200])
    jrender = jax.jit(lambda v, m: jtrain.render_eam(
        v[..., None], tf, m, jparams, jnp.float32(0.0), 16, 16))

    def trender(v, m):
        with torch.no_grad():
            return train.render_eam(v[..., None], _t(tf),
                                    tuple(_t(x) for x in m), tparams,
                                    np.float32(0.0), 16, 16)

    targets = [np.array(jrender(jnp.asarray(truth), c)) for c in held_cams]
    cam_pos = np.stack([np.asarray(jinpaint.camera_position(c[1]))
                        for c in fit_cams])
    depth = np.array(jinpaint.optical_depth_views(
        jnp.asarray(fitted), 25.0, jnp.asarray(cam_pos), n_steps=32,
        grid=None))
    tdepth = inpaint.optical_depth_views(_t(fitted), 25.0, _t(cam_pos),
                                         n_steps=32, grid=None, chunk=5)
    assert _rel(tdepth.numpy(), depth) <= 1e-5
    taus = [0.02, 0.5, 2.0, 50.0]
    kw = dict(slack_abs=1e-5, coarsest=8, cg_iters=20)
    jtau, jcompleted, jtable = jinpaint.select_tau_blind(
        jnp.asarray(fitted), taus, targets,
        lambda v: [jrender(v, c) for c in held_cams],
        depth=jnp.asarray(depth), **kw)
    ttau, tcompleted, ttable = inpaint.select_tau_blind(
        _t(fitted), taus, [_t(t) for t in targets],
        lambda v: [trender(v, c) for c in held_cams], depth=tdepth, **kw)
    assert ttau == jtau and jtau is not None and 0.02 < jtau < 50.0
    floor = min(r["heldout_mse"] for r in jtable)
    threshold = floor * 1.02 + 1e-5
    for jr, tr in zip(jtable, ttable):
        assert tr["tau"] == jr["tau"]
        assert tr["filled_frac"] == jr["filled_frac"]
        assert tr["heldout_mse"] == pytest.approx(jr["heldout_mse"],
                                                  rel=1e-3, abs=1e-12)
        assert abs(jr["heldout_mse"] - threshold) >= 0.05 * threshold
    assert np.abs(tcompleted.numpy() - np.asarray(jcompleted)).max() \
        <= FILL_BOUND
