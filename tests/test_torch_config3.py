"""The port's config-3 recipe (``vpt_tpu_torch.examples.config3_mcm256``)
against ``examples/config3_mcm256.py`` on the CPU, on seeded numpy inputs.

- ``box_blur``, ``resize_volume`` (``inpaint.resize``'s bound, 4.8e-7)
  and the pyramid's decomposition and compose: within 1e-6 relative of
  JAX's; the five priors within 1e-6 relative of JAX's formula in float64
  and 2e-6 of JAX's float32 value, which carries its own float32
  summation error (the priors and the pyramid transcribed from the JAX
  recipe's ``loss_fn`` and stage loop, which are inline code there).
- ``orbit_cameras``: the camera matrices within 1e-6.
- ``cosine_lr``: within 1e-7 relative of ``optax.cosine_decay_schedule``
  at every step of the recipe's stages (measured: at most 9.9e-8; XLA's
  float32 cosine is not correctly rounded at 3 of 301 steps).
- The view order equals the JAX recipe's.
- One stage-1 value-and-grad of ``loss_fn`` (16³, 16², 2 frames, both
  extinctions, the ``lap`` prior) from the recipe's init (the blurred,
  dimmed blobs) on the same camera matrices against the
  JAX recipe's loss (its fold packing, transcribed): the loss within 1e-6
  relative, the gradient within ``tests/test_torch_diff_mc.py``'s 1e-4
  relative L2 (measured: 2.3e-7 and 1.8e-6).
- A port-only run of the recipe through :func:`run` on tiny stages ends in
  its JSON summary line and writes its gallery, and :func:`main`'s
  defaults write under ``build/``.
"""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import diff_mc as jdiff
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import transfer as ttransfer
from vpt_tpu_torch.examples import config3_mcm256 as c3
from vpt_tpu_torch.renderers import make_scene
from vpt_tpu_torch.scene import CameraState

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "jax_config3_mcm256", ROOT / "examples" / "config3_mcm256.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J3 = _jax_recipe()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _volume(n, seed):
    r = np.random.default_rng(seed)
    return r.uniform(0.0, 1.0, (n, n, n, 1)).astype(np.float32)


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("n,k", [(20, 13), (12, 3)])
def test_box_blur_matches_jax(n, k):
    vol = _volume(n, 1)
    want = np.asarray(J3.box_blur(jnp.asarray(vol), k))
    got = c3.box_blur(torch.from_numpy(vol), k).numpy()
    assert got.shape == want.shape == (n, n, n, 1)
    assert np.allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_in,n_out", [(16, 32), (32, 16), (20, 8)])
def test_resize_volume_matches_jax(n_in, n_out):
    vol = _volume(n_in, 2)
    want = np.asarray(J3.resize_volume(jnp.asarray(vol), n_out))
    got = c3.resize_volume(torch.from_numpy(vol), n_out).numpy()
    assert got.shape == want.shape == (n_out,) * 3 + (1,)
    assert np.abs(got - want).max() <= 4.8e-7


def _jax_prior(voxels, prior):
    """examples/config3_mcm256.py:408-433, the prior term of loss_fn."""
    v = voxels[..., 0]
    if prior == "tv":
        pen = sum(jnp.mean((jnp.roll(v, -1, a_) - v) ** 2)
                  for a_ in range(3))
    else:
        if prior in ("logcurv", "loglap"):
            v = jnp.log(jnp.maximum(v, 0.01))
        lap = sum(jnp.roll(v, -1, a_) + jnp.roll(v, 1, a_)
                  - 2.0 * v for a_ in range(3))
        if prior in ("lap", "loglap"):
            pen = jnp.mean(lap ** 2)
        else:
            pen = sum(jnp.mean((jnp.roll(lap, -1, a_) - lap) ** 2)
                      for a_ in range(3))
    return pen


@pytest.mark.parametrize("prior", ["tv", "curv", "logcurv", "lap", "loglap"])
def test_priors_match_jax(prior):
    """Each prior within 1e-6 relative of JAX's formula evaluated in
    float64 (``jax.enable_x64``) on the same grid (measured: at most
    6.8e-8), and within 2e-6 relative of JAX's float32 value, whose mean
    of 4096 terms in XLA's order lies up to 1.1e-6 (``loglap``) from the
    float64 value on this grid (measured: at most 1.2e-6)."""
    vol = _volume(16, 3)
    vol[vol < 0.2] = 0.0           # empty space, below logcurv's clamp
    want = float(_jax_prior(jnp.asarray(vol), prior))
    with jax.enable_x64(True):
        exact = _jax_prior(jnp.asarray(vol.astype(np.float64)), prior)
        assert exact.dtype == jnp.float64
        exact = float(exact)
    got = float(c3.prior_penalty(torch.from_numpy(vol), prior))
    assert want > 0.0
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)
    assert abs(got - want) <= 2e-6 * want, (got, want)


def test_pyramid_matches_jax():
    """examples/config3_mcm256.py:515-526 at a 64³ final grid (levels 32
    and 64): the coefficients and the composed volume."""
    final_n = 64
    vol = jnp.asarray(_volume(final_n, 4))
    levels = []
    lv = 32 if final_n >= 32 else final_n
    while lv <= final_n:
        levels.append(lv)
        lv *= 2
    downs = {lv: J3.resize_volume(vol, lv) for lv in levels}
    theta = {}
    for i, lv in enumerate(levels):
        theta[f"l{lv:04d}"] = (
            downs[lv] if i == 0
            else downs[lv] - J3.resize_volume(downs[levels[i - 1]], lv))
    composed = jnp.clip(sum(J3.resize_volume(c, final_n)
                            for c in theta.values()), 0.0, 1.0)

    assert c3.pyramid_levels(final_n) == levels == [32, 64]
    assert c3.pyramid_levels(16) == [16]
    tvol = torch.from_numpy(np.asarray(vol))
    ttheta = c3.pyramid_decompose(tvol, levels)
    assert sorted(ttheta) == sorted(theta)
    for key in theta:
        assert _rel_close(ttheta[key].numpy(), theta[key], 1e-6), key
    got = c3.pyramid_compose(ttheta, final_n).numpy()
    assert _rel_close(got, composed, 1e-6)


def test_orbit_cameras_match_jax():
    yaws = np.arange(10) * 36.0
    jcams = J3.orbit_cameras(yaws, (0.25, -0.35))
    tcams = c3.orbit_cameras(yaws, (0.25, -0.35))
    assert len(tcams) == len(jcams) == 10
    for j, t in zip(jcams, tcams):
        for name in ("mvp_inverse", "model_view", "projection"):
            assert np.allclose(getattr(t, name).numpy(),
                               np.asarray(getattr(j, name)), rtol=1e-6,
                               atol=1e-6), name


@pytest.mark.parametrize("lr0,steps", [(3e-3, 300), (1.5e-3, 200),
                                       (8e-4, 150), (5e-4, 160), (3e-3, 6),
                                       (1e-3, 6)])
def test_cosine_lr_matches_optax(lr0, steps):
    """The learning rate of each Adam step, as ``optax.adam(sched)``
    evaluates ``sched`` (on its int32 step count, outside jit as the JAX
    recipe's update runs)."""
    sched = optax.cosine_decay_schedule(lr0, steps, alpha=0.05)
    for s in range(steps):
        want = float(np.asarray(sched(jnp.asarray(s, jnp.int32))))
        got = c3.cosine_lr(lr0, steps, s)
        assert abs(got - want) <= 1e-7 * want, (s, got, want)


@pytest.mark.parametrize("n_fit,fit_ids,steps", [
    (32, list(range(10)), 300), (256, [0, 1, 2, 4, 5, 6, 8, 9], 160),
    (16, [0, 1, 2], 6)])
def test_view_order_matches_jax(n_fit, fit_ids, steps):
    """examples/config3_mcm256.py:541-546."""
    order = np.random.default_rng(n_fit).permutation
    want = np.concatenate([np.asarray(fit_ids)[order(len(fit_ids))]
                           for _ in range(steps // len(fit_ids) + 1)])
    got = c3.view_order(n_fit, fit_ids, steps)
    assert np.array_equal(got, want)
    assert len(got) >= steps


def test_stage1_loss_and_gradient_match_jax():
    """examples/config3_mcm256.py:381-435's loss (the fold packing, the
    A/B split, the lap prior) at a 16³ stage of 16² images, 2 frames,
    both extinctions, on one camera's matrices."""
    n, res, frames, exts, prior_w = 16, 16, 2, (25.0, 5.0), 30.0
    # the recipe's init: blobs (seed 3, 6 blobs), box-blurred, dimmed
    truth = jvolume.blobs_volume(n, seed=3, count=6).data
    voxels = np.array(jnp.clip(0.55 * J3.box_blur(truth, 13), 0.0, 1.0))
    r = np.random.default_rng(6)
    tgts = [r.uniform(0, 0.5, (res, res, 3)).astype(np.float32)
            for _ in exts]
    cam = J3.orbit_cameras([36.0], (0.25,))[0]
    params = jmcm.Params(extinction=25.0, anisotropy=0.2, steps=8)
    seed0 = 0.31 * 1 + 1000.0 * n
    jtmpl = jmake_scene(jnp.asarray(voxels), jtransfer.gray_ramp(
        alpha_scale=0.9), camera=cam, pack=False)

    def jloss(vox):
        fold = jsampling.scatter_fold_log2(
            vox.shape[0] * vox.shape[1] * vox.shape[2], 8 * vox.shape[3],
            vox.shape[2])
        packed = jsampling.pack_corner_volume(vox, fold)
        sc = dataclasses.replace(
            jtmpl, volume=vox, volume_packed=packed,
            transfer_packed=jsampling.pack_corner_texture2d(jtmpl.transfer),
            fused_vjp=True)
        loss = 0.0
        s0 = jnp.float32(seed0)
        for ext, tgt in zip(exts, tgts):
            p_ext = dataclasses.replace(params, extinction=ext)
            a = jdiff.mcm_expected_image(sc, p_ext, res, res, frames,
                                         seed0=s0 + ext)
            b = jdiff.mcm_expected_image(sc, p_ext, res, res, frames,
                                         seed0=s0 + ext + 131.9)
            loss = loss + jnp.mean((a - tgt) * (b - tgt))
        return loss + prior_w * _jax_prior(vox, "lap")

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(voxels))

    tcam = CameraState(*(torch.from_numpy(np.array(getattr(cam, k)))
                         for k in ("mvp_inverse", "model_view",
                                   "projection")))
    ttmpl = make_scene(torch.from_numpy(voxels), ttransfer.gray_ramp(
        alpha_scale=0.9, device="cpu"), camera=tcam, pack=False,
        device="cpu")
    vox = torch.from_numpy(voxels).requires_grad_(True)
    loss = c3.loss_fn(vox, ttmpl, [torch.from_numpy(t) for t in tgts],
                      seed0, frames, exts, prior_w, c3._base_params(), res,
                      "lap")
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl)), (
        loss.item(), float(jl))
    got, want = vox.grad.numpy(), np.asarray(jg)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_recipe_runs_to_its_summary(tmp_path, capsys):
    """The recipe's own code on tiny stages (8³ then 16³ with both
    extinctions), 8² images, 3 views, ``--inpaint``: the JSON summary line
    last, the gallery written, the cache read back on a second run."""
    out, cache = tmp_path / "g.png", tmp_path / "c.npz"
    argv = ["--platform", "cpu", "--inpaint", "--out", str(out), "--cache",
            str(cache)]
    stages = [(8, 2, 1, 3e-3, False), (16, 2, 1, 1e-3, True)]
    args = c3.build_parser().parse_args(argv)
    summary = c3.run(args, stages, n=16, res=8, min_spp=4, n_views=3)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == summary
    assert summary["config"] == "mcm/16^3/8^2/3views/4spp/c2f/ext25,5"
    assert np.isfinite([summary["image_mse_first"],
                        summary["voxel_mse_fitted"],
                        summary["voxel_mse_inpaint"]]).all()
    assert 0.0 <= summary["inpaint_filled_frac"] <= 1.0
    assert out.exists() and cache.exists()
    args = c3.build_parser().parse_args(argv)
    again = c3.run(args, stages, n=16, res=8, min_spp=4, n_views=3)
    said = capsys.readouterr().out
    assert "cache hit" in said and "prefit cache hit" in said
    assert again["config"] == summary["config"]


def test_defaults_write_under_build():
    args = c3.build_parser().parse_args([])
    assert args.out == "build/config3_torch_gallery.png"
    assert args.cache == "build/config3_torch_cache.npz"
    assert c3.sizes(False) == (256, 256, 2048, 10)
    assert c3.sizes(True) == (64, 64, 64, 4)
    assert [s[:2] for s in c3.stage_table(args, 256)] == [
        (32, 300), (64, 200), (128, 150), (256, 160)]
    quick = c3.build_parser().parse_args(["--quick", "--steps", "3"])
    assert c3.stage_table(quick, 64) == [(16, 6, 2, 3e-3, False),
                                         (64, 3, 2, 1e-3, True)]
