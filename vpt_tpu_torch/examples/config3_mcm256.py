"""BASELINE config 3, end to end, on the port: MCM multiple scattering on a
256³ volume, voxel-density gradients, ≥1024 spp accumulated targets,
recover a perturbed volume coarse to fine over 10 orbit views.

Mirrors ``examples/config3_mcm256.py`` (every flag, message and the final
JSON summary line) with PyTorch inside:

1. Ground truth: 256³ Gaussian-blobs volume (``volume.blobs_volume``).
2. Targets: MCM progressive renders (``mcm.render_frame``: the event
   kernel K5 on the card, bf16 tables and ``tf_mxu``) from 10 orbit views
   (alternating pitch, full yaw circle), accumulated until the mean
   samples/pixel reach ``min_spp``.
3. Perturbation: truth box-blurred (13³) and dimmed 0.55×.
4. Recovery: per-stage Adam on the raw voxel grid through the detached-
   decision MC estimator (``diff_mc.mcm_expected_image``) on the fits'
   differentiable scene (``renderers.base.fit_scene``: the corner tables
   packed in the graph, every fetch K3 forward and K4 backward), A/B-split
   loss, one randomly cycled view per step, optional priors, coarse to
   fine (32³ → 64³ → 128³ → 256³, trilinear ``inpaint.resize``
   between stages) with a dual-extinction final stage; optionally the
   Gaussian pyramid parametrisation of the final stage.
5. Completion (``--inpaint`` / ``--inpaint-blind``) with ``inpaint``.
6. Artifacts: loss curve and voxel-MSE numbers on stdout (and JSON), a
   target/init/fitted gallery PNG of three views.

``optax.adam(optax.cosine_decay_schedule(lr0, steps, alpha=0.05))``
becomes ``torch.optim.Adam`` (the same defaults) whose learning rate is
set before each step to :func:`cosine_lr`, the schedule's float32 value.
``vpt_tpu``'s scatter fold (``sampling.scatter_fold_log2``) and
``--fused-vjp`` are TPU layouts of the same fetch backward: the flags are
accepted, and the backward is K4 whatever they say.

Outputs go under ``build/`` (git-ignored) by default: the gallery
``build/config3_torch_gallery.png`` and the cache
``build/config3_torch_cache.npz``, whose key names this package, so a
``vpt_tpu`` cache is never read as the port's.

Run (the card):  python -m vpt_tpu_torch.examples.config3_mcm256
Quick CPU check: python -m vpt_tpu_torch.examples.config3_mcm256 \\
    --platform cpu --quick

:func:`main` parses the flags and picks the sizes and the stage table
(:func:`sizes`, :func:`stage_table`); :func:`run` takes them, so a caller
can run the recipe's own code with other stages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch

from .. import inpaint
from ..renderers import diff_mc, make_scene
from ..renderers import mcm as mcm_mod
from ..renderers.base import fit_scene

_f32 = np.float32


def box_blur(vol, k: int):
    """Separable k³ mean filter with edge padding (the perturbation): the
    k window sums taken in window order, then divided by k (a tensor: the
    true quotient on the card), one axis at a time."""
    v = vol[..., 0]
    for axis in range(3):
        n = v.shape[axis]
        first = v.narrow(axis, 0, 1)
        last = v.narrow(axis, n - 1, 1)
        vp = torch.cat([first] * (k // 2) + [v] + [last] * (k // 2),
                       dim=axis)
        acc = torch.zeros_like(v)
        for i in range(k):
            acc = acc + vp.narrow(axis, i, n)
        v = acc / torch.full_like(acc, k)
    return v[..., None]


def _base_params():
    return mcm_mod.Params(extinction=25.0, anisotropy=0.2, steps=8)


def orbit_cameras(yaws_deg, pitches=None):
    """One ``CameraState`` per yaw (degrees), the orbit's pitch cycling
    through ``pitches`` (radians)."""
    from ..runtime.animators import OrbitCameraAnimator
    from ..scene import CameraState, default_camera

    out = []
    for i, yaw in enumerate(yaws_deg):
        cam = default_camera()
        orbit = OrbitCameraAnimator(cam)
        orbit.yaw = math.radians(yaw)
        if pitches is not None:
            orbit.pitch = pitches[i % len(pitches)]
        orbit._update_camera()
        out.append(CameraState.from_nodes(cam))
    return out


def resize_volume(vol, n):
    """Trilinear resample of a (D, H, W, C) grid to (n, n, n, C)
    (``jax.image.resize(..., "trilinear")``, :func:`inpaint.resize`)."""
    return inpaint.resize(vol, (n, n, n, vol.shape[-1]))


def render_target(vol, tf, cam, params, res, min_spp, label):
    """Progressive analog MCM on ``vol``'s device until the mean
    samples/pixel reach ``min_spp``, 64 frames between checks; returns the
    (res, res, 3) radiance."""
    scene = make_scene(vol, tf, camera=cam, pack_dtype=torch.bfloat16,
                       tf_mxu=True, device=vol.device)
    state = mcm_mod.reset(params, res, res, scene)
    i, spp = 0, 0.0
    t0 = time.perf_counter()
    while spp < min_spp:
        for _ in range(64):
            i += 1
            state = mcm_mod.render_frame(state, scene, params,
                                         _f32(0.1 + 0.003 * i), i)
        spp = float(torch.mean(state["samples"]))
    dt = time.perf_counter() - t0
    print(f"  {label}: {spp:.0f} spp in {i} frames, {dt:.1f}s "
          f"({res * res * params.steps * i / dt / 1e6:.1f}M events/s)")
    return state["radiance"]


def cosine_lr(lr0: float, steps: int, step: int, alpha: float = 0.05):
    """``optax.cosine_decay_schedule(lr0, steps, alpha)(step)`` in its
    float32 arithmetic (the cosine rounded from float64)."""
    count = _f32(min(step, steps))
    arg = _f32(np.pi) * count / _f32(steps)
    cosine = _f32(0.5) * (_f32(1.0) + _f32(np.cos(np.float64(arg))))
    return float(_f32(lr0) * (_f32(1 - alpha) * cosine + _f32(alpha)))


def prior_penalty(voxels, prior: str):
    """The conditioning priors on a (D, H, W, 1) grid (``--prior``):
    'tv' squared forward differences; 'curv' squared gradient of the
    Laplacian; 'lap' mean squared Laplacian; 'logcurv'/'loglap' the same
    on log(max(v, 0.01)).  Periodic differences (``roll``)."""
    v = voxels[..., 0]
    if prior == "tv":
        # H1 smoothness: squared forward differences
        return sum(torch.mean((torch.roll(v, -1, a) - v) ** 2)
                   for a in range(3))
    # 'curv': zero on any quadratic field, so it extrapolates the data-
    # constrained shell into the occluded cores; 'logcurv' the same in log
    # space, where a Gaussian blob is quadratic; 'lap'/'loglap' one order
    # softer (the biharmonic mean(lap²))
    if prior in ("logcurv", "loglap"):
        v = torch.log(torch.clamp(v, min=0.01))
    lap = sum(torch.roll(v, -1, a) + torch.roll(v, 1, a) - 2.0 * v
              for a in range(3))
    if prior in ("lap", "loglap"):
        return torch.mean(lap ** 2)
    return sum(torch.mean((torch.roll(lap, -1, a) - lap) ** 2)
               for a in range(3))


def loss_fn(voxels, scene_tmpl, tgts, seed0, grad_frames, use_exts,
            prior_w, params, res, prior="none"):
    """One view's A/B-split loss ``Σ_ext mean((A − t)(B − t))`` over two
    independent estimates A, B (seeds ``seed0 + ext`` and ``seed0 + ext +
    131.9`` in float32) at each extinction of ``use_exts``, plus
    ``prior_w`` times :func:`prior_penalty`.  The scene is
    ``fit_scene(scene_tmpl, voxels)``: gradients reach ``voxels`` through
    K3 and K4."""
    sc = fit_scene(scene_tmpl, volume=voxels)
    seed0 = _f32(seed0)
    loss = 0.0
    for ext, tgt in zip(use_exts, tgts):
        p_ext = dataclasses.replace(params, extinction=ext)
        seed_a = _f32(seed0 + _f32(ext))
        a = diff_mc.mcm_expected_image(sc, p_ext, res, res, grad_frames,
                                       seed0=seed_a)
        b = diff_mc.mcm_expected_image(sc, p_ext, res, res, grad_frames,
                                       seed0=_f32(seed_a + _f32(131.9)))
        loss = loss + torch.mean((a - tgt) * (b - tgt))
    if prior_w > 0.0:
        loss = loss + prior_w * prior_penalty(voxels, prior)
    return loss


def pyramid_levels(final_n: int):
    """{32, 64, ..., final_n} (only final_n when it is below 32)."""
    levels = []
    lv = 32 if final_n >= 32 else final_n
    while lv <= final_n:
        levels.append(lv)
        lv *= 2
    return levels


def pyramid_decompose(vol, levels):
    """Telescoping decomposition: the level-l coefficients are the residual
    of level l/2's upsampling, so the composed volume ≈ ``vol``."""
    downs = {lv: resize_volume(vol, lv) for lv in levels}
    theta = {}
    for i, lv in enumerate(levels):
        theta[f"l{lv:04d}"] = (
            downs[lv] if i == 0
            else downs[lv] - resize_volume(downs[levels[i - 1]], lv))
    return theta


def pyramid_compose(theta, final_n):
    return torch.clamp(sum(resize_volume(c, final_n)
                           for c in theta.values()), 0.0, 1.0)


def view_order(n_fit: int, fit_ids, opt_steps: int):
    """The stage's view sequence: permutations of ``fit_ids`` from
    ``np.random.default_rng(n_fit)``, as many as cover ``opt_steps``."""
    order = np.random.default_rng(n_fit).permutation
    return np.concatenate(
        [np.asarray(fit_ids)[order(len(fit_ids))]
         for _ in range(opt_steps // len(fit_ids) + 1)])


def bucket_table(truth, fit_vol, label):
    """Voxel MSE by truth-density bucket (the null-space probe)."""
    edges = (0.0, 0.05, 0.3, 0.7, 1.0000001)
    t = truth[..., 0].cpu().numpy()
    fv = fit_vol[..., 0].cpu().numpy()
    rows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (t >= lo) & (t < hi)
        rows.append({"bucket": f"[{lo:g},{min(hi, 1.0):g})",
                     "frac": round(float(m.mean()), 4),
                     "mse": (float(np.mean((fv - t)[m] ** 2))
                             if m.any() else 0.0)})
    print(f"  {label} voxel MSE by truth bucket: "
          + "  ".join(f"{r['bucket']}={r['mse']:.2e}" for r in rows))
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m vpt_tpu_torch.examples.config3_mcm256",
        description="BASELINE config 3 on vpt_tpu_torch")
    ap.add_argument("--platform", default=None,
                    help="cpu: run on the CPU (default: the CUDA card)")
    ap.add_argument("--quick", action="store_true",
                    help="64^3 volume / 64^2 images / small budgets (CPU)")
    ap.add_argument("--out", default="build/config3_torch_gallery.png")
    ap.add_argument("--lr", type=float, default=None,
                    help="SGD lr base; per stage it scales as lr·(n/64) — "
                         "per-voxel gradient magnitude scales with events "
                         "per voxel")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the final stage's step count")
    ap.add_argument("--final-lr", type=float, default=None,
                    help="override the final stage's Adam lr0")
    ap.add_argument("--tv", type=float, default=0.0,
                    help="total-variation prior weight (optional; alias "
                         "for --prior tv --prior-w W)")
    ap.add_argument("--prior", default="none",
                    choices=("none", "tv", "curv", "logcurv", "lap",
                             "loglap"),
                    help="conditioning prior for the occluded-core null "
                         "space: 'tv' = squared forward differences (H1 "
                         "smoothness), 'curv' = squared gradient-of-"
                         "Laplacian (zero on quadratic caps), 'logcurv' = "
                         "the same penalty on log(max(v, 0.01)), 'lap' / "
                         "'loglap' = biharmonic mean(lap^2)")
    ap.add_argument("--prior-w", type=float, default=0.0,
                    help="prior weight (on the stage mean penalty, at the "
                         "native grid; coarser stages are rescaled by "
                         "--prior-scale-pow)")
    ap.add_argument("--prior-from", type=int, default=256,
                    help="apply the prior at stages with grid >= this "
                         "(default: native resolution only)")
    ap.add_argument("--prior-scale-pow", type=float, default=6.0,
                    help="per-stage weight = w * (n/256)^pow")
    ap.add_argument("--param", default="raw", choices=("raw", "pyramid"),
                    help="final-stage parametrization: 'pyramid' "
                         "optimizes a Gaussian-pyramid decomposition "
                         "{32, 64, 128, 256} jointly")
    ap.add_argument("--save-fit", default="",
                    help="save the fitted 256^3 volume (npz) for "
                         "forensics")
    ap.add_argument("--inpaint", action="store_true",
                    help="after the fit, complete the optically occluded "
                         "null space with vpt_tpu_torch.inpaint (6-axis "
                         "visibility mask at the primary extinction + "
                         "log-domain biharmonic CG solve)")
    ap.add_argument("--inpaint-tau", type=float, default=0.15,
                    help="visibility threshold: optical depth above which "
                         "a voxel counts as unobserved (vpt_tpu's "
                         "default)")
    ap.add_argument("--inpaint-blind", action="store_true",
                    help="truth-free completion protocol: fit WITHOUT the "
                         "--heldout views, compute the view-aware "
                         "visibility field along the fit-view capture "
                         "rays (--blind-ext; default the primary "
                         "extinction), and choose tau by held-out-view "
                         "reprojection (inpaint.select_tau_blind)")
    ap.add_argument("--heldout", default="3,7",
                    help="view indices withheld from the fit and used "
                         "for blind tau selection (--inpaint-blind)")
    ap.add_argument("--blind-taus", default="0.05,0.1,0.15,0.25,0.5,1.0",
                    help="candidate thresholds for the blind sweep")
    ap.add_argument("--blind-ext", type=float, default=None,
                    help="extinction for the view-aware visibility "
                         "field (default: the primary capture extinction)")
    ap.add_argument("--cache", default="build/config3_torch_cache.npz",
                    help="cache file for the rendered targets AND the "
                         "pre-final-stage fit; '' disables")
    ap.add_argument("--fused-vjp", action="store_true", default=True,
                    help="accepted for vpt_tpu's command lines: the "
                         "fetch backward is K4 either way")
    ap.add_argument("--no-fused-vjp", dest="fused_vjp",
                    action="store_false")
    ap.add_argument("--exts", default="25,5",
                    help="comma-separated target extinctions; the first "
                         "is primary (gallery/params), later ones are the "
                         "low-extinction capture that penetrates occluded "
                         "cores (fine stages only)")
    return ap


def sizes(quick: bool):
    """(volume n, image res, target spp, views) of the full run or of
    ``--quick``."""
    return (64, 64, 64, 4) if quick else (256, 256, 2048, 10)


def stage_table(args, n: int):
    """The coarse-to-fine schedule: (grid, steps, grad frames, Adam lr0,
    dual extinction) a stage.  Coarse and mid stages fit the primary
    extinction only (a coarse transport model biases the low-extinction
    images' optimum); the aux extinction joins at the native grid."""
    if args.quick:
        return [(16, 6, 2, 3e-3, False), (n, args.steps or 6, 2, 1e-3,
                                          True)]
    return [(32, 300, 16, 3e-3, False),
            (64, 200, 8, 1.5e-3, False),
            (128, 150, 6, 8e-4, False),
            (256, args.steps or 160, 4, 5e-4, True)]


def run(args, stages, n: int, res: int, min_spp: int, n_views: int):
    """The recipe: targets, perturbation, the stages' fits, the completion,
    the gallery and the JSON summary line (printed and returned)."""
    from .. import tonemap, transfer, volume
    from ..cli import _device
    from ..io.image import write_png

    dev = _device(args)
    if args.tv > 0.0 and args.prior == "none":
        args.prior, args.prior_w = "tv", args.tv
    exts = tuple(float(x) for x in args.exts.split(","))

    truth = volume.blobs_volume(n, seed=3, count=6, device=dev).data
    tf = transfer.gray_ramp(alpha_scale=0.9, device=dev)
    pitches = (0.25, -0.35)
    cams = orbit_cameras(np.arange(n_views) * (360.0 / n_views), pitches)

    held_ids = tuple(int(x) for x in args.heldout.split(",")) \
        if args.inpaint_blind else ()
    if any(i >= n_views for i in held_ids):
        raise SystemExit(f"--heldout {held_ids} out of range ({n_views})")
    fit_ids = [i for i in range(n_views) if i not in held_ids]

    print(f"config 3: {n}^3 volume, {res}^2 images, {n_views} views, "
          f"extinctions {exts}, >= {min_spp} spp targets, stages {stages}, "
          f"prior {args.prior}/{args.prior_w:g} from {args.prior_from}^3")
    t_all = time.perf_counter()

    # -- target / pre-final-stage cache --------------------------------
    cache_key = (f"vpt_tpu_torch:n{n}res{res}spp{min_spp}v{n_views}exts"
                 f"{args.exts}stages{stages[:-1]}lr{args.lr}")
    cache = {}
    if args.cache and pathlib.Path(args.cache).exists():
        with np.load(args.cache, allow_pickle=False) as z:
            if str(z["key"]) == cache_key:
                cache = {k: torch.from_numpy(z[k]).to(dev)
                         for k in z.files if k != "key"}
                print(f"  cache hit: {args.cache} ({len(cache)} arrays)")
            else:
                print(f"  cache key mismatch — re-rendering ({args.cache})")

    tsets = {}
    for ext in exts:
        p_ext = dataclasses.replace(_base_params(), extinction=ext)
        tsets[ext] = [
            cache[f"t_e{ext:g}_v{i}"] if f"t_e{ext:g}_v{i}" in cache
            else render_target(truth, tf, cam, p_ext, res, min_spp,
                               f"target e{ext:g} v{i}")
            for i, cam in enumerate(cams)]
    params = dataclasses.replace(_base_params(), extinction=exts[0])
    targets = tsets[exts[0]]

    init = torch.clamp(0.55 * box_blur(truth, 13), 0.0, 1.0)
    voxel_mse0 = float(torch.mean((init - truth) ** 2))
    templates = [make_scene(truth, tf, camera=cam, pack=False, device=dev)
                 for cam in cams]
    tstack = {ext: torch.stack(tsets[ext]) for ext in exts}

    # the blind prefit depends on WHICH views were withheld
    prefit_key = (f"prefit_blind_h{args.heldout}" if args.inpaint_blind
                  else "prefit")

    def save_cache(prefit=None):
        if not args.cache:
            return
        data = {"key": cache_key}
        for ext in exts:
            for i in range(n_views):
                data[f"t_e{ext:g}_v{i}"] = tsets[ext][i].cpu().numpy()
        if prefit is not None:
            data[prefit_key] = prefit.cpu().numpy()
        elif prefit_key in cache:
            data[prefit_key] = cache[prefit_key].cpu().numpy()
        pathlib.Path(args.cache).parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.cache, **data)
        print(f"  cache saved: {args.cache}")

    save_cache()

    losses = []
    vol_fit = None
    final_n = stages[-1][0]
    # the coarse stages are identical across (prior, final-lr, steps)
    # settings when the prior only acts at the native grid
    coarse_cacheable = args.prior_from >= final_n or args.prior_w == 0.0
    skip_coarse = coarse_cacheable and prefit_key in cache
    if skip_coarse:
        vol_fit = cache[prefit_key]
        print(f"  prefit cache hit: skipping stages {stages[:-1]}")
    t_fit = time.perf_counter()
    for n_fit, opt_steps, grad_frames, lr0, dual in stages:
        if skip_coarse and n_fit != final_n:
            continue
        if n_fit == final_n and args.final_lr:
            lr0 = args.final_lr
        vol_fit = resize_volume(init if vol_fit is None else vol_fit,
                                n_fit)
        vol_fit = torch.clamp(vol_fit, 0.0, 1.0)
        use_exts = exts if (dual and len(exts) > 1) else exts[:1]
        prior_w = (args.prior_w * (n_fit / final_n) ** args.prior_scale_pow
                   if (args.prior != "none" and n_fit >= args.prior_from)
                   else 0.0)
        pyramid = args.param == "pyramid" and n_fit == final_n
        if pyramid:
            levels = pyramid_levels(final_n)
            theta = {k: c.requires_grad_(True) for k, c in
                     pyramid_decompose(vol_fit, levels).items()}
            with torch.no_grad():
                vol_fit = pyramid_compose(theta, final_n)
                mse = float(torch.mean((resize_volume(vol_fit, n) - truth)
                                       ** 2))
            print(f"  [pyramid] levels {levels}, composed-init voxel MSE "
                  f"{mse:.6f}")
            leaves = list(theta.values())
        else:
            vol_fit = vol_fit.detach().clone().requires_grad_(True)
            leaves = [vol_fit]
        optimizer = torch.optim.Adam(leaves, lr=cosine_lr(lr0, opt_steps, 0))
        view_seq = view_order(n_fit, fit_ids, opt_steps)
        t_stage = time.perf_counter()
        for s in range(opt_steps):
            vi = int(view_seq[s])
            tgts = tuple(tstack[ext][vi] for ext in use_exts)
            optimizer.zero_grad(set_to_none=True)
            voxels = pyramid_compose(theta, final_n) if pyramid else vol_fit
            loss = loss_fn(voxels, templates[vi], tgts,
                           0.31 * s + 1000.0 * n_fit, grad_frames, use_exts,
                           prior_w, params, res, args.prior)
            loss.backward()
            for group in optimizer.param_groups:
                group["lr"] = cosine_lr(lr0, opt_steps, s)
            optimizer.step()
            with torch.no_grad():
                if pyramid:
                    vol_fit = pyramid_compose(theta, final_n)
                else:
                    vol_fit.clamp_(0.0, 1.0)
            losses.append(loss.item())
            if s == 0 and not pyramid:
                # calibration: where does the total gradient act?
                tr = resize_volume(truth, n_fit)[..., 0].cpu().numpy()
                gg = vol_fit.grad[..., 0].cpu().numpy()
                rms = {tag: float(np.sqrt(np.mean(
                    gg[(tr >= lo) & (tr < hi)] ** 2)))
                    for lo, hi, tag in ((0.7, 1.01, "core"),
                                        (0.05, 0.7, "shell"),
                                        (0.0, 0.05, "empty"))}
                print("    grad RMS " + "  ".join(
                    f"{tag}={v:.2e}" for tag, v in rms.items()), flush=True)
            if s % 20 == 0 or s == opt_steps - 1:
                with torch.no_grad():
                    up = resize_volume(vol_fit, n)
                    mse = float(torch.mean((up - truth) ** 2))
                dual_tag = (f"x{len(use_exts)}ext" if len(use_exts) > 1
                            else "")
                print(f"  [{n_fit}^3{dual_tag}] step {s:4d}: A/B loss "
                      f"{losses[-1]:+.6f}  voxel MSE {mse:.6f}", flush=True)
        print(f"  [{n_fit}^3] stage done in "
              f"{time.perf_counter() - t_stage:.1f}s")
        vol_fit = vol_fit.detach()
        if n_fit != final_n and coarse_cacheable and not skip_coarse \
                and n_fit == stages[-2][0]:
            save_cache(prefit=vol_fit)
    fit_dt = time.perf_counter() - t_fit
    vol_fit = resize_volume(vol_fit, n)
    voxel_mse1 = float(torch.mean((vol_fit - truth) ** 2))
    bucket_table(truth, init, "init  ")
    buckets = bucket_table(truth, vol_fit, "fitted")
    if args.save_fit:
        np.savez(args.save_fit, fit=vol_fit.cpu().numpy())

    inpaint_fields = {}
    if args.inpaint_blind:
        t_inp = time.perf_counter()
        # view-aware visibility: optical depth along the fit views' capture
        # rays, at the primary capture extinction by default
        cam_pos = torch.stack([inpaint.camera_position(cams[i].model_view)
                               for i in fit_ids])
        blind_ext = args.blind_ext if args.blind_ext else exts[0]
        depth = inpaint.optical_depth_views(
            vol_fit[..., 0], blind_ext, cam_pos, n_steps=64,
            grid=min(n, 128))

        spp_eval = max(min_spp // 8, 64)

        def render_heldout(v):
            v4 = v[..., None]
            outs = []
            for ext in exts:
                p_ext = dataclasses.replace(_base_params(), extinction=ext)
                for i in held_ids:
                    outs.append(render_target(
                        v4, tf, cams[i], p_ext, res, spp_eval,
                        f"blind-eval e{ext:g} v{i}"))
            return outs

        held_targets = [tsets[ext][i] for ext in exts for i in held_ids]
        taus = tuple(float(t) for t in args.blind_taus.split(","))
        tau_blind, completed, table = inpaint.select_tau_blind(
            vol_fit[..., 0], taus, held_targets, render_heldout,
            depth=depth)
        vol_fit = torch.clamp(completed, 0.0, 1.0)[..., None]
        inpaint_fields = {
            "voxel_mse_inpaint_blind": float(
                torch.mean((vol_fit - truth) ** 2)),
            "inpaint_blind_ext": blind_ext,
            "inpaint_tau_blind": tau_blind,
            "inpaint_blind_table": table,
            "inpaint_seconds": round(time.perf_counter() - t_inp, 1),
            "heldout_views": list(held_ids),
        }
        print(f"  blind tau selection: {json.dumps(table)}")
        print(f"  chosen tau = {tau_blind} (truth untouched)")
        inpaint_fields["inpaint_buckets"] = bucket_table(
            truth, vol_fit, "blind-inpaint")
    elif args.inpaint:
        t_inp = time.perf_counter()
        filled, unseen = inpaint.complete_occluded(
            vol_fit[..., 0], extinction=exts[0], tau=args.inpaint_tau)
        vol_fit = torch.clamp(filled, 0.0, 1.0)[..., None]
        inpaint_fields = {
            "voxel_mse_inpaint": float(torch.mean((vol_fit - truth) ** 2)),
            "inpaint_filled_frac": round(
                float(unseen.to(torch.float32).mean()), 5),
            "inpaint_tau": args.inpaint_tau,
            "inpaint_seconds": round(time.perf_counter() - t_inp, 1),
        }
        inpaint_fields["inpaint_buckets"] = bucket_table(truth, vol_fit,
                                                         "inpaint")

    # gallery: rows = views, cols = target / init render / fitted render,
    # tone-mapped by ACES (the display kernel on the card)
    tm = tonemap.ToneMapper("aces")
    rows = []
    for vi, cam in list(enumerate(cams))[:3]:
        row = [targets[vi]]
        for v in (init, vol_fit):
            row.append(render_target(v, tf, cam, params, res,
                                     min_spp // 4, f"gallery v{vi}"))
        ones = torch.ones(row[0].shape[:-1] + (1,), dtype=torch.float32,
                          device=dev)
        rows.append(torch.cat(
            [torch.clamp(tm(torch.cat([r, ones], dim=-1)), 0, 1)[..., :3]
             for r in row], dim=1))
    gallery = torch.cat(rows, dim=0)
    write_png(args.out, torch.cat(
        [gallery, torch.ones(gallery.shape[:2] + (1,), dtype=torch.float32,
                             device=dev)], dim=-1))

    prior_tag = (f"+{args.prior}{args.prior_w:g}"
                 if args.prior != "none" and args.prior_w else "")
    if args.param != "raw":
        prior_tag += f"+{args.param}"
    summary = {
        "config": f"mcm/{n}^3/{res}^2/{n_views}views/{min_spp}spp/"
                  f"c2f/ext{args.exts}{prior_tag}",
        "image_mse_first": losses[0], "image_mse_last": losses[-1],
        "voxel_mse_init": voxel_mse0, "voxel_mse_fitted": voxel_mse1,
        "buckets": buckets,
        "fit_seconds": round(fit_dt, 1),
        "seconds_per_step": round(fit_dt / opt_steps, 2),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "gallery": args.out,
        **inpaint_fields,
    }
    print(json.dumps(summary))
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    n, res, min_spp, n_views = sizes(args.quick)
    return run(args, stage_table(args, n), n, res, min_spp, n_views)


if __name__ == "__main__":
    main()
