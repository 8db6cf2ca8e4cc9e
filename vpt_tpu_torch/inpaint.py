"""Occlusion-aware volume completion for inverse rendering.

Mirrors ``vpt_tpu/inpaint.py``.  After a multi-view fit, the voxels behind
optical depth >> 1 from every view are a gradient null space: radiance
does not constrain them.  This module detects that set from the fitted
volume and fills it with the biharmonic (Δ²u = 0) continuation of the
observed material, solved by conjugate gradients, in log space by default
(a Gaussian core is quadratic in log space, so its visible skirt rebuilds
it exactly).

- :func:`optical_depth_min6` / :func:`unobserved_mask`: the six-axis
  proxy of visibility (cumulative sums, no gathers);
- :func:`optical_depth_views`: the optical depth along the actual capture
  rays from each camera centre (:func:`camera_position`), min over views,
  sampled through ``sampling.volume_rg``; all z planes of a chunk in one
  batched fetch;
- :func:`select_tau_blind`: the threshold chosen by held-out
  reprojection, without ground truth;
- :func:`biharmonic_fill`: coarse-to-fine CG on the masked voxels;
- :func:`complete_occluded`: mask and fill in one call.

Resampling between pyramid levels and compute grids is :func:`resize`,
the port's separable form of ``jax.image.resize(..., "trilinear")``: a
triangle kernel widened by 1/scale when it downsamples (antialiased), its
weights renormalised at the edges.  Nothing here is a kernel of its own:
every operation is a PyTorch operation on the volume's device.

The proxy's default threshold (tau = 0.15 in :func:`complete_occluded`)
is ``vpt_tpu``'s, kept as it is there (ROADMAP.md queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from . import math3d as m4
from . import sampling

__all__ = ["optical_depth_min6", "optical_depth_views", "unobserved_mask",
           "biharmonic_fill", "complete_occluded", "camera_position",
           "select_tau_blind", "resize"]


def _density(volume):
    return volume[..., 0] if volume.dim() == 4 else volume


# -- the resize of jax.image.resize(..., "trilinear") -----------------------

def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) float32 weights of one axis of
    ``jax.image.resize(..., "trilinear")`` (``compute_weight_mat`` with
    antialias, scale n_out/n_in, no translation), in its operations:
    1/scale in float64 rounded to float32, then in float32 the sample
    points ``(j + 0.5)/scale − 0.5``, the triangle
    kernel ``max(0, 1 − |x|)`` at distance ``|s − i| / max(1/scale, 1)``,
    each column divided by its sum, and columns whose point lies outside
    the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))     # in float64, then rounded
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize(x, shape):
    """``jax.image.resize(x, shape, "trilinear")`` of a float32 tensor: one
    weight matrix (:func:`resize_weights`) contracted per axis whose size
    changes, in float32 (TF32 off)."""
    m4._exact_float32()
    x = x.to(torch.float32)
    for axis, n_out in enumerate(shape):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = torch.from_numpy(resize_weights(n_in, n_out)).to(x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1,
                          axis)
    return x.contiguous()


# -- visibility ------------------------------------------------------------

def optical_depth_min6(volume, extinction: float):
    """Min over the six axis directions of the accumulated optical depth
    from the volume boundary to each voxel (exclusive of the voxel).

    The volume spans the unit cube, so the per-step length is 1/n per
    axis.  Exact for axis-aligned rays; a conservative proxy for the
    best orbit view."""
    rho = _density(volume)
    od = None
    for axis in range(3):
        h = float(np.float32(extinction / rho.shape[axis]))
        cs = torch.cumsum(rho, dim=axis) * h
        fwd = cs - rho * h           # exclusive prefix: depth *to* the voxel
        rev = cs.narrow(axis, rho.shape[axis] - 1, 1) - cs   # suffix
        for d in (fwd, rev):
            od = d if od is None else torch.minimum(od, d)
    return od


def unobserved_mask(volume, extinction: float, tau: float = 3.0):
    """Voxels whose best axis-aligned view exceeds optical depth ``tau``
    (transmittance < e^-tau): the data null space to complete."""
    return optical_depth_min6(volume, extinction) > tau


def camera_position(model_view):
    """Camera center in normalized texture space: the origin of camera
    space mapped back through inv(V·M·center).  All capture rays of a
    pinhole view pass through this point."""
    return m4.transform_point(m4.invert(model_view),
                              torch.zeros(3, dtype=torch.float32))


def _centers(n, device):
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    return i / torch.full_like(i, n)


def optical_depth_views(volume, extinction, camera_positions,
                        n_steps: int = 64, grid: int | None = 128,
                        chunk: int = 8):
    """Min over the actual capture views of the accumulated optical depth
    from the cube boundary to each voxel: the view-aware visibility field.

    For each voxel center p and camera center o (``camera_positions``,
    (V, 3) in texture space, :func:`camera_position`), integrates
    ``extinction · ρ`` along the segment from the cube entry of the ray
    o→p to p (midpoint rule, ``n_steps`` samples, exclusive of p).

    ``grid``: compute at this resolution (the volume resized down, the
    result resized up); None = native.  ``chunk``: z planes sampled in one
    batched fetch (memory bound)."""
    rho = _density(volume)
    dev = rho.device
    d, h, w = rho.shape
    cams = torch.as_tensor(camera_positions, dtype=torch.float32).to(dev)
    if cams.dim() == 1:
        cams = cams[None]
    if grid is None:
        gd, gh, gw = d, h, w
    else:
        scale = min(1.0, grid / max(d, h, w))
        gd, gh, gw = (max(1, round(d * scale)), max(1, round(h * scale)),
                      max(1, round(w * scale)))
    rho_g = rho if (gd, gh, gw) == (d, h, w) else resize(rho, (gd, gh, gw))
    rho4 = rho_g[..., None]

    zs_all = _centers(gd, dev)
    yy, xx = torch.meshgrid(_centers(gh, dev), _centers(gw, dev),
                            indexing="ij")
    ext = float(np.float32(extinction))
    mid = torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5

    def planes_od(zs, cam):
        """(len(zs), gh, gw) optical depth of the planes at ``zs``."""
        nz = zs.shape[0]
        pts = torch.stack([xx.expand(nz, gh, gw), yy.expand(nz, gh, gw),
                           zs[:, None, None].expand(nz, gh, gw)],
                          dim=-1).reshape(-1, 3)
        dvec = pts - cam
        tb = sampling.intersect_cube(cam.expand(pts.shape), dvec)
        t0 = torch.clamp(tb[..., 0], 0.0, 1.0)
        dt = (1.0 - t0) / torch.full_like(t0, n_steps)
        ts = t0[:, None] + mid[None, :] * dt[:, None]
        x = cam + ts[..., None] * dvec[:, None, :]
        dens = sampling.volume_rg(rho4, x, "linear")[..., 0]
        seg = torch.sqrt(torch.sum(dvec * dvec, dim=-1)) * dt
        return (ext * torch.sum(dens, dim=1) * seg).reshape(nz, gh, gw)

    out = []
    for z0 in range(0, gd, chunk):
        zs = zs_all[z0:z0 + chunk]
        planes = None
        for cam in cams:
            od = planes_od(zs, cam)
            planes = od if planes is None else torch.minimum(planes, od)
        out.append(planes)
    od_g = torch.cat(out, dim=0)
    if (gd, gh, gw) != (d, h, w):
        od_g = resize(od_g, (d, h, w))
    return od_g


# -- the fill --------------------------------------------------------------

def select_tau_blind(volume, taus, heldout_targets, render_views_fn,
                     depth=None, extinction=None, slack: float = 0.02,
                     slack_abs: float = 0.0, **fill_kwargs):
    """Choose the completion threshold without ground truth: for each
    candidate tau, complete the volume and re-render held-out capture
    views (views the fit never saw).  Held-out reprojection can only veto:
    the choice is the largest filled fraction whose held-out MSE stays
    within ``floor·(1 + slack) + slack_abs`` of the best row (the no-fill
    row included).

    ``render_views_fn(volume) -> (V, H, W, C) or list``: renders the
    held-out views; ``heldout_targets``: their captured images;
    ``depth``: a visibility field (:func:`optical_depth_views` of the fit
    views), else the six-axis proxy at ``extinction``.

    Returns ``(best_tau, completed, table)``; ``best_tau`` is None (and
    ``completed`` the untouched fit) when every fill hurts."""
    v = _density(volume)
    if depth is None:
        if extinction is None:
            raise ValueError("need depth or extinction")
        depth = optical_depth_min6(v, extinction)

    def as_stack(x):
        if isinstance(x, (list, tuple)):
            return torch.stack([torch.as_tensor(p) for p in x])
        return torch.as_tensor(x)

    tgt = as_stack(heldout_targets).to(v.device)

    def score(vol):
        pred = as_stack(render_views_fn(vol))
        return float(torch.mean((pred[..., :3] - tgt[..., :3]) ** 2))

    # the first pass scores every candidate without keeping its volume;
    # the winner is filled again once
    table = [{"tau": None, "filled_frac": 0.0, "heldout_mse": score(v)}]
    for tau in taus:
        mask = depth > tau
        filled = biharmonic_fill(v, mask, **fill_kwargs)
        table.append({"tau": float(tau),
                      "filled_frac": float(mask.to(torch.float32).mean()),
                      "heldout_mse": score(filled)})
        del filled
    floor = min(r["heldout_mse"] for r in table)
    admissible = [r for r in table
                  if r["heldout_mse"] <= floor * (1.0 + slack) + slack_abs]
    best = max(admissible, key=lambda r: r["filled_frac"])
    if best["tau"] is None:
        completed = v
    else:
        completed = biharmonic_fill(v, depth > best["tau"], **fill_kwargs)
    completed = completed[..., None] if volume.dim() == 4 else completed
    return best["tau"], completed, table


def _lap(u):
    out = 0
    for a in range(3):
        out = out + (torch.roll(u, -1, a) + torch.roll(u, 1, a) - 2.0 * u)
    return out


def _cg_fill(u0, mask, iters: int):
    """CG on J(x) = sum(lap(u)²), u = where(mask, x, u0): quadratic and SPD
    on the mask subspace.  A fixed iteration count, every scalar on the
    device (no host sync in the loop)."""
    mask = mask.to(u0.dtype)

    def matvec(x):
        return mask * _lap(_lap(x * mask))

    def vdot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    b = -mask * _lap(_lap(u0 * (1.0 - mask)))
    x = u0 * mask
    r = b - matvec(x)
    p = r
    rs = vdot(r, r)
    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)
    for _ in range(iters):
        ap = matvec(p)
        denom = vdot(p, ap)
        alpha = torch.where(denom > 0, rs / torch.clamp(denom, min=1e-30),
                            zero)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = vdot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
    return u0 * (1.0 - mask) + x * mask


def biharmonic_fill(volume, mask, log_space: bool = True,
                    floor: float = 0.01, coarsest: int = 32,
                    cg_iters: int = 200, clip: bool = True):
    """Fill ``mask`` voxels with the biharmonic (Δ²u = 0) continuation of
    the unmasked data, coarse-to-fine from ``coarsest`` with CG at every
    level.  ``log_space`` solves on log(max(v, floor)), then exponentiates
    the filled region."""
    v = _density(volume)
    u = torch.log(torch.clamp(v, min=floor)) if log_space else v
    n = v.shape[0]
    levels = []
    lv = min(coarsest, n)
    while lv < n:
        levels.append(lv)
        lv *= 2
    levels.append(n)

    filled = None
    for lv in levels:
        ul = u if lv == n else resize(u, (lv,) * 3)
        ml = mask if lv == n else resize(mask.to(torch.float32),
                                         (lv,) * 3) > 0.5
        if filled is not None:
            up = resize(filled, (lv,) * 3)
            ul = torch.where(ml, up, ul)   # carry the coarse fill down
        filled = _cg_fill(ul, ml, cg_iters)
    out = torch.where(mask, torch.exp(filled) if log_space else filled, v)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out[..., None] if volume.dim() == 4 else out


def complete_occluded(volume, extinction: float = None, tau: float = None,
                      depth=None, **fill_kwargs):
    """Detect the unobserved set of ``volume`` and fill it with the
    log-domain biharmonic continuation of the observed material.
    Returns ``(completed_volume, mask)``.

    ``depth``: a visibility field (:func:`optical_depth_views` of the
    capture cameras; default tau 1.0: transmittance < e⁻¹ from every
    view).  Without it, the six-axis proxy at ``extinction``, with default
    tau 0.15, ``vpt_tpu``'s (ROADMAP.md queue 3)."""
    if depth is None:
        if extinction is None:
            raise ValueError("need depth or extinction")
        depth = optical_depth_min6(volume, extinction)
        tau = 0.15 if tau is None else tau
    else:
        tau = 1.0 if tau is None else tau
    mask = depth > tau
    return biharmonic_fill(volume, mask, **fill_kwargs), mask
