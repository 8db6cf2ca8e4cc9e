"""Ray/volume sampling primitives for the MCM slice.

Mirrors the main-path subset of ``vpt_tpu/sampling.py``: ray setup
(``pixel_ndc``, ``intersect_cube``, ``unproject_rand``), the GL LINEAR +
CLAMP_TO_EDGE volume and texture fetches with their corner-packed tables,
the equirect environment lookup and Henyey-Greenstein sampling.  Every
operation runs in the JAX package's order so that the float32 results
agree.

The TPU-only layouts are not ported: the scatter fold and two-level fold of
the corner table (a fix for a TPU scatter cliff) and the MXU one-hot TF
matmul.  The port's single-channel TF lookup is ``kernels/tf1d.py``, which
reproduces the matmul's rounded weights (``tf_mxu``).

A corner table that requires grad is fetched through :class:`CornerFetch`,
the port of ``vpt_tpu.sampling._select_trilerp`` (the fit's fused VJP): the
forward is the fused gather and lerp of ``kernels/corner_gather.py`` (K3),
the backward the corner scatter-add of ``kernels/corner_scatter.py`` (K4).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .kernels import corner_gather, corner_scatter
from .math3d import apply_mat4

EPS = np.float32(1e-5)
INVPI = np.float32(0.31830988618)


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------

def intersect_cube(origin, direction):
    """Slab test against the unit cube → (..., 2) = (tnear, tfar).  min/max
    propagate NaN, as ``jnp.minimum``/``jnp.maximum`` do."""
    tmin = (0.0 - origin) / direction
    tmax = (1.0 - origin) / direction
    t1 = torch.minimum(tmin, tmax)
    t2 = torch.maximum(tmin, tmax)
    tnear = torch.amax(t1, dim=-1)
    tfar = torch.amin(t2, dim=-1)
    return torch.stack([tnear, tfar], dim=-1)


def unproject_rand(state, ndc, mvp_inverse, inverse_resolution, blur):
    """Stochastic unproject: disk jitter on the near plane (depth of field),
    square jitter on the far plane (antialiasing).  Consumes 4 uniforms in
    the GLSL order."""
    state, disk_offset = rng.disk(state)
    state, aa = rng.square(state)
    near_xy = ndc + disk_offset * blur
    far_xy = ndc + (aa * 2.0 - 1.0) * inverse_resolution
    ones = torch.ones(ndc.shape[:-1] + (1,), dtype=torch.float32,
                      device=ndc.device)
    f = apply_mat4(mvp_inverse, torch.cat([near_xy, -ones, ones], dim=-1))
    t = apply_mat4(mvp_inverse, torch.cat([far_xy, ones, ones], dim=-1))
    return state, f[..., :3] / f[..., 3:4], t[..., :3] / t[..., 3:4]


def pixel_ndc(height, width, device="cpu"):
    """NDC coordinates of pixel centers, (H, W, 2); row 0 is the bottom of
    the image (y up, OpenGL convention).  The true quotient on every device:
    CUDA divides by a Python scalar through its reciprocal, so the divisor
    is a tensor (see ``rng.exponential``)."""
    def centers(n):
        i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        return i / torch.full_like(i, n) * 2.0 - 1.0

    yy, xx = torch.meshgrid(centers(height), centers(width), indexing="ij")
    return torch.stack([xx, yy], dim=-1)


# ---------------------------------------------------------------------------
# Texture sampling
# ---------------------------------------------------------------------------

def _filter_coords(position, dims):
    """GL CLAMP_TO_EDGE filter coordinate: (i0 float, fraction)."""
    dims_t = torch.tensor(dims, dtype=torch.float32, device=position.device)
    u = torch.clamp(position * dims_t - 0.5, min=torch.zeros_like(dims_t),
                    max=dims_t - 1.0)
    i0 = torch.floor(u)
    return i0, u - i0


def _clamp_index(i0f, dims):
    maxi = torch.tensor(dims, dtype=torch.int64, device=i0f.device) - 1
    return torch.minimum(torch.clamp(i0f.to(torch.int64), min=0), maxi)


def sample_volume(volume, position):
    """Trilinear fetch of a (D, H, W, C) texture at (..., 3) xyz positions in
    [0, 1], GL LINEAR + CLAMP_TO_EDGE."""
    d, h, w, _ = volume.shape
    i0f, f = _filter_coords(position, (w, h, d))
    i0 = _clamp_index(i0f, (w, h, d))
    i1 = torch.minimum(i0 + 1, torch.tensor([w - 1, h - 1, d - 1],
                                            device=i0.device))
    flat = volume.reshape(d * h * w, -1)

    def tap(ix, iy, iz):
        return flat[(iz * h + iy) * w + ix]

    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = tap(x0, y0, z0) * (1 - fx) + tap(x1, y0, z0) * fx
    c10 = tap(x0, y1, z0) * (1 - fx) + tap(x1, y1, z0) * fx
    c01 = tap(x0, y0, z1) * (1 - fx) + tap(x1, y0, z1) * fx
    c11 = tap(x0, y1, z1) * (1 - fx) + tap(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_texture2d(texture, uv):
    """Bilinear fetch of an (H, W, C) texture at (..., 2) uv, CLAMP_TO_EDGE."""
    h, w, _ = texture.shape
    i0f, f = _filter_coords(uv, (w, h))
    i0 = _clamp_index(i0f, (w, h))
    i1 = torch.minimum(i0 + 1, torch.tensor([w - 1, h - 1],
                                            device=i0.device))
    flat = texture.reshape(h * w, -1)

    def tap(ix, iy):
        return flat[iy * w + ix]

    fx, fy = f[..., 0:1], f[..., 1:2]
    c0 = tap(i0[..., 0], i0[..., 1]) * (1 - fx) \
        + tap(i1[..., 0], i0[..., 1]) * fx
    c1 = tap(i0[..., 0], i1[..., 1]) * (1 - fx) \
        + tap(i1[..., 0], i1[..., 1]) * fx
    return c0 * (1 - fy) + c1 * fy


def pack_corner_volume(volume):
    """(D, H, W, C) → (D·H·W, 8·C) rows of the 2×2×2 cell corners, corner
    order (z, y, x) with x minor, clamped at the +1 edges (fold 0 of
    ``vpt_tpu.sampling.pack_corner_volume``)."""
    d, h, w, c = volume.shape
    vp = torch.cat([volume, volume[:, :, -1:]], dim=2)
    vp = torch.cat([vp, vp[:, -1:]], dim=1)
    vp = torch.cat([vp, vp[-1:]], dim=0)
    corners = [vp[dz:dz + d, dy:dy + h, dx:dx + w]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(corners, dim=3).reshape(d * h * w, 8 * c)


def trilerp_chain(rows, f):
    """The 3-level lerp over (..., 8, C) corner rows, in the order of
    ``vpt_tpu.sampling._trilerp_chain``."""
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
        + rows[..., 1::2, :] * fx[..., None]
    cy = cx[..., 0::2, :] * (1 - fy)[..., None] \
        + cx[..., 1::2, :] * fy[..., None]
    return cy[..., 0, :] * (1 - fz) + cy[..., 1, :] * fz


def corner_cells(position, shape):
    """The corner-table row (cell) and the filter fractions of each (..., 3)
    position in a (D, H, W, C) volume: ((...) int64, (..., 3) float32)."""
    d, h, w = shape[:3]
    i0f, f = _filter_coords(position, (w, h, d))
    i0 = _clamp_index(i0f, (w, h, d))
    return (i0[..., 2] * h + i0[..., 1]) * w + i0[..., 0], f


class CornerFetch(torch.autograd.Function):
    """The differentiable packed volume fetch: forward
    ``corner_gather.corner_fetch`` (the gather and lerp, bit for bit
    :func:`trilerp_chain` over the gathered row), backward
    ``corner_scatter.corner_grad`` (``w8(f) ⊗ ct`` scattered into the
    table's gradient).  Only the cells and fractions are saved, as
    ``vpt_tpu.sampling._select_trilerp_fwd`` saves them; positions are
    detached (no gradient reaches ``f``), the contract of the MC gradient
    estimators (``vpt_tpu/sampling.py:415-421``)."""

    @staticmethod
    def forward(ctx, table, idx, f):
        ctx.save_for_backward(idx, f)
        ctx.table_shape = tuple(table.shape)
        return corner_gather.corner_fetch(table, idx, f)

    @staticmethod
    def backward(ctx, ct):
        idx, f = ctx.saved_tensors
        rows, lanes = ctx.table_shape
        grad = corner_scatter.corner_grad(idx, f, ct.contiguous(), rows,
                                          lanes // 8)
        return grad, None, None


def sample_volume_packed(packed, shape, position, fused: bool = True):
    """Trilinear fetch from a corner-packed (D·H·W, 8·C) table, float32 or
    bfloat16 rows; identical to :func:`sample_volume` on a float32 table.

    When autograd records and the table requires grad, the fetch runs
    through :class:`CornerFetch` (its kernels for CUDA tensors); the fit
    packs float32 tables in the graph, and a bfloat16 table that requires
    grad raises.  ``fused=False`` keeps the plain gather and lerp, whose
    autograd backward is the full-Jacobian reference."""
    c = shape[3]
    idx, f = corner_cells(position, shape)
    if fused and packed.requires_grad and torch.is_grad_enabled():
        if packed.dtype != torch.float32:
            raise ValueError("the differentiable fetch takes float32 corner "
                             f"tables, not {packed.dtype}")
        return CornerFetch.apply(packed, idx, f.detach())
    rows = packed[idx].to(torch.float32).reshape(idx.shape + (8, c))
    return trilerp_chain(rows, f)


def pack_corner_texture2d(texture):
    """(H, W, C) → (H·W, 4·C) rows of the 2×2 texel corners (x minor)."""
    h, w, c = texture.shape
    tp = torch.cat([texture, texture[:, -1:]], dim=1)
    tp = torch.cat([tp, tp[-1:]], dim=0)
    corners = [tp[dy:dy + h, dx:dx + w] for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(corners, dim=2).reshape(h * w, 4 * c)


def sample_texture2d_packed(packed, shape, uv):
    """Bilinear fetch from a corner-packed 2D texture (one row per sample)."""
    h, w, c = shape
    i0f, f = _filter_coords(uv, (w, h))
    i0 = _clamp_index(i0f, (w, h))
    rows = packed[i0[..., 1] * w + i0[..., 0]].to(torch.float32)
    rows = rows.reshape(rows.shape[:-1] + (4, c))
    fx, fy = f[..., 0:1], f[..., 1:2]
    cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
        + rows[..., 1::2, :] * fx[..., None]
    return cx[..., 0, :] * (1 - fy) + cx[..., 1, :] * fy


def sample_environment(env, direction):
    """Equirectangular environment lookup (MCMRenderer.glsl:80-83)."""
    d = direction
    u = torch.atan2(d[..., 0], -d[..., 2]) * float(INVPI) * 0.5 + 0.5
    v = torch.asin(torch.clamp(-d[..., 1], -1.0, 1.0)) * 2.0 \
        * float(INVPI) * 0.5 + 0.5
    return sample_texture2d(env, torch.stack([u, v], dim=-1))


# ---------------------------------------------------------------------------
# Shading helpers
# ---------------------------------------------------------------------------

def henyey_greenstein_cosine(state, g):
    """HG scattering-angle cosine (MCMRenderer.glsl:91-95)."""
    state, u = rng.uniform(state)
    g2 = g * g
    c = (1.0 - g2) / (1.0 - g + 2.0 * g * u)
    return state, (1.0 + g2 - c * c) / (2.0 * g)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def henyey_greenstein(state, g, direction):
    """Sample an HG-distributed direction around ``direction``
    (MCMRenderer.glsl:97-106).  Like the shader, |g| < EPS returns the raw
    sphere sample and draws one uniform fewer."""
    g = np.float32(g)
    state, u = rng.sphere(state)
    if abs(g) < EPS:
        return state, u
    # a float32 scalar tensor, so that g·g and 1 − g round as in float32
    g = torch.tensor(g, device=direction.device)
    state, hgcos = henyey_greenstein_cosine(state, g)
    proj = _dot3(u, direction)[..., None]
    perp = u - proj * direction
    circle = perp / torch.sqrt(
        torch.clamp(_dot3(perp, perp)[..., None], min=1e-12))
    hgcos = hgcos[..., None]
    return state, torch.sqrt(torch.clamp(1.0 - hgcos * hgcos, min=0.0)) \
        * circle + hgcos * direction


def max3(v):
    return torch.amax(v, dim=-1)
