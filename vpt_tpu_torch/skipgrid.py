"""Empty-space structures of the tracking and march renderers.

Mirrors ``vpt_tpu/skipgrid.py``:

- **cheb-skip.**  A voxel cell is empty when the transfer function gives
  alpha exactly 0 to every value the trilinear interpolation can produce
  inside it.  An empty cell's corner-packed row is repurposed to hold
  −chebdist in all 8 lanes, so the event loop's one corner fetch yields
  both the shading value and, in empty space, the distance to the nearest
  occupied cell (``mcm.flight_phase``).
- **The majorant grid** (``make_scene(tracking="grid")``): a coarse N³ grid
  of [max alpha over the cell's trilinear support, Chebyshev distance in
  cells to the nearest cell with max alpha > 0]
  (:func:`build_majorant_grid`).  The MCM event flies against the current
  cell's majorant and hops cell boundaries (:func:`flight_step`); it draws
  another stream than the exact machine.
- **The march clamp boxes** (``march_clamp``, ``iso_clamp_min``): the
  normalized-position box of every cell the TF can make visible
  (:func:`occupied_aabb`), or whose alpha can reach a floor
  (:func:`iso_value_aabb`).

Scene build, not frame work: plain PyTorch on the scene's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import sampling

#: cell-indexing nudge along the ray (normalized units): a position on a
#: cell face indexes the next cell
EPS_NUDGE = 1e-5

#: cap on the stored Chebyshev distance (voxels); bf16 tables represent
#: integers exactly up to 256.
CHEB_CAP = 64


def _tf_range_max(alpha_row, lo, hi):
    """max(alpha_row[lo..hi]) for int64 index tensors lo <= hi, through a
    (TW, TW) running-max table."""
    tw = alpha_row.shape[0]
    li = torch.arange(tw, device=alpha_row.device)[:, None]
    hj = torch.arange(tw, device=alpha_row.device)[None, :]
    masked = torch.where(hj >= li, alpha_row[None, :],
                         torch.zeros((), dtype=alpha_row.dtype,
                                     device=alpha_row.device))
    table = torch.cummax(masked, dim=1).values          # table[lo, hi]
    return table.reshape(-1)[lo * tw + hi]


def cell_empty_mask(packed_rows, transfer):
    """(R, 8) corner-value rows + (TH, TW, 4) transfer → (R,) bool: True
    where the TF alpha is exactly 0 for every value the cell can produce
    (single-channel volumes sample the TF's y = 0 row)."""
    vmin = torch.amin(packed_rows, dim=-1)
    vmax = torch.amax(packed_rows, dim=-1)
    tw = transfer.shape[1]
    alpha_row = transfer[0, :, 3]
    lo = torch.clamp(torch.floor(vmin * tw - 0.5), 0, tw - 1).to(torch.int64)
    hi = torch.clamp(torch.floor(vmax * tw - 0.5) + 1.0, 0,
                     tw - 1).to(torch.int64)
    return _tf_range_max(alpha_row, lo, hi) == 0.0


def chebyshev_distance(occupied, cap: int = CHEB_CAP):
    """(D, H, W) bool → float32 Chebyshev distance (in cells) to the nearest
    True cell, clamped to ``cap``; cells outside the volume count as empty.

    Iterated 3×3×3 max-pool dilation of the occupancy: max_pool3d pads with
    −inf, which is the "outside is empty" rule.  The loop stops once every
    cell is reached, which leaves the result unchanged."""
    dist = torch.where(occupied, 0.0, float(cap))
    if not bool(occupied.any()):
        return dist
    reach = occupied.to(torch.float32)[None, None]
    for k in range(1, cap):
        reach = F.max_pool3d(reach, kernel_size=3, stride=1, padding=1)
        dist = torch.minimum(dist, torch.where(reach[0, 0] > 0, float(k),
                                               float(cap)))
        if bool(reach.min() > 0):
            break
    return dist


def build_majorant_grid(volume, transfer, n_cells: int):
    """(D, H, W, C) volume + (TH, TW, 4) transfer → (N, N, N, 2) float32
    [maxalpha, chebdist] grid, or None for C > 1 or dims not divisible by
    N.  maxalpha bounds the TF alpha over every texel a bilinear lookup at
    (value, 0) can touch for any value in the cell's voxels dilated by
    one; chebdist is the Chebyshev distance in cells to the nearest cell
    with maxalpha > 0.

    ``lax.reduce_window``'s padded min and max are ``max_pool3d`` of −v and
    v (it pads with −inf, the windows' init); its iterated 3³ dilation is
    :func:`chebyshev_distance`'s.  Every step is exact, so the grid equals
    JAX's."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    if d % n_cells or h % n_cells or w % n_cells:
        return None
    window = (d // n_cells + 2, h // n_cells + 2, w // n_cells + 2)
    stride = (d // n_cells, h // n_cells, w // n_cells)
    v = volume[..., 0][None, None]
    vmax = F.max_pool3d(v, window, stride, padding=1)[0, 0]
    vmin = -F.max_pool3d(-v, window, stride, padding=1)[0, 0]

    # the texels a bilinear lookup at u = value·TW − 0.5 can touch for any
    # value in [vmin, vmax]: corners floor(u) and floor(u) + 1
    tw = transfer.shape[1]
    alpha_row = transfer[0, :, 3]
    lo = torch.clamp(torch.floor(vmin * tw - 0.5), 0, tw - 1).reshape(-1, 1)
    hi = torch.clamp(torch.floor(vmax * tw - 0.5) + 1.0, 0,
                     tw - 1).reshape(-1, 1)
    t = torch.arange(tw, dtype=torch.float32, device=volume.device)[None]
    in_range = (t >= lo) & (t <= hi)
    maxalpha = torch.amax(torch.where(in_range, alpha_row[None],
                                      torch.zeros_like(alpha_row)[None]),
                          dim=1).reshape(n_cells, n_cells, n_cells)
    dist = chebyshev_distance(maxalpha > 0.0, cap=n_cells)
    return torch.stack([maxalpha, dist], dim=-1)


def flight_step(grid, position, direction):
    """The local-majorant flight geometry of each photon: ``(maxalpha,
    t_bound)``, the current cell's alpha majorant and the distance along
    ``direction`` to the cell's boundary (the DDA crossing), extended to a
    (chebdist − 1)-cell hop through exactly-empty space, at least 0.
    Divisions by N are by tensors, as the true quotient of JAX and of the
    event kernel."""
    n = grid.shape[0]
    p_idx = position + EPS_NUDGE * direction
    cell = torch.clamp(torch.floor(p_idx * n).to(torch.int64), 0, n - 1)
    flat = (cell[..., 2] * n + cell[..., 1]) * n + cell[..., 0]
    rows = grid.reshape(-1, 2)[flat]
    maxalpha, cheb = rows[..., 0], rows[..., 1]

    step_pos = (direction > 0.0).to(torch.float32)
    boundary = cell.to(torch.float32) + step_pos
    boundary = boundary / torch.full_like(boundary, n)
    t_axis = torch.where(direction != 0.0, (boundary - position) / direction,
                         torch.full_like(position, float("inf")))
    t_bound = torch.amin(t_axis, dim=-1)
    hop_far = torch.clamp(cheb - 1.0, min=0.0)
    hop_far = hop_far / torch.full_like(hop_far, n)
    t_bound = torch.where((maxalpha == 0.0) & (cheb >= 2.0),
                          torch.maximum(t_bound, hop_far), t_bound)
    return maxalpha, torch.clamp(t_bound, min=0.0)


def pack_tracking_volume(volume, transfer, cap: int = CHEB_CAP,
                         min_empty_fraction: float = 0.0):
    """(D, H, W, 1) volume + (TH, TW, 4) transfer → (D·H·W, 8) tracking
    table: occupied cells hold their corner values, empty cells −chebdist
    in every lane.  None for multi-channel volumes, volumes with negative
    values (the sign is the empty flag), or when fewer than
    ``min_empty_fraction`` of the cells are empty (the auto policy's
    decline, checked before the distance transform)."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    if bool(volume.min() < 0.0):
        return None
    packed = sampling.pack_corner_volume(volume)
    empty = cell_empty_mask(packed, transfer)
    if min_empty_fraction > 0.0:
        # a float32 count / float32 total, as jnp.mean computes it (the
        # count is exact in float32 below 2^24 cells); a tensor divisor,
        # since CUDA divides by a Python scalar through its reciprocal
        count = empty.sum().to(torch.float32)
        frac = count / torch.full_like(count, empty.numel())
        if float(frac) < min_empty_fraction:
            return None
    occupied = (~empty).reshape(d, h, w)
    cheb = chebyshev_distance(occupied, cap=cap).reshape(-1)
    return torch.where(empty[:, None],
                       -torch.clamp(cheb, min=1.0)[:, None], packed)


def empty_fraction(tracking_packed) -> float:
    """Fraction of cells marked empty in a built tracking table."""
    return float((tracking_packed[:, 0] < -0.5).to(torch.float32).mean())


def occupied_aabb(volume, transfer):
    """(2, 3) float32 box [lo, hi] in normalized (x, y, z) positions over
    every cell the TF can make visible (the cells :func:`cell_empty_mask`
    does not mark), or None for C > 1 or when no cell is empty (the clamp
    would change nothing).  Cell x covers p_x in [(x + 0.5)/W, (x + 1.5)/W];
    cells 0 and W − 1 reach the faces (CLAMP_TO_EDGE)."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    empty = cell_empty_mask(sampling.pack_corner_volume(volume), transfer)
    if not bool(empty.any()):
        return None
    return _cells_aabb((~empty).reshape(d, h, w))


def _cells_aabb(occ):
    """(D, H, W) bool cell mask → the (2, 3) box over every True cell, on
    the mask's device; the degenerate [0.5]³ box, which every ray misses,
    when no cell is True.  The bounds are float32 quotients computed on the
    host, as JAX computes them."""
    d, h, w = occ.shape
    if not bool(occ.any()):
        box = np.full((2, 3), 0.5, np.float32)
    else:
        def axis_range(mask_1d, n):
            idx = torch.nonzero(mask_1d).reshape(-1)
            mn, mx = int(idx.min()), int(idx.max())
            lo = np.float32(0.0) if mn == 0 \
                else np.float32(mn + 0.5) / np.float32(n)
            hi = np.float32(1.0) if mx == n - 1 \
                else np.float32(mx + 1.5) / np.float32(n)
            return lo, hi

        zlo, zhi = axis_range(occ.any(2).any(1), d)
        ylo, yhi = axis_range(occ.any(2).any(0), h)
        xlo, xhi = axis_range(occ.any(1).any(0), w)
        box = np.array([[xlo, ylo, zlo], [xhi, yhi, zhi]], np.float32)
    return torch.from_numpy(box).to(occ.device)


def iso_value_aabb(volume, transfer, alpha_min: float):
    """The ISO clamp's box: (2, 3) over every cell whose TF alpha can reach
    ``alpha_min`` (float32) anywhere in its trilinear value range, or None
    for C > 1 or when every cell can.  A box is valid for isovalues of at
    least ``alpha_min``, which ``renderers/iso.py`` checks."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    packed = sampling.pack_corner_volume(volume)
    vmin = torch.amin(packed, dim=-1)
    vmax = torch.amax(packed, dim=-1)
    tw = transfer.shape[1]
    lo = torch.clamp(torch.floor(vmin * tw - 0.5), 0, tw - 1).to(torch.int64)
    hi = torch.clamp(torch.floor(vmax * tw - 0.5) + 1.0, 0,
                     tw - 1).to(torch.int64)
    can_hit = _tf_range_max(transfer[0, :, 3], lo, hi) \
        >= float(np.float32(alpha_min))
    if bool(can_hit.all()):
        return None
    return _cells_aabb(can_hit.reshape(d, h, w))
