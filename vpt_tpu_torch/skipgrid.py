"""Voxel-resolution Chebyshev empty-space skipping ("cheb-skip").

Mirrors the cheb-skip subset of ``vpt_tpu/skipgrid.py``.  A voxel cell is
empty when the transfer function gives alpha exactly 0 to every value the
trilinear interpolation can produce inside it.  An empty cell's
corner-packed row is repurposed to hold −chebdist in all 8 lanes, so the
event loop's one corner fetch yields both the shading value and, in empty
space, the distance to the nearest occupied cell (``mcm.flight_phase``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sampling

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
