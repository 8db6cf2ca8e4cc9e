"""DOS under pixel-row sharding with an explicit occlusion halo exchange.

Mirrors ``vpt_tpu/parallel/dos_halo.py``.  DOS is the one renderer whose
kernel reads neighbouring pixels: each slice's occlusion is the mean of
disk taps on the previous slice's buffer (``DOSRenderer.glsl:56-64``).
Row-sharding the image therefore needs a halo of occlusion rows from the
neighbouring bands, exchanged once a slice.  K is the worst-case tap radius
over the whole sweep (:func:`occlusion_halo_width`), usually a few rows, so
a slice moves O(K·W) a rank instead of the whole buffer
(``shard.shard_render_frame``'s DOS gathers the whole buffer each slice,
as JAX's partitioner does, and so also takes a camera inside the volume).

A frame is ``dos.render_band``: the host reads the frame's active-slice
count once, then for each slice exchanges the K top and bottom rows over
``data`` (one all-gather of every band's edge rows, ``shard._all_gather``;
point-to-point sends are left to a measured change) and runs K9's band
instance (one launch a slice; ``dos_sweep.band_slice_plain`` on the CPU).
The taps are clamped in the whole image's texel space and read from the
halo-extended block, vpt_tpu's sharded taps, which agree with the
single-device sweep's shifted taps within 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..renderers import dos
from .halo import COLLECTIVES
from .mesh import axis_group, axis_index, axis_size, block_of


def occlusion_halo_width(scene, params: dos.Params, height: int) -> int:
    """The worst-case occlusion tap radius in pixel rows over the whole
    sweep (host-side, float64): ``|offset_y| · occlusion_scale_y(depth)``
    bounded over every slice depth, in texels, plus one row for the
    bilinear footprint.  Raises for a camera inside the volume (a slice at
    depth 0 has an unbounded tap scale)."""
    min_d, max_d = (float(v) for v in dos._depth_range(scene.model_view))
    slice_distance = (max_d - min_d) / params.slices
    extent = slice_distance * math.tan(math.radians(params.aperture))
    depths = np.asarray(
        min_d + slice_distance * np.arange(params.slices), np.float64)
    # project [1, 1, -d]: the y scale of the tap disk at that slice
    proj = scene.projection.detach().cpu().numpy().astype(np.float64)
    h = proj @ np.stack([np.ones_like(depths), np.ones_like(depths),
                         -depths, np.ones_like(depths)])
    with np.errstate(divide="ignore", invalid="ignore"):
        corr_y = np.abs(h[1] / h[3])
    if not np.isfinite(corr_y).all():
        raise ValueError(
            "occlusion tap scale is unbounded (slice at depth 0 — camera "
            "inside the volume); use the auto-partitioned DOS path "
            "(shard.shard_render_frame)")
    max_scale = float(np.max(corr_y)) * extent
    offsets = dos._occlusion_samples(params.samples).numpy()
    max_off = float(np.max(np.abs(offsets[:, 1]))) if offsets.size else 0.0
    k = int(math.ceil(max_off * max_scale * height)) + 1
    return min(k, height)


def _exchange(mesh, data_axis, halo, row0):
    """``extend(occlusion) -> (ext, ext_row0)`` of a band: its rows with
    the K rows below it (the previous band's last) and the K above it (the
    next band's first), zeros past the image's edges, from one all-gather
    of every band's 2K edge rows over ``data`` (none for one band)."""
    from .shard import _all_gather

    n = axis_size(mesh, data_axis)
    i = axis_index(mesh, data_axis)
    group = axis_group(mesh, data_axis)

    def extend(occ):
        zeros = occ.new_zeros((halo, occ.shape[1]))
        if n == 1:
            return torch.cat([zeros, occ, zeros]), row0 - halo
        edges = torch.cat([occ[:halo], occ[-halo:]])
        every = edges.new_empty((n * 2 * halo, occ.shape[1]))
        _all_gather(every, edges, group)
        COLLECTIVES["all_gather"] += 1
        every = every.reshape(n, 2 * halo, occ.shape[1])
        below = every[i - 1, halo:] if i > 0 else zeros
        above = every[i + 1, :halo] if i < n - 1 else zeros
        return torch.cat([below, occ, above]), row0 - halo

    return extend


def sharded_render_frame(mesh, scene, params: dos.Params, height: int,
                         width: int, data_axis: str = "data",
                         donate: bool = True):
    """A DOS frame function over ``data``'s row bands with the K-row
    occlusion halo exchanged every slice.

    Returns ``(frame_fn, halo_width)``; call ``frame_fn(state, scene,
    params, seed, frame_number)`` with this rank's band of the state
    (``shard.place_state``: ``color`` and ``occlusion`` split by rows; the
    scalars and the (samples, 2) offsets whole, whatever ``samples`` is).
    The scene is replicated (DOS sweeps the whole volume on every band).
    The state is updated in place unless ``donate`` is False.  Raises when
    the height does not split evenly or the halo is as tall as a band."""
    n = axis_size(mesh, data_axis)
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by {n} shards")
    h_local = height // n
    halo = occlusion_halo_width(scene, params, height)
    if halo >= h_local:
        raise ValueError(
            f"occlusion halo {halo} rows ≥ shard height {h_local}; "
            "use fewer shards or the auto-partitioned path")
    row0 = block_of(height, mesh, (data_axis,))[0]
    extend = _exchange(mesh, data_axis, halo, row0)

    def frame_fn(state, scene, params, seed, frame_number):
        del seed, frame_number
        if not donate:
            state = {k: v.clone() for k, v in state.items()}
        return dos.render_band(state, scene, params, (row0, height), extend)

    return frame_fn, halo

