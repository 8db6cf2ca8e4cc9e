"""Slice marching for the fixed-schedule renderers (EAM, MIP, Depth, ISO).

Mirrors ``vpt_tpu/renderers/_march.py``: the march renderers sample the
volume at a static slice schedule, positions that depend on the slice index
alone, and fold a ``composite`` over it slice by slice.  :func:`march` is
that fold in plain PyTorch, sampling ``chunk`` slices with one call; the
result does not depend on ``chunk``, since the fold is sequential.  On the
card a whole frame is one launch of the march kernel
(``kernels/march.py``), which runs the same fold per pixel.

The per-frame scalars of a schedule (its first parameter and its step) are
float32 values computed on the host, where the plain version and the
kernel's wrapper both take them.

Each march renderer's ``generate`` and ``render_frame`` take a row window,
``window=(row0, full_height)``: the frame renders the state's rows as the
rows from ``row0`` of a ``full_height``-row image (:func:`rays`), which is
how a rank of ``parallel.shard`` renders its block of rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import sampling
from .base import march_interval

_MASK = 0xFFFFFFFF


def pcg(x: int) -> int:
    """rng.pcg on one Python int holding a uint32."""
    x = (x * 747796405 + 2891336453) & _MASK
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _MASK
    return ((x >> 22) ^ x) & _MASK


def frame_offset(seed) -> np.float32:
    """``uniform(pcg(floatBitsToUint(seed)))``: the frame's one jitter
    offset in [0, 1] (uOffset = Math.random() of the reference's JS), as
    ``rng.uniform`` computes it: the uint32 rounded to float32, then
    scaled by 2^-32 (exact)."""
    bits = int(np.float32(seed).view(np.uint32))
    return np.float32(np.float32(pcg(pcg(bits)))
                      * np.float32(2.0 ** -32))


def jittered_schedule(slices: int, random: bool, seed):
    """(t0, step) of EAM's and Depth's slices: ``step = 1/slices`` and
    ``t0 = step · offset``, the frame's offset or 0, float32."""
    step = np.float32(1.0 / slices)
    return step * (frame_offset(seed) if random else np.float32(0.0)), step


def schedule(first, step, n: int, device) -> torch.Tensor:
    """``first + i·step`` for i < n, float32 (the order of
    ``t0 + arange(n) * step``)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return i * float(step) + float(first)


def dot3(a, b):
    """a·b over the last axis, left to right (as the kernels sum)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def rays(scene, height: int, width: int, interval=None, window=None):
    """Every pixel's clipped segment: ``(tb, miss, start, end)`` with
    ``tb`` the (H, W, 2) interval, ``miss`` where it is empty and
    ``start``/``end`` its (H, W, 3) end points.  ``interval(ray_from,
    direction)`` gives ``tb``: by default ``base.march_interval`` (the cube,
    clamped to the scene's occupied box), ISO's and LAO's their own.
    ``window``: None, or ``(row0, full_height)``: the rays of the
    ``height`` rows from ``row0`` of a ``full_height``-row image."""
    ndc = sampling.pixel_ndc(height, width, device=scene.device,
                             window=window)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    if interval is None:
        tb = march_interval(scene, ray_from, direction)
    else:
        tb = interval(ray_from, direction)
    miss = tb[..., 0] >= tb[..., 1]
    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    return tb, miss, start, end


def grey(values):
    """vec4(v, v, v, 1) of an (H, W) image."""
    rgb = values[..., None].expand(values.shape + (3,))
    return torch.cat([rgb, torch.ones_like(values)[..., None]], dim=-1)


def segment_length(start, end):
    seg = end - start
    return torch.sqrt(dot3(seg, seg))


def march(scene, start, end, ts, composite, carry, chunk: int = 8):
    """Fold ``composite(carry, t, color) -> carry`` over the schedule
    ``ts`` (S,), with ``color = scene.sample_color(start + t·(end −
    start))``, sampling ``chunk`` slices a call."""
    seg = end - start
    for c0 in range(0, ts.shape[0], chunk):
        tc = ts[c0:c0 + chunk]
        colors = scene.sample_color(start[None]
                                    + tc[:, None, None, None] * seg[None])
        for k in range(tc.shape[0]):
            carry = composite(carry, tc[k], colors[k])
    return carry
