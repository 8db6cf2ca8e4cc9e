"""DOS: directional occlusion shading by a view-aligned slice sweep.

Mirrors ``vpt_tpu/renderers/dos.py`` (DOSRenderer.glsl integrate:66-82 and
occlusion:56-64, DOSRenderer.js): the volume is swept front to back in
view-aligned slices; each slice composites ``1 − exp(−σ·Δs)`` opacity
modulated by the occlusion buffer, and the occlusion buffer becomes the mean
of N disk taps of the previous buffer times the slice transmittance.  One
``render_frame`` advances ``steps`` slices of the ``slices``-slice sweep;
slices past the far depth change nothing.

The state is a dict: ``color`` (H, W, 4), ``occlusion`` (H, W), the 0-d
``depth``, ``max_depth`` and ``slice_distance``, and the (N, 2) disk
``offsets``.  :func:`render_frame` runs the frame through
``kernels/dos_sweep.py``: the plain slices of :func:`composite_slices` on
the CPU, which take the frame's per-slice constants from
:func:`slice_table`, and one launch of the slice kernel (K9) a frame on
the card, which computes the same constants itself, bit for bit.

The sharding hooks of ``vpt_tpu`` (``ndc=``, ``sample_occlusion=``)
work in the plain slices as JAX uses them (the taps at ``mapped + offset
· scale``, sampled by the hook and averaged); a Python hook cannot enter
K9, so on the card they raise.  A band of rows renders through
:func:`render_band`, one slice at a time with the previous slice's
occlusion extended past the band (``parallel/dos_halo.py``'s K-row halo,
or ``parallel/shard.py``'s whole image): K9's band instance on the card,
``kernels/dos_sweep.band_slice_plain`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import math3d, rng, sampling
from ..kernels import dos_sweep
from ..utils import constant
from .base import Scene, static_field


@dataclasses.dataclass(frozen=True)
class Params:
    extinction: float = 100.0
    aperture: float = 30.0        # degrees
    steps: int = static_field(default=50)     # slices advanced per frame
    slices: int = static_field(default=200)   # total sweep resolution
    samples: int = static_field(default=8)    # occlusion disk taps


def _occlusion_samples(count: int, device="cpu"):
    """Centred disk samples (DOSRenderer.js:105-128), deterministic, (N, 2)
    float32."""
    state = rng.pcg(torch.arange(2 * count, dtype=torch.int64,
                                 device=device) + 17)
    _, sq = rng.square(state[:count])
    radius = torch.sqrt(sq[:, 0])
    angle = sq[:, 1] * 2.0 * float(np.float32(np.pi))
    pts = radius[:, None] * torch.stack([torch.cos(angle), torch.sin(angle)],
                                        dim=-1)
    return pts - pts.mean(dim=0, keepdim=True)


_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float32)


def _depth_range(model_view):
    """[min, max] of −(V·M·C · corner).z over the 8 cube corners
    (calculateDepth, DOSRenderer.js:140-164); min clamped to 0.  Two 0-d
    tensors."""
    # the corners as a cached device constant: a host array would be a
    # copy that waits for the card's queue at every reset
    corners = constant(tuple(map(tuple, _CORNERS.tolist())), torch.float32,
                       model_view.device)
    cam = math3d.transform_point(model_view, corners)
    depths = -cam[:, 2]
    return torch.clamp(depths.min(), min=0.0), depths.max()


def reset(params: Params, height: int, width: int, scene: Scene = None):
    if scene is None:
        raise ValueError("DOS reset needs the scene (depth range)")
    min_depth, max_depth = _depth_range(scene.model_view)
    device = scene.device
    occlusion = torch.ones((height, width), dtype=torch.float32,
                           device=device)
    return {
        "color": torch.zeros((height, width, 4), dtype=torch.float32,
                             device=device),
        "occlusion": occlusion,
        "depth": min_depth,
        "max_depth": max_depth,
        # the true quotient on every device (a tensor divisor)
        "slice_distance": (max_depth - min_depth)
        / torch.full_like(max_depth, params.slices),
        "offsets": _samples_on(params.samples, device).clone(),
    }


@functools.lru_cache(maxsize=16)
def _samples_on(count: int, device):
    """:func:`_occlusion_samples` once per (count, device), which a reset
    would otherwise run as ~60 small tensor ops; callers copy it."""
    with torch.inference_mode(False):
        return _occlusion_samples(count, device)


def tap_shifts(offsets, occlusion_scale, height: int, width: int):
    """The integer texel shift and bilinear fraction of every disk tap,
    ``(base, frac)``, each (..., N, 2) float32 (x, y), for the occlusion
    scales (..., 2).  ``base = clip(floor(dd), −(W+1), W+1)`` clips BOTH axes
    by the width, as ``vpt_tpu`` does; ``frac = dd − base``."""
    dims = constant((float(width), float(height)), torch.float32,
                    offsets.device)
    dd = offsets * occlusion_scale[..., None, :] * dims
    base = torch.clamp(torch.floor(dd), -(width + 1), width + 1)
    return base, dd - base


def occlusion_taps(occlusion, base, frac):
    """Mean of the N bilinear taps of ``occlusion`` (H, W) shifted by the
    (N, 2) texel shifts ``base`` with the (N, 2) fractions ``frac``: reads
    clamped at the edges, ``fx`` zeroed unless ``0 <= p + bx <= W − 2``
    (``fy`` likewise with H), the taps summed in order, then divided by N
    (``vpt_tpu``'s ``_shifted_occlusion_taps``)."""
    h, w = occlusion.shape
    n = base.shape[0]
    dev = occlusion.device
    b = base.to(torch.int64)
    xs = torch.arange(w, device=dev)[None, :] + b[:, 0:1]        # (N, W)
    ys = torch.arange(h, device=dev)[None, :] + b[:, 1:2]        # (N, H)
    x0, x1 = xs.clamp(0, w - 1), (xs + 1).clamp(0, w - 1)
    y0, y1 = ys.clamp(0, h - 1), (ys + 1).clamp(0, h - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fx = torch.where((xs >= 0) & (xs <= w - 2), frac[:, 0:1], zero)
    fy = torch.where((ys >= 0) & (ys <= h - 2), frac[:, 1:2], zero)
    fx, fy = fx[:, None, :], fy[:, :, None]
    a00 = occlusion[y0[:, :, None], x0[:, None, :]]
    a10 = occlusion[y0[:, :, None], x1[:, None, :]]
    a01 = occlusion[y1[:, :, None], x0[:, None, :]]
    a11 = occlusion[y1[:, :, None], x1[:, None, :]]
    c0 = a00 * (1 - fx) + a10 * fx
    c1 = a01 * (1 - fx) + a11 * fx
    taps = c0 * (1 - fy) + c1 * fy
    total = taps[0]
    for k in range(1, n):
        total = total + taps[k]
    return total / torch.full_like(total, n)


def _shifted_occlusion_taps(occlusion, offsets, occlusion_scale):
    """``vpt_tpu``'s function of the same name: the mean of the disk taps
    at the offsets ``offsets`` (N, 2) times ``occlusion_scale`` (2,)."""
    h, w = occlusion.shape
    base, frac = tap_shifts(offsets, occlusion_scale, h, w)
    return occlusion_taps(occlusion, base, frac)


def _tan_aperture(params: Params, device):
    """tan(aperture · π / 180) in float32: the product and the quotient
    rounded in float32 on the host, the tangent on ``device``."""
    x = np.float32(np.float32(params.aperture) * np.float32(np.pi)) \
        / np.float32(180.0)
    return torch.tan(constant(float(x), torch.float32, device))


#: the leading columns of a row of :func:`slice_table`; the taps follow
TABLE_HEAD = 4


def _slice_projection(state, scene: Scene, params: Params):
    """``(depths, corr, scale)`` of the frame's slices: ``depth_k``, the
    projection of (1, 1, −depth_k) divided by w (steps, 3), and the
    occlusion scale ``corr[:, :2] · Δ·tan(aperture)`` (steps, 2)."""
    color = state["color"]
    sd = state["slice_distance"]
    idx = torch.arange(params.steps, dtype=torch.float32,
                       device=color.device)
    depths = state["depth"] + idx * sd
    ones = torch.ones_like(depths)
    corr = math3d.transform_point(scene.projection,
                                  torch.stack([ones, ones, -depths], dim=-1))
    scale = corr[:, :2] * (sd * _tan_aperture(params, color.device))
    return depths, corr, scale


def slice_table(state, scene: Scene, params: Params):
    """The frame's per-slice constants, (steps, 4 + 4·N) float32 on the
    state's device: per slice its NDC depth, 1.0 where it is active
    (``depth_k <= max_depth``) else 0.0, the slice distance, 0.0, then per
    tap (bx, by, fx, fy) of :func:`tap_shifts`.  ``depth_k = depth + k·Δ``
    and the NDC depth and occlusion scale come from ``transform_point
    (projection, [1, 1, −depth_k])`` (DOSRenderer.js:240-248), in
    ``vpt_tpu``'s order.  The plain slices read it; the kernel computes
    the same rows itself (``kernels/dos_sweep.slice_rows_plain`` is its
    scalar twin); building it reads nothing back to the host."""
    color = state["color"]
    h, w = color.shape[:2]
    n = params.steps
    sd = state["slice_distance"]
    depths, corr, scale = _slice_projection(state, scene, params)
    active = (depths <= state["max_depth"]).to(torch.float32)
    base, frac = tap_shifts(state["offsets"], scale, h, w)      # (n, N, 2)
    head = torch.stack([corr[:, 2], active, sd.expand(n),
                        torch.zeros_like(depths)], dim=-1)
    return torch.cat([head, torch.cat([base, frac], dim=-1).reshape(n, -1)],
                     dim=1).contiguous()


def advance_depth(state, table):
    """``depth + n_active·Δ`` (not repeated additions), in the state."""
    n_active = table[:, 1].sum()
    state["depth"] = state["depth"] + n_active * state["slice_distance"]


def _slice_step(color, occlusion, scene: Scene, params: Params, row, ndc,
                sd, tap_mean):
    """One slice of the sweep at the pixels of ``ndc`` (H, W, 2): the
    composite of the slice's colour into ``color`` and the new occlusion
    ``tap_mean(occlusion) · transmittance``, where the slice's point lies
    in the cube and ``row`` (a :func:`slice_table` row) is active; returns
    ``(color, occlusion)``."""
    h, w = ndc.shape[:2]
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=ndc.device)
    extinction = float(np.float32(params.extinction))
    pos = math3d.apply_mat4(scene.mvp_inverse, torch.cat(
        [ndc, row[0].expand(h, w, 1), ones], dim=-1))
    pos = pos[..., :3] / pos[..., 3:4]
    ts = scene.sample_color(pos)
    e = ts[..., 3] * extinction
    transmittance = torch.exp(-e * sd)
    alpha = 1.0 - transmittance
    contrib = ts[..., :3] * occlusion[..., None] * alpha[..., None]
    rgb = color[..., :3] + contrib * (1.0 - color[..., 3:4])
    a = torch.clamp(color[..., 3] + alpha, max=1.0)
    new_occlusion = tap_mean(occlusion) * transmittance
    outside = ((pos > 1.0) | (pos < 0.0)).any(dim=-1)
    write = (row[1] > 0.0) & ~outside
    return (torch.where(write[..., None],
                        torch.cat([rgb, a[..., None]], dim=-1), color),
            torch.where(write, new_occlusion, occlusion))


def _mean_of_taps(taps):
    """The mean of (N, ...) taps: summed in order k = 0..N−1, then divided
    by N (K9's order)."""
    total = taps[0]
    for k in range(1, taps.shape[0]):
        total = total + taps[k]
    return total / torch.full_like(total, taps.shape[0])


def hook_taps(ndc, offsets, scale):
    """vpt_tpu's tap positions of the sharding hook, (N, H, W, 2):
    ``mapped + offsets · scale`` with ``mapped = ndc · 0.5 + 0.5``
    (``vpt_tpu/renderers/dos.py:181-183``)."""
    mapped = ndc * 0.5 + 0.5
    return mapped[None] + (offsets * scale)[:, None, None, :]


def composite_slices(state, scene: Scene, params: Params, table, ndc=None,
                     sample_occlusion=None):
    """The frame's slices in plain PyTorch, in place on the state's color
    and occlusion (``vpt_tpu``'s ``chunk_step``, a slice at a time).
    ``ndc``: the pixels' NDC, (H, W, 2), by default the whole image's;
    ``sample_occlusion(occlusion, taps)``: the sharding hook, (N, H, W)
    occlusion samples at (N, H, W, 2) tap positions (:func:`hook_taps`),
    whose mean replaces the shifted taps."""
    color, occlusion = state["color"], state["occlusion"]
    h, w = color.shape[:2]
    if ndc is None:
        ndc = sampling.pixel_ndc(h, w, device=color.device)
    sd = state["slice_distance"]
    n_taps = state["offsets"].shape[0]
    scales = None if sample_occlusion is None \
        else _slice_projection(state, scene, params)[2]
    for k in range(params.steps):
        row = table[k]
        if sample_occlusion is None:
            taps = row[TABLE_HEAD:].reshape(n_taps, 4)

            def tap_mean(occ, taps=taps):
                return occlusion_taps(occ, taps[:, :2], taps[:, 2:])
        else:
            taps = hook_taps(ndc, state["offsets"], scales[k])

            def tap_mean(occ, taps=taps):
                return _mean_of_taps(sample_occlusion(occ, taps))
        color, occlusion = _slice_step(color, occlusion, scene, params, row,
                                       ndc, sd, tap_mean)
    state["color"].copy_(color)
    state["occlusion"].copy_(occlusion)


def extended_taps(ext, ext_row0: int, taps, height: int, width: int):
    """The occlusion of a band's halo-extended buffer at tap positions
    (``vpt_tpu/parallel/dos_halo.py:103-121``): ``ext`` (E, W) holds the
    image's rows from ``ext_row0``; the taps (..., 2) clamp in the whole
    ``height`` × ``width`` image's texel space, then read the buffer at
    their local row (clamped to its rows) with the bilinear lerp of the
    corner-packed texture."""
    dims = constant((float(width), float(height)), torch.float32, ext.device)
    hi = constant((float(width - 1), float(height - 1)), torch.float32,
                  ext.device)
    u = torch.clamp(taps * dims - 0.5, min=torch.zeros_like(hi), max=hi)
    i0 = torch.floor(u)
    f = u - i0
    i0 = i0.to(torch.int64)
    e = ext.shape[0]
    x0 = torch.clamp(i0[..., 0], 0, width - 1)
    x1 = torch.clamp(x0 + 1, max=width - 1)
    ly = torch.clamp(i0[..., 1] - ext_row0, 0, e - 1)
    ly1 = torch.clamp(ly + 1, max=e - 1)
    fx, fy = f[..., 0], f[..., 1]
    cx0 = ext[ly, x0] * (1 - fx) + ext[ly, x1] * fx
    cx1 = ext[ly1, x0] * (1 - fx) + ext[ly1, x1] * fx
    return cx0 * (1 - fy) + cx1 * fy


def active_slices(state, params: Params) -> int:
    """The frame's active slices (a prefix: ``depth_k`` only grows),
    counted on the host from one read of the state's depth, far depth and
    slice distance, with the float32 operations of K9's rows."""
    depth, max_depth, sd = (np.float32(v) for v in torch.stack(
        [state["depth"], state["max_depth"],
         state["slice_distance"]]).tolist())
    n = 0
    while n < params.steps and depth + np.float32(n) * sd <= max_depth:
        n += 1
    return n


def render_band(state, scene: Scene, params: Params, window, extend):
    """One frame of ``steps`` slices on a band of rows (``window`` =
    (row0, H)), in place on the band's state: for each active slice
    ``extend(occlusion) -> (ext, ext_row0)`` gives the previous slice's
    occlusion past the band (a collective for sharded bands), then K9's
    band instance (the plain slice on the CPU) renders it; the depth then
    advances by the active slices (:func:`advance_depth`'s value).  The
    host reads the active-slice count once a frame.  Over a
    ``parallel.halo.HaloScene`` (a rank's z slab) the band instance's halo
    instance runs: a fetch and an all-reduce over ``space`` a chunk of 8
    active slices.  On the card the band's frame is checked and prepared
    once (``dos_sweep.band_frame``), and a slice passes only the previous
    occlusion and its index."""
    n_active = active_slices(state, params)
    if state["color"].is_cuda:
        run = dos_sweep.band_frame(state, scene, params, window,
                                   n_active).slice
    else:
        def run(ext, ext_row0, k):
            dos_sweep.band_slice_plain(state, ext, ext_row0, scene, params, k,
                                       window)
    for k in range(n_active):
        ext, ext_row0 = extend(state["occlusion"])
        run(ext, ext_row0, k)
    state["depth"] = state["depth"] \
        + float(n_active) * state["slice_distance"]
    return state


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, ndc=None, sample_occlusion=None, window=None):
    """``steps`` slices of the sweep, in the state (a dict, updated in
    place).  ``ndc`` / ``sample_occlusion``: vpt_tpu's sharding hooks
    (:func:`composite_slices`), plain PyTorch only: on the card they raise
    (the sharded sweep is ``parallel.dos_halo.sharded_render_frame``).  A
    ``window`` other than the whole image raises: a band of rows needs its
    neighbours' occlusion every slice (``parallel.dos_halo.
    sharded_render_frame`` or ``parallel.shard.shard_render_frame``)."""
    del seed, frame_number
    height = state["color"].shape[0]
    if sampling.row_window(window, height) != (0, height):
        raise ValueError(
            "a DOS band of rows needs its neighbours' occlusion every "
            "slice: render it through parallel.dos_halo."
            "sharded_render_frame or parallel.shard.shard_render_frame")
    if ndc is not None or sample_occlusion is not None:
        if state["color"].is_cuda:
            raise ValueError(
                "DOS's sharding hooks (ndc=, sample_occlusion=) are Python "
                "and cannot enter the slice kernel (K9): the sharded sweep "
                "on the card is parallel.dos_halo.sharded_render_frame")
        table = slice_table(state, scene, params)
        composite_slices(state, dataclasses.replace(scene, kernels=False),
                         params, table, ndc, sample_occlusion)
        advance_depth(state, table)
        return state
    dos_sweep.sweep_frame(state, scene, params)
    return state


def display(state, scene: Scene, params: Params):
    """mix(white, color, alpha) (DOS render fragment:113-116)."""
    color = state["color"]
    rgb = 1.0 + (color[..., :3] - 1.0) * color[..., 3:4]
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
