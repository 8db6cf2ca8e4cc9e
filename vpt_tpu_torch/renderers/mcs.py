"""MCS: Monte-Carlo single scattering by delta tracking.

Mirrors ``vpt_tpu/renderers/mcs.py`` (MCSRenderer.glsl): delta-tracking
free paths (sampleDistance:70-87), the collision-product transmittance
toward the frame's scatter direction (sampleTransmittance:89-105), the
environment on a miss (:59-62) and the incremental mean (:173-177).  The
frame's scatter direction is ``sphere(pcg(bits(seed) ^ 0x9E3779B9))``.

The tracking loops run per pixel until the pixel is done: a pixel's stream
advances by the draws its own iterations take (a free path that leaves the
segment takes 1, one that stays takes 2; a transmittance step takes 1), as
in a sequential fragment.  Scenes with a cheb-skip tracking table extend
each free path to at least (cheb − 1) empty cells, as in ``mcm.py``.

:func:`generate` is the plain PyTorch frame; :func:`render_frame` runs the
frame through ``kernels/mcs_frame.py`` (the plain frame on the CPU, one
launch of the MCS kernel on the card), updating the state in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng, sampling
from ..kernels import mcs_frame
from . import _march
from .base import Scene, state_device, volume_shape

#: the tracking loops' backstop; delta tracking ends after about
#: extinction · path length events
_MAX_TRACKING_ITERS = 100000


@dataclasses.dataclass(frozen=True)
class Params:
    extinction: float = 1.0


def reset(params: Params, height: int, width: int, scene: Scene = None):
    acc = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=state_device(scene))
    acc[..., 3] = 1.0
    return acc


def scatter_direction(seed) -> tuple:
    """The frame's uniform scatter direction, three float32 scalars
    computed on the host: the Marsaglia sphere sample (``rng.sphere``'s
    float32 operations) of the stream ``pcg(bits(seed) ^ 0x9E3779B9)``."""
    f32 = np.float32
    state = _march.pcg(int(f32(seed).view(np.uint32)) ^ 0x9E3779B9)
    draws = []
    for _ in range(2):
        state = _march.pcg(state)
        draws.append(f32(state) * f32(2.0 ** -32))
    radius = np.sqrt(draws[0])
    angle = rng.TWOPI * draws[1]
    d0, d1 = radius * np.cos(angle), radius * np.sin(angle)
    norm = d0 * d0 + d1 * d1
    rad2 = f32(2.0) * np.sqrt(max(f32(1.0) - norm, f32(0.0)))
    return rad2 * d0, rad2 * d1, f32(1.0) - f32(2.0) * norm


def skip_cell_size(scene) -> float:
    """The cheb hop's cell: the smallest of the three axes' 1/N (of the
    whole volume for a HaloScene)."""
    d, h, w = volume_shape(scene)[:3]
    return min(1.0 / d, 1.0 / h, 1.0 / w)


def generate(scene: Scene, params: Params, seed, height: int, width: int,
             *, window=None):
    """One single-scattering sample per pixel, (H, W, 4).  ``window``:
    None, or ``(row0, full_height)``: the ``height`` rows from ``row0`` of
    a ``full_height``-row image (``sampling.pixel_ndc``)."""
    dev = scene.device
    ndc = sampling.pixel_ndc(height, width, device=dev, window=window)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    ray = ray_to - ray_from
    dir_unit = ray / torch.sqrt(torch.clamp(_march.dot3(ray, ray),
                                            min=1e-20))[..., None]
    tb = torch.clamp(sampling.intersect_cube(ray_from, ray), min=0.0)
    miss = tb[..., 0] >= tb[..., 1]
    start = ray_from + tb[..., 0:1] * ray
    end = ray_from + tb[..., 1:2] * ray
    max_distance = _march.segment_length(start, end)
    extinction = float(np.float32(params.extinction))

    use_skip = scene.tracking_packed is not None
    cell = skip_cell_size(scene) if use_skip else None

    def alpha_at(pos):
        """(alpha, cheb) at pos; cheb is None without a tracking table."""
        if use_skip:
            vs, cheb = scene.sample_color_tracking(pos)
            return vs[..., 3], cheb
        return scene.sample_color(pos)[..., 3], None

    def extend(d, cheb):
        """The free path extended through the empty cells around the last
        landing (cheb-skip; exact by memorylessness)."""
        if not use_skip:
            return d
        return torch.maximum(d, torch.clamp(cheb - 1.0, min=0.0) * cell)

    def sample_distance(state, seg_from, seg_to, max_dist):
        """sampleDistance (glsl:70-87): a pixel whose path leaves the
        segment takes 1 draw in that iteration, one that stays takes 2."""
        dist = torch.zeros_like(max_dist)
        cheb = torch.zeros_like(max_dist)
        done = torch.zeros_like(max_dist, dtype=torch.bool)
        it = 0
        while it < _MAX_TRACKING_ITERS and not bool(done.all()):
            s1, d = rng.exponential(state, extinction)
            ndist = dist + extend(d, cheb)
            over = ndist > max_dist
            pos = seg_from + (ndist / max_dist)[..., None] \
                * (seg_to - seg_from)
            s2, u = rng.uniform(s1)
            alpha, cheb_new = alpha_at(pos)
            collide = ~over & (u < alpha)
            state = torch.where(done, state, torch.where(over, s1, s2))
            dist = torch.where(done, dist, ndist)
            if use_skip:
                cheb = torch.where(done, cheb, cheb_new)
            done = done | over | collide
            it += 1
        return state, dist

    def sample_transmittance(state, seg_from, seg_to, max_dist):
        """sampleTransmittance (glsl:89-105): one draw an iteration."""
        dist = torch.zeros_like(max_dist)
        cheb = torch.zeros_like(max_dist)
        trans = torch.ones_like(max_dist)
        done = torch.zeros_like(max_dist, dtype=torch.bool)
        it = 0
        while it < _MAX_TRACKING_ITERS and not bool(done.all()):
            s1, d = rng.exponential(state, extinction)
            ndist = dist + extend(d, cheb)
            over = ndist > max_dist
            pos = seg_from + (ndist / max_dist)[..., None] \
                * (seg_to - seg_from)
            active = ~done & ~over
            alpha, cheb_new = alpha_at(pos)
            state = torch.where(done, state, s1)
            dist = torch.where(done, dist, ndist)
            trans = torch.where(active, trans * (1.0 - alpha), trans)
            if use_skip:
                cheb = torch.where(done, cheb, cheb_new)
            done = done | over
            it += 1
        return state, trans

    direction = torch.tensor([float(x) for x in scatter_direction(seed)],
                             dtype=torch.float32, device=dev)

    state = rng.seed_pixels(ndc * 0.5 + 0.5, np.float32(seed))
    clamped = torch.clamp(max_distance, min=1e-20)
    state, dist = sample_distance(state, start, end, clamped)
    escaped = dist > max_distance

    # the scattering point and its shadow segment along the direction
    spoint = start + (dist / clamped)[..., None] * (end - start)
    tb2 = torch.clamp(sampling.intersect_cube(spoint, direction), min=0.0)
    sto = spoint + direction * tb2[..., 1:2]
    sdist = _march.segment_length(spoint, sto)

    diffuse = scene.sample_color_tracking(spoint)[0] if use_skip \
        else scene.sample_color(spoint)
    light = scene.sample_env(direction)
    state, trans = sample_transmittance(state, spoint, sto,
                                        torch.clamp(sdist, min=1e-20))

    scatter_color = diffuse * light * trans[..., None]
    env_color = scene.sample_env(dir_unit)
    return torch.where((miss | escaped)[..., None], env_color, scatter_color)


def integrate(state, frame, frame_number):
    """acc + (frame − acc) / n, in place, the IEEE quotient
    (MCS integrate:173-177)."""
    n = torch.full_like(state, float(np.float32(frame_number)))
    state.copy_(state + (frame - state) / n)


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, window=None):
    mcs_frame.mcs_frame(state, scene, params, seed, frame_number,
                        window=window)
    return state


def display(state, scene: Scene, params: Params):
    return state.clone()
