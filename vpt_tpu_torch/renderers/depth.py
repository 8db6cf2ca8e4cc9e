"""Depth: first-crossing depth image.

Mirrors ``vpt_tpu/renderers/depth.py`` (DepthRenderer.glsl generate:53-79):
an EAM-style march accumulating opacity until it crosses ``threshold``; the
output is the ray parameter at the crossing, ``mix(tnear, tfar, t)``, or −1
where the ray never crosses.  The integrate is EAM's running mean.

The samples sit at the schedule ``t0 + i·step``, but the carried ``t`` that
becomes the depth advances by repeated addition, ``t + step``, while the
pixel is active: the two part by ulps, and the port carries both, as JAX
does.  :func:`render_frame` runs the frame through ``kernels/march.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import march as march_kernel
from . import _march
from .base import Scene, frame_weight, state_device, static_field


@dataclasses.dataclass(frozen=True)
class Params:
    extinction: float = 100.0
    slices: int = static_field(default=64)
    threshold: float = 0.1
    random: bool = static_field(default=False)


def reset(params: Params, height: int, width: int, scene: Scene = None):
    acc = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=state_device(scene))
    acc[..., 3] = 1.0
    return acc


def schedule(params: Params, seed):
    """(first t, step) of the frame's slices, float32 on the host."""
    return _march.jittered_schedule(params.slices, params.random, seed)


def generate(scene: Scene, params: Params, seed, height: int, width: int,
             *, window=None):
    """The frame's depth, (H, W): −1 on a miss or below the threshold."""
    tb, miss, start, end = _march.rays(scene, height, width, window=window)
    t0, step = schedule(params, seed)
    ray_step_length = _march.segment_length(start, end) * float(step)
    extinction = float(np.float32(params.extinction))
    threshold = float(np.float32(params.threshold))

    def composite(carry, t_sched, color):
        t, acc = carry
        active = (t < 1.0) & (acc < threshold)
        alpha = color[..., 3]
        new_acc = acc + (1.0 - acc) * alpha * ray_step_length * extinction
        acc = torch.where(active, new_acc, acc)
        t = torch.where(active, t + float(step), t)
        return t, acc

    ts = _march.schedule(t0, step, params.slices, scene.device)
    t_init = torch.full((height, width), float(t0), dtype=torch.float32,
                        device=scene.device)
    t, acc = _march.march(scene, start, end, ts, composite,
                          (t_init, torch.zeros_like(t_init)))
    # oDepth = mix(tnear, tfar, t) at the exit t, else -1 (glsl:73-77)
    depth = tb[..., 0] + t * (tb[..., 1] - tb[..., 0])
    minus = torch.full_like(depth, -1.0)
    depth = torch.where(acc < threshold, minus, depth)
    return torch.where(miss, minus, depth)


def integrate(state, frame, frame_number):
    """state + ((depth, 0, 0, 1) − state) · 1/n, in place."""
    zeros = torch.zeros_like(frame)
    frame = torch.stack([frame, zeros, zeros, torch.ones_like(frame)],
                        dim=-1)
    state.copy_(state + (frame - state) * float(frame_weight(frame_number)))


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, window=None):
    march_kernel.march_frame("depth", state, scene, params, seed,
                             frame_number, window=window)
    return state


def display(state, scene: Scene, params: Params):
    """vec4(vec3(depth), 1): grey depth."""
    return _march.grey(state[..., 0])
