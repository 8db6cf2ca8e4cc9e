"""EAM: emission-absorption ray marching with progressive refinement.

Mirrors ``vpt_tpu/renderers/eam.py`` (EAMRenderer.glsl generate:52-80,
integrate:100-119): front-to-back compositing of the TF color along each
ray with an early exit at alpha >= 0.99, the ``a > 1`` normalisation, and
the running mean ``acc + (frame − acc) · 1/n``.

:func:`generate` is the plain PyTorch frame; :func:`render_frame` runs the
frame through ``kernels/march.py`` (the plain frame on the CPU, one launch
of the march kernel on the card), updating the state in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import march as march_kernel
from ..utils import constant
from . import _march
from .base import Scene, frame_weight, state_device, static_field


@dataclasses.dataclass(frozen=True)
class Params:
    extinction: float = 100.0
    slices: int = static_field(default=64)
    random: bool = static_field(default=True)


def reset(params: Params, height: int, width: int, scene: Scene = None):
    """The accumulator clears to (0, 0, 0, 1) on the scene's device."""
    acc = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=state_device(scene))
    acc[..., 3] = 1.0
    return acc


def schedule(params: Params, seed):
    """(first t, step) of the frame's slices, float32 on the host."""
    return _march.jittered_schedule(params.slices, params.random, seed)


def generate(scene: Scene, params: Params, seed, height: int, width: int,
             *, window=None):
    """One jittered front-to-back march per pixel, (H, W, 4)."""
    tb, miss, start, end = _march.rays(scene, height, width, window=window)
    t0, step = schedule(params, seed)
    ray_step_length = _march.segment_length(start, end) * float(step)
    extinction = float(np.float32(params.extinction))

    def composite(acc, t, color):
        active = (t < 1.0) & (acc[..., 3] < 0.99)
        alpha = color[..., 3] * ray_step_length * extinction
        premult = torch.cat([color[..., :3] * alpha[..., None],
                             alpha[..., None]], dim=-1)
        new_acc = acc + (1.0 - acc[..., 3:4]) * premult
        return torch.where(active[..., None], new_acc, acc)

    ts = _march.schedule(t0, step, params.slices, scene.device)
    acc0 = torch.zeros((height, width, 4), dtype=torch.float32,
                       device=scene.device)
    acc = _march.march(scene, start, end, ts, composite, acc0)
    # `if (a > 1) rgb /= a` (EAM glsl:74-76)
    over = acc[..., 3:4] > 1.0
    rgb = torch.where(over, acc[..., :3] / torch.clamp(acc[..., 3:4],
                                                       min=1e-6),
                      acc[..., :3])
    frame = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    black = constant((0.0, 0.0, 0.0, 1.0), torch.float32, scene.device)
    return torch.where(miss[..., None], black, frame)


def integrate(state, frame, frame_number):
    """state + (frame − state) · 1/n, in place (EAMRenderer.js:120-136)."""
    state.copy_(state + (frame - state) * float(frame_weight(frame_number)))


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, window=None):
    """generate + integrate, in place on ``state``."""
    march_kernel.march_frame("eam", state, scene, params, seed,
                             frame_number, window=window)
    return state


def display(state, scene: Scene, params: Params):
    return state.clone()
