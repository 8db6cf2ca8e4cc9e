"""MIP: maximum-intensity projection.

Mirrors ``vpt_tpu/renderers/mip.py`` (MIPRenderer.glsl generate:51-72,
integrate:105-109): a jittered march taking the maximum TF alpha along the
ray, integrated as a running max over progressive frames.  The slices walk
``mod(offset + i·step, 1)``, the GLSL do/while.

:func:`render_frame` runs the frame through ``kernels/march.py`` (the
plain frame on the CPU, one launch of the march kernel on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import march as march_kernel
from . import _march
from .base import Scene, state_device, static_field


@dataclasses.dataclass(frozen=True)
class Params:
    steps: int = static_field(default=64)


def reset(params: Params, height: int, width: int, scene: Scene = None):
    return torch.zeros((height, width), dtype=torch.float32,
                       device=state_device(scene))


def schedule(params: Params, seed):
    """(offset, step): the slices sit at mod(offset + i·step, 1)."""
    return _march.frame_offset(seed), np.float32(1.0 / params.steps)


def generate(scene: Scene, params: Params, seed, height: int, width: int,
             *, window=None):
    """The frame's per-pixel maximum alpha, (H, W); 0 on a miss."""
    _, miss, start, end = _march.rays(scene, height, width, window=window)
    offset, step = schedule(params, seed)

    def composite(val, t, color):
        return torch.maximum(val, color[..., 3])

    # the offsets are non-negative, where fmod is JAX's mod, exactly
    ts = torch.fmod(_march.schedule(offset, step, params.steps,
                                    scene.device), 1.0)
    val0 = torch.zeros((height, width), dtype=torch.float32,
                       device=scene.device)
    val = _march.march(scene, start, end, ts, composite, val0)
    return torch.where(miss, torch.zeros_like(val), val)


def integrate(state, frame, frame_number):
    """max(acc, frame), in place (the MIP integrate fragment)."""
    del frame_number
    torch.maximum(state, frame, out=state)


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, window=None):
    march_kernel.march_frame("mip", state, scene, params, seed,
                             frame_number, window=window)
    return state


def display(state, scene: Scene, params: Params):
    """Grey: vec4(acc, acc, acc, 1)."""
    return _march.grey(state)
