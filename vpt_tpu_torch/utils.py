"""Interpolation helpers, which mirror the tensor helpers of
``vpt_tpu/utils.py``, and the port's default device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card where it is None: the port's entry points
    run on the card unless the caller asks for another device.  Without a
    card, asking for none raises; nothing falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def lerp(a, b, t):
    return a + (b - a) * t


def step(edge, x):
    return torch.where(x < edge, 0.0, 1.0)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
