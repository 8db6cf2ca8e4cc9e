"""Interpolation helpers; mirrors the tensor helpers of
``vpt_tpu/utils.py``."""

from __future__ import annotations

import torch


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def lerp(a, b, t):
    return a + (b - a) * t


def step(edge, x):
    return torch.where(x < edge, 0.0, 1.0)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
