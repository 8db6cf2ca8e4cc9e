"""Environment maps (equirectangular RGBA textures).

Mirrors ``vpt_tpu/environment.py``.  The MCM and MCS renderers look a
map up at a direction (``sampling.sample_environment``); their kernels keep
a 1×1 map's texel in shared memory and read a larger map from device
memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device


def white(height: int = 1, width: int = 1, device=None) -> torch.Tensor:
    """Constant white environment, the reference default, on ``device``
    (default: the card)."""
    return torch.ones(height, width, 4, dtype=torch.float32,
                      device=resolve_device(device))


def constant(color, height: int = 1, width: int = 1,
             device=None) -> torch.Tensor:
    device = resolve_device(device)
    c = torch.as_tensor(color, dtype=torch.float32, device=device)
    if c.shape[-1] == 3:
        c = torch.cat([c, torch.ones(1, dtype=torch.float32, device=device)])
    return c.expand(height, width, 4).contiguous()


def gradient_sky(height: int = 64, width: int = 128,
                 horizon=(1.0, 0.9, 0.7), zenith=(0.3, 0.5, 1.0),
                 device=None) -> torch.Tensor:
    """Vertical-gradient sky for tests and demos, on ``device`` (default:
    the card)."""
    t = (np.arange(height, dtype=np.float32) + 0.5) / height
    horizon = np.asarray(horizon, np.float32)
    zenith = np.asarray(zenith, np.float32)
    rows = horizon[None] * (1 - t[:, None]) + zenith[None] * t[:, None]
    rgba = np.concatenate([
        np.broadcast_to(rows[:, None, :], (height, width, 3)),
        np.ones((height, width, 1), np.float32),
    ], axis=-1)
    return torch.from_numpy(rgba).to(resolve_device(device))


def from_image(image: np.ndarray, device=None) -> torch.Tensor:
    """An (H, W, 3|4) uint8 or float image as a float32 RGBA map on
    ``device`` (default: the card)."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.ones(img.shape[:-1] + (1,), np.float32)], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(img)).to(
        resolve_device(device))
