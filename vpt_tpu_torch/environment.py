"""Environment maps (equirectangular RGBA textures).

Mirrors ``white`` and ``constant`` of ``vpt_tpu/environment.py``.
"""

from __future__ import annotations

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
