"""Transfer functions: the diagnostic gray ramp and the GL texture path.

Mirrors ``gray_ramp`` and ``to_gl_texture`` of ``vpt_tpu/transfer.py``.
"""

from __future__ import annotations

import torch

from .utils import resolve_device

DEFAULT_SIZE = 256


def to_gl_texture(texture, srgb: bool = True,
                  quantize: bool = True) -> torch.Tensor:
    """Emulate the reference's SRGB8_ALPHA8 TF texture: 8-bit quantize, then
    sRGB-decode the color channels; alpha stays linear."""
    tex = torch.as_tensor(texture, dtype=torch.float32)
    if quantize:
        tex = torch.round(torch.clamp(tex, 0.0, 1.0) * 255.0) / 255.0
    if srgb:
        rgb = tex[..., :3]
        linear = torch.where(rgb <= 0.04045, rgb / 12.92,
                             torch.pow((rgb + 0.055) / 1.055, 2.4))
        tex = torch.cat([linear, tex[..., 3:4]], dim=-1)
    return tex


def gray_ramp(height: int = 2, width: int = DEFAULT_SIZE,
              alpha_scale: float = 1.0, device=None) -> torch.Tensor:
    """Diagnostic TF: color = value, alpha = value · scale, on ``device``
    (default: the card)."""
    device = resolve_device(device)
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width
    row = torch.stack([u, u, u, u * alpha_scale], dim=-1)
    return row[None].expand(height, width, 4).contiguous()
