"""Transfer functions: Gaussian bumps, the diagnostic gray ramp and the GL
texture path.

Mirrors ``vpt_tpu/transfer.py``.  A bump contributes ``color · exp(−r²)``
with ``r = |(bump.position − uv) / bump.size|``, composited in order with
premultiplied alpha over (``dst·(1 − src.a) + src``), as the reference's
TransferFunction widget draws it.  Bumps serialize to and from the widget's
JSON format, so TFs authored in the reference UI load directly.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Sequence

import numpy as np
import torch

from .utils import resolve_device

DEFAULT_SIZE = 256  # widget default (TransferFunction.js:33-34)


@dataclasses.dataclass
class TransferFunctionBumps:
    """Batched bump parameters: positions and sizes (N, 2), colors (N, 4),
    float32 tensors on one device."""

    positions: torch.Tensor
    sizes: torch.Tensor
    colors: torch.Tensor

    @property
    def num_bumps(self) -> int:
        return self.positions.shape[0]

    @staticmethod
    def from_list(bumps: Sequence[Any],
                  device=None) -> "TransferFunctionBumps":
        """From the widget's JSON structure, on ``device`` (default: the
        card): [{"position": {"x","y"}, "size": {"x","y"},
        "color": {"r","g","b","a"}}]."""
        device = resolve_device(device)
        pos = np.array([[b["position"]["x"], b["position"]["y"]]
                        for b in bumps], dtype=np.float32).reshape(-1, 2)
        size = np.array([[b["size"]["x"], b["size"]["y"]] for b in bumps],
                        dtype=np.float32).reshape(-1, 2)
        col = np.array([[b["color"]["r"], b["color"]["g"], b["color"]["b"],
                         b["color"]["a"]] for b in bumps],
                       dtype=np.float32).reshape(-1, 4)
        return TransferFunctionBumps(*(torch.from_numpy(a).to(device)
                                       for a in (pos, size, col)))

    @staticmethod
    def default(device=None) -> "TransferFunctionBumps":
        """The widget's default new bump (TransferFunction.js:129-144)."""
        return TransferFunctionBumps.from_list([{
            "position": {"x": 0.5, "y": 0.5},
            "size": {"x": 0.2, "y": 0.2},
            "color": {"r": 1.0, "g": 0.0, "b": 0.0, "a": 1.0},
        }], device)

    def to_list(self) -> List[dict]:
        pos, size, col = (t.detach().cpu().numpy()
                          for t in (self.positions, self.sizes, self.colors))
        return [{
            "position": {"x": float(pos[i, 0]), "y": float(pos[i, 1])},
            "size": {"x": float(size[i, 0]), "y": float(size[i, 1])},
            "color": {"r": float(col[i, 0]), "g": float(col[i, 1]),
                      "b": float(col[i, 2]), "a": float(col[i, 3])},
        } for i in range(self.num_bumps)]

    def to_json(self) -> str:
        return json.dumps(self.to_list())

    @staticmethod
    def from_json(text: str, device=None) -> "TransferFunctionBumps":
        return TransferFunctionBumps.from_list(json.loads(text), device)


def rasterize(bumps: TransferFunctionBumps, height: int = DEFAULT_SIZE,
              width: int = DEFAULT_SIZE) -> torch.Tensor:
    """Render the bump list to an (H, W, 4) float32 RGBA texture on the
    bumps' device; row 0 is y = 0 (bottom).  One (H, W, 4) draw a bump, in
    bump order, as ``vpt_tpu``'s ``lax.scan``.  The texel centres divide by
    tensors: the true quotients on every device."""
    device = bumps.positions.device

    def centres(n):
        return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
            / torch.tensor(float(n), device=device)

    vv, uu = torch.meshgrid(centres(height), centres(width), indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)                     # (H, W, 2)
    dst = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
    for position, size, color in zip(bumps.positions, bumps.sizes,
                                      bumps.colors):
        delta = (position - uv) / size
        r2 = delta[..., 0:1] * delta[..., 0:1] + delta[..., 1:2] \
            * delta[..., 1:2]
        src = color * torch.exp(-r2)
        dst = dst * (1.0 - src[..., 3:4]) + src
    return dst


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
