"""Small shared utilities, which mirror ``vpt_tpu/utils.py`` (hex↔rgb
colors, interpolation helpers, JSON file round trips), the port's default
device and its cache of constant tensors."""

from __future__ import annotations

import functools
import json
from pathlib import Path

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


@functools.lru_cache(maxsize=256)
def constant(value, dtype, device) -> torch.Tensor:
    """The tensor ``torch.tensor(value, dtype=dtype, device=device)``,
    built once per (value, dtype, device) and shared: on a CUDA device
    each build is a host-to-device copy that waits for the stream, which a
    per-call build would pay at every call.  ``value`` is a number or a
    tuple of numbers.  Callers must not write to it.  It is built outside
    inference mode, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype, device=device)


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def lerp(a, b, t):
    return a + (b - a) * t


def step(edge, x):
    return torch.where(x < edge, 0.0, 1.0)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def hex2rgb(s: str):
    """'#rrggbb' → (r, g, b) floats in [0, 1] (CommonUtils.hex2rgb)."""
    s = s.lstrip("#")
    return tuple(int(s[i:i + 2], 16) / 255.0 for i in (0, 2, 4))


def rgb2hex(r: float, g: float, b: float) -> str:
    def byte(x):
        return int(max(0.0, min(1.0, x)) * 255.0 + 0.5)

    return "#{:02x}{:02x}{:02x}".format(byte(r), byte(g), byte(b))


def download_json(obj, path):
    """Write an object as JSON (CommonUtils.downloadJSON counterpart)."""
    Path(path).write_text(json.dumps(obj, indent=2))


def read_json(path):
    return json.loads(Path(path).read_text())
