"""Renderer registry: string → renderer, mirroring
``vpt_tpu/renderers/factory.py``.  Every renderer of vpt_tpu is ported."""

from __future__ import annotations

from . import base, depth, dos, eam, iso, lao, mcm, mcs, mip

MODULES = {"mip": mip, "iso": iso, "eam": eam, "dos": dos, "mcs": mcs,
           "mcm": mcm, "lao": lao, "depth": depth}


def get_module(key: str):
    if key not in MODULES:
        raise ValueError(
            f"unknown renderer {key!r}; available: {sorted(MODULES)}")
    return MODULES[key]


def make_renderer(key: str, params=None, height: int = 512,
                  width: int = 512) -> base.Renderer:
    module = get_module(key)
    cls = type(f"{key.upper()}Renderer", (base.Renderer,), {
        "module": module,
        "Params": module.Params,
    })
    return cls(params=params, height=height, width=width)
