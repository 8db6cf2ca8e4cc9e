"""Tone-mapping suite: the reference's ten curves.

Mirrors ``vpt_tpu/tonemap.py``.  Each mapper takes an (..., 3|4) HDR image
and returns display RGBA with alpha 1.  The curves run in the JAX package's
float32 order; Python-double constants round once to float32, as JAX's weak
types do.

:class:`ToneMapper` on a CUDA image launches the display kernel
(``kernels/tonemap_kernel.py``) for the eight :data:`RAW_CURVES`;
``artistic`` and ``range`` stay plain PyTorch, as the TPU kernel does not
compute them either.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from .utils import smoothstep as _smoothstep


def _split_rgb(image):
    if image.shape[-1] == 4:
        return image[..., :3]
    return image


def _finish(rgb, gamma):
    """pow(vec4(curve(rgb·exposure), 1), 1/gamma) as in every GLSL mapper."""
    rgb = torch.pow(torch.clamp(rgb, min=0.0), 1.0 / gamma)
    return torch.cat([rgb, torch.ones(rgb.shape[:-1] + (1,),
                                      dtype=rgb.dtype, device=rgb.device)],
                     dim=-1)


def _curve_reinhard(x):
    return x / (1.0 + x)


def _curve_reinhard2(x):
    l_white2 = 4.0 * 4.0
    return (x * (1.0 + x / l_white2)) / (1.0 + x)


def _uncharted2_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2_white_scale() -> torch.Tensor:
    """The curve at the white point W = 11.2, evaluated in float32."""
    return _uncharted2_curve(torch.tensor(11.2, dtype=torch.float32))


def _curve_uncharted2(x):
    return _uncharted2_curve(2.0 * x) / uncharted2_white_scale().to(x.device)


def _curve_filmic(x):
    x = torch.clamp(x - 0.004, min=0.0)
    result = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return torch.pow(result, 2.2)


def _curve_unreal(x):
    return x / (x + 0.155) * 1.019


def _curve_aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


LOTTES_A, LOTTES_D, LOTTES_HDR_MAX, LOTTES_MID_IN, LOTTES_MID_OUT = \
    1.6, 0.977, 8.0, 0.18, 0.267


def lottes_bc():
    """Lottes's derived b and c, as Python doubles."""
    a, d, hdr_max = LOTTES_A, LOTTES_D, LOTTES_HDR_MAX
    mid_in, mid_out = LOTTES_MID_IN, LOTTES_MID_OUT
    b = ((-mid_in ** a + hdr_max ** a * mid_out)
         / ((hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out))
    c = ((hdr_max ** (a * d) * mid_in ** a
          - hdr_max ** a * mid_in ** (a * d) * mid_out)
         / ((hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out))
    return b, c


def _curve_lottes(x):
    x = torch.clamp(x, min=0.0)
    b, c = lottes_bc()
    a, d = LOTTES_A, LOTTES_D
    return torch.pow(x, a) / (torch.pow(x, a * d) * b + c)


def _curve_uchimura(x):
    x = torch.clamp(x, min=0.0)
    p, a, m, l, c, b = 1.0, 1.0, 0.22, 0.4, 1.33, 0.0
    l0 = ((p - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * p) / (p - s1)
    cp = -c2 / p
    w0 = 1.0 - _smoothstep(0.0, m, x)
    w2 = torch.where(x >= m + l0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2
    t = m * torch.pow(x / m, c) + b
    s = p - (p - s1) * torch.exp(cp * (x - s0))
    lin = m + a * (x - m)
    return t * w0 + lin * w1 + s * w2


def reinhard(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_reinhard(_split_rgb(image) * exposure), gamma)


def reinhard2(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_reinhard2(_split_rgb(image) * exposure), gamma)


def uncharted2(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_uncharted2(_split_rgb(image) * exposure), gamma)


def filmic(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_filmic(_split_rgb(image) * exposure), gamma)


def unreal(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_unreal(_split_rgb(image) * exposure), gamma)


def aces(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_aces(_split_rgb(image) * exposure), gamma)


def lottes(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_lottes(_split_rgb(image) * exposure), gamma)


def uchimura(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_uchimura(_split_rgb(image) * exposure), gamma)


def range_map(image, low=0.0, high=1.0, gamma=2.2):
    """RangeToneMapper.glsl: linear window [low, high] + gamma."""
    x = _split_rgb(image)
    return _finish((x - low) / (high - low), gamma)


def artistic(image, low=0.0, mid=0.5, high=1.0, saturation=1.0, gamma=2.2):
    """ArtisticToneMapper.glsl: levels + saturation + implied gamma."""
    dev = image.device
    x = (_split_rgb(image) - low) / (high - low)
    gray = torch.full((3,), 1.0, dtype=torch.float32, device=dev) \
        / torch.sqrt(torch.tensor(3.0, dtype=torch.float32, device=dev))
    luma = (x * gray).sum(-1, keepdim=True) * gray
    x = luma * (1.0 - saturation) + x * saturation
    midpoint = (mid - low) / (high - low)
    exponent = -torch.log(torch.tensor(midpoint, dtype=torch.float32,
                                       device=dev)) \
        / torch.log(torch.tensor(2.0, dtype=torch.float32, device=dev))
    rgb = torch.pow(torch.clamp(x, min=0.0), exponent / gamma)
    return torch.cat([rgb, torch.ones(rgb.shape[:-1] + (1,),
                                      dtype=rgb.dtype, device=dev)], dim=-1)


RAW_CURVES: Dict[str, Callable] = {
    "reinhard": _curve_reinhard,
    "reinhard2": _curve_reinhard2,
    "uncharted2": _curve_uncharted2,
    "filmic": _curve_filmic,
    "unreal": _curve_unreal,
    "aces": _curve_aces,
    "lottes": _curve_lottes,
    "uchimura": _curve_uchimura,
}

TONE_MAPPERS: Dict[str, Callable] = {
    "artistic": artistic,
    "range": range_map,
    "reinhard": reinhard,
    "reinhard2": reinhard2,
    "uncharted2": uncharted2,
    "filmic": filmic,
    "unreal": unreal,
    "aces": aces,
    "lottes": lottes,
    "uchimura": uchimura,
}


@dataclasses.dataclass
class ToneMapper:
    """Configured tone mapper, callable on images.  A CUDA image with a
    RAW_CURVES name goes through the display kernel."""

    name: str = "artistic"
    params: dict = dataclasses.field(default_factory=dict)

    def __call__(self, image):
        if image.is_cuda and self.name in RAW_CURVES:
            from .kernels import tonemap_kernel

            return tonemap_kernel.tonemap(image, self.name, **self.params)
        return get(self.name)(image, **self.params)


def get(name: str) -> Callable:
    if name not in TONE_MAPPERS:
        raise ValueError(
            f"unknown tone mapper {name!r}; available: {sorted(TONE_MAPPERS)}")
    return TONE_MAPPERS[name]
