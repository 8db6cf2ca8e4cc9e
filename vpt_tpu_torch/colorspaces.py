"""Color-space conversions and packing helpers.

Mirrors ``vpt_tpu/colorspaces.py``: RGB↔XYZ↔xyY (XYZITU2002.glsl:3-30),
RGB↔YUV (YUVBT601.glsl, YUVBT709.glsl), scalar→rainbow (hue.glsl:3-10) and
the float↔RGBA8 packers (floatToRgba.glsl, rgbaToFloat.glsl,
encodeFloat.glsl).  Elementwise over (..., 3) / (..., 4) float32 tensors.
The 3×3 products are elementwise sums in a fixed order, so no TF32 product
reaches them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import smoothstep

_RGB2XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
], dtype=np.float32)

_XYZ2RGB = np.array([
    [3.240481, -1.537152, -0.498536],
    [-0.969255, 1.875990, 0.041556],
    [0.055647, -0.204041, 1.057311],
], dtype=np.float32)

_RGB2YUV_601 = np.array([
    [0.29900, 0.58700, 0.11400],
    [-0.14713, -0.28886, 0.43600],
    [0.61500, -0.51499, -0.10001],
], dtype=np.float32)

_YUV2RGB_601 = np.array([
    [1.0, 0.0, 1.13983],
    [1.0, -0.39465, -0.58060],
    [1.0, 2.03211, 0.0],
], dtype=np.float32)

_RGB2YUV_709 = np.array([
    [0.21260, 0.71520, 0.07220],
    [-0.09991, -0.33609, 0.43600],
    [0.61500, -0.55861, -0.05639],
], dtype=np.float32)

_YUV2RGB_709 = np.array([
    [1.0, 0.0, 1.28033],
    [1.0, -0.21482, -0.38059],
    [1.0, 2.12798, 0.0],
], dtype=np.float32)


def _apply3(x, m):
    """``x @ m.T`` over the last axis as a float32 sum, left to right."""
    x = torch.as_tensor(x, dtype=torch.float32)
    m = torch.from_numpy(m).to(x.device)
    return x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1] \
        + x[..., 2:3] * m[:, 2]


def rgb2xyz(rgb):
    return _apply3(rgb, _RGB2XYZ)


def xyz2rgb(xyz):
    return _apply3(xyz, _XYZ2RGB)


def xyz2xyY(xyz):
    s = xyz[..., 0] + xyz[..., 1] + xyz[..., 2]
    return torch.stack([xyz[..., 0] / s, xyz[..., 1] / s, xyz[..., 1]],
                       dim=-1)


def xyY2xyz(xyY):
    x, y, Y = xyY[..., 0], xyY[..., 1], xyY[..., 2]
    scale = Y / y
    return torch.stack([x * scale, y * scale, (1.0 - x - y) * scale],
                       dim=-1)


def rgb2yuv(rgb, standard="bt601"):
    return _apply3(rgb, _RGB2YUV_601 if standard == "bt601"
                   else _RGB2YUV_709)


def yuv2rgb(yuv, standard="bt601"):
    return _apply3(yuv, _YUV2RGB_601 if standard == "bt601"
                   else _YUV2RGB_709)


def hue(x):
    """Scalar → rainbow RGBA (mixins/hue.glsl:3-10)."""
    part = 1.0 / 6.0
    x = torch.as_tensor(x, dtype=torch.float32)
    r = smoothstep(1 * part, 2 * part, x) - smoothstep(4 * part, 5 * part, x)
    g = smoothstep(0 * part, 1 * part, x) - smoothstep(3 * part, 4 * part, x)
    b = smoothstep(2 * part, 3 * part, x) - smoothstep(5 * part, 6 * part, x)
    return torch.stack([1.0 - r, g, b, torch.ones_like(x)], dim=-1)


def float_to_rgba(x):
    """Pack a [0,1) float into 4 × 8-bit channels (mixins/floatToRgba.glsl)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    encoder = torch.tensor([1.0, 255.0, 255.0 ** 2, 255.0 ** 3],
                           dtype=torch.float32, device=x.device)
    corrector = torch.tensor([1 / 255.0, 1 / 255.0, 1 / 255.0, 0.0],
                             dtype=torch.float32, device=x.device)
    enc = torch.remainder(x[..., None] * encoder, 1.0)
    shifted = torch.cat([enc[..., 1:], enc[..., 3:4]], dim=-1)
    return enc - shifted * corrector


def rgba_to_float(rgba):
    """Inverse of :func:`float_to_rgba` (mixins/rgbaToFloat.glsl): the sum
    of the four scaled channels, left to right."""
    rgba = torch.as_tensor(rgba, dtype=torch.float32)
    decoder = 1.0 / torch.tensor([1.0, 255.0, 255.0 ** 2, 255.0 ** 3],
                                 dtype=torch.float32, device=rgba.device)
    p = rgba * decoder
    return p[..., 0] + p[..., 1] + p[..., 2] + p[..., 3]


def encode_float(x):
    """A float32's IEEE-754 bytes, little-endian, each scaled to [0, 1]
    (mixins/encodeFloat.glsl; the exact bits come from a bitcast)."""
    bits = torch.as_tensor(x, dtype=torch.float32).view(torch.int32) \
        .to(torch.int64) & 0xFFFFFFFF
    bytes_ = torch.stack([(bits >> s) & 0xFF for s in (0, 8, 16, 24)],
                         dim=-1)
    return bytes_.to(torch.float32) / 255.0


def decode_float(rgba):
    """Inverse of :func:`encode_float`."""
    b = (torch.as_tensor(rgba, dtype=torch.float32) * 255.0 + 0.5) \
        .to(torch.int64)
    bits = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) \
        | (b[..., 3] << 24)
    # two's complement of the top bit, then the float's bits
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)
