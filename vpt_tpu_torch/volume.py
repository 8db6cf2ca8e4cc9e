"""Volumes: the 3D scalar fields the renderers sample.

Mirrors ``vpt_tpu/volume.py``: a volume is a (D, H, W, C) float32 tensor in
[0, 1] plus its filter.  The synthetic volumes are built with numpy by the
same code as the JAX package's, so both packages get identical data.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .utils import resolve_device


@dataclasses.dataclass
class Volume:
    """data: (D, H, W, C) float32; ``filter`` in {'linear', 'nearest',
    'cubic'}."""

    data: torch.Tensor
    filter: str = "linear"

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape[:3])

    @property
    def channels(self) -> int:
        return self.data.shape[3]


def normalized_grid(depth: int, height: int, width: int):
    """Texture-space coordinates of voxel centers, three (D, H, W) numpy
    arrays (x, y, z)."""
    z = (np.arange(depth, dtype=np.float32) + 0.5) / depth
    y = (np.arange(height, dtype=np.float32) + 0.5) / height
    x = (np.arange(width, dtype=np.float32) + 0.5) / width
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    return xx, yy, zz


def sphere_volume(n: int = 64, center=(0.5, 0.5, 0.5), radius: float = 0.3,
                  soft: float = 0.1, device=None) -> Volume:
    """Soft-edged spherical density blob, on ``device`` (default: the
    card)."""
    x, y, z = normalized_grid(n, n, n)
    r = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                + (z - center[2]) ** 2)
    t = np.clip((radius - r) / max(soft, 1e-6) + 0.5, 0.0, 1.0)
    val = (t * t * (3.0 - 2.0 * t)).astype(np.float32)
    return Volume(torch.from_numpy(val[..., None]).to(
        resolve_device(device)))


def shell_volume(n: int = 64, radius: float = 0.35,
                 thickness: float = 0.08, device=None) -> Volume:
    """Hollow spherical shell, on ``device`` (default: the card)."""
    x, y, z = normalized_grid(n, n, n)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    val = np.exp(-((r - radius) / thickness) ** 2).astype(np.float32)
    return Volume(torch.from_numpy(val[..., None]).to(
        resolve_device(device)))


def blobs_volume(n: int = 64, seed: int = 0, count: int = 5,
                 device=None) -> Volume:
    """Sum of random Gaussian blobs, an asymmetric test scene, on
    ``device`` (default: the card)."""
    rng = np.random.default_rng(seed)
    x, y, z = normalized_grid(n, n, n)
    val = np.zeros((n, n, n), np.float32)
    for _ in range(count):
        c = rng.uniform(0.25, 0.75, size=3)
        s = rng.uniform(0.05, 0.15)
        a = rng.uniform(0.4, 1.0)
        val += a * np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2
                             + (z - c[2]) ** 2) / (2 * s * s)))
    val = np.clip(val, 0.0, 1.0).astype(np.float32)
    return Volume(torch.from_numpy(val[..., None]).to(
        resolve_device(device)))


def gradient_magnitude(values: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient magnitude of a (D, H, W) scalar field in
    voxel units, one-sided at the boundaries, ``clip(2·|g|, 0, 1)``: the
    second channel of a 2D-TF volume, as ``vpt_tpu.volume`` computes it."""
    def diff(axis):
        n = values.shape[axis]
        d = (torch.roll(values, -1, dims=axis)
             - torch.roll(values, 1, dims=axis)) * 0.5
        d.narrow(axis, 0, 1).copy_(values.narrow(axis, 1, 1)
                                   - values.narrow(axis, 0, 1))
        d.narrow(axis, n - 1, 1).copy_(values.narrow(axis, n - 1, 1)
                                       - values.narrow(axis, n - 2, 1))
        return d

    gx, gy, gz = diff(2), diff(1), diff(0)
    # the three-term sum left to right, as jnp.sum reduces it; the square
    # root in float64 rounded to float32 is the correctly rounded float32
    # root (torch's vectorised CPU sqrt is not, in the last bit)
    mag = torch.sqrt((gx * gx + gy * gy + gz * gz).to(torch.float64)).to(
        torch.float32)
    return torch.clamp(mag * 2.0, 0.0, 1.0)


def with_gradient_magnitude(volume: Volume) -> Volume:
    """The volume with its gradient magnitude as channel 1, for 2D transfer
    functions (value, |∇|); the filter is kept."""
    values = volume.data[..., 0]
    return Volume(torch.stack([values, gradient_magnitude(values)], dim=-1),
                  volume.filter)


#: positions a :func:`with_lao_gradient` pass samples at once (six taps
#: each): whole z-slices of a 256³ volume, a few hundred MB of temporaries
LAO_BAKE_CHUNK = 2 ** 21


def with_lao_gradient(volume, voxel_size: float = 1.0 / 32.0) -> Volume:
    """The volume with LAO's own gradient magnitude as channel 1, baked at
    voxel centres, as ``vpt_tpu.volume.with_lao_gradient``: the raw central
    difference of channel 0 over ±``voxel_size`` in normalised coordinates
    through the GL trilinear sampler (``sampling.raw_gradient``, the stencil
    of LAORenderer.glsl:73-80 with its 1/32), its magnitude the float32
    square root of the three squares summed left to right.  Between the
    centres ``lao.Params(baked_gradient=True)`` interpolates |∇|
    trilinearly.  One vectorised pass on the volume's device, in chunks of
    whole z-slices of about :data:`LAO_BAKE_CHUNK` positions; the filter
    is kept."""
    from . import sampling

    data = volume.data if isinstance(volume, Volume) \
        else torch.as_tensor(volume, dtype=torch.float32)
    vol_filter = volume.filter if isinstance(volume, Volume) else "linear"
    d, h, w = data.shape[:3]
    values = data[..., :1].contiguous()
    x, y, z = normalized_grid(d, h, w)
    grid = torch.from_numpy(np.stack([x, y, z], axis=-1)).to(data.device)
    step = max(1, LAO_BAKE_CHUNK // (h * w))
    mags = []
    for z0 in range(0, d, step):
        g = sampling.raw_gradient(values, grid[z0:z0 + step], voxel_size)
        # the square root in float64 rounded to float32 is the correctly
        # rounded float32 root, as XLA's (torch's vectorised CPU sqrt is
        # not, in the last bit)
        sq = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] \
            + g[..., 2] * g[..., 2]
        mags.append(torch.sqrt(sq.to(torch.float64)).to(torch.float32))
    return Volume(torch.stack([data[..., 0], torch.cat(mags)], dim=-1),
                  vol_filter)


def from_raw_bytes(data: bytes, depth: int, height: int, width: int,
                   dtype=np.uint8, device=None) -> Volume:
    """Decode a headerless RAW volume (one scalar per voxel, z-major) on
    ``device`` (default: the card); integer types normalize to [0, 1] by
    their maximum (readers/RAWReader.js:15-71)."""
    arr = np.frombuffer(data, dtype=dtype, count=depth * height * width)
    arr = arr.reshape(depth, height, width).astype(np.float32)
    if np.issubdtype(dtype, np.integer):
        arr = arr / float(np.iinfo(dtype).max)
    return Volume(torch.from_numpy(arr[..., None]).to(
        resolve_device(device)))
