"""LAO: ray marching with local ambient occlusion and soft shadows.

Mirrors ``vpt_tpu/renderers/lao.py`` (LAORenderer.glsl:97-191): a
front-to-back march with a 2D transfer-function lookup of (value, |∇|), a
per-slice local-ambient-occlusion term (:135-151) and a soft-shadow term
(:153-167), each darkening the slice colour by a fixed tint (:176-177).  The
reference's ``rand`` is a stateless hash of the pixel position with a
constant seed, so every AO and shadow sample of a pixel is the same and
each loop reduces to one evaluation (the carried AO accumulator is kept for
``num_lao_samples`` > 1); ``voxelSize`` is the shader's 1/32; the light is
the inverse-MVP-transformed light position without the divide by w.  LAO is
not progressive: a frame replaces the state.

:func:`generate` is the plain PyTorch frame, slice by slice
(:func:`setup`, :func:`slice_active`, :func:`march_slice`, :func:`finish`);
:func:`render_frame` runs the frame through ``kernels/lao_march.py`` (the
plain frame on the CPU, one launch of the LAO kernel, K10, on the card),
writing the state in place.  ``baked_gradient`` reads (value, |∇|) from a
two-channel volume baked with ``volume.with_lao_gradient`` in one fetch in
place of the seven of the gradient.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from .. import math3d, rng, sampling
from ..kernels import lao_march
from ..utils import constant
from . import _march
from .base import (Scene, cube_interval, state_device, static_field,
                   volume_shape)


@dataclasses.dataclass(frozen=True)
class Params:
    extinction: float = 100.0
    lao_weight: float = 0.69
    soft_shadows_weight: float = 0.54
    light_radius: float = 0.19
    light_position: tuple = (2.0, 12.0, 3.0)
    light_coefficient: float = 1.0
    local_ambient_occlusion: bool = static_field(default=True)
    num_lao_samples: int = static_field(default=1)
    lao_step_size: float = static_field(default=0.05)
    soft_shadows: bool = static_field(default=True)
    num_shadow_samples: int = static_field(default=10)
    slices: int = static_field(default=64)
    #: read (value, |∇|) from a two-channel volume baked with
    #: ``volume.with_lao_gradient`` instead of the seven-tap central
    #: difference a sample (the baked |∇| is the stencil's at voxel
    #: centres, trilinearly interpolated between them)
    baked_gradient: bool = static_field(default=False)


VOXEL_SIZE = 1.0 / 32.0   # LAORenderer.glsl:59 (the reference hard-codes it)
SEED = (3.14, 2.71)       # the constant seed of the reference's rand (:60)
TINT_LAO = (0.15, 0.18, 0.32, 1.0)
TINT_SHADOW = (0.15, 0.18, 0.22, 1.0)
#: float32 1/sqrt(3), the divisor of rdir (``np.sqrt(3.0)`` in vpt_tpu)
SQRT3 = float(np.float32(np.sqrt(3.0)))


def reset(params: Params, height: int, width: int, scene: Scene = None):
    acc = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=state_device(scene))
    acc[..., 3] = 1.0
    return acc


def check_params(params: Params, scene: Scene):
    """Raise, before any launch, for ``baked_gradient`` on a volume of
    fewer than two channels, as ``vpt_tpu`` does."""
    if params.baked_gradient and volume_shape(scene)[-1] < 2:
        raise ValueError(
            "baked_gradient needs a 2-channel (value, |grad|) volume — "
            "bake one with volume.with_lao_gradient")


def lao_taps(params: Params):
    """The AO taps along the half-vector: (T, 3) float32 numpy rows of
    ``t2`` (``np.arange(0.001, 1, lao_step_size)``), ``light_radius · t2``
    and the weight ``(1 − t2)²``, each rounded to float32 as vpt_tpu's
    numpy computes it."""
    t2s = np.arange(0.001, 1.0, params.lao_step_size, dtype=np.float32)
    radius = np.float32(params.light_radius)
    return np.array([[t2, radius * t2, np.float32((1.0 - t2) ** 2)]
                     for t2 in t2s], np.float32).reshape(-1, 3)


def pixel_random(height: int, width: int, device, window=None):
    """The reference's stateless per-pixel random value ``rand(ndc ·
    (3.14, 2.71)).x`` (:60, 115), (H, W) float32: the same for every seed
    and frame.  ``window``: None, or ``(row0, full_height)``: the
    ``height`` rows from ``row0`` of a ``full_height``-row image."""
    ndc = sampling.pixel_ndc(height, width, device=device, window=window)
    return rng.rand_vec2(ndc * constant(SEED, torch.float32, device))[..., 0]


def random_constant(device):
    """``rand(seed).x`` with the constant seed (:156), a 0-d tensor."""
    return rng.rand_vec2(constant(SEED, torch.float32, device))[0]


def light_of(scene: Scene, params: Params):
    """vLight = (inverseMvp · [light, 1]).xyz without /w (vertex:25), (3,)
    on the scene's device."""
    lp = constant(tuple(float(np.float32(v)) for v in params.light_position)
                  + (1.0,), torch.float32, scene.device)
    return math3d.apply_mat4(scene.mvp_inverse, lp)[:3]


def _norm(v):
    return torch.sqrt(torch.clamp(_march.dot3(v, v), min=1e-20))[..., None]


def setup(scene: Scene, params: Params, height: int, width: int,
          window=None):
    """What every slice of a frame reads: the rays, the per-pixel random
    value and what it fixes (the first ``t``, the AO direction, the shadow
    tap's offset and length), the light, the AO taps.  ``window`` as in
    :func:`pixel_random`."""
    check_params(params, scene)
    # the cube alone: vpt_tpu's LAO clamps to no box
    _, miss, start, end = _march.rays(scene, height, width, cube_interval,
                                      window)
    rx = pixel_random(height, width, scene.device, window)
    rconst = random_constant(scene.device)
    light = light_of(scene, params)
    step = np.float32(1.0 / params.slices)
    t0 = torch.clamp(rx * float(step) * 1.5, 0.0, 1.0)
    rdir = torch.sign(2.0 * rx - 1.0) * (rx / torch.full_like(rx, SQRT3))
    sdir = torch.stack([-1.0 + light[0] * rx, light[1] + rx * light[2],
                        (-1.0 + 2.0 * rconst).expand(rx.shape)], dim=-1)
    sdir = sdir / _norm(sdir) * rx[..., None]
    radius = float(np.float32(params.light_radius))
    return types.SimpleNamespace(
        miss=miss, start=start, end=end, step=step, t0=t0,
        rdir=rdir[..., None].expand(rdir.shape + (3,)), light=light,
        shadow_offset=sdir * radius,
        shadow_length=torch.sqrt(_march.dot3(sdir, sdir)),
        taps=lao_taps(params))


def slice_active(ctx, acc, i: int):
    """The pixels slice ``i`` changes: ``t < 1`` and alpha at most 0.9."""
    t = ctx.t0 + float(np.float32(i) * ctx.step)
    return t, (t < 1.0) & (acc[..., 3] <= 0.9)


def march_slice(scene: Scene, params: Params, ctx, acc, i: int):
    """Slice ``i`` of the march (vpt_tpu/renderers/lao.py:97-172): the new
    accumulator."""
    t, active = slice_active(ctx, acc, i)
    position = ctx.start + t[..., None] * (ctx.end - ctx.start)
    if params.baked_gradient:
        # one fetch gives (value, baked |∇|)
        rg = scene.sample_volume_rg(position)
        value, grad_mag = rg[..., 0], rg[..., 1]
    else:
        grad = scene.raw_gradient(position, VOXEL_SIZE)
        grad_mag = torch.sqrt(_march.dot3(grad, grad))
        value = scene.sample_value(position)

    lao = torch.zeros_like(value)
    if params.local_ambient_occlusion:
        inner = torch.zeros_like(value)
        for t2, c, weight in ctx.taps:
            half = ctx.light + ctx.rdir * float(c) - position
            half = half / _norm(half)
            inner = inner + scene.sample_value(position + half * float(t2)) \
                * float(weight)
        carried = torch.zeros_like(value)
        total = torch.zeros_like(value)
        coefficient = torch.full_like(value, np.float32(
            params.light_coefficient))
        for _ in range(params.num_lao_samples):
            carried = torch.clamp((carried + inner) / coefficient, 0.0, 1.0)
            total = total + carried
        lao = total / torch.full_like(total, params.num_lao_samples)

    soft = torch.zeros_like(value)
    if params.soft_shadows:
        vshadow = scene.sample_value(position + ctx.shadow_offset)
        contrib = vshadow * (vshadow * 0.2) * ctx.shadow_length
        contrib = torch.clamp(contrib * 20.0, 0.0, 1.0)
        soft = torch.clamp((-0.2 + 1.2 * contrib)
                           / torch.full_like(contrib, 1.3), 0.0, 1.0)

    color = scene.sample_transfer(torch.stack([value, grad_mag], dim=-1))
    dev = value.device
    w1 = (lao * float(np.float32(params.lao_weight)))[..., None]
    color = color * (1.0 - w1) \
        + color * constant(TINT_LAO, torch.float32, dev) * w1
    w2 = (soft * float(np.float32(params.soft_shadows_weight)))[..., None]
    color = color * (1.0 - w2) \
        + color * constant(TINT_SHADOW, torch.float32, dev) * w2

    keep = 1.0 - acc[..., 3:4]
    new_rgb = acc[..., :3] + keep * color[..., :3] * value[..., None]
    a = keep[..., 0] * value * float(np.float32(params.extinction))
    new_a = acc[..., 3] + a / torch.full_like(a, 100.0)
    new_acc = torch.cat([new_rgb, new_a[..., None]], dim=-1)
    return torch.where(active[..., None], new_acc, acc)


def finish(ctx, acc):
    """The ``alpha > 1`` normalisation, alpha 1, and (0, 0, 0, 1) where the
    ray misses the cube."""
    over = acc[..., 3:4] > 1.0
    rgb = torch.where(over, acc[..., :3] / torch.clamp(acc[..., 3:4],
                                                       min=1e-6),
                      acc[..., :3])
    frame = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    black = constant((0.0, 0.0, 0.0, 1.0), torch.float32, acc.device)
    return torch.where(ctx.miss[..., None], black, frame)


def generate(scene: Scene, params: Params, seed, height: int, width: int,
             *, window=None):
    """One frame in plain PyTorch, (H, W, 4); the seed changes nothing
    (the reference's rand has a constant seed).  ``window`` as in
    :func:`pixel_random`."""
    del seed
    ctx = setup(scene, params, height, width, window)
    acc = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=scene.device)
    for i in range(params.slices):
        acc = march_slice(scene, params, ctx, acc, i)
    return finish(ctx, acc)


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, window=None):
    """LAO's integrate replaces the accumulator with the frame (integrate
    fragment:226), in place; ``window`` as in :func:`pixel_random`."""
    lao_march.lao_frame(state, scene, params, window=window)
    return state


def display(state, scene: Scene, params: Params):
    return state.clone()
