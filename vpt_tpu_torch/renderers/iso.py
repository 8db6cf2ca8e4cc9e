"""ISO: isosurface ray casting with deferred Lambert shading.

Mirrors ``vpt_tpu/renderers/iso.py`` (ISORenderer.glsl): a jittered
backward march recording the nearest position whose TF alpha reaches
``isovalue`` (generate:52-76; the last write wins), a keep-the-nearer-hit
integrate (:111-121), and a deferred shade with a central-difference
gradient (h = ``gradient_step``) and a Lambert term (:165-191) against a
world light mapped into texture space through ``inv(model_view)`` as a
point, then normalised (ISORenderer.js:150-165).

:func:`render_frame` runs the frame through ``kernels/march.py`` and
:func:`display` through ``kernels/iso_shade.py``: the plain versions on the
CPU, one launch of each kernel on the card.  The march clamps to the
scene's empty-space boxes where they hold (:func:`boxes`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import math3d
from ..kernels import iso_shade
from ..kernels import march as march_kernel
from . import _march
from .base import (Scene, clamp_to_box, cube_interval, state_device,
                   static_field)


@dataclasses.dataclass(frozen=True)
class Params:
    isovalue: float = 0.5
    light: tuple = (2.0, -3.0, -5.0)
    gradient_step: float = 0.005
    steps: int = static_field(default=50)


def reset(params: Params, height: int, width: int, scene: Scene = None):
    """The closest-hit buffer clears to vec4(-1)."""
    return torch.full((height, width, 4), -1.0, dtype=torch.float32,
                      device=state_device(scene))


def schedule(params: Params, seed):
    """(first t, step): the backward march's slices sit at
    ``(1 − offset·step) − i·step``."""
    step = np.float32(1.0 / params.steps)
    return np.float32(1.0) - _march.frame_offset(seed) * step, step


def boxes(scene: Scene, params: Params):
    """The clamp boxes that hold for ``params.isovalue``, in the order they
    apply: the occupied box (``march_clamp``) where the isovalue is above
    0, since a hit needs alpha >= isovalue and the box leaves out only
    alpha ≡ 0; the iso box (``iso_clamp_min``) where the isovalue is at
    least its floor.  Float32 comparisons, as JAX's traced isovalue
    against its weakly typed floats."""
    isovalue = np.float32(params.isovalue)
    out = []
    if scene.occupied_aabb is not None and isovalue > np.float32(0.0):
        out.append(scene.occupied_aabb)
    if scene.iso_aabb is not None \
            and isovalue >= np.float32(scene.iso_clamp_min):
        out.append(scene.iso_aabb)
    return out


def march_interval(scene: Scene, params: Params, ray_from, direction):
    """ISO's marched segment (``vpt_tpu``'s ``_march_interval_iso``): the
    cube slab test clamped to each of :func:`boxes` in turn."""
    tb = cube_interval(ray_from, direction)
    for box in boxes(scene, params):
        tb = clamp_to_box(tb, ray_from, direction, box)
    return tb


def generate(scene: Scene, params: Params, seed, height: int, width: int,
             *, window=None):
    """The frame's nearest hit (position, t), (H, W, 4); −1 where none."""
    _, miss, start, end = _march.rays(
        scene, height, width,
        lambda ray_from, direction: march_interval(scene, params, ray_from,
                                                   direction),
        window=window)
    first, step = schedule(params, seed)
    isovalue = float(np.float32(params.isovalue))
    seg = end - start

    # backward march: the last write wins, which is the nearest hit
    def composite(closest, t, color):
        hit = color[..., 3] >= isovalue
        position = start + t * seg
        candidate = torch.cat([position, t.expand(position.shape[:-1])[
            ..., None]], dim=-1)
        return torch.where(hit[..., None], candidate, closest)

    i = torch.arange(params.steps, dtype=torch.float32, device=scene.device)
    ts = float(first) - i * float(step)
    init = torch.full((height, width, 4), -1.0, dtype=torch.float32,
                      device=scene.device)
    closest = _march.march(scene, start, end, ts, composite, init)
    return torch.where(miss[..., None], torch.full_like(closest, -1.0),
                       closest)


def integrate(state, frame, frame_number):
    """Keep the nearer of the frame's and the accumulated hits, in place
    (integrate:111-121)."""
    del frame_number
    ft, at = frame[..., 3:4], state[..., 3:4]
    both = (ft > 0.0) & (at > 0.0)
    take_frame = torch.where(both, ft < at, ft > 0.0)
    state.copy_(torch.where(take_frame, frame, state))


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, window=None):
    march_kernel.march_frame("iso", state, scene, params, seed,
                             frame_number, window=window)
    return state


def light_direction(scene: Scene, params: Params):
    """The world light as a texture-space direction, (3,) on the scene's
    device: ``transform_point(inv(model_view), light)``, normalised."""
    inv_mv = math3d.invert(scene.model_view)
    light = math3d.transform_point(inv_mv, params.light)
    return light / torch.sqrt(torch.clamp(_march.dot3(light, light),
                                          min=1e-12))


def shade(state, scene: Scene, params: Params):
    """The deferred shade in plain PyTorch (render:179-191): the TF color
    at the hit times the Lambert term of the central-difference normal;
    white where nothing was hit; alpha 1."""
    pos = state[..., :3]
    hit = state[..., 3] > 0.0
    grad = scene.value_gradient(pos, params.gradient_step)
    normal = grad / torch.sqrt(torch.clamp(_march.dot3(grad, grad),
                                           min=1e-12))[..., None]
    light = light_direction(scene, params)
    lambert = torch.clamp(_march.dot3(normal, light), min=0.0)
    shaded = scene.sample_color(pos)[..., :3] * lambert[..., None]
    rgb = torch.where(hit[..., None], shaded, torch.ones_like(shaded))
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def display(state, scene: Scene, params: Params):
    return iso_shade.shade(state, scene, params)
