"""Differentiable isosurface rendering: depth and normal gradients.

Mirrors ``vpt_tpu/renderers/diff_iso.py``.  The hard first crossing of the
ISO renderer becomes a soft first-crossing distribution along each ray,

    a_i = σ((v_i − isovalue) / τ)                (crossing at step i)
    w_i = a_i · Π_{j<i} (1 − a_j)                (first crossing at step i)

so that the expected depth ``t̄ = Σ w_i t_i / Σ w_i`` and the expected hit
position are smooth in the voxel densities, the transfer function and the
isovalue; normals are the central-difference gradient of TF alpha at the
expected hit, and the image is the deferred Lambert pass over a white
background.

Two kinds of samples, two fetches:

- the per-step samples sit at positions that depend on the camera alone,
  so a differentiable scene (``base.fit_scene``, which :func:`depth_loss`
  builds) reads them through the fused fetch: K3 forward, K4 backward.
  They are taken in fetches of ``_STEPS_PER_FETCH`` steps (one fetch at
  the default 50 steps); the fold over the steps stays sequential, in
  JAX's order;
- the expected hit depends on the volume (through t̄) and on the isovalue,
  so its colour and gradient samples need gradients to the positions:
  :func:`sample_color_at` reads them through the plain gather and lerp
  (``fused=False``) and the 2D TF texture, whose autograd carries the
  gradient to the tables and to the positions alike.

``Params.isovalue`` may be a 0-d tensor that requires grad.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import math3d as m4
from .. import sampling
from .base import Scene, fit_scene, static_field

#: soft steps sampled in one fetch: bounds the (steps, H, W, 3) positions
#: and the (steps, H, W, 4) colours that one fetch holds
_STEPS_PER_FETCH = 64


@dataclasses.dataclass(frozen=True)
class Params:
    isovalue: Any = 0.5                # a float or a 0-d tensor
    light: tuple = (2.0, -3.0, -5.0)
    gradient_step: float = 0.005
    tau: float = 0.02                  # crossing softness; -> 0: hard ISO
    steps: int = static_field(default=50)


def _scalar(x, device):
    """A float32 0-d tensor of ``x`` on ``device``, keeping its graph when
    ``x`` is a tensor (a divisor as a tensor: the true quotient on the
    card)."""
    return torch.as_tensor(np.float32(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32).to(device)


def sample_color_at(scene: Scene, position):
    """TF(volume(p)) at positions that require grad, (..., 4).  The fused
    fetch (K3) detaches positions, so these samples take the plain gather
    and lerp of the corner table (``fused=False``) and the 2D bilinear TF
    texture, whose autograd reaches the tables and the positions; the
    values are those of ``Scene.sample_color``."""
    if scene._packed_samples():
        rg = sampling.sample_volume_packed(
            scene.volume_packed,
            tuple(scene.volume.shape[:3]) + (scene.channels,), position,
            fused=False)
        if rg.shape[-1] < 2:
            rg = torch.cat([rg, torch.zeros_like(rg)], dim=-1)
    else:
        rg = sampling.volume_rg(scene.volume, position, scene.filter)
    return scene.sample_transfer(rg)


def _sample(scene, position):
    if torch.is_grad_enabled() and position.requires_grad:
        return sample_color_at(scene, position)
    return scene.sample_color(position)


def render(scene: Scene, params: Params, height: int, width: int) -> dict:
    """One deterministic differentiable pass.

    Returns ``{"depth", "hit", "position", "normal", "image"}``:
    ``depth`` is the expected ray parameter t̄ in [0, 1] over the clipped
    segment (−1 where the ray misses the cube), ``hit`` the soft crossing
    probability Σw, ``position``/``normal`` the expected hit point and its
    unit density gradient, ``image`` the Lambert-shaded RGBA (white
    background, as the reference's display pass)."""
    dev = scene.device
    ndc = sampling.pixel_ndc(height, width, device=dev)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    tb = torch.clamp(sampling.intersect_cube(ray_from, direction), min=0.0)
    miss = tb[..., 0] >= tb[..., 1]

    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    seg = end - start
    step_size = np.float32(1.0 / params.steps)
    isovalue = _scalar(params.isovalue, dev)
    tau = _scalar(params.tau, dev)

    ts = (torch.arange(params.steps, dtype=torch.float32, device=dev)
          + 0.5) * float(step_size)                     # front to back
    transmittance = torch.ones((height, width), dtype=torch.float32,
                               device=dev)
    ws, wts = [], []
    for c0 in range(0, params.steps, _STEPS_PER_FETCH):
        tc = ts[c0:c0 + _STEPS_PER_FETCH]
        values = scene.sample_color(
            start[None] + tc[:, None, None, None] * seg[None])[..., 3]
        for k in range(tc.shape[0]):
            a = torch.sigmoid((values[k] - isovalue) / tau)
            w = transmittance * a
            transmittance = transmittance * (1.0 - a)
            ws.append(w)
            wts.append(w * tc[k])
    hit = torch.sum(torch.stack(ws), dim=0)                    # Σw (H, W)
    t_bar = torch.sum(torch.stack(wts), dim=0) / torch.clamp(hit, min=1e-8)

    position = start + t_bar[..., None] * seg
    grad = sampling.central_value_gradient(
        lambda p: _sample(scene, p), position, params.gradient_step)
    normal = grad / torch.sqrt(torch.clamp(
        torch.sum(grad * grad, dim=-1, keepdim=True), min=1e-12))

    inv_mv = m4.invert(scene.model_view)
    light = m4.transform_point(inv_mv, torch.tensor(params.light,
                                                    dtype=torch.float32))
    light = light / torch.sqrt(torch.clamp(torch.sum(light * light),
                                           min=1e-12))
    lambert = torch.clamp(torch.sum(normal * light, dim=-1), min=0.0)
    material = _sample(scene, position)[..., :3]
    shaded = material * lambert[..., None]
    # soft composite over the white background by hit probability
    rgb = shaded * hit[..., None] + (1.0 - hit[..., None])
    image = torch.cat([rgb, torch.ones_like(hit)[..., None]], dim=-1)

    white = torch.ones(4, dtype=torch.float32, device=dev)
    return {
        "depth": torch.where(miss, -1.0, t_bar),
        "hit": torch.where(miss, 0.0, hit),
        "position": position,
        "normal": normal,
        "image": torch.where(miss[..., None], white, image),
    }


def depth_loss(volume_leaves, scene_template: Scene, params: Params,
               target_depth, height: int, width: int):
    """Mean-squared depth loss over the pixels whose target is >= 0, as a
    function of the voxel grid: the entry point for inverse depth fitting.
    The scene is ``scene_template`` with ``volume_leaves`` packed in the
    graph (``base.fit_scene``), so every per-step fetch is K3 forward and
    K4 backward on the card, never the TF-lookup kernel, which has no
    gradient."""
    sc = fit_scene(scene_template, volume=volume_leaves)
    out = render(sc, params, height, width)
    valid = target_depth >= 0.0
    err = torch.where(valid, out["depth"] - target_depth, 0.0)
    count = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    return torch.sum(err * err) / count
