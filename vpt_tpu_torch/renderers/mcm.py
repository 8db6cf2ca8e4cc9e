"""MCM: Monte-Carlo multiple scattering by Woodcock/null-collision tracking.

Mirrors ``vpt_tpu/renderers/mcm.py``.  Each pixel owns one photon with
{position, direction, bounces, transmittance, radiance, samples} (plus the
cheb-skip distance ``cheb`` when the scene has a tracking table), advanced by
``steps`` null-collision events per progressive frame:

  1. exponential free-path sample, position += dist · direction
  2. classify: out of bounds → deposit env radiance; absorption
     (P = 1 − P_null − P_scatter) → deposit black; scattering
     (P = α · max3(rgb), zero past the bounce cap) → tint transmittance and
     resample the direction (Henyey-Greenstein); else a null collision
  3. a deposit folds into the running mean ``radiance += (r − radiance) /
     samples`` and re-seeds the photon through the stochastic unprojection

RNG draws follow the GLSL stream: the state advances only by the draws the
taken branch consumes (flight 1, fortune 1, reset 4, scatter 2 or 3).

:func:`flight_phase` (or, on a scene with a majorant grid,
:func:`grid_flight_phase`) and :func:`interact_phase` are the plain PyTorch
event, with one classify/deposit/commit ladder for the three machines (the
JAX file repeats it for the majorant-grid branch).  :func:`render_frame`
runs the frame through ``kernels/mcm_event.py``: a Python loop over the two phases on
the CPU, one launch of the CUDA event kernel on the GPU.  Unlike JAX, the
port updates the state tensors in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng, sampling, skipgrid
from ..kernels import mcm_event
from .base import Scene, static_field, volume_shape


@dataclasses.dataclass(frozen=True)
class Params:
    extinction: float = 1.0
    anisotropy: float = 0.0
    blur: float = 0.0
    max_bounces: int = static_field(default=8)
    steps: int = static_field(default=8)


def inverse_resolution(height: int, width: int, device) -> torch.Tensor:
    return torch.tensor([1.0 / width, 1.0 / height], dtype=torch.float32,
                        device=device)


def photon_reset(state, ndc, scene: Scene, params: Params, inv_res):
    """resetPhoton (MCMRenderer.glsl:70-78): stochastic unproject, clip to
    the cube.  Consumes 4 uniforms."""
    blur = float(np.float32(params.blur))
    state, ray_from, ray_to = sampling.unproject_rand(
        state, ndc, scene.mvp_inverse, inv_res, blur)
    direction = ray_to - ray_from
    sq = direction * direction
    norm2 = (sq[..., 0] + sq[..., 1] + sq[..., 2])[..., None]
    direction = direction / torch.sqrt(torch.clamp(norm2, min=1e-20))
    tb = torch.clamp(sampling.intersect_cube(ray_from, direction), min=0.0)
    position = ray_from + tb[..., 0:1] * direction
    return state, position, direction


def reset(params: Params, height: int, width: int, scene: Scene = None,
          seed=0.0, *, window=None):
    """MCM reset: seed every photon through the stochastic unprojection on
    the scene's device; radiance starts at 1.  ``window``: None, or
    ``(row0, full_height)`` for the ``height`` rows from ``row0`` of a
    ``full_height``-row image (``sampling.pixel_ndc``), equal to those
    rows of the whole image's state."""
    if scene is None:
        raise ValueError("MCM reset needs the scene (camera rays)")
    dev = scene.device
    ndc = sampling.pixel_ndc(height, width, device=dev, window=window)
    inv_res = inverse_resolution(sampling.row_window(window, height)[1],
                                 width, dev)
    state = rng.seed_pixels(ndc, np.float32(seed))
    state, position, direction = photon_reset(state, ndc, scene, params,
                                              inv_res)
    shape = (height, width)
    out = {
        "position": position,
        "direction": direction,
        "bounces": torch.zeros(shape, dtype=torch.float32, device=dev),
        "transmittance": torch.ones(shape + (3,), dtype=torch.float32,
                                    device=dev),
        "radiance": torch.ones(shape + (3,), dtype=torch.float32,
                               device=dev),
        "samples": torch.zeros(shape, dtype=torch.float32, device=dev),
    }
    if scene.tracking_packed is not None and scene.majorant is None:
        # cheb-skip carry; 0 = unknown/occupied, so the first event after a
        # reset tracks exactly
        out["cheb"] = torch.zeros(shape, dtype=torch.float32, device=dev)
    return out


def flight_phase(ph, rstate, params: Params, use_skip: bool, cell):
    """Draw the free-path sample and advance the photon
    (MCMRenderer.glsl:130-131).  In cheb-skip mode the flight extends to at
    least (cheb − 1) empty cells, which is exact by memorylessness.
    Returns ``(rstate, position)``."""
    extinction = float(np.float32(params.extinction))
    rstate, dist = rng.exponential(rstate, extinction)
    if use_skip:
        hop = torch.clamp(ph["cheb"] - 1.0, min=0.0) * cell
        dist = torch.maximum(dist, hop)
    return rstate, ph["position"] + dist[..., None] * ph["direction"]


def grid_flight_phase(ph, rstate, scene, params: Params):
    """The local-majorant flight (``skipgrid.flight_step``): an exponential
    flight against the current cell's majorant ``mu`` = extinction ·
    maxalpha; a tentative collision past the cell's boundary becomes a hop
    to just beyond it (``EPS_NUDGE``, so that the photon leaves the cell,
    and the cube from its far face), valid by memorylessness.  Returns
    ``(rstate, position, mu, collide)``."""
    mu, t_bound = skipgrid.flight_step(scene.majorant, ph["position"],
                                       ph["direction"])
    rstate, tau = rng.exponential(rstate, 1.0)
    sigma = float(np.float32(params.extinction)) * mu
    t_coll = torch.where(sigma > 0.0, tau / torch.clamp(sigma, min=1e-30),
                         torch.full_like(tau, float("inf")))
    collide = t_coll < t_bound
    dist = torch.where(collide, t_coll, t_bound + skipgrid.EPS_NUDGE)
    return (rstate, ph["position"] + dist[..., None] * ph["direction"], mu,
            collide)


def interact_phase(ph, rstate, position, vs, cheb_new, scene, params: Params,
                   ndc, inv_res, use_skip: bool, majorant=None):
    """Classify the collision at ``position`` given the sampled color ``vs``
    (and, in skip mode, the landing cell's cheb distance), commit the branch
    and advance the RNG by exactly the draws the taken branch consumes
    (MCMRenderer.glsl:135-165).  ``majorant``: the grid flight's ``(mu,
    collide)``; a hop interacts with nothing, and a collision's alpha is
    the ratio ``min(alpha / mu, 1)`` to the local majorant.  Returns
    ``(new_ph, new_rstate)``."""
    alpha = vs[..., 3]
    if majorant is not None:
        mu, collide = majorant
        alpha = torch.where(mu > 0.0, torch.clamp(alpha / mu, max=1.0),
                            torch.zeros_like(alpha))
    p_null = 1.0 - alpha
    capped = ph["bounces"] >= params.max_bounces
    p_scatter = torch.where(capped, torch.zeros_like(alpha),
                            alpha * sampling.max3(vs[..., :3]))
    p_absorb = 1.0 - p_null - p_scatter

    rstate, fortune = rng.uniform(rstate)
    oob = ((position > 1.0) | (position < 0.0)).any(-1)
    interact = ~oob if majorant is None else ~oob & collide
    absorb = interact & (fortune < p_absorb)
    scatter = interact & (~absorb) & (fortune < p_absorb + p_scatter)
    deposit = oob | absorb

    # running-mean deposit: env radiance on escape, black on absorption
    env = scene.sample_env(ph["direction"])
    r_new = torch.where(oob[..., None], ph["transmittance"] * env[..., :3],
                        torch.zeros_like(ph["transmittance"]))
    samples = torch.where(deposit, ph["samples"] + 1.0, ph["samples"])
    radiance = torch.where(
        deposit[..., None],
        ph["radiance"] + (r_new - ph["radiance"])
        / torch.clamp(samples, min=1.0)[..., None],
        ph["radiance"])

    # tentative continuations; the state keeps only the taken branch's draws
    rs_reset, pos_reset, dir_reset = photon_reset(rstate, ndc, scene,
                                                  params, inv_res)
    rs_scat, dir_scat = sampling.henyey_greenstein(
        rstate, params.anisotropy, ph["direction"])

    dmask = deposit[..., None]
    smask = scatter[..., None]
    new_ph = {
        "position": torch.where(dmask, pos_reset, position),
        "direction": torch.where(dmask, dir_reset,
                                 torch.where(smask, dir_scat,
                                             ph["direction"])),
        "bounces": torch.where(deposit, torch.zeros_like(ph["bounces"]),
                               torch.where(scatter, ph["bounces"] + 1.0,
                                           ph["bounces"])),
        "transmittance": torch.where(
            dmask, torch.ones_like(ph["transmittance"]),
            torch.where(smask, ph["transmittance"] * vs[..., :3],
                        ph["transmittance"])),
        "radiance": radiance,
        "samples": samples,
    }
    if use_skip:
        # cheb at the committed position: the landing cell's; 0 after reset
        new_ph["cheb"] = torch.where(deposit, torch.zeros_like(cheb_new),
                                     cheb_new)
    elif "cheb" in ph:
        # a tracking-era state against a non-tracking scene: keep the carry
        new_ph["cheb"] = ph["cheb"]
    new_state = torch.where(deposit, rs_reset,
                            torch.where(scatter, rs_scat, rstate))
    return new_ph, new_state


def skip_cell_size(scene) -> float:
    """The normalized cell size the cheb hop may use: the smallest of the
    three axes' 1/N (of the whole volume for a HaloScene)."""
    d, h, w = volume_shape(scene)[:3]
    return min(1.0 / d, 1.0 / h, 1.0 / w)


def uses_skip(state, scene) -> bool:
    return scene.majorant is None and scene.tracking_packed is not None \
        and "cheb" in state


def render_frame(state, scene: Scene, params: Params, seed, frame_number=0,
                 *, window=None):
    """One progressive frame of ``params.steps`` events per pixel, updating
    ``state`` in place: the CUDA event kernel for CUDA state, the plain
    PyTorch event loop for CPU state (kernels/mcm_event.py).  ``window``:
    the state's rows of the image, as in :func:`reset`."""
    del frame_number  # the seed alone selects the frame's streams
    mcm_event.event_frame(state, scene, params, seed, window=window)
    return state


def display(state, scene: Scene, params: Params):
    """vec4(radiance, 1)."""
    radiance = state["radiance"]
    return torch.cat([radiance, torch.ones(radiance.shape[:-1] + (1,),
                                           dtype=torch.float32,
                                           device=radiance.device)], dim=-1)
