"""Differentiable Monte-Carlo estimators for the MCM and MCS renderers.

Mirrors ``vpt_tpu/renderers/diff_mc.py``.  The forward MC machines sample
discrete events, which have no pathwise derivative; this module re-runs
the same event chains (same RNG streams, same branch outcomes) but
multiplies each path's contribution by ratio weights
``w_k = p_k / detach(p_k)`` for every decision ``k`` with a probability that
depends on the scene.  Each weight is 1 in value, so the image is the analog
estimator's, and its gradient carries the score-function term: the gradient
of the *expected* radiance, pathwise through the tints and TF colours and
score through the weights.

An MCM frame is a Python loop of plain PyTorch events over the pixel grid;
an MCS frame (:func:`mcs_generate`) its two tracking loops, masked scans
of at most ``track_steps`` steps with the weights on the collision
decisions.  Unlike ``renderers/mcm.py`` and ``mcs.py`` they update their
state functionally, since autograd keeps the tensors of every event.  The
scene's samplers put the kernels on the path: the volume fetch of a table
that requires grad is the fused corner gather forward and the corner
scatter backward (``sampling.CornerFetch``), and a table that does not
(a TF fit) is read by the no-grad fused gather.  Positions are detached,
as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng, sampling
from ..utils import constant
from . import _march, mcm, mcs
from .base import Scene

#: leave a tracking scan of :func:`mcs_generate` once every pixel is done;
#: off, the scans run all ``track_steps`` as JAX's do (the tests switch it
#: off to hold the two equal)
_EXIT_EARLY = True

def _ratio(p, eps=1e-8, floor=None):
    """p / detach(p): value 1, gradient d log p.  ``floor`` drops the score
    contribution of decisions with probability below it (``max(p, floor)``,
    value still 1); ``floor >= 1`` drops every score term, leaving the
    pathwise gradient (``vpt_tpu/renderers/diff_mc.py:47-67``)."""
    if floor is not None and floor >= 1.0:
        return torch.ones_like(p)
    bound = eps if floor is None else max(eps, floor)
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    p = torch.maximum(p, constant(bound, p.dtype, p.device))
    return p / p.detach()


def mcm_render_frame(state, scene: Scene, params: mcm.Params, seed,
                     frame_number=0, score_floor: float | None = None):
    """Differentiable twin of ``mcm.render_frame``: the same event chain and
    RNG stream, with per-path ratio weights folded into the deposits.
    Returns a new state; ``state`` is left as it was.

    The carry ``logw`` accumulates Σ log w_k along the current path and
    resets with the photon.  ``score_floor``: see :func:`_ratio`."""
    del frame_number  # the seed alone selects the frame's streams
    height, width = state["position"].shape[:2]
    dev = state["position"].device
    ndc = sampling.pixel_ndc(height, width, device=dev)
    inv_res = mcm.inverse_resolution(height, width, dev)
    rstate = rng.seed_pixels(ndc * 0.5 + 0.5, np.float32(seed))
    extinction = float(np.float32(params.extinction))

    logw = state.get("logw")
    if logw is None:
        logw = torch.zeros((height, width), dtype=torch.float32, device=dev)
    # "cheb" (a tracking scene's skip carry) is not part of the
    # differentiable machine; see mcm_reset
    ph = {k: v for k, v in state.items() if k not in ("logw", "cheb")}
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    for _ in range(params.steps):
        rstate, dist = rng.exponential(rstate, extinction)
        position = ph["position"] + dist[..., None] * ph["direction"]

        vs = scene.sample_color(position)
        alpha = vs[..., 3]
        p_null = 1.0 - alpha
        capped = ph["bounces"] >= params.max_bounces
        p_scatter = torch.where(capped, zero,
                                alpha * sampling.max3(vs[..., :3]))
        p_absorb = 1.0 - p_null - p_scatter

        rstate, fortune = rng.uniform(rstate)
        oob = ((position > 1.0) | (position < 0.0)).any(-1)
        absorb = (~oob) & (fortune < p_absorb.detach())
        scatter = (~oob) & (~absorb) \
            & (fortune < (p_absorb + p_scatter).detach())
        deposit = oob | absorb

        # ratio weight of this event's discrete decision
        p_taken = torch.where(absorb, p_absorb,
                              torch.where(scatter, p_scatter,
                                          torch.where(oob, one, p_null)))
        logw_ev = torch.log(_ratio(p_taken, floor=score_floor))
        logw = logw + torch.where(oob, zero, logw_ev)

        env = scene.sample_env(ph["direction"])
        # path weight: exp(logw) == 1 in value, carries the score gradient
        w = torch.exp(logw)
        r_new = torch.where(oob[..., None],
                            ph["transmittance"] * env[..., :3] * w[..., None],
                            zero)
        # absorption deposits 0; its weight contributes no gradient either
        samples = torch.where(deposit, ph["samples"] + 1.0, ph["samples"])
        radiance = torch.where(
            deposit[..., None],
            ph["radiance"] + (r_new - ph["radiance"])
            / torch.clamp(samples, min=1.0)[..., None],
            ph["radiance"])

        rs_reset, pos_reset, dir_reset = mcm.photon_reset(
            rstate, ndc, scene, params, inv_res)
        rs_scat, dir_scat = sampling.henyey_greenstein(
            rstate, params.anisotropy, ph["direction"].detach())

        dmask = deposit[..., None]
        smask = scatter[..., None]
        # the scatter tint vs.rgb is the pathwise factor; its sampling
        # probability α·max3 is covered by logw
        ph = {
            "position": torch.where(dmask, pos_reset, position.detach()),
            "direction": torch.where(dmask, dir_reset,
                                     torch.where(smask, dir_scat,
                                                 ph["direction"])),
            "bounces": torch.where(deposit, zero,
                                   torch.where(scatter, ph["bounces"] + 1.0,
                                               ph["bounces"])),
            "transmittance": torch.where(
                dmask, one,
                torch.where(smask, ph["transmittance"] * vs[..., :3],
                            ph["transmittance"])),
            "radiance": radiance,
            "samples": samples,
        }
        logw = torch.where(deposit, zero, logw)
        rstate = torch.where(deposit, rs_reset,
                             torch.where(scatter, rs_scat, rstate))
    return dict(ph, logw=logw)


def mcm_reset(params: mcm.Params, height: int, width: int, scene: Scene,
              seed=0.0):
    """``mcm.reset`` without the cheb-skip carry (the differentiable machine
    always runs the exact global-majorant chain) and with ``logw`` = 0."""
    state = mcm.reset(params, height, width, scene, seed=seed)
    state.pop("cheb", None)
    state["logw"] = torch.zeros((height, width), dtype=torch.float32,
                                device=scene.device)
    return state


def frame_seed(i: int, seed0) -> np.float32:
    """Frame ``i``'s seed: ``pcg(i + floatBitsToUint(seed0)) / 2³²``, the
    seeds of ``vpt_tpu.renderers.diff_mc.mcm_expected_image``."""
    bits = rng.float_bits_to_uint(torch.tensor(np.float32(seed0)))
    h = rng.pcg(rng.u32(bits + i))
    return np.float32(h.to(torch.float32)) / np.float32(2 ** 32)


def mcm_expected_image(scene: Scene, params: mcm.Params, height: int,
                       width: int, frames: int, seed0: float = 0.0,
                       score_floor: float | None = None):
    """Mean radiance (H, W, 3) over ``frames`` progressive frames,
    differentiable w.r.t. the scene's tables.  Frame seeds derive from the
    frame index (:func:`frame_seed`), so the estimate is deterministic.

    Not checkpointed, as in JAX (``vpt_tpu/renderers/diff_mc.py:190-196``):
    a recomputed forward could flip borderline float comparisons and walk
    another path tree than the primal; autograd keeps every event's
    tensors instead."""
    state = mcm_reset(params, height, width, scene, seed=seed0)
    for i in range(frames):
        state = mcm_render_frame(state, scene, params, frame_seed(i, seed0),
                                 i + 1, score_floor=score_floor)
    return state["radiance"]


def mcs_generate(scene: Scene, params: mcs.Params, seed, height: int,
                 width: int, track_steps: int = 128,
                 score_floor: float | None = None):
    """Differentiable twin of ``mcs.generate``, (H, W, 4): the same
    tracking loops and RNG streams, with ratio weights on the collision
    decisions (collide with probability α, continue with 1 − α) folded
    into the colour; the collision-product transmittance's (1 − α) factors
    are pathwise already.  ``score_floor``: see :func:`_ratio`.

    Reverse-mode autograd needs a bounded loop, so each tracking loop is a
    masked scan of ``track_steps`` steps, as in JAX: exact while every path
    ends within the budget.  A scan ends once every pixel is done
    (:data:`_EXIT_EARLY`): the steps after that change no value and add
    zero cotangents, so values and gradients equal the full budget's
    (``tests/test_torch_diff_mcs.py`` holds them equal); it reads one bool
    back to the host a step."""
    dev = scene.device
    ndc = sampling.pixel_ndc(height, width, device=dev)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    dir_unit = direction / torch.sqrt(torch.clamp(
        _march.dot3(direction, direction), min=1e-20))[..., None]
    tb = torch.clamp(sampling.intersect_cube(ray_from, direction), min=0.0)
    miss = tb[..., 0] >= tb[..., 1]
    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    max_distance = torch.clamp(_march.segment_length(start, end), min=1e-20)
    extinction = float(np.float32(params.extinction))
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def alpha_at(pos):
        return scene.sample_color(pos)[..., 3]

    def sample_distance(state):
        dist = torch.zeros_like(max_distance)
        logw = torch.zeros_like(max_distance)
        done = torch.zeros_like(max_distance, dtype=torch.bool)
        for _ in range(track_steps):
            if _EXIT_EARLY and bool(done.all()):
                break
            s1, d = rng.exponential(state, extinction)
            ndist = dist + d
            over = ndist > max_distance
            pos = start + (ndist / max_distance)[..., None] * (end - start)
            a = alpha_at(pos)
            s2, u = rng.uniform(s1)
            collide = ~over & (u < a.detach())
            # decision weight: collide with probability a, continue 1 - a
            p_taken = torch.where(collide, a, 1.0 - a)
            step_logw = torch.log(_ratio(p_taken, floor=score_floor))
            logw = logw + torch.where(~done & ~over, step_logw, zero)
            state = torch.where(done, state, torch.where(over, s1, s2))
            dist = torch.where(done, dist, ndist)
            done = done | over | collide
        return state, dist, logw

    def sample_transmittance(state, seg_from, seg_to, max_dist):
        dist = torch.zeros_like(max_dist)
        trans = torch.ones_like(max_dist)
        done = torch.zeros_like(max_dist, dtype=torch.bool)
        for _ in range(track_steps):
            if _EXIT_EARLY and bool(done.all()):
                break
            s1, d = rng.exponential(state, extinction)
            ndist = dist + d
            over = ndist > max_dist
            pos = seg_from + (ndist / max_dist)[..., None] \
                * (seg_to - seg_from)
            active = ~done & ~over
            state = torch.where(done, state, s1)
            dist = torch.where(done, dist, ndist)
            trans = torch.where(active, trans * (1.0 - alpha_at(pos)), trans)
            done = done | over
        return state, trans

    scatter_dir = torch.tensor([float(x) for x in mcs.scatter_direction(
        seed)], dtype=torch.float32, device=dev)
    state = rng.seed_pixels(ndc * 0.5 + 0.5, np.float32(seed))
    state, dist, logw = sample_distance(state)
    escaped = dist > max_distance

    # the scattering point and its shadow segment along the direction
    spoint = start + (dist.detach() / max_distance)[..., None] \
        * (end - start)
    tb2 = torch.clamp(sampling.intersect_cube(spoint, scatter_dir), min=0.0)
    sto = spoint + scatter_dir * tb2[..., 1:2]
    sdist = torch.clamp(_march.segment_length(spoint, sto), min=1e-20)
    diffuse = scene.sample_color(spoint)
    light = scene.sample_env(scatter_dir)
    state, trans = sample_transmittance(state, spoint, sto, sdist)

    # the path weight: exp(logw) == 1 in value, carries the score gradient
    w = torch.exp(logw)[..., None]
    scatter_color = diffuse * light * trans[..., None] * w
    env_color = scene.sample_env(dir_unit) * w
    return torch.where((miss | escaped)[..., None], env_color, scatter_color)


def mcs_expected_image(scene: Scene, params: mcs.Params, height: int,
                       width: int, frames: int, seed0: float = 0.0,
                       track_steps: int = 128,
                       score_floor: float | None = None):
    """Mean colour (H, W, 4) of ``frames`` :func:`mcs_generate` frames,
    differentiable w.r.t. the scene's tables; frame ``i`` takes
    :func:`frame_seed` ``(i, seed0)``, and the running mean divides by the
    float32 ``i + 1``, as ``vpt_tpu``'s ``mcs_expected_image``."""
    acc = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=scene.device)
    for i in range(frames):
        color = mcs_generate(scene, params, frame_seed(i, seed0), height,
                             width, track_steps=track_steps,
                             score_floor=score_floor)
        acc = acc + (color - acc) / torch.full_like(acc, float(i + 1))
    return acc
