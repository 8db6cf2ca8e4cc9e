"""Differentiable Monte-Carlo estimator for the MCM renderer.

Mirrors the MCM half of ``vpt_tpu/renderers/diff_mc.py``.  The forward MC
machine samples discrete events, which have no pathwise derivative; this
module re-runs the same event chains (same RNG streams, same branch
outcomes) but multiplies each path's contribution by ratio weights
``w_k = p_k / detach(p_k)`` for every decision ``k`` with a probability that
depends on the scene.  Each weight is 1 in value, so the image is the analog
estimator's, and its gradient carries the score-function term: the gradient
of the *expected* radiance, pathwise through the tints and TF colours and
score through the weights.

The frame is a Python loop of plain PyTorch events over the pixel grid.
Unlike ``renderers/mcm.py`` it updates the state functionally, since
autograd keeps the tensors of every event.  The scene's samplers put the
kernels on the path: the volume fetch of a table that requires grad is the
fused corner gather forward and the corner scatter backward
(``sampling.CornerFetch``).  Positions are detached, as in JAX.

Not ported: the MCS estimator (``mcs_generate``, ``mcs_expected_image``),
which waits for the MCS renderer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng, sampling
from ..utils import constant
from . import mcm
from .base import Scene, _not_ported


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


def mcs_generate(*args, **kwargs):
    raise _not_ported("the differentiable MCS estimator (mcs_generate)",
                      "queue 1 items 10 and 12")


def mcs_expected_image(*args, **kwargs):
    raise _not_ported("the differentiable MCS estimator "
                      "(mcs_expected_image)", "queue 1 items 10 and 12")
