"""Inverse rendering through the Monte-Carlo estimator: fit voxel densities
and/or the transfer-function texture to a target image.

Mirrors ``fit_mc(renderer="mcm")`` of ``vpt_tpu/train.py:95-190``, with
``optax.adam`` replaced by ``torch.optim.Adam`` (the same defaults: betas
0.9 and 0.999, eps 1e-8).  The corner tables are packed inside the
differentiated graph at fold 0: one corner-row gather per event forward
(K3) and one corner scatter-add per event backward (K4).  The scatter fold
of the JAX fit (``sampling.scatter_fold_log2``) is a TPU layout and is not
ported.

Not ported yet: the EAM fit (``fit``, ``make_train_step``, ``render_eam``),
which waits for the EAM renderer, and ``fit_mc(renderer="mcs")``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import sampling
from .renderers import diff_mc
from .renderers import mcm as mcm_mod
from .renderers.base import _not_ported, transfer_row

#: default estimator extinctions fit_mc uses when no Params are passed
MC_FIT_EXTINCTION = {"mcm": 10.0, "mcs": 5.0}


def fit_scene(scene_template, volume=None, tf=None):
    """The fit's differentiable scene: ``scene_template`` with the given
    volume and/or TF texture and their corner tables packed from them (in
    the graph, so gradients reach the leaves), sampled through the bilinear
    packed TF as JAX's fit scene is (``transfer_mxu=None``)."""
    vol = scene_template.volume if volume is None else volume
    tf_tex = scene_template.transfer if tf is None else tf
    transfer_packed = sampling.pack_corner_texture2d(tf_tex)
    return dataclasses.replace(
        scene_template, volume=vol, transfer=tf_tex,
        volume_packed=sampling.pack_corner_volume(vol),
        transfer_packed=transfer_packed,
        transfer_1d=transfer_row(tf_tex, transfer_packed),
        tracking_packed=None, tf_mxu=None)


def mc_loss(leaves, scene_template, target, params, frames, seed0):
    """Mean squared error of the expected MC image against ``target``'s
    RGB, for the fit leaves ``{"volume": ..., "tf": ...}``."""
    sc = fit_scene(scene_template, leaves.get("volume"), leaves.get("tf"))
    height, width = target.shape[:2]
    img = diff_mc.mcm_expected_image(sc, params, height, width, frames,
                                     seed0=seed0)
    return torch.mean((img - target[..., :3]) ** 2)


def _float32(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device, torch.float32)


def fit_mc(target, scene_template, init_volume=None, init_tf=None,
           renderer: str = "mcm", params=None, frames: int = 64,
           steps: int = 50, learning_rate: float = 0.02,
           verbose: bool = False):
    """Inverse rendering through the MC estimator (BASELINE config 3:
    voxel-density gradients through MCM).  Optimizes the voxel grid and/or
    the TF texture so that the expected MCM radiance matches ``target``,
    with the ratio-weight estimator of :mod:`renderers.diff_mc`, on the
    device of ``scene_template``.  Each step draws a fresh seed stream,
    takes one Adam step and clips the leaves to [0, 1].  Returns
    ``(volume, tf, losses)``; a leaf that was not fitted comes back None."""
    if renderer == "mcm":
        params = params or mcm_mod.Params(
            extinction=MC_FIT_EXTINCTION["mcm"], steps=16)
    elif renderer == "mcs":
        raise _not_ported("fit_mc(renderer='mcs')", "queue 1 items 10 and 12")
    else:
        raise ValueError("fit_mc supports 'mcm' and 'mcs'")
    if init_volume is None and init_tf is None:
        raise ValueError("nothing to fit: pass init_volume and/or init_tf")

    dev = scene_template.device
    target = _float32(target, dev)
    leaves = {name: _float32(init, dev).clone().requires_grad_(True)
              for name, init in (("volume", init_volume), ("tf", init_tf))
              if init is not None}
    optimizer = torch.optim.Adam(list(leaves.values()), lr=learning_rate)

    losses = []
    for i in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = mc_loss(leaves, scene_template, target, params, frames,
                       np.float32(0.1 + 0.013 * i))
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for leaf in leaves.values():
                leaf.clamp_(0.0, 1.0)
        losses.append(loss.item())
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    out = {k: v.detach() for k, v in leaves.items()}
    return out.get("volume"), out.get("tf"), losses


def render_eam(*args, **kwargs):
    raise _not_ported("the differentiable EAM render (render_eam)",
                      "queue 1 item 11")


def make_train_step(*args, **kwargs):
    raise _not_ported("the EAM train step (make_train_step)",
                      "queue 1 item 11")


def fit(*args, **kwargs):
    raise _not_ported("the EAM fit (fit)", "queue 1 item 11")
