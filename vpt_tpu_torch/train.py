"""Inverse rendering: fit voxel densities and/or the transfer-function
texture to target images.

Mirrors ``vpt_tpu/train.py``, with ``optax.adam`` replaced by
``torch.optim.Adam`` (the same defaults: betas 0.9 and 0.999, eps 1e-8):

- the EAM fit: :func:`render_eam` (one differentiable EAM frame),
  :class:`FitState`, :func:`make_train_step` (one Adam step) and
  :func:`fit` (Adam over one or several views, the loss their mean);
- the Monte-Carlo fit :func:`fit_mc` (``renderer="mcm"`` and ``"mcs"``).

Every fit samples a differentiable scene (``renderers.base.fit_scene``):
the corner tables are packed inside the differentiated graph, so each
volume fetch is one corner-row gather forward (K3) and one corner
scatter-add backward (K4), and the TF is the packed bilinear texture.  The
float32 packing is bit for bit the unpacked fetch that ``vpt_tpu``'s EAM
fit samples.  The EAM fit renders through the plain frame
(``eam.generate``): the march kernel (K6) has no gradient.  The scatter
fold of the JAX MC fit (``sampling.scatter_fold_log2``) is a TPU layout
and is not ported.

Optimizer state crosses between the packages through
``interop.adam_state_from_numpy`` / ``adam_state_to_numpy`` (optax's
``count``, ``mu`` and ``nu`` against Adam's ``step``, ``exp_avg`` and
``exp_avg_sq``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .renderers import diff_mc
from .renderers import mcm as mcm_mod
from .renderers import mcs as mcs_mod
from .renderers import eam
from .renderers.base import Scene, fit_scene

#: default estimator extinctions fit_mc uses when no Params are passed
MC_FIT_EXTINCTION = {"mcm": 10.0, "mcs": 5.0}


def mc_loss(leaves, scene_template, target, params, frames, seed0):
    """Mean squared error of the expected MC image (MCM's for
    ``mcm.Params``, MCS's for ``mcs.Params``) against ``target``'s RGB,
    for the fit leaves ``{"volume": ..., "tf": ...}``."""
    sc = fit_scene(scene_template, leaves.get("volume"), leaves.get("tf"))
    height, width = target.shape[:2]
    expected = diff_mc.mcs_expected_image \
        if isinstance(params, mcs_mod.Params) else diff_mc.mcm_expected_image
    img = expected(sc, params, height, width, frames, seed0=seed0)
    return torch.mean((img[..., :3] - target[..., :3]) ** 2)


def _float32(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device, torch.float32)


def fit_mc(target, scene_template, init_volume=None, init_tf=None,
           renderer: str = "mcm", params=None, frames: int = 64,
           steps: int = 50, learning_rate: float = 0.02,
           verbose: bool = False):
    """Inverse rendering through the MC estimators (BASELINE config 3:
    voxel-density gradients through MCM; ``renderer="mcs"``: BASELINE's
    MCS single scattering with differentiable TF parameters).  Optimizes
    the voxel grid and/or the TF texture so that the expected MC radiance
    matches ``target``, with the ratio-weight estimators of
    :mod:`renderers.diff_mc`, on the device of ``scene_template``.  Each
    step draws a fresh seed stream, takes one Adam step and clips the
    leaves to [0, 1].  Returns
    ``(volume, tf, losses)``; a leaf that was not fitted comes back None."""
    if renderer == "mcm":
        params = params or mcm_mod.Params(
            extinction=MC_FIT_EXTINCTION["mcm"], steps=16)
    elif renderer == "mcs":
        params = params or mcs_mod.Params(
            extinction=MC_FIT_EXTINCTION["mcs"])
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


def eam_scene(volume_data, tf_texture, camera_matrices, kernels: bool = True):
    """The EAM fit's scene on the volume's device: ``vpt_tpu.train``'s
    unpacked scene (a 1×1 white environment) as
    :func:`renderers.base.fit_scene` packs it, so that autograd reaches
    whichever of the volume and the TF requires grad through K3 and K4
    (and the packed TF texture).  ``kernels=False``: the plain version of
    every kernel (the reference on the card)."""
    dev = volume_data.device
    mvp_inv, model_view, projection = (_float32(m, dev)
                                       for m in camera_matrices)
    tf_texture = _float32(tf_texture, dev)
    template = Scene(volume=volume_data, transfer=tf_texture,
                     environment=torch.ones((1, 1, 4), dtype=torch.float32,
                                            device=dev),
                     mvp_inverse=mvp_inv, model_view=model_view,
                     projection=projection, transfer_1d=tf_texture[0],
                     kernels=kernels)
    return fit_scene(template)


def _with_camera(scene, camera_matrices):
    mvp_inv, model_view, projection = (_float32(m, scene.device)
                                       for m in camera_matrices)
    return dataclasses.replace(scene, mvp_inverse=mvp_inv,
                               model_view=model_view, projection=projection)


def render_eam(volume_data, tf_texture, camera_matrices, params: eam.Params,
               seed, height: int, width: int, window=None):
    """One differentiable EAM frame (the plain frame ``eam.generate``: the
    march kernel K6 has no gradient) of ``volume_data`` (D, H, W, C) under
    ``tf_texture`` (TH, TW, 4) through ``camera_matrices`` =
    (mvp_inverse, model_view, projection), on :func:`eam_scene`.  Under
    ``torch.no_grad`` the same frame samples as a rendering scene (K3 and
    the K1 TF lookup on the card), with the same values.  ``window``:
    None, or ``(row0, full_height)``: the ``height`` rows from ``row0`` of
    a ``full_height``-row image (a data-parallel rank's rows,
    ``parallel.shard``)."""
    return eam.generate(eam_scene(volume_data, tf_texture, camera_matrices),
                        params, seed, height, width, window=window)


@dataclasses.dataclass
class FitState:
    """An EAM fit's leaves and Adam state (:func:`make_train_step`'s
    ``opt_state``: ``{leaf name: {"step", "exp_avg", "exp_avg_sq"}}``)."""

    volume_data: Any
    tf_texture: Any
    opt_state: Any
    step: int = 0


def mse_rgb(pred, target):
    """``mean((pred[..., :3] − target[..., :3])²)``: the EAM fit's loss."""
    return torch.mean((pred[..., :3] - target[..., :3]) ** 2)


def _adam(leaves, opt_state, optimizer):
    """``optimizer(params)`` over the fitted leaves (in the order volume,
    tf), its state loaded from a copy of ``opt_state``: a step leaves the
    state it was given as it was, as optax's update does."""
    opt = optimizer(list(leaves.values()))
    for name, leaf in leaves.items():
        if opt_state and name in opt_state:
            opt.state[leaf] = copy.deepcopy(opt_state[name])
    return opt


def _fit_leaves(volume_data, tf_texture, fit_volume, fit_tf, device):
    """The leaves the step fits, as fresh tensors that require grad, and
    the ones it holds fixed."""
    fit, static = {}, {}
    for name, value, fitted in (("volume", volume_data, fit_volume),
                                ("tf", tf_texture, fit_tf)):
        value = _float32(value, device)
        if fitted:
            fit[name] = value.detach().clone().requires_grad_(True)
        else:
            static[name] = value
    return fit, static


def make_train_step(optimizer: Callable,
                    params: Optional[eam.Params] = None,
                    height: int = 256, width: int = 256,
                    fit_volume: bool = True, fit_tf: bool = False,
                    loss_fn: Callable = None):
    """Build ``step(volume, tf, opt_state, camera_matrices, target, seed) ->
    (loss, volume, tf, opt_state)`` for EAM inverse rendering.

    ``optimizer``: a factory ``params -> torch.optim.Optimizer``, e.g.
    ``lambda p: torch.optim.Adam(p, lr=0.05)`` for ``optax.adam(0.05)``.
    ``opt_state`` is None for a fresh optimizer, else the state a step
    returned (``{leaf name: the optimizer's per-parameter state}``);
    ``loss`` is a 0-d tensor.  Gradients flow to the leaves the fit_*
    flags name (they alone require grad); the other input passes through
    untouched.  The updated volume is clipped to [0, 1]; the TF is not, as
    in ``vpt_tpu``."""
    params = params or eam.Params(random=False)
    loss_fn = loss_fn or mse_rgb

    def step(volume_data, tf_texture, opt_state, camera_matrices, target,
             seed):
        dev = torch.as_tensor(volume_data).device
        fit, static = _fit_leaves(volume_data, tf_texture, fit_volume,
                                  fit_tf, dev)
        opt = _adam(fit, opt_state, optimizer)
        leaves = {**static, **fit}
        pred = render_eam(leaves["volume"], leaves["tf"], camera_matrices,
                          params, seed, height, width)
        loss = loss_fn(pred, _float32(target, dev))
        loss.backward()
        opt.step()
        new_volume = fit["volume"].detach() if fit_volume \
            else static["volume"]
        new_tf = fit["tf"].detach() if fit_tf else static["tf"]
        if fit_volume:
            new_volume = torch.clamp(new_volume, 0.0, 1.0)
        return loss.detach(), new_volume, new_tf, {
            name: opt.state[leaf] for name, leaf in fit.items()}

    return step


def multiview_loss(volume_data, tf_texture, views, targets, params, seed,
                   kernels: bool = True):
    """The mean over views of each view's :func:`mse_rgb` of
    :func:`render_eam` against its target, in the order of ``views``
    (``vpt_tpu.train.fit`` vmaps the same per-view losses, then means
    them).  The scene is packed once for all views."""
    height, width = targets[0].shape[:2]
    scene = eam_scene(volume_data, tf_texture, views[0], kernels)
    losses = []
    for mats, target in zip(views, targets):
        pred = eam.generate(_with_camera(scene, mats), params, seed, height,
                            width)
        losses.append(mse_rgb(pred, target))
    return torch.mean(torch.stack(losses))


def fit(target, camera_matrices, init_volume, init_tf,
        steps: int = 100, learning_rate: float = 0.05,
        params: Optional[eam.Params] = None,
        fit_volume: bool = True, fit_tf: bool = False,
        verbose: bool = False):
    """Adam-optimize a volume (and/or TF) against target EAM renderings,
    on the device of ``init_volume``.  Returns ``(volume, tf, losses)``.

    Multi-view: pass ``target`` as a list of images and
    ``camera_matrices`` as a matching list of (mvp_inv, model_view, proj)
    tuples; the loss is the mean over views (single-view reconstruction
    is ill-posed along the view axis).  The seed is 0 at every step; the
    updated volume is clipped to [0, 1], the TF is not."""
    if not isinstance(target, (list, tuple)):
        target = [target]
        camera_matrices = [camera_matrices]
    dev = torch.as_tensor(init_volume).device
    targets = [_float32(t, dev) for t in target]
    params = params or eam.Params(random=False)
    leaves, static = _fit_leaves(init_volume, init_tf, fit_volume, fit_tf,
                                 dev)
    opt = torch.optim.Adam(list(leaves.values()), lr=learning_rate)
    seed = np.float32(0.0)

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        cur = {**static, **leaves}
        loss = multiview_loss(cur["volume"], cur["tf"], camera_matrices,
                              targets, params, seed)
        loss.backward()
        opt.step()
        if fit_volume:
            with torch.no_grad():
                leaves["volume"].clamp_(0.0, 1.0)
        losses.append(loss.item())
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    out = {**static, **{k: v.detach() for k, v in leaves.items()}}
    return out["volume"], out["tf"], losses
