"""Sharded progressive rendering: pixel rows over ``data``, the volume over
``space``.

Mirrors ``vpt_tpu/parallel/shard.py``.  JAX's arrays are global and its
partitioner splits a jitted frame; here every rank is a process that holds
its own block of image rows (:func:`place_state`) and renders it through
the renderer's frame with a row window (``render_frame(...,
window=(row0, H))``): the kernels (K5, K6, K8, K10) take each pixel's NDC
and RNG stream from its row in the whole image, so an N-rank render equals
the single-process render bit for bit, and every launch is the card's
kernel.  :func:`gather_state` assembles the row blocks into the whole
image, which JAX never needs.

With ``sharded_scene(shard_volume=True)`` a rank keeps only its z slab of
the volume and of its corner tables between frames, and each frame
all-gathers them over ``space`` (the collective XLA's partitioner inserts
for ``vpt_tpu``'s ``P("space", ...)`` volume), so the image is the
replicated one.  The masked, slab-local fetch that saves the frame's
memory too is ``halo.py``'s (``halo.sharded_render_frame``).

:func:`data_parallel_train_step` is the EAM fit's step that ``vpt_tpu``'s
``train.make_train_step`` becomes under sharded inputs: each rank renders
its rows, the volume gradient is all-reduced over the mesh, and with
``shard_volume=True`` it is reduce-scattered over ``space`` into the
slabs.  Every collective goes through the mesh's process groups (``gloo``
on the CPU, ``nccl`` on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..renderers.base import Scene
from .mesh import Sharding, axis_group, axis_size, block_of, pixel_sharding


def volume_sharding(mesh, axis: str = "space") -> Sharding:
    """Split a (D, H, W, C) volume by z slabs."""
    return Sharding(mesh, (axis, None, None, None))


def _all_gather(out, local, group):
    """``all_gather_into_tensor`` (torch 1.13 and later; torch 2.13 calls
    it deprecated, with a FutureWarning, in favour of
    ``all_gather_single``, which torch 2.11 lacks); bfloat16 crosses as
    int16 (``gloo`` has no bfloat16)."""
    import torch.distributed as dist

    if local.dtype == torch.bfloat16:
        out, local = out.view(torch.int16), local.view(torch.int16)
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)


def _reduce_scatter(out, full, group):
    """The sum of ``full`` over ``group``, this rank's block in ``out``:
    ``reduce_scatter_tensor`` (torch 1.13 and later; deprecated in torch
    2.13 like ``all_gather_into_tensor``)."""
    import torch.distributed as dist

    dist.reduce_scatter_tensor(out, full.contiguous(), group=group)


def gather_blocks(local, n: int, mesh, axes=("data",)):
    """The whole (n, ...) tensor from this rank's block along dim 0, where
    dim 0 splits into ``prod(axis sizes)`` contiguous blocks
    (``mesh.block``), block ``i`` held by the rank whose coordinates
    along ``axes`` (first axis major) read ``i``.  A collective over those
    axes' groups, innermost first; an axis of one rank costs nothing."""
    parts = 1
    for axis in axes:
        parts *= axis_size(mesh, axis)
    size = -(-n // parts)
    buf = local
    if local.shape[0] != size:
        buf = local.new_zeros((size,) + tuple(local.shape[1:]))
        buf[:local.shape[0]] = local
    for axis in reversed(axes):
        k = axis_size(mesh, axis)
        if k == 1:
            continue
        out = buf.new_empty((buf.shape[0] * k,) + tuple(buf.shape[1:]))
        _all_gather(out, buf, axis_group(mesh, axis))
        buf = out
    return buf[:n]


@dataclasses.dataclass
class ShardedScene(Scene):
    """A scene whose volume and corner tables are this rank's z slab
    (:func:`sharded_scene` with ``shard_volume=True``): ``volume`` is (z1 −
    z0, H, W, C) and each table the slab's rows.  Only :meth:`gather`'s
    scene renders; everything else is replicated."""

    mesh: Any = None
    depth: int = 0                     # the whole volume's D

    def gather(self) -> Scene:
        """The whole scene, all-gathered over ``space`` (a collective)."""
        d, h, w = (self.depth,) + tuple(self.volume.shape[1:3])
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(Scene)}
        fields["volume"] = gather_blocks(self.volume, d, self.mesh,
                                         ("space",))
        for name in ("volume_packed", "tracking_packed"):
            table = fields[name]
            if table is not None:
                slab = table.reshape(-1, h * w, table.shape[-1])
                fields[name] = gather_blocks(slab, d, self.mesh,
                                             ("space",)).reshape(
                                                 d * h * w, -1)
        return Scene(**fields)


def sharded_scene(scene: Scene, mesh, shard_volume: bool = False):
    """Place the scene on the mesh.  Every rank builds the same scene (the
    same data and seed); replicated, it is returned as it is.  With
    ``shard_volume`` the rank keeps only its z slab of the volume and of
    its corner tables (:class:`ShardedScene`, whose :meth:`~ShardedScene.
    gather` a frame calls); everything else replicates."""
    if not shard_volume:
        return scene
    d, h, w = scene.volume.shape[:3]
    slab = volume_sharding(mesh).local_slice(scene.volume.shape)
    fields = {f.name: getattr(scene, f.name)
              for f in dataclasses.fields(Scene)}
    fields["volume"] = scene.volume[slab].clone()
    for name in ("volume_packed", "tracking_packed"):
        if fields[name] is not None:
            rows = fields[name].reshape(d, h * w, -1)[slab]
            fields[name] = rows.reshape(-1, rows.shape[-1]).clone()
    return ShardedScene(**fields, mesh=mesh, depth=d)


def whole_scene(scene):
    """The scene a frame renders: a :class:`ShardedScene` gathered, any
    other as it is."""
    return scene.gather() if isinstance(scene, ShardedScene) else scene


#: state leaves that never split by rows, whatever their shape: DOS's
#: (samples, 2) disk offsets (``vpt_tpu``'s ``dos_halo`` shards DOS's
#: leaves by name, so ``samples == height`` splits nothing more)
WHOLE_LEAVES = ("offsets",)


def _leaves(state):
    if isinstance(state, dict):
        return [v for k, v in state.items() if k not in WHOLE_LEAVES]
    return [state]


def state_height(state) -> Optional[int]:
    """The image height of a renderer state: the largest leading dim of
    its leaves of two or more dims (``vpt_tpu``'s ``_state_sharding``
    rule), :data:`WHOLE_LEAVES` aside."""
    return max((leaf.shape[0] for leaf in _leaves(state)
                if getattr(leaf, "ndim", 0) >= 2), default=None)


def _map_rows(state, height, fn):
    """``fn`` over each (H, W, ...) leaf (two or more dims, ``height``
    rows), the others (and :data:`WHOLE_LEAVES`) kept."""
    def leaf(x):
        if getattr(x, "ndim", 0) >= 2 and x.shape[0] == height:
            return fn(x)
        return x

    if isinstance(state, dict):
        return {k: v if k in WHOLE_LEAVES else leaf(v)
                for k, v in state.items()}
    return leaf(state)


def place_state(state, mesh, height: Optional[int] = None):
    """This rank's block of image rows of every (H, W, ...) leaf of a
    whole-image state (contiguous copies over ``data``); every other leaf
    (scalars, DOS's (samples, 2) tap table) is kept whole."""
    height = state_height(state) if height is None else height
    return _map_rows(state, height, lambda x: x[pixel_sharding(
        mesh, x.ndim).local_slice(x.shape)].clone())


def gather_state(state, mesh, height: int):
    """The whole-image state (or image) from every rank's row block of
    each leaf (a collective over ``data``); the inverse of
    :func:`place_state`."""
    r0, r1 = block_of(height, mesh)
    return _map_rows(state, r1 - r0,
                     lambda x: gather_blocks(x, height, mesh))


def shard_render_frame(module, mesh, state_example, donate: bool = True):
    """The renderer's frame on this rank's rows.

    ``state_example``: a whole-image state of the renderer (JAX's arrays
    are global), which gives the image height.  Returns ``(state, scene,
    params, seed, frame) -> state`` for the rank's placed state
    (:func:`place_state`): ``module.render_frame`` with the rank's row
    window, on the scene as :func:`sharded_scene` placed it (a sharded
    volume is gathered for the frame).  The state is updated in place
    unless ``donate`` is False, which renders into a copy.  DOS's band
    of rows (``dos.render_band``) reads its neighbours' occlusion: each
    slice all-gathers the whole occlusion buffer over ``data``, as JAX's
    partitioner does, so it also takes a camera inside the volume
    (``dos_halo.sharded_render_frame`` exchanges K rows instead); a band
    of the whole image is the renderer's own frame."""
    height = state_height(state_example)
    window = (block_of(height, mesh)[0], height)
    band = getattr(module, "render_band", None) \
        if axis_size(mesh, "data") > 1 else None

    def extend(occlusion):
        return gather_blocks(occlusion, height, mesh), 0

    def frame(state, scene, params, seed, frame_number):
        if not donate:
            state = _map_rows(state, state_height(state), torch.clone)
        if band is not None:
            return band(state, whole_scene(scene), params, window, extend)
        return module.render_frame(state, whole_scene(scene), params, seed,
                                   frame_number, window=window)

    return frame


def shard_display(module, mesh, state_example):
    """``(state, scene, params) -> image rows``: the renderer's display of
    this rank's rows (every display is per pixel), on the whole scene."""
    def display(state, scene, params):
        return module.display(state, whole_scene(scene), params)

    return display


def _all_reduce(t, mesh, axes=("data", "space")):
    """``t`` summed over the mesh's ``axes``, in place."""
    import torch.distributed as dist

    for axis in axes:
        group = axis_group(mesh, axis)
        if group is not None and axis_size(mesh, axis) > 1:
            dist.all_reduce(t, group=group)
    return t


def scatter_blocks(full, mesh, axis: str = "space"):
    """This rank's block along dim 0 (:func:`block_of` over ``axis``) of
    the sum of ``full`` over ``axis``: a reduce-scatter."""
    n = full.shape[0]
    k = axis_size(mesh, axis)
    start, stop = block_of(n, mesh, (axis,))
    if k == 1:
        return full[start:stop]
    size = -(-n // k)
    buf = full.new_zeros((size * k,) + tuple(full.shape[1:]))
    buf[:n] = full
    out = full.new_empty((size,) + tuple(full.shape[1:]))
    _reduce_scatter(out, buf, axis_group(mesh, axis))
    return out[:stop - start]


def _slab_depth(slab, mesh) -> int:
    """The whole volume's D from this rank's z slab (a collective over
    ``space``)."""
    n = torch.tensor([slab.shape[0]], dtype=torch.int64, device=slab.device)
    return int(_all_reduce(n, mesh, ("space",)).item())


def eam_loss_rows(volume_data, tf_texture, camera_matrices, target, params,
                  seed, mesh, axes=("data", "space")):
    """This rank's share of the EAM fit's loss (``train.mse_rgb`` of the
    whole image): the squared RGB error summed over its block of rows
    (split over ``axes``, first major) divided by H·W·3, so that the sum
    over ranks is the whole image's mean and the sum of their gradients
    its gradient.  ``target`` is the whole (H, W, 4) image."""
    from ..train import _float32, render_eam

    height, width = target.shape[:2]
    r0, r1 = block_of(height, mesh, axes)
    pred = render_eam(volume_data, tf_texture, camera_matrices, params,
                      seed, r1 - r0, width, window=(r0, height))
    rows = _float32(target, pred.device)[r0:r1]
    err = (pred[..., :3] - rows[..., :3]) ** 2
    return torch.sum(err) / float(height * width * 3)


def eam_value_and_grad(volume_data, tf_texture, camera_matrices, target,
                       params, seed, mesh, fit_volume: bool = True,
                       fit_tf: bool = False, shard_volume: bool = False):
    """The whole image's EAM loss and the gradients of the fitted leaves,
    ``(loss, {"volume": ..., "tf": ...})``, every rank rendering its block
    of rows (over data, then space).  ``shard_volume``: ``volume_data`` is
    this rank's z slab, all-gathered over ``space`` for the frame, and its
    gradient is the whole gradient reduce-scattered over ``space`` and
    all-reduced over ``data``; else the volume is whole and its gradient
    all-reduced over the mesh, as is the TF's.  Collectives: every rank
    calls it."""
    from ..train import _float32

    dev = torch.as_tensor(volume_data).device
    vol = _float32(volume_data, dev).detach()
    if shard_volume:
        vol = gather_blocks(vol, _slab_depth(vol, mesh), mesh, ("space",))
    tf = _float32(tf_texture, dev).detach()
    vol.requires_grad_(fit_volume)
    tf.requires_grad_(fit_tf)
    loss = eam_loss_rows(vol, tf, camera_matrices, target, params, seed,
                         mesh)
    loss.backward()
    grads = {}
    if fit_volume:
        if shard_volume:
            grads["volume"] = _all_reduce(scatter_blocks(vol.grad, mesh),
                                          mesh, ("data",))
        else:
            grads["volume"] = _all_reduce(vol.grad, mesh)
    if fit_tf:
        grads["tf"] = _all_reduce(tf.grad, mesh)
    return _all_reduce(loss.detach(), mesh), grads


def data_parallel_train_step(optimizer: Callable, mesh, params=None,
                             fit_volume: bool = True, fit_tf: bool = False,
                             shard_volume: bool = False):
    """``step(volume, tf, opt_state, camera_matrices, target, seed) ->
    (loss, volume, tf, opt_state)``: one optimizer step of the EAM fit
    whose image rows split over every rank of the mesh
    (:func:`eam_value_and_grad`), in ``train.make_train_step``'s
    convention: ``optimizer`` a factory of a torch optimizer (e.g.
    ``lambda p: torch.optim.Adam(p, lr=0.05)``), ``opt_state`` None or
    {leaf name: its per-parameter state}, ``target`` the whole (H, W, 4)
    image.  With ``shard_volume`` the volume in and out is this rank's z
    slab, and so is its optimizer state.  ``loss`` is the whole image's
    MSE on every rank; the volume is clipped to [0, 1], the TF is not."""
    from ..renderers import eam
    from ..train import _adam, _float32

    params = params or eam.Params(random=False)

    def step(volume_data, tf_texture, opt_state, camera_matrices, target,
             seed):
        dev = torch.as_tensor(volume_data).device
        loss, grads = eam_value_and_grad(
            volume_data, tf_texture, camera_matrices, target, params, seed,
            mesh, fit_volume, fit_tf, shard_volume)
        current = {"volume": _float32(volume_data, dev),
                   "tf": _float32(tf_texture, dev)}
        fit = {name: current[name].detach().clone().requires_grad_(True)
               for name in grads}
        opt = _adam(fit, opt_state, optimizer)
        for name, leaf in fit.items():
            leaf.grad = grads[name]
        opt.step()
        out = {**current, **{k: v.detach() for k, v in fit.items()}}
        if fit_volume:
            out["volume"] = torch.clamp(out["volume"], 0.0, 1.0)
        return loss, out["volume"], out["tf"], {
            name: opt.state[leaf] for name, leaf in fit.items()}

    return step
