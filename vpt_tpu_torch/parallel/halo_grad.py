"""Differentiable spatially sharded rendering (BASELINE config 4).

Mirrors ``vpt_tpu/parallel/halo_grad.py``.  Voxel-density gradients for
volumes too large to keep whole on a card: the volume lives as z slabs
over the mesh's ``space`` axis (``halo.py``), and the gradient comes back
in slab form, each rank holding its slab's voxel gradients.  Three
mechanisms compose:

1. **Forward halo sampling**: the masked slab fetch (K3's slab instance,
   ``sampling.SlabCornerFetch``) and its sum over ``space``
   (``halo.SpaceSum``), whose backward hands each rank the cotangent of
   the positions it owns; K4's bucket instance scatters them into the
   slab's corner-table gradient a bucket at a time (item 3; a non-owned
   sample's cell is -1, which K4 skips).
2. **Halo-plane gradient exchange**: slab k's halo plane is slab k+1's
   first plane, so after the backward pass its gradient goes to slab k+1
   and is added there (the last slab's halo repeats its own edge plane,
   CLAMP_TO_EDGE, so its halo gradient folds into its last plane).  JAX
   sends it by ``ppermute``; here it rides one ``all_gather`` of the halo
   planes over ``space`` (``shard._all_gather``; point-to-point sends are
   left to a measured change).
3. **Bucketed data-axis reduction**: the slab splits into z buckets that
   are separate leaves (``_split_slab``; the last holds the halo plane),
   joined by a ``sampling.BucketedTable``.  The masked fetches keep their
   entries, and after the backward march the buckets' gradients are
   scattered (K4's bucket instance), folded and, with ``data`` > 1 (every
   rank of a ``space`` line renders the same rows), each all-reduced over
   ``data`` asynchronously as soon as it is final, before the next
   bucket's scatter: one reduction a bucket, as in ``overlap.py``.  The
   loss is all-reduced over ``data`` after the backward pass.

The slab's corner table is packed in the graph once a step through the
buckets (``sampling.pack_fit_table``, as ``renderers.base.fit_scene``
packs the fits' tables); JAX's ``scatter_fold_log2`` wide rows are a TPU
layout, not ported (K4 scatters into the unfolded rows).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import sampling
from ..renderers.base import transfer_row
from .halo import (COLLECTIVES, HaloScene, all_reduce_, all_reduce_async,
                   slab_of)
from .mesh import axis_group, axis_index, axis_size, block_of


def _split_slab(slab, num_buckets: int):
    """(Ds+1, H, W, C) haloed slab → its ``num_buckets`` body buckets, the
    last with the halo plane after its Ds / k planes: each a leaf of its
    own, whose gradient is reduced over ``data`` once (JAX makes the halo
    plane a leaf of its own, a psum more)."""
    ds = slab.shape[0] - 1
    if ds % num_buckets:
        raise ValueError(f"slab depth {ds} not divisible by {num_buckets}")
    bs = ds // num_buckets
    return [slab[i * bs:(i + 1) * bs] for i in range(num_buckets - 1)] \
        + [slab[(num_buckets - 1) * bs:]]


def _join_slab(parts):
    return torch.cat(list(parts), dim=0)


def _gather_planes(plane, mesh, space_axis):
    """Every rank's (H, W, C) ``plane`` over ``space``, (S, H, W, C): one
    all-gather (counted)."""
    from .shard import _all_gather

    k = axis_size(mesh, space_axis)
    if k == 1:
        return plane[None]
    out = plane.new_empty((k * plane.shape[0],) + tuple(plane.shape[1:]))
    _all_gather(out, plane.contiguous(), axis_group(mesh, space_axis))
    COLLECTIVES["all_gather"] += 1
    return out.reshape((k,) + tuple(plane.shape))


def make_sharded_grad(mesh, scene, params, height: int, width: int,
                      frames: int, num_slabs: int,
                      expected: Optional[Callable] = None,
                      num_buckets: int = 1,
                      score_floor: Optional[float] = None,
                      space_axis: str = "space", data_axis: str = "data"):
    """``grad_fn(slabs, target, seed0) -> (loss, body_grads)`` over a
    halo-sharded volume.

    ``slabs``: this rank's (1, Ds+1, H, W, C) block of
    :func:`place_slabs` (the ``space`` axis holds ``num_slabs`` ranks);
    ``target`` the whole (H, W, 3 or 4) image; ``body_grads`` the (1, Ds,
    H, W, C) voxel gradient of this rank's slab body with the halo-plane
    gradients exchanged to their owners (the bodies over ``space`` joined
    are the replicated volume's gradient).  ``loss`` is the whole image's
    RGB mean squared error, the same on every rank.  ``expected(scene,
    params, height, width, frames, seed0=, score_floor=)`` renders the
    image; it defaults to the MCM expected-image estimator
    (``diff_mc.mcm_expected_image``).  The estimators take no row window,
    so with ``data`` > 1 a rank renders the whole image and takes the loss
    of its block of rows.  Every rank calls ``grad_fn`` (collectives)."""
    if expected is None:
        from ..renderers.diff_mc import mcm_expected_image as expected

    if axis_size(mesh, space_axis) != num_slabs:
        raise ValueError(f"{num_slabs} slabs on a {space_axis} axis of "
                         f"{axis_size(mesh, space_axis)} ranks: one slab a "
                         "rank")
    volume_shape = tuple(scene.volume.shape)
    d = volume_shape[0]
    ds = d // num_slabs
    index = axis_index(mesh, space_axis)
    group = axis_group(mesh, space_axis)
    rows = block_of(height, mesh, (data_axis,))
    data_group = axis_group(mesh, data_axis) \
        if axis_size(mesh, data_axis) > 1 else None
    transfer = scene.transfer
    transfer_packed = sampling.pack_corner_texture2d(transfer)
    camera = dict(environment=scene.environment,
                  mvp_inverse=scene.mvp_inverse,
                  model_view=scene.model_view, projection=scene.projection)

    def grad_fn(slabs, target, seed0):
        slab = slabs[0]
        parts = [p.detach().requires_grad_(True)
                 for p in _split_slab(slab, num_buckets)]
        handles = []

        def reduce(bucket, grad):
            handles.append(all_reduce_async(grad, data_group))

        table = sampling.BucketedTable(
            [p.shape[0] for p in parts],
            None if data_group is None else reduce)
        joined = table.join(parts)
        hscene = HaloScene(
            slab=joined, slab_index=index, num_slabs=num_slabs,
            volume_shape=volume_shape, transfer=transfer,
            transfer_1d=transfer_row(transfer, transfer_packed),
            group=group, slab_packed=sampling.pack_fit_table(joined),
            transfer_packed=transfer_packed, **camera)
        img = expected(hscene, params, height, width, frames, seed0=seed0,
                       score_floor=score_floor)
        pred = img[..., :3] if img.shape[-1] >= 3 else img
        want = torch.as_tensor(target, dtype=torch.float32,
                               device=pred.device)[..., :3]
        if data_group is None:
            loss = torch.mean((pred - want) ** 2)
        else:
            err = (pred[rows[0]:rows[1]] - want[rows[0]:rows[1]]) ** 2
            loss = torch.sum(err) / float(height * width * 3)
        loss.backward()
        grads = table.gradients()
        for handle in handles:
            handle.wait()
        g = _join_slab(grads)                       # (Ds+1, H, W, C)
        loss = loss.detach()
        if data_group is not None:
            all_reduce_(loss, data_group)
        # the halo plane's gradient belongs to the next slab's first plane;
        # the last slab's halo repeats its own edge plane
        halo_g = g[ds]
        halos = _gather_planes(halo_g, mesh, space_axis)
        body_g = g[:ds].clone()
        if index > 0:
            body_g[0] += halos[index - 1]
        if index == num_slabs - 1:
            body_g[ds - 1] += halo_g
        return loss, body_g[None]

    return grad_fn


def place_slabs(volume, mesh, num_slabs: int, space_axis: str = "space"):
    """This rank's (1, Ds+1, H, W, C) block of the halo-sharded ``volume``
    (``halo.shard_volume_with_halo``'s slab of its ``space`` index)."""
    if axis_size(mesh, space_axis) != num_slabs:
        raise ValueError(f"{num_slabs} slabs on a {space_axis} axis of "
                         f"{axis_size(mesh, space_axis)} ranks")
    return slab_of(volume, num_slabs, axis_index(mesh, space_axis))[None]


def rehalo(body_slabs, mesh, space_axis: str = "space"):
    """This rank's (1, Ds, H, W, C) slab body → its (1, Ds+1, H, W, C)
    haloed slab: the halo plane is the next slab's first plane (one
    all-gather of the first planes over ``space``), the last slab's its own
    edge plane.  The sharded twin of ``shard_volume_with_halo``: a train
    step updates the bodies in place and refreshes the halos without
    gathering the volume."""
    body = body_slabs[0]
    index = axis_index(mesh, space_axis)
    last = axis_size(mesh, space_axis) - 1
    firsts = _gather_planes(body[0], mesh, space_axis)
    halo = body[-1] if index == last else firsts[index + 1]
    return torch.cat([body, halo[None]], dim=0)[None]
