"""Bucketed gradient reduction: the voxel gradient reduced per z bucket,
each bucket's reduction issued as soon as its gradient is final.

Mirrors ``vpt_tpu/parallel/overlap.py``.  One all-reduce of the whole
grid's gradient after the backward pass serializes communication after
compute; splitting the volume into z buckets lets each bucket's reduction
start while the next bucket's gradient is still being computed (DDP's
bucketed all-reduce; JAX's scheduler interleaves the per-bucket
scatter-add and psum that the transpose emits for each bucket input).

The buckets are leaves joined by a ``sampling.BucketedTable``: the loss
receives their join, the (D, H, W, C) volume, and the fits' table packing
(``renderers.base.fit_scene`` → ``sampling.pack_fit_table``) finds the
buckets behind it through the join's ``grad_fn`` and packs the corner
table through them.  Every fused fetch of that table (K3) keeps its cells,
fractions and cotangents in its backward and scatters nothing.  Once the
last fetch's backward has run, the join's backward walks the buckets in
ascending z: K4's bucket instance over bucket b's rows
(``kernels/corner_scatter.corner_grad_bucket``), the fold of those rows'
gradient into bucket b's voxels, whose gradient is then final (a voxel of
plane z takes gradient from the rows of planes z − 1 and z), and with a
process ``group`` its ``all_reduce(async_op=True)``, before bucket b + 1's
scatter is launched.  The step waits on the handles before the optimizer.
A loss that reads the volume by another route too (a plain fetch, the
voxels themselves) still gets each bucket's whole gradient: that share
arrives with the join's backward and is added before the reduction.

Usage::

    buckets = split_volume(volume, k)
    loss, grads = value_and_grad_bucketed(loss_of_volume, buckets, *args,
                                          group=group)
    volume_grad = join_volume(grads)

``loss_of_volume`` receives the re-joined (D, H, W, C) tensor; gradients
come back per bucket, summed over ``group`` (none: this process's own).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .. import sampling


def split_volume(volume, num_buckets: int) -> List[torch.Tensor]:
    """(D, H, W, C) → list of (D/k, H, W, C) z buckets (views)."""
    d = volume.shape[0]
    if d % num_buckets != 0:
        raise ValueError(f"depth {d} not divisible by {num_buckets}")
    size = d // num_buckets
    return [volume[i * size:(i + 1) * size] for i in range(num_buckets)]


def join_volume(buckets: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(buckets), dim=0)


def _all_reduce_async(grad, group):
    """The asynchronous sum of ``grad`` over ``group``, in place: its
    handle."""
    import torch.distributed as dist

    return dist.all_reduce(grad, group=group, async_op=True)


def value_and_grad_bucketed(loss_of_volume: Callable, buckets, *args,
                            group=None, **kwargs):
    """``(loss, [gradient of each bucket])`` of a volume loss.

    Each bucket becomes a leaf of a ``sampling.BucketedTable``, whose
    backward gives each bucket's gradient its own scatter (K4's bucket
    instance) in ascending z; with a process ``group``, the sum of a
    bucket's gradient over the group is issued as soon as that gradient
    is final, before the next bucket's scatter, and the call waits on
    every handle before it returns.  ``loss`` is this process's (the
    caller sums it over the group if it wants the total)."""
    leaves = [b.detach().requires_grad_(True) for b in buckets]
    handles = []

    def reduce(index, grad):
        handles.append(_all_reduce_async(grad, group))

    table = sampling.BucketedTable([leaf.shape[0] for leaf in leaves],
                                   None if group is None else reduce)
    loss = loss_of_volume(table.join(leaves), *args, **kwargs)
    loss.backward()
    grads = table.gradients()
    for handle in handles:
        handle.wait()
    return loss.detach(), grads


def bucketed_train_step(optimizer: Callable, loss_of_volume: Callable,
                        num_buckets: int, group=None):
    """``step(volume, opt_state, *args) -> (loss, volume, opt_state)``: one
    optimizer step whose voxel-gradient reduction over ``group`` is
    bucketed (:func:`value_and_grad_bucketed`).  ``optimizer`` is a
    factory of a torch optimizer over the bucket leaves (``train``'s
    convention); ``opt_state`` None or {bucket index: its per-parameter
    state}.  The joined volume is clipped to [0, 1]."""
    from ..train import _adam

    def step(volume, opt_state, *args):
        buckets = split_volume(volume, num_buckets)
        loss, grads = value_and_grad_bucketed(loss_of_volume, buckets,
                                              *args, group=group)
        leaves = {i: b.detach().clone().requires_grad_(True)
                  for i, b in enumerate(buckets)}
        opt = _adam(leaves, opt_state, optimizer)
        for i, leaf in leaves.items():
            leaf.grad = grads[i]
        opt.step()
        new_volume = join_volume([leaf.detach() for leaf in leaves.values()])
        return loss, torch.clamp(new_volume, 0.0, 1.0), {
            i: opt.state[leaf] for i, leaf in leaves.items()}

    return step
