"""Bucketed gradient reduction: the voxel gradient reduced per z bucket,
from autograd's hooks.

Mirrors ``vpt_tpu/parallel/overlap.py``.  One all-reduce of the whole
grid's gradient after the backward pass serializes communication after
compute; splitting the volume into z buckets is meant to let each
bucket's reduction start as soon as its gradient is complete (DDP's
bucketed all-reduce).  In PyTorch's idiom each bucket is a leaf, a
post-accumulate-grad hook starts its gradient's
``all_reduce(async_op=True)``, and the step waits on the handles before
the optimizer.

This structure overlaps nothing yet.  The loss sees the buckets through
:func:`join_volume` (one ``torch.cat``), so every bucket's gradient comes
out of that one ``CatBackward``, after the renderer's whole backward pass
(K4's scatter into the joined volume) has finished: the hooks all fire
together at the end, and the result costs what one ``all_reduce`` of the
joined gradient costs.  An overlap needs buckets that the renderer's
graph reads as leaves of their own (a fetch a bucket, so that a bucket's
backward can finish before another's), and a measurement on more than
one card.

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


def split_volume(volume, num_buckets: int) -> List[torch.Tensor]:
    """(D, H, W, C) → list of (D/k, H, W, C) z buckets (views)."""
    d = volume.shape[0]
    if d % num_buckets != 0:
        raise ValueError(f"depth {d} not divisible by {num_buckets}")
    size = d // num_buckets
    return [volume[i * size:(i + 1) * size] for i in range(num_buckets)]


def join_volume(buckets: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(buckets), dim=0)


def value_and_grad_bucketed(loss_of_volume: Callable, buckets, *args,
                            group=None, **kwargs):
    """``(loss, [gradient of each bucket])`` of a volume loss.

    Each bucket becomes a leaf; with a process ``group``, the hook of a
    bucket starts the asynchronous sum of its gradient over the group as
    soon as autograd has accumulated it (for every bucket at once, at the
    end of the backward pass: see the module's note), and the call waits
    on every handle before it returns.  ``loss`` is this process's (the caller sums
    it over the group if it wants the total)."""
    import torch.distributed as dist

    leaves = [b.detach().requires_grad_(True) for b in buckets]
    handles = []
    if group is not None:
        def reduce(leaf):
            handles.append(dist.all_reduce(leaf.grad, group=group,
                                           async_op=True))

        hooks = [leaf.register_post_accumulate_grad_hook(reduce)
                 for leaf in leaves]
    loss = loss_of_volume(join_volume(leaves), *args, **kwargs)
    try:
        loss.backward()
    finally:
        if group is not None:
            for hook in hooks:
                hook.remove()
    for handle in handles:
        handle.wait()
    return loss.detach(), [leaf.grad for leaf in leaves]


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
