"""Device meshes and placements for multi-card rendering.

Mirrors ``vpt_tpu/parallel/mesh.py``.  The scaling axes are explicit:

- ``data``: the pixel grid, embarrassingly parallel; rows of the image and
  every per-pixel state leaf split across it in contiguous blocks.  The
  per-pixel RNG streams hash the pixel's coordinates in the whole image
  (the kernels' row window, ``sampling.pixel_ndc(window=)``), so a split
  render equals the single-process render bit for bit.
- ``space``: the volume's z extent, for grids too large to keep whole on
  every card between frames (``shard.sharded_scene(shard_volume=True)``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those axis
names over the ranks of the default process group (one card a rank, or one
CPU process a rank under ``gloo``), built after
``distributed.initialize``.  :func:`pixel_sharding`, :func:`replicated`
and ``shard.volume_sharding`` are small placement descriptors
(:class:`Sharding`) that ``shard.py`` reads, in place of JAX's
``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """Where a rank runs: its global ``rank``, its ``node`` (the host) and
    its ``local_rank`` on that node (JAX's ``process_index`` and device
    ``id``)."""

    rank: int
    node: Any
    local_rank: int


def device_grid(ranks, space: int = 1):
    """Topology-aware (data, space) grid of rank descriptors (objects with
    ``node`` and ``local_rank``, such as :class:`RankInfo`).

    Ranks are ordered by (node, local rank), so that whenever ``space``
    divides every node's rank count each ``space`` row (the axis a frame
    all-gathers the volume's slabs over) lies within one node, and a node's
    data rows are contiguous, so a data reduction crosses nodes once per
    node; as ``vpt_tpu`` orders devices by (process index, id).  Warns when
    ``space`` does not divide a node's rank count and there is more than
    one node."""
    ranks = sorted(ranks, key=lambda r: (r.node, r.local_rank))
    n = len(ranks)
    if n % space != 0:
        raise ValueError(f"{n} ranks not divisible by space={space}")
    per_node = {}
    for r in ranks:
        per_node[r.node] = per_node.get(r.node, 0) + 1
    if any(c % space for c in per_node.values()) and len(per_node) > 1:
        warnings.warn(
            f"space={space} does not divide the per-node rank counts "
            f"{per_node}; space-axis collectives will cross nodes",
            stacklevel=2)
    grid = np.empty(n, dtype=object)
    grid[:] = ranks
    return grid.reshape(n // space, space)


def rank_infos():
    """Every rank's :class:`RankInfo`, gathered over the default process
    group (collective): the host name and ``LOCAL_RANK`` (else the rank)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    mine = RankInfo(rank, socket.gethostname(),
                    int(os.environ.get("LOCAL_RANK", rank)))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data", "space"), space: int = 1,
              device=None):
    """DeviceMesh over the default process group's ``n_devices`` ranks
    (all of them; a mesh over fewer is not supported), shaped
    (n_devices // space, space) with the ordering of :func:`device_grid`
    over :func:`rank_infos` (a collective), or (n_devices,) for one axis;
    on ``"cuda"`` unless ``device`` is ``"cpu"``.  Every rank calls it, in
    the same order as its other collectives."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}: the mesh spans every rank")
    ranks = rank_infos()
    axes = tuple(axes)
    cells = device_grid(ranks, space if len(axes) > 1 else 1)
    grid = torch.tensor([[r.rank for r in row] for row in cells])
    if len(axes) == 1:
        grid = grid.reshape(-1)
    device_type = "cpu" if device is not None \
        and torch.device(device).type == "cpu" else "cuda"
    return DeviceMesh(device_type, grid, mesh_dim_names=axes)


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis``; 1 for an axis it lacks."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 for an axis it lacks."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 0
    return mesh.get_coordinate()[names.index(axis)]


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None for
    an axis the mesh lacks."""
    if axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def block(n: int, parts: int, index: int):
    """``(start, stop)`` of block ``index`` when ``n`` items split into
    ``parts`` contiguous blocks of ``ceil(n / parts)`` (the last ones
    shorter or empty): ``torch.chunk``'s split, which DTensor's
    ``Shard(0)`` uses too."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


def block_of(n: int, mesh, axes=("data",)):
    """``(start, stop)`` of this rank's block of ``n`` items split over
    the mesh's ``axes`` (first axis major)."""
    parts, index = 1, 0
    for axis in axes:
        k = axis_size(mesh, axis)
        parts, index = parts * k, index * k + axis_index(mesh, axis)
    return block(n, parts, index)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement on a mesh: ``spec`` names, for each leading dimension
    of an array, the mesh axis it splits over (None: kept whole); an empty
    spec replicates.  ``vpt_tpu``'s ``NamedSharding(mesh, P(*spec))``;
    only dimension 0 may split."""

    mesh: Any
    spec: tuple = ()

    def local_slice(self, shape):
        """This rank's index along dimension 0 of an array of ``shape``:
        its block of the axis ``spec[0]`` names, or everything."""
        if not self.spec or self.spec[0] is None:
            return slice(None)
        return slice(*block_of(shape[0], self.mesh, (self.spec[0],)))


def pixel_sharding(mesh, ndim: int = 3, axis: str = "data") -> Sharding:
    """Split an (H, W, ...) image or state array by rows across ``axis``."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())
