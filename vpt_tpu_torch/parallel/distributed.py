"""Multi-process bring-up: ``torch.distributed`` with bounded retries and a
topology report.

Mirrors ``vpt_tpu/parallel/distributed.py``: processes (one a card, or one
a CPU process under ``gloo``) join a process group with bounded retries,
agree on a mesh over its ranks (:func:`default_mesh`), and long progressive
renders survive restarts through the checkpoints
(``runtime/checkpoint.save_sharded``); a resumed render is bit-identical
because seeds derive from frame indices.

Nothing on a machine announces a cluster: the caller gives the
coordinator's address (``tcp://host:port``), the world size and the rank,
or sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (as
``torchrun`` does).  Without either :func:`initialize` returns False and
the program runs as one process, as ``vpt_tpu``'s does without
``JAX_COORDINATOR_ADDRESS``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..utils import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               retries: int = 5, retry_delay: float = 5.0,
               init_method: Optional[str] = None, device=None) -> bool:
    """Join (or skip) a process group.

    ``coordinator_address``: ``host:port`` of rank 0's store (or give
    ``init_method``, e.g. ``file:///path``); ``num_processes`` the world
    size and ``process_id`` this rank.  On the card the card's tensors go
    through ``nccl`` (each rank takes card ``LOCAL_RANK``, else its rank,
    modulo the cards) and host tensors through ``gloo`` (the background
    writes of ``checkpoint.save_sharded(wait=False)`` need a host
    backend); with ``device="cpu"`` everything goes through ``gloo``.

    Returns True once the group is up (also when it already was), False
    when no coordinator is configured (none given and no ``MASTER_ADDR``).
    Retries transient failures ``retries`` times, waiting ``retry_delay``
    seconds times the attempt, then raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator_address is None and init_method is None \
            and num_processes is None and "MASTER_ADDR" not in os.environ:
        return False
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}"
                       if coordinator_address is not None else "env://")
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", 0))
    device = resolve_device(device)
    backend = "gloo" if device.type == "cpu" else "cpu:gloo,cuda:nccl"
    if device.type != "cpu":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    last_err = None
    for attempt in range(retries):
        try:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world, rank=rank)
            return True
        except Exception as e:  # noqa: BLE001 — retry any transient error
            last_err = e
            time.sleep(retry_delay * (attempt + 1))
    raise RuntimeError(
        f"torch.distributed.init_process_group failed after {retries} "
        "attempts") from last_err


def _device_name() -> str:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "gloo":
        return "cpu"
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


def topology_summary() -> str:
    """One line for logs: this rank of the world, its node's local and the
    global devices (one a rank), and their names.  Gathers the names over
    the process group when there is one (a collective: every rank calls
    it)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return (f"process 0/1: 1 local / 1 global devices "
                f"({_device_name()})")
    rank, world = dist.get_rank(), dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, _device_name())
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() if names[rank] != "cpu" else 1)
    return (f"process {rank}/{world}: {local} local / {world} global "
            f"devices ({', '.join(sorted(set(names)))})")


def default_mesh(space: int = 1, device=None):
    """Mesh over every rank: (data × space), node-major ordering
    (``mesh.device_grid``), so that a space row stays within a node."""
    import torch.distributed as dist

    from .mesh import make_mesh

    return make_mesh(dist.get_world_size(), space=space, device=device)
