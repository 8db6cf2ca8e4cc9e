"""Multi-card demo: a pixel-sharded MCM frame, then a halo-sharded volume.

Mirrors ``examples/distributed_demo.py``: a 32³ sphere, the gray ramp at
alpha 0.9, MCM at extinction 20 and 8 steps on a 64² image.

1. The volume replicated, the pixel rows split over ``data``
   (``shard.shard_render_frame``: K5 with each rank's row window).
2. When the mesh has a ``space`` axis of more than one rank, the volume
   in z slabs over ``space`` (``halo.sharded_render_frame``: K5's halo
   instance on the card, each rank holding only its slab's rows).

Each prints the mean samples a pixel over the whole image.  Every rank of
a process group runs it (``torchrun``, or ``MASTER_ADDR`` and the rest:
``parallel.distributed.initialize``); without a coordinator it runs as a
world of one on a free ``localhost`` port.  ``space`` defaults to JAX's
rule: 2 when the world is even and at least 4, else 1.

Run (the card):  python -m vpt_tpu_torch.examples.distributed_demo
On the CPU:      python -m vpt_tpu_torch.examples.distributed_demo \\
    --platform cpu

:func:`main` parses the flags and joins the group; :func:`run` takes the
sizes and the mesh's ``space``.
"""

from __future__ import annotations

import argparse
import socket

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join(device=None):
    """Join the configured process group, else a world of one on a free
    ``localhost`` port; True when this call made the group."""
    from ..parallel import distributed

    if distributed.initialize(device=device):
        return False
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, retries=2,
                           retry_delay=1.0, device=device)
    return True


def _mean_samples(local, mesh, height: int) -> float:
    """The whole image's mean samples a pixel from this rank's rows."""
    from ..parallel.shard import _all_reduce

    total = torch.stack([local["samples"].sum(),
                         torch.tensor(float(local["samples"].numel()),
                                      device=local["samples"].device)])
    total = _all_reduce(total.to(torch.float64), mesh, ("data",))
    return float(total[0] / total[1])


def run(space=None, size: int = 64, volume_size: int = 32, device=None,
        verbose: bool = True):
    """Both frames on the mesh of the default process group: ``(pixel,
    halo)`` mean samples a pixel (``halo`` None when ``space`` is 1)."""
    import torch.distributed as dist

    from .. import transfer, volume
    from ..parallel import make_mesh, place_state, shard_render_frame
    from ..parallel import sharded_scene
    from ..parallel.distributed import topology_summary
    from ..parallel.halo import sharded_render_frame
    from ..renderers import make_scene, mcm
    from ..utils import resolve_device

    device = resolve_device(device)
    if verbose:
        print(topology_summary())
    n = dist.get_world_size()
    if space is None:
        space = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n, space=space, device=device)
    if verbose:
        print("mesh:", dict(zip(mesh.mesh_dim_names, mesh.shape)))

    scene = make_scene(volume.sphere_volume(volume_size, device=device),
                       transfer.gray_ramp(alpha_scale=0.9, device=device),
                       device=device)
    params = mcm.Params(extinction=20.0, steps=8)

    # 1) the volume replicated, the pixel rows split over data
    sc = sharded_scene(scene, mesh)
    whole = mcm.reset(params, size, size, sc)
    state = place_state(whole, mesh)
    frame = shard_render_frame(mcm, mesh, whole, donate=False)
    state = frame(state, sc, params, np.float32(0.3), 1)
    pixel = _mean_samples(state, mesh, size)
    if verbose:
        print("pixel-sharded MCM: samples mean", pixel)

    # 2) the volume in z slabs over space
    halo = None
    if space > 1:
        whole = mcm.reset(params, size, size, scene)
        state = place_state(whole, mesh)
        frame_fn, slabs = sharded_render_frame(mcm, mesh, scene, space,
                                               whole)
        state = frame_fn(state, slabs, params, np.float32(0.3), 1)
        halo = _mean_samples(state, mesh, size)
        if verbose:
            print("halo-sharded MCM: samples mean", halo)
    return pixel, halo


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--space", type=int, default=None,
                    help="ranks of the mesh's space axis (default: 2 for "
                         "an even world of at least 4, else 1)")
    return ap


def main(argv=None):
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    made = join(device)
    try:
        return run(args.space, device=device)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
