"""BASELINE config 4: MCM over a spatially sharded volume, with the
voxel gradient in slab form (``BASELINE.json`` configs[4]: a 512³ volume,
a 1024² image).

Mirrors ``examples/config4_pod512.py`` (every flag) with PyTorch inside,
on the ranks of a ``torch.distributed`` group (``torchrun``, or a world of
one on a free ``localhost`` port without a coordinator), the volume's z
slabs over the mesh's ``space`` axis (the largest of 1, 2, 4, 8 that
divides the world) and pixel rows over ``data``:

1. Forward: progressive MCM frames (extinction 30, anisotropy 0.2, 8
   steps) through ``halo.sharded_render_frame`` until the mean samples a
   pixel reach ``--spp`` (checked every 8 frames): K5's halo instance on
   the card, a rank holding only its slab's corner rows.
2. Fit: the sharded voxel gradient (``halo_grad.make_sharded_grad``: the
   MCM expected image of 2 frames, ``--buckets`` z buckets a slab) of the
   volume dimmed to 0.6×, against the forward's radiance, then SGD at
   rate 1 on the slab bodies and ``rehalo``, ``--fit-steps`` times at a
   fixed seed; the loss must descend, as vpt_tpu's recipe asserts (which
   it does not at the default 64³ / 128², in vpt_tpu as in the port:
   ROADMAP queue 3).

JAX counts the collectives in the compiled HLO; the port counts those it
issues (``halo.COLLECTIVES``, by kind) and prints them in the same form.

Run (the card):  python -m vpt_tpu_torch.examples.config4_pod512 --full
On the CPU:      python -m vpt_tpu_torch.examples.config4_pod512 \\
    --platform cpu

:func:`main` parses the flags and joins the group; :func:`run` takes the
sizes and runs :func:`forward_phase` and :func:`fit_phase`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def forward_phase(mesh, scene, params, res: int, spp: int,
                  num_slabs: int, device, say=print):
    """Phase 1: progressive frames through ``halo.sharded_render_frame``
    until the mean samples a pixel reach ``spp`` (checked every 8
    frames).  Returns ``(state rows, frames, mean, seconds, collectives a
    frame)``."""
    from ..parallel import place_state
    from ..parallel.halo import COLLECTIVES, sharded_render_frame
    from ..renderers import mcm
    from .distributed_demo import _mean_samples

    whole = mcm.reset(params, res, res, scene)
    state = place_state(whole, mesh)
    frame_fn, slabs = sharded_render_frame(mcm, mesh, scene, num_slabs,
                                           whole)
    COLLECTIVES.clear()
    _sync(device)
    t0 = time.perf_counter()
    frames = 0
    while True:
        frames += 1
        state = frame_fn(state, slabs, params, np.float32(0.1 * frames),
                         frames)
        if frames % 8 == 0:
            mean = _mean_samples(state, mesh, res)
            if mean >= spp:
                break
    _sync(device)
    dt = time.perf_counter() - t0
    coll = {k: v // frames for k, v in sorted(COLLECTIVES.items())}
    ev = res * res * params.steps * frames
    say(f"forward: {mean:.1f} spp in {frames} frames, {dt:.1f}s, "
        f"{ev / dt / 1e6:.1f}M events/s")
    say("forward-frame collectives:", coll)
    return state, frames, mean, dt, coll


def fit_phase(mesh, scene, params, target, fit_steps: int, buckets: int,
              num_slabs: int, device, say=print):
    """Phase 2: the sharded voxel gradient (2 frames of the MCM expected
    image at the target's size) of the scene's volume dimmed to 0.6×,
    then SGD at rate 1 on the slab bodies and ``rehalo``, ``fit_steps``
    times at a fixed seed.  Returns ``(losses, seconds a step, the
    collectives of a step, the final slab)``; :func:`run` asserts the
    descent."""
    from ..parallel.halo import COLLECTIVES
    from ..parallel.halo_grad import make_sharded_grad, place_slabs, rehalo

    res = target.shape[0]
    init = torch.clamp(scene.volume * 0.6, 0.0, 1.0)
    grad_frames = 2
    grad_fn = make_sharded_grad(mesh, scene, params, res, res, grad_frames,
                                num_slabs, num_buckets=buckets)
    slabs = place_slabs(init, mesh, num_slabs)
    del init
    # a fixed seed: a deterministic objective whose SGD descent is
    # checkable
    lr = 1.0
    losses, step_s, grad_coll = [], [], {}
    for i in range(fit_steps):
        COLLECTIVES.clear()
        _sync(device)
        t0 = time.perf_counter()
        loss, g = grad_fn(slabs, target, np.float32(0.5))
        bodies = torch.clamp(slabs[:, :-1] - lr * g, 0.0, 1.0)
        slabs = rehalo(bodies, mesh)
        losses.append(float(loss))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        grad_coll = dict(sorted(COLLECTIVES.items()))
        if i == 0:
            say(f"grad-step collectives ({buckets} buckets):", grad_coll)
    say(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
        f"({fit_steps} steps, {sum(step_s) / fit_steps:.2f}s/step)")
    return losses, step_s, grad_coll, slabs


def run(vol_n: int = 64, res: int = 128, spp: int = 32, fit_steps: int = 4,
        buckets: int = 4, device=None, fit_res=None, verbose: bool = True):
    """Both phases on the mesh of the default process group; returns a
    dict: ``spp``, ``frames``, ``forward_s``, ``events_per_s``,
    ``forward_collectives``, ``grad_collectives``, ``losses``,
    ``step_s``.  ``fit_res``: the fit's image (a divisor of ``res``: the
    target is the forward's radiance at that stride), the forward's
    unless given."""
    import torch.distributed as dist

    from .. import transfer, volume
    from ..parallel import gather_state, make_mesh
    from ..parallel.distributed import topology_summary
    from ..renderers import make_scene, mcm
    from ..utils import resolve_device

    def say(*args):
        if verbose:
            print(*args, flush=True)

    device = resolve_device(device)
    say(topology_summary())
    n = dist.get_world_size()
    num_slabs = max(s for s in (1, 2, 4, 8) if n % s == 0 and s <= n)
    mesh = make_mesh(n, space=num_slabs, device=device)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}  "
        f"(slabs={num_slabs})")
    say(f"volume {vol_n}^3, image {res}^2")

    scene = make_scene(volume.blobs_volume(vol_n, seed=3, device=device),
                       transfer.gray_ramp(alpha_scale=0.9, device=device),
                       device=device)
    params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
    state, frames, mean, dt, fwd_coll = forward_phase(
        mesh, scene, params, res, spp, num_slabs, device, say)
    target = gather_state(state["radiance"], mesh, res)
    del state
    fit_res = res if fit_res is None else fit_res
    if fit_res != res:
        target = target[::res // fit_res, ::res // fit_res].contiguous()
    losses, step_s, grad_coll, _ = fit_phase(mesh, scene, params, target,
                                             fit_steps, buckets, num_slabs,
                                             device, say)
    # vpt_tpu's check, mirrored: at a fixed seed the MC estimator's value
    # is stepwise constant in the voxels, and vpt_tpu's recipe fails it at
    # its own default size (ROADMAP queue 3)
    assert losses[-1] < losses[0], "loss must descend"
    say("ok")
    return {"spp": mean, "frames": frames, "forward_s": dt,
            "events_per_s": res * res * params.steps * frames / dt,
            "forward_collectives": fwd_coll,
            "grad_collectives": grad_coll, "losses": losses,
            "step_s": step_s}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--full", action="store_true",
                    help="config-4 stated shapes (512^3, 1024^2)")
    ap.add_argument("--spp", type=int, default=32,
                    help="progressive samples/pixel for the forward phase")
    ap.add_argument("--fit-steps", type=int, default=4)
    ap.add_argument("--buckets", type=int, default=4)
    return ap


def main(argv=None):
    import torch.distributed as dist

    from .distributed_demo import join

    args = build_parser().parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    vol_n, res = (512, 1024) if args.full else (64, 128)
    made = join(device)
    try:
        return run(vol_n, res, args.spp, args.fit_steps, args.buckets,
                   device=device)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
