"""Rank bodies of the port's data-parallel tests, and the launcher that
runs them as a ``gloo`` (CPU) process group.

No JAX here: the spawned ranks import only torch and the port, so they
start in seconds.  ``tests/test_torch_parallel.py`` spawns one group and
holds what rank 0 returns against the single-process port and against
``vpt_tpu``; a run on the card can call the same bodies.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import traceback

import numpy as np
import torch

#: the image the frames render (the JAX tests' 32² on 8 devices) and an
#: uneven one (4 ranks: blocks of 8, 8, 8, 6 rows)
SIZE = 32
UNEVEN = 30


def _entry(rank, world, init_file, out_dir, body, args):
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    path = pathlib.Path(out_dir) / f"rank{rank}.pt"
    try:
        assert distributed.initialize(init_method=f"file://{init_file}",
                                      num_processes=world, process_id=rank,
                                      retries=1, device="cpu")
        result = body(rank, world, *args)
        dist.barrier()
        torch.save({"ok": True, "result": result}, path)
    except Exception:  # noqa: BLE001 — reported to the parent
        torch.save({"ok": False, "error": traceback.format_exc()}, path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(body, world: int, tmp_dir, *args):
    """Run ``body(rank, world, *args)`` in ``world`` spawned processes
    joined by a ``gloo`` group through a ``file://`` store under
    ``tmp_dir`` (so parallel test workers never share a port); returns
    each rank's result, and raises with a rank's traceback if one
    failed."""
    import torch.multiprocessing as mp

    tmp_dir = pathlib.Path(tmp_dir)
    out_dir = tmp_dir / "ranks"
    out_dir.mkdir(parents=True, exist_ok=True)
    init_file = tmp_dir / "store"
    try:
        mp.start_processes(_entry, args=(world, str(init_file), str(out_dir),
                                         body, args),
                           nprocs=world, start_method="spawn")
    finally:
        results = []
        for rank in range(world):
            path = out_dir / f"rank{rank}.pt"
            got = torch.load(path, weights_only=False) if path.exists() \
                else {"ok": False, "error": f"rank {rank} wrote nothing"}
            if not got["ok"]:
                raise RuntimeError(f"rank {rank}:\n{got['error']}")
            results.append(got["result"])
    return results


def _np(state):
    if isinstance(state, dict):
        return {k: v.detach().cpu().numpy() for k, v in state.items()}
    return state.detach().cpu().numpy()


def cases():
    """(name, renderer key, Params kwargs, scene kind, height) of every
    sharded frame the group renders; the scene kinds are the fields the
    parent passes (``plain`` and ``cheb``)."""
    return [
        ("mcm", "mcm", dict(extinction=20.0, steps=8), "plain", SIZE),
        ("mcm_cheb", "mcm", dict(extinction=30.0, steps=8), "cheb", SIZE),
        ("mcm_uneven", "mcm", dict(extinction=20.0, steps=8), "plain",
         UNEVEN),
        ("mcs", "mcs", dict(extinction=20.0), "plain", SIZE),
        ("eam", "eam", dict(slices=16), "plain", SIZE),
        ("mip", "mip", dict(steps=16), "plain", SIZE),
        ("depth", "depth", dict(slices=16), "plain", SIZE),
        ("iso", "iso", dict(steps=16, isovalue=0.3), "plain", SIZE),
        ("lao", "lao", dict(slices=16), "plain", SIZE),
    ]


def render_case(module, params, scene, height, width, seed=0.3, frame=1):
    """The whole-image state of one frame in one process."""
    state = module.reset(params, height, width, scene)
    return module.render_frame(state, scene, params, np.float32(seed),
                               frame)


def eam_setup(scene_fields):
    """The EAM fit's inputs the gradient cases share: the volume, TF,
    camera matrices, a 16² target and Params."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.renderers import eam

    scene = interop.scene_from_numpy(scene_fields, device="cpu")
    mats = (scene.mvp_inverse, scene.model_view, scene.projection)
    target = torch.zeros((16, 16, 4), dtype=torch.float32)
    params = eam.Params(slices=8, random=False)
    return scene.volume, scene.transfer, mats, target, params


def everything(rank, world, fields, ckpt_dir):
    """Every sharded case on one ``gloo`` group of ``world`` ranks (4):
    the frames of :func:`cases`, the z-sharded EAM frame, the
    data-parallel and bucketed gradients and steps, and a sharded
    checkpoint saved from every rank and loaded on 2 and on 1.  Rank 0's
    results (numpy, whole images) go back to the parent."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from vpt_tpu_torch import interop
    from vpt_tpu_torch.parallel import (gather_state, make_mesh,
                                        place_state, shard_render_frame,
                                        sharded_scene)
    from vpt_tpu_torch.parallel import mesh as meshmod
    from vpt_tpu_torch.parallel import overlap, shard
    from vpt_tpu_torch.renderers import eam, factory
    from vpt_tpu_torch.runtime import checkpoint

    out = {}
    scenes = {k: interop.scene_from_numpy(v, device="cpu")
              for k, v in fields.items()}
    mesh = make_mesh(world, axes=("data",), device="cpu")
    out["coordinate"] = mesh.get_coordinate()
    for name, key, kwargs, kind, height in cases():
        module = factory.get_module(key)
        params = module.Params(**kwargs)
        sc = sharded_scene(scenes[kind], mesh)
        whole = module.reset(params, height, SIZE, sc)
        local = place_state(whole, mesh)
        frame = shard_render_frame(module, mesh, whole, donate=False)
        local = frame(local, sc, params, np.float32(0.3), 1)
        out[name] = _np(gather_state(local, mesh, height))

    # the volume z-sharded over space: the replicated frame
    grid = make_mesh(world, space=2, device="cpu")
    sc_sh = sharded_scene(scenes["plain"], grid, shard_volume=True)
    params = eam.Params(slices=16, random=False)
    whole = eam.reset(params, SIZE, SIZE, sc_sh)
    local = shard_render_frame(eam, grid, whole)(
        place_state(whole, grid), sc_sh, params, np.float32(0.0), 1)
    out["eam_space"] = _np(gather_state(local, grid, SIZE))
    out["slab_depth"] = sc_sh.volume.shape[0]

    # the data-parallel gradient, the volume sharded over space
    vol, tf, mats, target, params = eam_setup(fields["plain"])
    z0, z1 = meshmod.block_of(vol.shape[0], grid, ("space",))
    loss, grads = shard.eam_value_and_grad(
        vol[z0:z1], tf, mats, target, params, np.float32(0.0), grid,
        shard_volume=True)
    out["space_loss"] = float(loss)
    out["space_grad"] = _np(shard.gather_blocks(grads["volume"],
                                                vol.shape[0], grid,
                                                ("space",)))
    # and replicated, rows over data only
    loss, grads = shard.eam_value_and_grad(vol, tf, mats, target, params,
                                           np.float32(0.0), mesh)
    out["data_grad"] = _np(grads["volume"])

    # two steps of the data-parallel train step on the slabs
    step = shard.data_parallel_train_step(
        lambda p: torch.optim.SGD(p, lr=0.1), grid, params=params,
        shard_volume=True)
    slab, opt_state, losses = vol[z0:z1], None, []
    for _ in range(2):
        loss, slab, _, opt_state = step(slab, tf, opt_state, mats, target,
                                        np.float32(0.0))
        losses.append(float(loss))
    out["train_losses"] = losses

    # bucketed: per-bucket all-reduce over data from the grad hooks
    def loss_of_volume(volume_data):
        return shard.eam_loss_rows(volume_data, tf, mats, target, params,
                                   np.float32(0.0), mesh)

    group = meshmod.axis_group(mesh, "data")
    _, bucket_grads = overlap.value_and_grad_bucketed(
        loss_of_volume, overlap.split_volume(vol, 4), group=group)
    out["bucket_grad"] = _np(overlap.join_volume(bucket_grads))
    bstep = overlap.bucketed_train_step(
        lambda p: torch.optim.SGD(p, lr=0.5), loss_of_volume, 4, group=group)
    volume, opt_state, losses = vol, None, []
    for _ in range(2):
        loss, volume, opt_state = bstep(volume, opt_state)
        losses.append(float(shard._all_reduce(loss.clone(), mesh)))
    out["bucket_losses"] = losses

    # a sharded checkpoint: saved from every rank, loaded on 2 and on 1
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=20.0, steps=8)
    whole = mcm.reset(params, UNEVEN, SIZE, scenes["plain"])
    local = shard_render_frame(mcm, mesh, whole)(
        place_state(whole, mesh), scenes["plain"], params,
        np.float32(0.3), 1)
    pending = checkpoint.save_sharded(ckpt_dir, "mcm", local, 7, params,
                                      extra={"seed0": 3}, wait=False,
                                      mesh=mesh, height=UNEVEN)
    pending.wait_until_finished()
    dist.barrier()
    out["saved"] = _np(gather_state(local, mesh, UNEVEN))
    two = DeviceMesh("cpu", torch.tensor([0, 1]), mesh_dim_names=("data",))
    if rank < 2:
        key, got, frame_number, meta = checkpoint.load_sharded(ckpt_dir,
                                                               mesh=two)
        out["loaded_rows"] = {k: v.shape[0] for k, v in got.items()}
        out["loaded2"] = _np(gather_state(got, two, UNEVEN))
        out["loaded2_meta"] = (key, frame_number, meta["extra"],
                               meta["params"])
    if rank == 0:
        key, got, frame_number, _ = checkpoint.load_sharded(ckpt_dir,
                                                            device="cpu")
        out["loaded1"] = _np(got)
    dist.barrier()
    return out if rank == 0 else {"coordinate": out["coordinate"]}


# -- the spatially sharded half of parallel/: halo, halo_grad, dos_halo ----

#: the halo MCM cases: (name, scene kind, Params kwargs); the kinds are the
#: parent's fields (``bf16_cheb``: bf16 tables and the cheb-skip table;
#: ``f32``: float32 tables, the exact flight; ``f32_cheb``, ``bf16``)
HALO_MCM = [
    ("mcm_bf16_cheb", "bf16_cheb", dict(extinction=25.0, steps=8)),
    ("mcm_f32_cheb", "f32_cheb", dict(extinction=25.0, steps=8)),
    ("mcm_bf16", "bf16", dict(extinction=25.0, steps=8)),
    ("mcm_f32", "f32", dict(extinction=25.0, steps=8)),
]
#: the march renderers' halo frames (plain twins over a HaloScene)
HALO_MARCH = ("eam", "mip", "iso", "depth")
HALO_SIZE = 16


def halo_everything(rank, world, fields):
    """The halo frames on a group of 2 ranks, ``space`` = 2: the MCM
    cases (2 frames) and the march renderers' frames through
    ``halo.sharded_render_frame``, each gathered over ``data`` (one rank:
    the whole image), then the distributed demo's two frames.  Rank 0's
    results go back."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.examples import distributed_demo
    from vpt_tpu_torch.parallel import gather_state, make_mesh, place_state
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import factory, mcm

    out = {}
    scenes = {k: interop.scene_from_numpy(v, device="cpu")
              for k, v in fields.items()}
    mesh = make_mesh(world, space=world, device="cpu")
    halo.COLLECTIVES.clear()
    for name, kind, kwargs in HALO_MCM:
        params = mcm.Params(**kwargs)
        whole = mcm.reset(params, HALO_SIZE, HALO_SIZE, scenes[kind])
        frame_fn, slabs = halo.sharded_render_frame(
            mcm, mesh, scenes[kind], world, whole)
        local = place_state(whole, mesh)
        for n in (1, 2):
            local = frame_fn(local, slabs, params, np.float32(0.7 * n), n)
        out[name] = _np(gather_state(local, mesh, HALO_SIZE))
    out["mcm_collectives"] = dict(halo.COLLECTIVES)
    for key in HALO_MARCH:
        module = factory.get_module(key)
        params = module.Params()
        whole = module.reset(params, HALO_SIZE, HALO_SIZE, scenes["f32"])
        frame_fn, slabs = halo.sharded_render_frame(
            module, mesh, scenes["f32"], world, whole)
        local = frame_fn(place_state(whole, mesh), slabs, params,
                         np.float32(0.3), 1)
        out[key] = _np(gather_state(local, mesh, HALO_SIZE))
    out["demo"] = distributed_demo.run(space=world, device="cpu",
                                       verbose=False)
    return out if rank == 0 else {}


#: the halo frames of every renderer with a halo instance on the card:
#: (name, renderer key, scene kind, Params kwargs, frames); the kinds are
#: the parent's fields (``f32``: float32 tables; ``cheb``: with the
#: cheb-skip table; ``rg``: a two-channel volume)
HALO_FRAME_CASES = [
    ("eam_rg", "eam", "rg", dict(slices=20), 2),
    ("iso", "iso", "f32", dict(steps=20, isovalue=0.3), 2),
    ("mcs", "mcs", "f32", dict(extinction=8.0), 2),
    ("mcs_cheb", "mcs", "cheb", dict(extinction=8.0), 2),
    ("mcs_rg", "mcs", "rg", dict(extinction=8.0), 1),
    ("dos", "dos", "f32", dict(extinction=80.0, steps=12, slices=24,
                               samples=4), 2),
    ("lao", "lao", "f32", dict(slices=16), 1),
    ("lao_baked", "lao", "baked", dict(slices=16, baked_gradient=True), 1),
]
HALO_FRAME_SIZE = 16


def halo_frame_seed(n):
    return np.float32(0.25 + 0.3 * n)


def halo_frames_everything(rank, world, fields):
    """Every case of :data:`HALO_FRAME_CASES` on a group of 2 ranks,
    ``space`` = 2, through ``halo.sharded_render_frame`` (the plain twins
    over the HaloScene on the CPU), gathered, with the collectives of each
    frame; ISO's display of its last state over the same rank's
    HaloScene, with its collectives.  Rank 0's results go back."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.parallel import gather_state, make_mesh, place_state
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.parallel.mesh import axis_group, axis_index
    from vpt_tpu_torch.renderers import factory, iso

    out = {}
    scenes = {k: interop.scene_from_numpy(v, device="cpu")
              for k, v in fields.items()}
    mesh = make_mesh(world, space=world, device="cpu")
    size = HALO_FRAME_SIZE
    for name, key, kind, kwargs, frames in HALO_FRAME_CASES:
        module = factory.get_module(key)
        params = module.Params(**kwargs)
        whole = module.reset(params, size, size, scenes[kind])
        frame_fn, slabs = halo.sharded_render_frame(module, mesh,
                                                    scenes[kind], world,
                                                    whole)
        local = place_state(whole, mesh)
        counts = []
        for n in range(1, frames + 1):
            halo.COLLECTIVES.clear()
            local = frame_fn(local, slabs, params, halo_frame_seed(n), n)
            counts.append(dict(halo.COLLECTIVES))
        out[name] = {"state": _np(gather_state(local, mesh, size)),
                     "collectives": counts}
        if key == "iso":
            hs = halo.halo_scene(scenes[kind], axis_index(mesh, "space"),
                                 world, axis_group(mesh, "space"), slabs)
            halo.COLLECTIVES.clear()
            out[name]["display"] = _np(iso.display(local, hs, params))
            out[name]["display_collectives"] = dict(halo.COLLECTIVES)
    return out if rank == 0 else {}


#: the halo frames on rows over ``data`` and slabs over ``space``: (name,
#: renderer key, Params kwargs, frames) of :data:`HALO_FRAME_CASES`' scene
#: of float32 tables
HALO_BAND_CASES = [
    ("dos", "dos", dict(extinction=80.0, steps=12, slices=24, samples=4),
     2),
    ("lao", "lao", dict(slices=16), 1),
]


def halo_bands_everything(rank, world, fields):
    """Every case of :data:`HALO_BAND_CASES` on a group of 4 ranks, ``data``
    = 2 × ``space`` = 2, through ``halo.sharded_render_frame`` (the plain
    twins over the HaloScene; DOS's bands through ``dos.render_band``),
    gathered, with each frame's collectives and DOS's active slices, and
    the same frames through ``shard.shard_render_frame`` on the whole
    scene.  Rank 0's results go back."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.parallel import (gather_state, make_mesh, place_state,
                                        shard_render_frame)
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import dos, factory

    out = {}
    scene = interop.scene_from_numpy(fields, device="cpu")
    mesh = make_mesh(world, space=2, device="cpu")
    size = HALO_FRAME_SIZE
    for name, key, kwargs, frames in HALO_BAND_CASES:
        module = factory.get_module(key)
        params = module.Params(**kwargs)
        whole = module.reset(params, size, size, scene)
        frame_fn, slabs = halo.sharded_render_frame(module, mesh, scene, 2,
                                                    whole)
        local = place_state(whole, mesh)
        counts, active = [], []
        for n in range(1, frames + 1):
            if key == "dos":
                active.append(dos.active_slices(local, params))
            halo.COLLECTIVES.clear()
            local = frame_fn(local, slabs, params, halo_frame_seed(n), n)
            counts.append(dict(halo.COLLECTIVES))
        frame = shard_render_frame(module, mesh, whole)
        rows = place_state(whole, mesh)
        for n in range(1, frames + 1):
            rows = frame(rows, scene, params, halo_frame_seed(n), n)
        out[name] = {"state": _np(gather_state(local, mesh, size)),
                     "whole": _np(gather_state(rows, mesh, size)),
                     "collectives": counts, "active": active}
    return out if rank == 0 else {}


#: the sharded-gradient cases' sizes (``tests/test_halo_grad.py``'s)
GRAD_SIZE, GRAD_FRAMES = 12, 3


def _eam_expected(scene, params, height, width, frames, seed0=0.0,
                  score_floor=None):
    from vpt_tpu_torch.renderers import eam

    return eam.generate(scene, params, np.float32(seed0), height, width)


def _fit_loop(grad_fn, mesh, target, body0, steps, mom=None, lr=0.05,
              beta=0.9):
    """``tests/test_halo_grad.py``'s momentum SGD on the slab bodies."""
    from vpt_tpu_torch.parallel.halo_grad import rehalo

    body = body0
    mom = torch.zeros_like(body0) if mom is None else mom
    for i in steps:
        slabs = rehalo(body, mesh)
        _, g = grad_fn(slabs, target, np.float32(0.1 + 0.013 * i))
        mom = beta * mom + g
        body = torch.clamp(body - lr * mom, 0.0, 1.0)
    return body, mom


def halo_grad_everything(rank, world, fields, ckpt_dir):
    """The sharded gradients on a group of 4 ranks, ``space`` = 4 (a 16³
    volume, 4 planes a slab): the EAM gradient with 1 and 2 buckets, the
    MCM gradient with 1, 2 and 4, ``rehalo``, an EAM fit checkpointed
    after 3 of 6 steps and resumed, and the config-4 recipe at vpt_tpu's
    reduced default.  Gradients come back joined over ``space``."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.examples import config4_pod512
    from vpt_tpu_torch.parallel import halo, make_mesh, shard
    from vpt_tpu_torch.parallel.halo_grad import (make_sharded_grad,
                                                  place_slabs, rehalo)
    from vpt_tpu_torch.renderers import eam, mcm
    from vpt_tpu_torch.runtime import checkpoint

    out = {}
    scene = interop.scene_from_numpy(fields, device="cpu")
    mesh = make_mesh(world, space=world, device="cpu")
    target = torch.full((GRAD_SIZE, GRAD_SIZE, 3), 0.4)

    def joined(g):
        return _np(shard.gather_blocks(g, world, mesh, ("space",))
                   .reshape(scene.volume.shape))

    slabs = place_slabs(scene.volume, mesh, world)
    eparams = eam.Params(slices=16, random=False, extinction=60.0)
    for nb in (1, 2):
        halo.COLLECTIVES.clear()
        grad_fn = make_sharded_grad(mesh, scene, eparams, GRAD_SIZE,
                                    GRAD_SIZE, GRAD_FRAMES, world,
                                    expected=_eam_expected, num_buckets=nb)
        loss, g = grad_fn(slabs, target, np.float32(0.0))
        out[f"eam{nb}"] = (float(loss), joined(g))
        out[f"eam{nb}_collectives"] = dict(halo.COLLECTIVES)
    mparams = mcm.Params(extinction=25.0, steps=8)
    for nb in (1, 2, 4):
        grad_fn = make_sharded_grad(mesh, scene, mparams, GRAD_SIZE,
                                    GRAD_SIZE, GRAD_FRAMES, world,
                                    num_buckets=nb)
        loss, g = grad_fn(slabs, target, np.float32(0.45))
        out[f"mcm{nb}"] = (float(loss), joined(g))
    out["rehalo"] = _np(shard.gather_blocks(
        rehalo(slabs[:, :-1], mesh), world, mesh, ("space",)))

    # the EAM fit: 6 steps against 3, a checkpoint of this rank's slab
    # state, its load, and 3 more
    grad_fn = make_sharded_grad(mesh, scene, eparams, GRAD_SIZE, GRAD_SIZE,
                                GRAD_FRAMES, world, expected=_eam_expected)
    body0 = slabs[:, :-1]
    body, _ = _fit_loop(grad_fn, mesh, target, body0, range(6))
    out["fit_losses"] = [
        float(grad_fn(rehalo(b, mesh), target, np.float32(0.0))[0])
        for b in (body0, body)]
    body3, mom = _fit_loop(grad_fn, mesh, target, body0, range(3))
    path = pathlib.Path(ckpt_dir) / f"slab{rank}"
    checkpoint.save_sharded(path, "eam-fit", {"body": body3, "mom": mom},
                            3, eparams)
    key, state, frame_number, meta = checkpoint.load_sharded(path,
                                                             device="cpu")
    out["ckpt"] = (key, frame_number, meta["params"]["slices"])
    resumed, _ = _fit_loop(grad_fn, mesh, target, state["body"],
                           range(3, 6), mom=state["mom"])
    out["resume_equal"] = bool(torch.equal(resumed, body))
    out["fit_body"] = joined(body)

    # the recipe at vpt_tpu's reduced default (64³, 128², 32 spp, 4 fit
    # steps, 4 buckets): its printed lines, and its assertion's message
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        try:
            config4_pod512.run(64, 128, spp=32, fit_steps=4, buckets=4,
                               device="cpu")
            out["config4_raised"] = None
        except AssertionError as err:
            out["config4_raised"] = str(err)
    out["config4"] = printed.getvalue().splitlines()
    return out if rank == 0 else {"resume_equal": out["resume_equal"]}


#: the bucket counts of the data-parallel sharded gradient
DATA_BUCKETS = (1, 2, 4)


def halo_grad_data_everything(rank, world, fields):
    """The sharded EAM gradient (``halo_grad.make_sharded_grad``) on a
    (data 2, space 2) mesh of 4 ranks (a 16³ volume in 2 slabs of 8
    planes), with 1, 2 and 4 buckets: each one's loss, gradient joined over
    ``space`` and the collectives of its step."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.parallel import halo, make_mesh, shard
    from vpt_tpu_torch.parallel.halo_grad import (make_sharded_grad,
                                                  place_slabs)
    from vpt_tpu_torch.renderers import eam

    scene = interop.scene_from_numpy(fields, device="cpu")
    mesh = make_mesh(world, space=2, device="cpu")
    target = torch.full((GRAD_SIZE, GRAD_SIZE, 3), 0.4)
    slabs = place_slabs(scene.volume, mesh, 2)
    params = eam.Params(slices=16, random=False, extinction=60.0)
    out = {"coordinate": mesh.get_coordinate()}
    for nb in DATA_BUCKETS:
        grad_fn = make_sharded_grad(mesh, scene, params, GRAD_SIZE,
                                    GRAD_SIZE, GRAD_FRAMES, 2,
                                    expected=_eam_expected, num_buckets=nb)
        halo.COLLECTIVES.clear()
        loss, g = grad_fn(slabs, target, np.float32(0.0))
        out[f"collectives{nb}"] = dict(halo.COLLECTIVES)
        out[f"eam{nb}"] = (float(loss), _np(
            shard.gather_blocks(g, 2, mesh, ("space",))
            .reshape(scene.volume.shape)))
    return out if rank == 0 else {"coordinate": out["coordinate"],
                                  "collectives4": out["collectives4"]}


#: the DOS cases: (name, Params kwargs, frames), a 64² image on 2 bands
DOS_CASES = [
    ("dos", dict(extinction=80.0, steps=30, slices=30, samples=4), 2),
    ("dos_samples_h", dict(extinction=80.0, steps=10, slices=30,
                           samples=64), 1),
]
DOS_SIZE = 64


def dos_everything(rank, world, fields, inside_fields):
    """The DOS bands on a group of 2 ranks, ``data`` = 2: each case through
    ``dos_halo.sharded_render_frame`` and ``shard.shard_render_frame``
    (the whole image gathered each slice), the halo width and the
    camera-inside case through ``shard_render_frame``; gathered."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.parallel import (gather_state, make_mesh, place_state,
                                        shard_render_frame)
    from vpt_tpu_torch.parallel import dos_halo, halo
    from vpt_tpu_torch.renderers import dos

    out = {}
    scene = interop.scene_from_numpy(fields, device="cpu")
    inside = interop.scene_from_numpy(inside_fields, device="cpu")
    mesh = make_mesh(world, axes=("data",), device="cpu")
    for name, kwargs, frames in DOS_CASES:
        params = dos.Params(**kwargs)
        halo.COLLECTIVES.clear()
        frame_fn, width = dos_halo.sharded_render_frame(
            mesh, scene, params, DOS_SIZE, DOS_SIZE, donate=False)
        whole = dos.reset(params, DOS_SIZE, DOS_SIZE, scene)
        local = place_state(whole, mesh, DOS_SIZE)
        got = []
        for n in range(1, frames + 1):
            local = frame_fn(local, scene, params, np.float32(0.0), n)
            got.append(_np(gather_state(local, mesh, DOS_SIZE)))
        out[name] = {"halo": width, "frames": got,
                     "collectives": dict(halo.COLLECTIVES),
                     "offsets_rows": int(local["offsets"].shape[0])}
        frame = shard_render_frame(dos, mesh, whole)
        local = place_state(whole, mesh, DOS_SIZE)
        local = frame(local, scene, params, np.float32(0.0), 1)
        out[name]["gathered"] = _np(gather_state(local, mesh, DOS_SIZE))
    params = dos.Params(**DOS_CASES[0][1])
    whole = dos.reset(params, DOS_SIZE, DOS_SIZE, inside)
    local = shard_render_frame(dos, mesh, whole)(
        place_state(whole, mesh, DOS_SIZE), inside, params, np.float32(0.0),
        1)
    out["inside"] = _np(gather_state(local, mesh, DOS_SIZE))
    return out if rank == 0 else {}


#: the resident cases' image, frames and Params (``tests/test_resident.py``'s)
RESIDENT_SIZE, RESIDENT_FRAMES = 16, 2
RESIDENT_PARAMS = dict(extinction=25.0, steps=8)

#: the stall-free resident frames: (name, scene kind, data, space,
#: interleave), each from the port's own reset
RESIDENT_STALL_FREE = [
    ("d1s4", "f32", 1, 4, 1),
    ("d2s2", "f32", 2, 2, 1),
    ("unpacked", "unpacked", 1, 4, 1),
    ("d2s2_unpacked", "unpacked", 2, 2, 1),
    ("cheb", "cheb", 1, 4, 1),
    ("interleave2", "f32", 1, 4, 2),
    ("interleave4", "f32", 1, 4, 4),
]

#: the frames held against vpt_tpu's resident machine on a (1, 4) mesh,
#: each from vpt_tpu's reset pool: (name, fanout, capacity, interleave,
#: migrate_every); a capacity of 64 is group // S, the mutual-full case
RESIDENT_JAX = [
    ("fanout2", 2, None, 1, 1),
    ("capacity_half", None, 128, 1, 1),
    ("amortized", None, None, 2, 2),
    ("mutual_full", None, 64, 1, 1),
]


def _resident_frames(frame_fn, pool, tables, params):
    for n in range(1, RESIDENT_FRAMES + 1):
        frame_fn(pool, tables, params, np.float32(0.1 * n), n)
    return pool


def resident_everything(rank, world, fields, jax_pools):
    """The resident frames on a group of 4 ranks: the stall-free cases of
    :data:`RESIDENT_STALL_FREE` from the port's reset, assembled over the
    mesh, with each rank's counters; the cases of :data:`RESIDENT_JAX`
    from vpt_tpu's reset pools (``jax_pools``, whole numpy pools), each
    rank's pool block; the collectives of one exact frame; and the
    amortized mode's refusal of steps it does not divide.  Every rank's
    results go back."""
    from vpt_tpu_torch import interop
    from vpt_tpu_torch.parallel import halo, make_mesh, resident
    from vpt_tpu_torch.parallel.mesh import axis_index
    from vpt_tpu_torch.renderers import mcm

    scenes = {k: interop.scene_from_numpy(v, device="cpu")
              for k, v in fields.items()}
    params = mcm.Params(**RESIDENT_PARAMS)
    h = w = RESIDENT_SIZE
    out = {}
    meshes = {}
    for name, kind, data, space, m in RESIDENT_STALL_FREE:
        if space not in meshes:
            meshes[space] = make_mesh(world, space=space, device="cpu")
        mesh = meshes[space]
        pool = resident.resident_reset(scenes[kind], params, h, w, mesh,
                                       space, interleave=m)
        frame_fn, tables = resident.resident_render_frame(
            mesh, scenes[kind], space, h, w, interleave=m)
        halo.COLLECTIVES.clear()
        frame_fn(pool, tables, params, np.float32(0.1), 1)
        collectives = dict(halo.COLLECTIVES)
        frame_fn(pool, tables, params, np.float32(0.2), 2)
        out[name] = {"state": _np(resident.assemble(pool, h, w, mesh)),
                     "counters": {c: int(pool[c]) for c in
                                  ("migrated", "stalled", "dropped")},
                     "collectives": collectives}
    # one slab a data group: the amortized mode parks nothing
    mesh = make_mesh(world, space=1, device="cpu")
    for every in (1, 4):
        pool = resident.resident_reset(scenes["f32"], params, h, w, mesh, 1)
        frame_fn, tables = resident.resident_render_frame(
            mesh, scenes["f32"], 1, h, w, migrate_every=every)
        _resident_frames(frame_fn, pool, tables, params)
        out[f"space1_every{every}"] = _np(resident.assemble(pool, h, w,
                                                            mesh))
    mesh = meshes[4]
    index = (axis_index(mesh, "data"), axis_index(mesh, "space"))
    for name, fanout, capacity, m, every in RESIDENT_JAX:
        pool = interop.resident_pool_from_numpy(jax_pools[name], *index,
                                                device="cpu")
        frame_fn, tables = resident.resident_render_frame(
            mesh, scenes["f32"], 4, h, w, fanout=fanout, interleave=m,
            migrate_every=every)
        _resident_frames(frame_fn, pool, tables, params)
        out[name] = {"index": index, "pool": _np(pool)}
    frame_fn, tables = resident.resident_render_frame(
        mesh, scenes["f32"], 4, h, w, migrate_every=3)
    pool = resident.resident_reset(scenes["f32"], params, h, w, mesh, 4)
    try:
        frame_fn(pool, tables, params, np.float32(0.1), 1)
        out["not_divisible"] = None
    except ValueError as exc:
        out["not_divisible"] = str(exc)
    return out
