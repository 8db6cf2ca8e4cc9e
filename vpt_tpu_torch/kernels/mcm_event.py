"""The MCM event machine: one progressive frame of null-collision events.

There is no Pallas original: in ``vpt_tpu`` the frame is an XLA
``fori_loop`` (``vpt_tpu/renderers/mcm.py:197-310``) over ``flight_phase``,
``Scene.sample_color_tracking`` and ``interact_phase``.  Here it is

- :func:`event_frame_plain`, a Python loop over the plain PyTorch phases of
  ``renderers/mcm.py``, on any device;
- the CUDA kernel ``csrc/mcm_event.cu``: one thread a pixel keeps its
  photon in registers for all ``steps`` events (flight, one corner row, the
  TF lookup of ``csrc/tf1d.cuh``, classification, then the deposit and
  reset or the scatter), computing its NDC and stream seed from the pixel
  index and the frame's row window (its first row and the image's
  height).  A scene with a majorant grid runs the kernel's grid machine, an
  environment map larger than 1×1 its map instance, a two-channel or
  filtered volume an ext instance (``csrc/ray.cuh``: the filtered fetch,
  the two-channel row, the 2D TF lookup).

A frame over a ``parallel.halo.HaloScene`` (a rank's z slab of the
volume) runs the kernel's halo instance on the card
(:func:`halo_event_frame`): a launch an event and one more, each
finishing the previous event with the value summed over the slabs and
starting the next one by writing each photon's masked slab-local value,
with the scene's all-reduce between them; its plain twin is
:func:`event_frame_plain` over the same scene, whose samplers mask and
sum alike.  A frame of ``parallel.resident`` (photons in pools of rows on
the rank that owns their next sample) runs the kernel's resident instance
(:func:`resident_event`, a launch an event and one more around the
migrations); its plain twin is the module's plain frame.

:func:`event_frame` takes the plain loop for CPU state and launches the
kernel for CUDA state; both update the state tensors in place.  For CUDA
state it raises on what the kernel does not take: scenes without corner
tables (a hand-built one: ``make_scene`` gives every scene on the card
its tables), images
of 2^31 pixels or more, and filtered volumes in bfloat16 rows (make_scene
builds them in float32).  What a launch needs of the scene it
prepares once per (scene, resolution, window); a frame then does no tensor work
besides the launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import rng, sampling
from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the halo instance (steps + 1 a frame), likewise
HALO_LAUNCHES = 0
#: launches of the resident instance (steps + 1 an exact frame), likewise
RESIDENT_LAUNCHES = 0
#: of those, the launches of the two-channel halo and resident instances
HALO_RG_LAUNCHES = 0
RESIDENT_RG_LAUNCHES = 0

_VEC3 = ("position", "direction", "transmittance", "radiance")
_SCALAR = ("bounces", "samples")


def event_frame_plain(state, scene, params, seed, window=None):
    """``params.steps`` events for every pixel in plain PyTorch."""
    from ..renderers import mcm

    height, width = state["position"].shape[:2]
    dev = state["position"].device
    ndc = sampling.pixel_ndc(height, width, device=dev, window=window)
    inv_res = mcm.inverse_resolution(sampling.row_window(window, height)[1],
                                     width, dev)
    # per-pixel stream: hash(uvec3(bits(mapped.xy), bits(seed))) (glsl:128)
    rstate = rng.seed_pixels(ndc * 0.5 + 0.5, np.float32(seed))
    use_skip = mcm.uses_skip(state, scene)
    cell = mcm.skip_cell_size(scene) if use_skip else None
    scene = dataclasses.replace(scene, kernels=False)
    ph = dict(state)
    for _ in range(params.steps):
        majorant = None
        if scene.majorant is not None:
            rstate, position, *majorant = mcm.grid_flight_phase(
                ph, rstate, scene, params)
        else:
            rstate, position = mcm.flight_phase(ph, rstate, params,
                                                use_skip, cell)
        if use_skip:
            vs, cheb_new = scene.sample_color_tracking(position)
        else:
            vs, cheb_new = scene.sample_color(position), None
        ph, rstate = mcm.interact_phase(ph, rstate, position, vs, cheb_new,
                                        scene, params, ndc, inv_res,
                                        use_skip, majorant)
    for key, value in state.items():
        value.copy_(ph[key])


def _check_state(state, height, width, device):
    for key in _VEC3 + _SCALAR + (("cheb",) if "cheb" in state else ()):
        t = state[key]
        want = (height, width, 3) if key in _VEC3 else (height, width)
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"mcm state {key!r} must be a contiguous "
                             f"float32 {want} tensor on {device}")


def _fields(scene):
    return (scene.volume_packed, scene.tracking_packed, scene.transfer_1d,
            scene.environment, scene.mvp_inverse, scene.tf_mxu,
            scene.majorant, scene.transfer_packed, scene.filter)


def majorant_grid(scene):
    """The scene's majorant grid as the kernel reads it, an (N³, 2)
    contiguous float32 tensor, or None without one."""
    grid = scene.majorant
    if grid is None:
        return None
    n = grid.shape[0]
    if grid.dtype != torch.float32 or tuple(grid.shape) != (n, n, n, 2):
        raise ValueError("the majorant grid must be (N, N, N, 2) float32")
    grid = grid.contiguous().reshape(n ** 3, 2)
    _build.check_aligned(grid, "the majorant grid")
    return grid


def _prepare(scene, key):
    """Check the scene and build the scene's part of the launch arguments
    for ``key`` = (use_skip, height, width), followed by (row0,
    full_height) for a window other than the whole image
    (``_build.window_key``):
    ``Prepared(tensors, args)``."""
    use_skip, height, width, *window = key
    row0, full_height = window or (0, height)
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the MCM event kernel indexes "
                         "pixels with 32-bit integers")
    tensors, args = _build.scene_args(
        scene, scene.tracking_packed if use_skip else scene.volume_packed,
        "MCM event", ext=True)
    env, eh, ew = _build.environment_map(scene)
    grid = majorant_grid(scene)
    grid_args = (None, 0) if grid is None \
        else (grid.data_ptr(), scene.majorant.shape[0])
    return _build.Prepared(tensors=(*tensors, env, grid), args=(
        *args[:8], env.data_ptr(), eh, ew, *grid_args, args[8], width,
        height), ext=args[9:] + (row0, full_height),
        inv_res=(1.0 / width, 1.0 / full_height))


#: the last scene's preparation; a renderer launches one scene at one
#: resolution frame after frame
_scene_cache = _build.LastScene(_prepare, _fields)


def launch_args(state, scene, params, seed, window=None):
    """The arguments of one ``vpt_mcm_event_frame`` call for CUDA
    ``state``: the state's pointers, the scene's part (prepared once per
    scene, resolution and row window), the frame's seed and ``params``,
    the current stream.  ``window``: None, or ``(row0, full_height)``, the
    state's rows of the image (``sampling.pixel_ndc``)."""
    from ..renderers import mcm

    position = state["position"]
    dev = position.device
    height, width = position.shape[:2]
    _check_state(state, height, width, dev)
    if scene.device != dev:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{dev}")
    use_skip = mcm.uses_skip(state, scene)
    prepared = _scene_cache.get(scene, (use_skip, height, width)
                                + _build.window_key(window, height))
    cheb = state["cheb"].data_ptr() if use_skip else None
    # ctypes rounds each Python float to the nearest float32, as
    # np.float32 and JAX's weak types do
    return (position.data_ptr(), state["direction"].data_ptr(),
            state["bounces"].data_ptr(), state["transmittance"].data_ptr(),
            state["radiance"].data_ptr(), state["samples"].data_ptr(), cheb,
            *prepared.args, *prepared.inv_res, float(seed),
            params.extinction, params.anisotropy, params.blur,
            mcm.skip_cell_size(scene), params.max_bounces, params.steps,
            int(use_skip), *prepared.ext, _build.stream_ptr(position))


def event_frame(state, scene, params, seed, window=None):
    """One frame of ``params.steps`` events, in place on ``state``;
    ``window`` as in :func:`launch_args`.  A HaloScene's frame on the card
    is :func:`halo_event_frame`."""
    if not state["position"].is_cuda:
        event_frame_plain(state, scene, params, seed, window)
        return
    if _build.is_halo(scene):
        halo_event_frame(state, scene, params, seed, window)
        return
    global LAUNCHES
    args = launch_args(state, scene, params, seed, window)
    # the stream and the shared-memory opt-in belong to the state's device
    with torch.cuda.device(state["position"].device):
        _build.check("vpt_mcm_event_frame",
                     _build.library().vpt_mcm_event_frame(*args))
    LAUNCHES += 1


def _halo_fields(scene):
    return (scene.slab_packed, scene.tracking_packed, scene.transfer_1d,
            scene.environment, scene.mvp_inverse, scene.tf_mxu,
            scene.transfer_packed)


def _prepare_halo(scene, key):
    """What the halo instance's launches of ``key`` = (use_skip, height,
    width, row0, full_height) take of a HaloScene: ``Prepared(tensors,
    scene_args, inv_res, window, scratch)``; the scratch (the streams and
    the values, (n, channels), between the launches) is the frame's."""
    use_skip, height, width, row0, full_height = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the MCM event kernel indexes "
                         "pixels with 32-bit integers")
    tensors, args = _build.slab_scene(scene, use_skip)
    dev = tensors[0].device
    n = height * width
    scratch = (torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n * args[-1], dtype=torch.float32, device=dev))
    return _build.Prepared(
        tensors=tensors, scratch=scratch, scene_args=args + (width, height),
        inv_res=(1.0 / width, 1.0 / full_height), window=(row0, full_height))


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_event_frame(state, scene, params, seed, window=None):
    """One frame over a HaloScene on the card, in place on CUDA ``state``:
    ``params.steps + 1`` launches, launch e finishing event e - 1 (the TF
    lookup of the value summed over the scene's group, the interaction)
    and starting event e (the flight and the masked value of its position
    from this rank's slab rows), with ``HaloScene.reduce_`` between them.
    Equal bit for bit to :func:`event_frame` on the whole scene: only the
    owner's value is non-zero.  The slabs may be interleaved, the fetch
    unmasked (``HaloScene.collective`` False: no sum either), the volume
    two-channel (a value pair a photon, the 2D TF lookup).  ``window`` as
    in :func:`launch_args`."""
    global HALO_LAUNCHES, HALO_RG_LAUNCHES
    from ..renderers import mcm

    position = state["position"]
    dev = position.device
    height, width = position.shape[:2]
    _check_state(state, height, width, dev)
    if scene.device != dev:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{dev}")
    use_skip = mcm.uses_skip(state, scene)
    p = _halo_cache.get(scene, (use_skip, height, width)
                        + sampling.row_window(window, height))
    rng_state, value = p.scratch
    cheb = state["cheb"].data_ptr() if use_skip else None
    stream = _build.stream_ptr(position)
    head = (position.data_ptr(), state["direction"].data_ptr(),
            state["bounces"].data_ptr(), state["transmittance"].data_ptr(),
            state["radiance"].data_ptr(), state["samples"].data_ptr(), cheb,
            *p.scene_args, *p.inv_res, float(seed), params.extinction,
            params.anisotropy, params.blur, mcm.skip_cell_size(scene),
            params.max_bounces, int(use_skip), *p.window, rng_state.data_ptr(),
            value.data_ptr(), scene.slab_index, scene.num_slabs,
            scene.interleave, int(scene.collective))
    launch = _build.library().vpt_mcm_halo_event
    steps = params.steps
    if steps <= 0:
        return
    rg = p.scene_args[14] == 2
    with torch.cuda.device(dev):
        for step in range(steps + 1):
            _build.check("vpt_mcm_halo_event",
                         launch(*head, int(step > 0), int(step < steps),
                                stream))
            HALO_LAUNCHES += 1
            HALO_RG_LAUNCHES += rg
            if step < steps:
                scene.reduce_(value)


#: the resident pool's leaves a launch reads and writes: (name, dtype,
#: lanes; 0 for a (rows,) leaf)
RESIDENT_LEAVES = (("position", torch.float32, 3),
                   ("direction", torch.float32, 3),
                   ("bounces", torch.float32, 1),
                   ("transmittance", torch.float32, 3),
                   ("radiance", torch.float32, 3),
                   ("samples", torch.float32, 1),
                   ("ndc", torch.float32, 2),
                   ("pixel_id", torch.int32, 0),
                   ("rstate", torch.int64, 0),
                   ("occupied", torch.bool, 0),
                   ("pending", torch.bool, 0))


def _prepare_resident(scene, key):
    use_skip, = key
    tensors, args = _build.slab_scene(scene, use_skip)
    return _build.Prepared(tensors=tensors, scene_args=args)


_resident_cache = _build.LastScene(_prepare_resident, _halo_fields)


def check_pool(pool, device):
    """Raise unless ``pool`` holds every leaf of :data:`RESIDENT_LEAVES`
    (and a (rows, 1) float32 ``cheb`` where it has one) as a contiguous
    tensor on ``device`` with the pool's row count below 2^31."""
    rows = pool["position"].shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} pool rows: the resident kernel indexes "
                         "rows with 32-bit integers")
    leaves = RESIDENT_LEAVES + ((("cheb", torch.float32, 1),)
                                if "cheb" in pool else ())
    for name, dtype, lanes in leaves:
        t = pool[name]
        want = (rows, lanes) if lanes else (rows,)
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"resident pool {name!r} must be a contiguous "
                             f"{dtype} {want} tensor on {device}")


def resident_event(pool, scene, params, seed, inv_res, reseed: bool,
                   interact: bool, flight: bool):
    """One launch of K5's resident instance over a rank's CUDA pool
    (``parallel/resident.py``), in place: ``reseed`` gives every row that
    is not pending its pixel's stream of ``seed``; ``interact`` finishes
    the event of every ready row (occupied, pending, and owned by this
    rank, ``scene.slab_index``: its cell's owner, or ``pixel_id % S`` out
    of the cube) from the slab's rows, unmasked; ``flight`` flies every
    occupied row that is not pending and leaves every occupied row
    pending.  ``scene`` is this rank's HaloScene (its slab index, slab
    count and ``interleave``); ``inv_res`` the whole image's ``(1 / W, 1 /
    H)``.  The pool is checked by the caller (:func:`check_pool`)."""
    global RESIDENT_LAUNCHES, RESIDENT_RG_LAUNCHES
    from ..renderers import mcm

    position = pool["position"]
    use_skip = "cheb" in pool and scene.tracking_packed is not None
    p = _resident_cache.get(scene, (use_skip,))
    cheb = pool["cheb"].data_ptr() if use_skip else None
    with torch.cuda.device(position.device):
        _build.check("vpt_mcm_resident_event",
                     _build.library().vpt_mcm_resident_event(
                         position.data_ptr(), pool["direction"].data_ptr(),
                         pool["bounces"].data_ptr(),
                         pool["transmittance"].data_ptr(),
                         pool["radiance"].data_ptr(),
                         pool["samples"].data_ptr(), cheb, *p.scene_args,
                         position.shape[0], *inv_res, float(seed),
                         params.extinction, params.anisotropy, params.blur,
                         mcm.skip_cell_size(scene), params.max_bounces,
                         int(use_skip), pool["rstate"].data_ptr(),
                         pool["ndc"].data_ptr(), pool["pixel_id"].data_ptr(),
                         pool["occupied"].data_ptr(),
                         pool["pending"].data_ptr(), scene.slab_index,
                         scene.num_slabs, scene.interleave, int(reseed),
                         int(interact), int(flight),
                         _build.stream_ptr(position)))
    RESIDENT_LAUNCHES += 1
    RESIDENT_RG_LAUNCHES += p.scene_args[14] == 2


def _slab_flags(table_dtype, env_map, channels):
    return int(table_dtype == torch.bfloat16) | 4 * env_map \
        | 16 * (channels == 2)


def halo_occupancy(table_dtype, tf_width: int, env_map: bool = False,
                   channels: int = 1) -> dict:
    """The launch shape of the halo instance on the current CUDA device,
    as :func:`occupancy`'s.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    _build.check("vpt_mcm_halo_info", _build.library().vpt_mcm_halo_info(
        _slab_flags(table_dtype, env_map, channels), tf_width, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


def resident_occupancy(table_dtype, tf_width: int, env_map: bool = False,
                       channels: int = 1) -> dict:
    """The launch shape of the resident instance, as
    :func:`halo_occupancy`'s."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    _build.check("vpt_mcm_resident_info",
                 _build.library().vpt_mcm_resident_info(
                     _slab_flags(table_dtype, env_map, channels), tf_width,
                     out))
    return dict(zip(OCCUPANCY_FIELDS, out))


#: the fields of :func:`occupancy`, in the order ``vpt_mcm_event_info``
#: writes them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "dynamic_smem_bytes")


def occupancy(table_dtype, tf_width: int, grid: bool = False,
              env_map: bool = False, channels: int = 1,
              filtered: bool = False) -> dict:
    """The launch shape on the current CUDA device of the kernel's instance
    for a corner table of ``table_dtype``, a TF row of ``tf_width`` texels,
    the grid machine or not, an environment map larger than 1×1 or not and
    the fetch (``channels`` 2, or ``filtered``: an ext instance): threads a
    block, resident blocks an SM, SMs, registers and local (spill) bytes a
    thread, static and dynamic shared memory a block.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    ext = channels == 2 or filtered
    flags = int(table_dtype == torch.bfloat16) | 2 * grid | 4 * env_map \
        | 8 * ext | 16 * (channels == 2)
    _build.check("vpt_mcm_event_info", _build.library().vpt_mcm_event_info(
        flags, tf_width, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
