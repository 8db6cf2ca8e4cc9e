"""The MCS kernel: one progressive frame of single scattering.

There is no Pallas original: in ``vpt_tpu`` the frame is two XLA
``lax.while_loop``s over the pixel grid (``vpt_tpu/renderers/mcs.py:47-178``,
the free path and the shadow transmittance) and the incremental mean.
Here it is

- :func:`mcs_frame_plain`, ``renderers/mcs.generate`` and ``integrate`` on
  the scene with ``kernels=False``, on any device;
- the CUDA kernel ``csrc/mcs_frame.cu``: one thread a pixel of an 8×4 warp
  tile runs both tracking loops to its own exit (the RNG, ray setup,
  corner fetch and TF lookup of ``csrc/ray.cuh`` and ``csrc/tf1d.cuh``),
  then the incremental mean, reading and writing its state once.

:func:`mcs_frame` takes the plain version for CPU state and launches the
kernel for CUDA state (its map instance for an environment map larger than
1×1, its ext instance for a two-channel or filtered volume); it raises on
what the kernel does not take (unpacked scenes, images of 2^31 pixels or
more, filtered volumes in bfloat16 rows).  What a launch takes of the
scene, the Params and the resolution it prepares once (``VptMcsExt``,
passed as one pointer); a frame passes
its seed, its scatter direction (``mcs.scatter_direction``, which the plain
version takes too) and n.  Given ``counts``, the frame also adds its
tracking steps and corner-row fetches to it.

A frame over a ``parallel.halo.HaloScene`` (a rank's z slab) runs the
kernel's halo instance on the card (:func:`halo_mcs_frame`): a launch a
fetch of the slowest pixel, and one more, the launches after the first over
the card's list of the pixels that still fetch, issued in batches of
:data:`HALO_BATCH` (:data:`HALO_REDUCE_BATCH` where the scene's group sums
the values) between two host reads of the list's length
(:func:`halo_schedule`); its plain twin is :func:`mcs_frame_plain` over the
same scene.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the halo instance (L + 1 to L + B a frame, L the slowest
#: pixel's fetches, B the batch), likewise
HALO_LAUNCHES = 0
#: host reads of the halo instance's count of the pixels that fetch (one a
#: batch of B launches), likewise
HALO_READS = 0
#: the halo frame's launches between two host reads where no collective
#: sums the values (chosen on the H100 from 2, 4 and 8 by the call's time:
#: PERF.md §6)
HALO_BATCH = 8
#: the same where the scene's group sums the values
#: (``HaloScene.reduces``): each launch but the first then follows an
#: all-reduce, which makes the host wait, so a surplus launch costs one
#: more and a read little (chosen on the H100 from 1, 2, 4 and 8 by the
#: call's time on two gloo ranks: PERF.md §6)
HALO_REDUCE_BATCH = 1
#: ``kMcsSlots`` of ``csrc/mcs_frame.cu``: the count slots a launch reads,
#: writes and zeroes for the next
_SLOTS = 3


def mcs_frame_plain(state, scene, params, seed, frame_number, window=None):
    """One frame in plain PyTorch, in place on ``state``."""
    from ..renderers import mcs

    height, width = state.shape[:2]
    frame = mcs.generate(dataclasses.replace(scene, kernels=False), params,
                         seed, height, width, window=window)
    mcs.integrate(state, frame, frame_number)


class _Args(ctypes.Structure):
    """``VptMcsExt`` of ``csrc/mcs_frame.cu``: the ``VptMcsArgs`` fields,
    then the ext instances'."""
    _fields_ = [("table", ctypes.c_void_p), ("tf_row", ctypes.c_void_p),
                ("mvp", ctypes.c_void_p), ("env", ctypes.c_void_p),
                ("table_bf16", ctypes.c_int), ("d", ctypes.c_int),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("tw", ctypes.c_int), ("tf_mode", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("extinction", ctypes.c_float), ("cell", ctypes.c_float),
                ("use_skip", ctypes.c_int), ("device", ctypes.c_int),
                ("env_h", ctypes.c_int), ("env_w", ctypes.c_int),
                ("row0", ctypes.c_int), ("full_height", ctypes.c_int),
                ("tf_table", ctypes.c_void_p), ("th", ctypes.c_int),
                ("channels", ctypes.c_int), ("filter", ctypes.c_int)]


def _fields(scene):
    return (scene.volume_packed, scene.tracking_packed, scene.transfer_1d,
            scene.mvp_inverse, scene.tf_mxu, scene.environment,
            scene.transfer_packed, scene.filter)


def _prepare(scene, key):
    """What every frame of ``key`` = (params, height, width), then (row0,
    full_height) for a window other than the whole image
    (``_build.window_key``), takes of the scene: the checked tensors and
    the ``VptMcsExt``."""
    from ..renderers import mcs

    params, height, width, *window = key
    row0, full_height = window or (0, height)
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the MCS kernel indexes pixels "
                         "with 32-bit integers")
    env, eh, ew = _build.environment_map(scene)
    use_skip = scene.tracking_packed is not None
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, mvp, *ext) = \
        _build.scene_args(scene, scene.tracking_packed if use_skip
                          else scene.volume_packed, "MCS", ext=True)
    cell = mcs.skip_cell_size(scene) if use_skip else 0.0
    device = scene.volume.get_device()
    # ctypes rounds each Python float to the nearest float32
    args = _Args(table, row, mvp, env.data_ptr(), bf16, d, h, w, tw, tf_mode,
                 width, height, params.extinction, cell, int(use_skip),
                 device, eh, ew, row0, full_height, *ext)
    return _build.Prepared(
        tensors=(*tensors, env), args=args, address=ctypes.addressof(args),
        device=device, shape=torch.Size((height, width, 4)),
        direction=mcs.scatter_direction,
        launch=_build.library().vpt_mcs_launch if device >= 0 else None)


#: the last (scene, params, resolution)'s preparation
_scene_cache = _build.LastScene(_prepare, _fields)


def mcs_frame(state, scene, params, seed, frame_number, counts=None,
              window=None):
    """One frame of MCS, generate and integrate, in place on ``state``.

    ``counts``: None, or a CUDA int64 tensor of 2 on the state's device to
    which the kernel adds the frame's tracking steps (draws) and corner-row
    fetches; the plain version takes none.  ``window``: None, or ``(row0,
    full_height)``: the state holds those rows of the image
    (``sampling.pixel_ndc``)."""
    if not state.is_cuda:
        if counts is not None:
            raise ValueError("the plain MCS frame counts nothing")
        mcs_frame_plain(state, scene, params, seed, frame_number, window)
        return
    if _build.is_halo(scene):
        if counts is not None:
            raise ValueError("the MCS halo frame counts nothing")
        halo_mcs_frame(state, scene, params, seed, frame_number, window)
        return
    global LAUNCHES
    p = _scene_cache.get(scene, (params,) + tuple(state.shape[:2])
                         + _build.window_key(window, state.shape[0]))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("the mcs state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a 16-byte boundary")
    if counts is not None and (
            counts.dtype is not torch.int64 or counts.shape != (2,)
            or counts.get_device() != p.device
            or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int64 (2,) tensor on "
                         "the state's device")
    sx, sy, sz = p.direction(seed)
    err = p.launch(p.address, state.data_ptr(), seed, sx, sy, sz,
                   frame_number, None if counts is None
                   else counts.data_ptr(), _build.current_stream(p.device))
    if err:
        _build.check("vpt_mcs_launch", err)
    LAUNCHES += 1


def _halo_fields(scene):
    return (scene.slab_packed, scene.tracking_packed, scene.transfer_1d,
            scene.mvp_inverse, scene.tf_mxu, scene.environment,
            scene.transfer_packed)


class _HaloFrameArgs(ctypes.Structure):
    """``VptMcsHaloFrame`` of ``csrc/mcs_frame.cu``, its nested
    ``VptMcsHalo`` (the scratch, the slab) and ``VptMcsFrame`` (the frame's
    scalars) flattened: no C padding falls between them."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("args", "state", "rng", "tag", "track", "diffuse", "value",
                  "live", "list")]
                + [(name, ctypes.c_int) for name in
                   ("slab_index", "num_slabs", "interleave", "masked")]
                + [(name, ctypes.c_float) for name in
                   ("seed", "sx", "sy", "sz", "frame_number")]
                + [("tail_blocks", ctypes.c_int)])


def _prepare_halo(scene, key):
    """What every halo frame of ``key`` = (params, height, width, row0,
    full_height) takes of a HaloScene, checked once
    (``vpt_mcs_halo_check``): the ``VptMcsExt`` of its slab rows (the
    cheb-skip rows where it has them) and the ``VptMcsHaloFrame`` around
    it with the frame's scratch between the launches (each pixel's stream,
    phase, tracking, diffuse colour and pending value; the card's count
    slots and two lists of the pixels that fetch) and the tail's persistent
    grid, the pinned word a read lands in and the event it waits on."""
    from ..renderers import mcs

    params, height, width, row0, full_height = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the MCS kernel indexes pixels "
                         "with 32-bit integers")
    use_skip = scene.tracking_packed is not None
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, env, eh, ew, mvp,
              tf_table, th, channels) = _build.slab_scene(scene, use_skip)
    cell = mcs.skip_cell_size(scene) if use_skip else 0.0
    dev = tensors[0].device
    args = _Args(table, row, mvp, env, bf16, d, h, w, tw, tf_mode, width,
                 height, params.extinction, cell, int(use_skip), dev.index,
                 eh, ew, row0, full_height, tf_table, th, channels, 0)
    n = height * width
    scratch = {"rng": torch.empty(n, dtype=torch.int32, device=dev),
               "tag": torch.empty(n, dtype=torch.int32, device=dev),
               "track": torch.empty((n, 4), dtype=torch.float32, device=dev),
               "diffuse": torch.empty((n, 4), dtype=torch.float32,
                                      device=dev),
               "value": torch.empty(n * channels, dtype=torch.float32,
                                    device=dev),
               "live": torch.zeros(_SLOTS, dtype=torch.int32, device=dev),
               "list": torch.empty(2 * n, dtype=torch.int32, device=dev)}
    occ = halo_occupancy(tensors[0].dtype, tw, dev.index,
                         env_map=(eh, ew) != (1, 1), channels=channels,
                         tail=True)
    tail_blocks = occ["blocks_per_sm"] * occ["sms"]
    if tail_blocks == 0:
        raise RuntimeError("the MCS halo tail fits no block on an SM")
    frame = _HaloFrameArgs(
        ctypes.addressof(args), None,
        *(scratch[k].data_ptr() for k in ("rng", "tag", "track", "diffuse",
                                          "value", "live", "list")),
        scene.slab_index, scene.num_slabs, scene.interleave,
        int(scene.collective), 0.0, 0.0, 0.0, 0.0, 0.0, tail_blocks)
    lib = _build.library()
    _build.check("vpt_mcs_halo_check",
                 lib.vpt_mcs_halo_check(ctypes.addressof(frame)))
    read = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    return _build.Prepared(
        tensors=tensors, args=args, frame=frame, tail_blocks=tail_blocks,
        tail_threads=occ["threads_per_block"],
        address=ctypes.addressof(frame), device=dev.index,
        shape=torch.Size((height, width, 4)), scratch=scratch,
        read=read, count=ctypes.c_int.from_address(read.data_ptr()),
        event=torch.cuda.Event(), direction=mcs.scatter_direction,
        run=lib.vpt_mcs_halo_run)


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_schedule(launch, read, batch: int = HALO_BATCH):
    """A halo frame's launches, in batches of ``batch`` between two host
    reads: ``launch(e, k)`` issues launches e .. e + k - 1 back to back,
    ``read()`` waits for the last one's count of the pixels that fetch,
    and the frame ends after a batch whose last launch counts none.
    Returns (launches, reads).  With L the slowest pixel's fetches
    (launch L is the first to count none) a frame issues between L + 1 and
    L + ``batch`` launches in ceil((L + 1) / ``batch``) reads.  It depends
    on the counts alone: every rank of a group reads the same counts, so
    every rank issues the same launches and all-reduces (never a poll of
    the card, whose answer would depend on timing)."""
    launches = reads = 0
    while True:
        launch(launches, batch)
        launches += batch
        reads += 1
        if read() == 0:
            return launches, reads


def batch_calls(e: int, k: int, reduces: bool):
    """The calls of ``vpt_mcs_halo_run`` that issue launches e .. e + k - 1
    of a halo frame, as (first launch, launches, read after, all-reduce
    before) tuples: one call of all k where the group sums nothing
    (``reduces`` False), else one a launch, each but the frame's first
    after the all-reduce of the values that the launch before it wrote;
    the read after the batch's last launch.  So a frame's all-reduces are
    its launches less one."""
    if not reduces:
        return [(e, k, True, False)]
    return [(j, 1, j == e + k - 1, j > 0) for j in range(e, e + k)]


def halo_mcs_frame(state, scene, params, seed, frame_number, window=None):
    """One MCS frame over a HaloScene on the card, in place on CUDA
    ``state``.  Each launch of the halo instance finishes its pixels'
    pending fetches from the values summed over the scene's group, tracks
    each on to its next fetch (the free path, the diffuse colour, the
    shadow's transmittance, in ``mcs.generate``'s order and with its
    ``_MAX_TRACKING_ITERS`` on each loop) and writes that fetch's masked
    value, or ends the pixel's frame; the first runs every pixel, each
    later one the card's list of the pixels that fetched in the one
    before.  The launches go out in batches (:func:`halo_schedule`), each
    but the frame's first after an all-reduce of the values
    (``HaloScene.reduce_``) where the group sums them; a read of the last
    launch's count into pinned memory ends a batch, and a batch whose last
    launch counts none ends the frame.  So a frame is L + 1 to L + B
    launches (B :data:`HALO_REDUCE_BATCH` where the group sums, else
    :data:`HALO_BATCH`), one fewer all-reduces, L the most fetches a pixel
    takes: never more than the plain twin's and vpt_tpu's loops, which sum
    a fetch of every pixel at every iteration (the distance loop's
    iterations, the diffuse fetch, the transmittance loop's) until all are
    done.  Equal bit for bit to :func:`mcs_frame` on the whole scene.
    Returns the launches."""
    global HALO_LAUNCHES, HALO_READS
    from .. import sampling

    if not state.is_cuda:
        mcs_frame_plain(state, scene, params, seed, frame_number, window)
        return 0
    height, width = state.shape[:2]
    p = _halo_cache.get(scene, (params, height, width)
                        + sampling.row_window(window, height))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("the mcs state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a 16-byte boundary")
    frame = p.frame
    frame.state = state.data_ptr()
    frame.seed = seed
    frame.sx, frame.sy, frame.sz = p.direction(seed)
    frame.frame_number = frame_number
    stream = _build.current_stream(p.device)
    run, address, read_ptr = p.run, p.address, p.read.data_ptr()
    value = p.scratch["value"]
    reduces = scene.reduces
    read_count = None

    def launch(e, k):
        # a pixel fetches at launch e only if it fetched at e - 1, so after
        # a read the tail's grid needs no more blocks than the count
        frame.tail_blocks = p.tail_blocks if read_count is None else min(
            p.tail_blocks, max(1, -(-read_count // p.tail_threads)))
        for first, count, last, reduce in batch_calls(e, k, reduces):
            if reduce:
                scene.reduce_(value)
            _build.check("vpt_mcs_halo_run", run(
                address, first, count, read_ptr if last else None, stream))

    def read():
        nonlocal read_count
        p.event.record(torch.cuda.current_stream(p.device))
        p.event.synchronize()
        read_count = p.count.value
        return read_count

    launches, reads = halo_schedule(
        launch, read, HALO_REDUCE_BATCH if reduces else HALO_BATCH)
    HALO_LAUNCHES += launches
    HALO_READS += reads
    return launches


def halo_occupancy(table_dtype, tf_width: int, device: int = 0,
                   env_map: bool = False, channels: int = 1,
                   tail: bool = False) -> dict:
    """The halo instance's launch shape, as :func:`occupancy`'s: launch
    0's tile grid, or with ``tail`` the persistent instance of the
    launches after it (its grid is its blocks an SM times the SMs).
    Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 4 * env_map \
        | 16 * (channels == 2) | 32 * tail
    _build.check("vpt_mcs_halo_info", _build.library().vpt_mcs_halo_info(
        flags, tf_width, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


#: the fields of :func:`occupancy`, in the order ``vpt_mcs_info`` writes
#: them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "dynamic_smem_bytes", "tile_width", "tile_height",
                    "warp_width")


def occupancy(table_dtype, tf_width: int, device: int = 0,
              env_map: bool = False, channels: int = 1,
              filtered: bool = False) -> dict:
    """The kernel's launch shape (the render path's, without the counter)
    on CUDA ``device`` for a corner table of ``table_dtype``, a TF row of
    ``tf_width`` texels, an environment map larger than 1×1 or not and
    the fetch (``channels`` 2, or ``filtered``: an ext instance).
    Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 4 * env_map \
        | 8 * (channels == 2 or filtered) | 16 * (channels == 2)
    _build.check("vpt_mcs_info", _build.library().vpt_mcs_info(
        flags, tf_width, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
