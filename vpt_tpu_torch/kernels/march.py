"""The march kernel: one progressive frame of a fixed-schedule renderer.

There is no Pallas original: in ``vpt_tpu`` a frame of EAM, MIP, Depth or
ISO is an XLA ``lax.scan`` (``vpt_tpu/renderers/_march.py:29-55``) over the
slices, folding the renderer's composite, then its integrate.  Here it is

- :func:`march_frame_plain`, the renderer's plain PyTorch ``generate`` and
  ``integrate`` on the scene with ``kernels=False``, on any device;
- the CUDA kernel ``csrc/march.cu``: one thread a pixel of an 8×4 warp
  tile computes its ray from the pixel index and the frame's row window, reads the corner rows of
  several slices ahead and folds them in order (the corner fetch of
  ``csrc/ray.cuh`` and the TF lookup of ``csrc/tf1d.cuh``) with the
  renderer's composite in registers, and integrates into the state in
  place, reading and writing it once.  Its clamp instance first
  intersects each ray's interval with the scene's boxes that hold for the
  frame (:func:`clamp_boxes`: ``march_clamp``'s occupied box, ISO's
  ``iso_clamp_min`` box).  A two-channel or filtered volume runs its ext
  instance (``csrc/ray.cuh``: the filtered fetch, the two-channel row, the
  2D TF lookup).

:func:`march_frame` takes the plain version for CPU state and launches the
kernel for CUDA state; it raises on what the kernel does not take
(unpacked scenes, images of 2^31 pixels or more, tables of 2^31 rows or
more: it indexes both with 32-bit integers) and never falls back.  A frame
over a ``parallel.halo.HaloScene`` (a rank's z slab) runs the kernel's
halo instance on the card (:func:`halo_march_frame`); its plain twin is
:func:`march_frame_plain` over the same scene, whose samplers mask and sum
alike.  What a launch takes of the scene, the Params
and the resolution it prepares once (``VptMarchExt``, passed as one
pointer); a frame then computes its two scalars, the schedule's first value
and the running mean's weight 1/n, the float32 values of
:func:`frame_scalars` that the plain version uses, without numpy.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the halo instance (a fetch and a fold a frame, a chunk of
#: ``_build.halo_chunk`` slices each past ``_build.HALO_VALUE_BYTES``),
#: likewise
HALO_LAUNCHES = 0
#: slab rows from which the halo fetch indexes them with 64 bits
ROWS32 = 2 ** 31
#: the halo instance's stages (``vpt_march_halo_launch``)
FETCH, FOLD = 1, 2

#: the kernel's code for each renderer's composite (``csrc/march.cu``)
MODES = {"eam": 0, "mip": 1, "depth": 2, "iso": 3}


def _module(mode):
    from ..renderers import depth, eam, iso, mip

    return {"eam": eam, "mip": mip, "depth": depth, "iso": iso}[mode]


def state_shape(mode, height, width):
    return (height, width) if mode == "mip" else (height, width, 4)


def march_frame_plain(mode, state, scene, params, seed, frame_number,
                      window=None):
    """One frame of renderer ``mode`` in plain PyTorch, in place on
    ``state``."""
    module = _module(mode)
    height, width = state.shape[:2]
    frame = module.generate(dataclasses.replace(scene, kernels=False),
                            params, seed, height, width, window=window)
    module.integrate(state, frame, frame_number)


def frame_scalars(mode, params, seed, frame_number):
    """(slices, step, first t, extinction, level, mix) of one frame: the
    schedule of the renderer's ``schedule``, the extinction (EAM, Depth),
    the level (Depth's threshold, ISO's isovalue) and the running mean's
    weight 1/n (EAM, Depth), float32."""
    from ..renderers.base import frame_weight

    first, step = _module(mode).schedule(params, seed)
    slices = params.slices if mode in ("eam", "depth") else params.steps
    extinction = getattr(params, "extinction", 0.0)
    level = {"depth": getattr(params, "threshold", 0.0),
             "iso": getattr(params, "isovalue", 0.0)}.get(mode, 0.0)
    return (slices, float(step), float(first), float(np.float32(extinction)),
            float(np.float32(level)), float(frame_weight(frame_number)))


def first_of(mode, params, step):
    """The frame's first schedule value as a function of the seed, in the
    float32 operations of the renderer's ``schedule`` on Python floats
    (``_build.f32``): EAM and Depth ``step · offset`` (0 unless
    ``random``), MIP the offset, ISO ``1 − offset · step``, where the
    offset is ``_march.frame_offset``: ``pcg(pcg(bits of float32(seed)))``
    rounded to float32, times 2^-32 (exact)."""
    from ..renderers._march import pcg

    f32, bits = _build.f32, _build.f32_bits

    def offset(seed):
        return f32(float(pcg(pcg(bits(seed))))) * 2.0 ** -32

    if mode == "mip":
        return offset
    if mode == "iso":
        return lambda seed: f32(1.0 - f32(offset(seed) * step))
    if params.random:
        return lambda seed: f32(step * offset(seed))
    return lambda seed: 0.0


def frame_mix(frame_number) -> float:
    """``base.frame_weight``: float32(1) / float32(n), as a Python float."""
    return _build.f32(1.0 / _build.f32(float(frame_number)))


class _Args(ctypes.Structure):
    """``VptMarchExt`` of ``csrc/march.cu``: the ``VptMarchArgs`` fields,
    the boxes (``VptMarchClamp``), then the ext instances' fields."""
    _fields_ = [("table", ctypes.c_void_p), ("tf_row", ctypes.c_void_p),
                ("mvp", ctypes.c_void_p), ("table_bf16", ctypes.c_int),
                ("d", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("tw", ctypes.c_int), ("tf_mode", ctypes.c_int),
                ("mode", ctypes.c_int), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("slices", ctypes.c_int),
                ("step", ctypes.c_float), ("extinction", ctypes.c_float),
                ("level", ctypes.c_float), ("device", ctypes.c_int),
                ("row0", ctypes.c_int), ("full_height", ctypes.c_int),
                ("boxes", ctypes.c_int), ("box", ctypes.c_float * 12),
                ("tf_table", ctypes.c_void_p), ("th", ctypes.c_int),
                ("channels", ctypes.c_int), ("filter", ctypes.c_int)]


def _fields(scene):
    return (scene.volume_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.tf_mxu, scene.occupied_aabb, scene.iso_aabb,
            scene.transfer_packed, scene.filter)


def clamp_boxes(mode, scene, params):
    """The boxes renderer ``mode`` clamps its rays to, in order: ISO's that
    hold for its isovalue (``iso.boxes``), else the occupied box where the
    scene has one (``base.march_interval``)."""
    if mode == "iso":
        return _module("iso").boxes(scene, params)
    return [] if scene.occupied_aabb is None else [scene.occupied_aabb]


def check_rows(volume_shape):
    """Raise for a volume of 2^31 cells or more: the kernel indexes its
    corner rows with 32-bit integers."""
    d, h, w = volume_shape[:3]
    if d * h * w >= 2 ** 31:
        raise ValueError(f"{d}x{h}x{w}: the march kernel indexes corner "
                         "rows with 32-bit integers")


def _prepare(scene, key):
    """What every frame of ``key`` = (mode, params, height, width), then
    (row0, full_height) for a window other than the whole image
    (``_build.window_key``), takes of the scene: the checked tensors, the
    ``VptMarchExt`` and the seed's schedule function."""
    mode, params, height, width, *window = key
    row0, full_height = window or (0, height)
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the march kernel indexes "
                         "pixels with 32-bit integers")
    check_rows(scene.volume.shape)
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, mvp, *ext) = \
        _build.scene_args(scene, scene.volume_packed, "march", ext=True)
    slices, step, _, extinction, level, _ = frame_scalars(mode, params, 0.0,
                                                          1)
    device = scene.volume.get_device()
    boxes = clamp_boxes(mode, scene, params)
    corners = [float(v) for box in boxes for v in box.reshape(-1).tolist()]
    args = _Args(table, row, mvp, bf16, d, h, w, tw, tf_mode, MODES[mode],
                 width, height, slices, step, extinction, level, device,
                 row0, full_height, len(boxes), (ctypes.c_float * 12)(*corners), *ext)
    return _build.Prepared(
        tensors=tensors, args=args, address=ctypes.addressof(args),
        device=device, shape=torch.Size(state_shape(mode, height, width)),
        align=4 if mode == "mip" else 16, first=first_of(mode, params, step),
        launch=_build.library().vpt_march_launch if device >= 0 else None)


#: the last (scene, mode, params, resolution)'s preparation: a renderer
#: launches one scene at one resolution frame after frame
_scene_cache = _build.LastScene(_prepare, _fields)


def march_frame(mode, state, scene, params, seed, frame_number,
                window=None):
    """One frame of renderer ``mode`` ("eam", "mip", "depth" or "iso"),
    generate and integrate, in place on ``state``.  ``window``: None, or
    ``(row0, full_height)``: the state holds those rows of the image
    (``sampling.pixel_ndc``)."""
    if mode not in MODES:
        raise ValueError(f"unknown march mode {mode!r}")
    if not state.is_cuda:
        march_frame_plain(mode, state, scene, params, seed, frame_number,
                          window)
        return
    if _build.is_halo(scene):
        halo_march_frame(mode, state, scene, params, seed, frame_number,
                         window)
        return
    global LAUNCHES
    p = _scene_cache.get(scene, (mode, params) + tuple(state.shape[:2])
                         + _build.window_key(window, state.shape[0]))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % p.align:
        raise ValueError(f"the {mode} state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a {p.align}-byte "
                         "boundary")
    err = p.launch(p.address, state.data_ptr(), p.first(seed),
                   frame_mix(frame_number), _build.current_stream(p.device))
    if err:
        _build.check("vpt_march_launch", err)
    LAUNCHES += 1


def _halo_fields(scene):
    return (scene.slab_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.tf_mxu, scene.transfer_packed)


class _HaloArgs(_Args):
    """``VptMarchHalo``: ``VptMarchExt``, the slab's plane map, the slab
    and the rows' index width."""
    _fields_ = [("planes", ctypes.c_void_p), ("slab_index", ctypes.c_int),
                ("num_slabs", ctypes.c_int), ("interleave", ctypes.c_int),
                ("masked", ctypes.c_int), ("rows64", ctypes.c_int),
                ("fetch_rows", ctypes.c_int)]


def fetch_rows(width: int, height: int, occupancy: dict) -> int:
    """The grid rows of the halo fetch, each a share of the frame's slices:
    2 where the tile grid (16×8-pixel blocks) is under two waves of the
    fetch's resident blocks (``occupancy``: :func:`halo_occupancy` of
    stage 0), so that more blocks hide its latency at the cost of a second
    ray a pixel; else 1."""
    tiles = -(-width // occupancy["tile_width"]) \
        * -(-height // occupancy["tile_height"])
    wave = occupancy["blocks_per_sm"] * occupancy["sms"]
    return 2 if tiles < 2 * wave else 1


def _prepare_halo(scene, key):
    """What every halo frame of ``key`` = (mode, params, height, width,
    row0, full_height, slab index, slabs, interleave, masked) takes of a
    HaloScene, checked once (``vpt_march_halo_check``): the
    ``VptMarchHalo`` of its slab rows (no box, no filter; 32-bit rows below
    :data:`ROWS32` slab rows, else 64), plane map and the fetch's grid rows
    (:func:`fetch_rows`), the seed's schedule
    function, the frame's chunks of slices (``_build.halo_chunks``: one
    unless the values pass ``_build.HALO_VALUE_BYTES``) and their values,
    (chunk, n, channels), and the composite's carry, (n, 4), between
    chunks where there are several."""
    mode, params, height, width, row0, full_height, *slab = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the march kernel indexes "
                         "pixels with 32-bit integers")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, _, _, _, mvp, tf_table,
              th, channels) = _build.slab_scene(scene)
    slices, step, _, extinction, level, _ = frame_scalars(mode, params, 0.0,
                                                          1)
    dev = tensors[0].device
    planes = _build.scene_plane_map(scene)
    rows64 = tensors[0].shape[0] >= ROWS32
    occ = halo_occupancy(mode, tensors[0].dtype, tw, tf_mode, dev.index,
                         channels, stage=0, depth=d, rows64=rows64)
    args = _HaloArgs(table, row, mvp, bf16, d, h, w, tw, tf_mode,
                     MODES[mode], width, height, slices, step, extinction,
                     level, dev.index, row0, full_height, 0,
                     (ctypes.c_float * 12)(), tf_table, th, channels, 0,
                     planes.data_ptr(), *slab, int(rows64),
                     fetch_rows(width, height, occ))
    lib = _build.library()
    _build.check("vpt_march_halo_check",
                 lib.vpt_march_halo_check(ctypes.addressof(args)))
    n = height * width
    chunk = _build.halo_chunk(slices, n, channels)
    value = torch.empty(chunk * n * channels, dtype=torch.float32,
                        device=dev)
    return _build.Prepared(
        tensors=(*tensors, planes), args=args,
        address=ctypes.addressof(args), device=dev.index,
        shape=torch.Size(state_shape(mode, height, width)),
        align=4 if mode == "mip" else 16, first=first_of(mode, params, step),
        chunks=[(k0, count, value[:count * n * channels])
                for k0, count, _ in _build.halo_chunks(slices, chunk)],
        value=value, carry=None if chunk == slices else torch.empty(
            (n, 4), dtype=torch.float32, device=dev),
        launch=lib.vpt_march_halo_launch)


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_march_frame(mode, state, scene, params, seed, frame_number,
                     window=None):
    """One frame of renderer ``mode`` over a HaloScene on the card, in
    place on CUDA ``state``: a launch of the halo instance's fetch (this
    rank's masked value of every slice of every pixel whose ray meets the
    cube, from its slab rows), one all-reduce of them
    (``HaloScene.reduce_``, none without a group) and a launch of its fold
    (the TF lookup of the sums and the renderer's composite, to where its
    loop stops, then the frame's integrate).  So a frame is 2 launches and
    one all-reduce, where vpt_tpu ``psum``s a ``sample_color`` of 8
    slices and the plain twin sums a fetch of 8 (ceil(slices / 8) each);
    the sums are the same.  Values past ``_build.HALO_VALUE_BYTES`` go in
    chunks of slices, each a fetch, an all-reduce and a fold.  Equal bit
    for bit to :func:`march_frame` on the whole scene: only the owner's
    value is non-zero.  The slabs may be interleaved, the fetch unmasked,
    the volume two-channel (a value pair a sample, the 2D TF lookup).
    ``window`` as in :func:`march_frame`."""
    global HALO_LAUNCHES
    from .. import sampling

    if not state.is_cuda:
        march_frame_plain(mode, state, scene, params, seed, frame_number,
                          window)
        return
    height, width = state.shape[:2]
    p = _halo_cache.get(scene, (mode, params, height, width)
                        + sampling.row_window(window, height)
                        + (scene.slab_index, scene.num_slabs,
                           scene.interleave, int(scene.collective)))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % p.align:
        raise ValueError(f"the {mode} state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a {p.align}-byte "
                         "boundary")
    head = (p.address, p.value.data_ptr(),
            None if p.carry is None else p.carry.data_ptr(),
            state.data_ptr(), p.first(seed), frame_mix(frame_number))
    stream = _build.current_stream(p.device)
    reduces = scene.reduces
    for k0, count, values in p.chunks:
        if reduces:
            _build.check("vpt_march_halo_launch",
                         p.launch(*head, k0, count, FETCH, stream))
            scene.reduce_(values)
            _build.check("vpt_march_halo_launch",
                         p.launch(*head, k0, count, FOLD, stream))
        else:
            _build.check("vpt_march_halo_launch",
                         p.launch(*head, k0, count, FETCH | FOLD, stream))
        HALO_LAUNCHES += 2


#: the fields of :func:`occupancy`, in the order ``vpt_march_info`` writes
#: them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "dynamic_smem_bytes", "chunk", "tile_width",
                    "tile_height", "warp_width")


def halo_occupancy(mode, table_dtype, tf_width: int, tf_mode: int = 0,
                   device: int = 0, channels: int = 1, stage: int = 1,
                   depth: int = 128, rows64: bool = False) -> dict:
    """The launch shape of the halo instance's fetch (``stage`` 0, for a
    volume of ``depth`` planes: its plane map's shared memory, and 64-bit
    rows or not) or fold (1), as :func:`occupancy`'s (``chunk``: the
    fetch's rows read ahead of their lerps, the fold's values a turn).
    Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 8 * (channels == 2) \
        | 16 * rows64
    _build.check("vpt_march_halo_info", _build.library().vpt_march_halo_info(
        stage, MODES[mode], flags, tf_width, tf_mode, depth, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


def occupancy(mode, table_dtype, tf_width: int, tf_mode: int = 0,
              device: int = 0, clamp: bool = False, channels: int = 1,
              filtered: bool = False) -> dict:
    """The kernel's launch shape in ``mode`` on CUDA ``device`` for a corner
    table of ``table_dtype``, a TF row of ``tf_width`` texels, the TF
    lookup mode ``tf_mode`` (``tf1d.mode_code``), the clamp instance or not
    and the fetch (``channels`` 2, or ``filtered``: an ext instance):
    threads a block, resident blocks an SM, SMs, registers and local
    (spill) bytes a thread, static and dynamic shared memory a block, the
    rows it reads ahead of the fold and its pixel tile.  Launches
    nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 2 * clamp \
        | 4 * (filtered and channels == 1) | 8 * (channels == 2)
    _build.check("vpt_march_info", _build.library().vpt_march_info(
        MODES[mode], flags, tf_width, tf_mode, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
