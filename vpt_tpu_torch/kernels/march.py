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
#: launches of the halo instance (ceil(slices / HALO_CHUNK) + 1 a frame),
#: likewise
HALO_LAUNCHES = 0
#: slices a halo fetch samples (``kHaloChunk``; vpt_tpu's march samples
#: 8 slices a ``sample_color``, one ``psum`` each)
HALO_CHUNK = 8

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


def _prepare_halo(scene, key):
    """What every halo frame of ``key`` = (mode, params, height, width,
    row0, full_height) takes of a HaloScene: the ``VptMarchExt`` of its
    slab rows (no box, no filter), the seed's schedule function and the
    frame's scratch: the chunk's values, (HALO_CHUNK, n, channels), and the
    composite's carry, (n, 4), between the launches."""
    mode, params, height, width, row0, full_height = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the march kernel indexes "
                         "pixels with 32-bit integers")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, _, _, _, mvp, tf_table,
              th, channels) = _build.slab_scene(scene)
    slices, step, _, extinction, level, _ = frame_scalars(mode, params, 0.0,
                                                          1)
    dev = tensors[0].device
    device = dev.index if dev.type == "cuda" else -1
    args = _Args(table, row, mvp, bf16, d, h, w, tw, tf_mode, MODES[mode],
                 width, height, slices, step, extinction, level, device,
                 row0, full_height, 0, (ctypes.c_float * 12)(), tf_table, th,
                 channels, 0)
    n = height * width
    value = torch.empty(HALO_CHUNK * n * channels, dtype=torch.float32,
                        device=dev)
    carry = torch.empty((n, 4), dtype=torch.float32, device=dev)
    return _build.Prepared(
        tensors=tensors, args=args, address=ctypes.addressof(args),
        device=device, shape=torch.Size(state_shape(mode, height, width)),
        align=4 if mode == "mip" else 16, first=first_of(mode, params, step),
        chunks=-(-slices // HALO_CHUNK), value=value, carry=carry,
        launch=_build.library().vpt_march_halo_launch)


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_march_frame(mode, state, scene, params, seed, frame_number,
                     window=None):
    """One frame of renderer ``mode`` over a HaloScene on the card, in
    place on CUDA ``state``: ``C = ceil(slices / HALO_CHUNK)`` all-reduces
    (``HaloScene.reduce_`` of the chunk's masked values, one a
    ``HALO_CHUNK`` slices as vpt_tpu's ``psum`` a ``sample_color``, and as
    the plain twin's sum a fetch) between ``C + 1`` launches of the halo
    instance: launch e folds chunk e − 1's summed values (the TF lookup of
    the sum, the renderer's composite) and writes chunk e's masked values
    from this rank's slab rows; the last integrates the frame.  Equal bit
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
                        + sampling.row_window(window, height))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % p.align:
        raise ValueError(f"the {mode} state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a {p.align}-byte "
                         "boundary")
    first, mix = p.first(seed), frame_mix(frame_number)
    stream = _build.current_stream(p.device)
    head = (p.address, scene.slab_index, scene.num_slabs, scene.interleave,
            int(scene.collective), p.value.data_ptr(), p.carry.data_ptr(),
            state.data_ptr(), first, mix)
    for chunk in range(p.chunks + 1):
        _build.check("vpt_march_halo_launch", p.launch(*head, chunk, stream))
        HALO_LAUNCHES += 1
        if chunk < p.chunks:
            scene.reduce_(p.value)


#: the fields of :func:`occupancy`, in the order ``vpt_march_info`` writes
#: them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "dynamic_smem_bytes", "chunk", "tile_width",
                    "tile_height", "warp_width")


def halo_occupancy(mode, table_dtype, tf_width: int, tf_mode: int = 0,
                   device: int = 0, channels: int = 1) -> dict:
    """The halo instance's launch shape, as :func:`occupancy`'s (``chunk``:
    the slices of a fetch).  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 8 * (channels == 2)
    _build.check("vpt_march_halo_info", _build.library().vpt_march_halo_info(
        MODES[mode], flags, tf_width, tf_mode, device, out))
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
