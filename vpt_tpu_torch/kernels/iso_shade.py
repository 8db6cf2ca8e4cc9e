"""The ISO shade kernel: the ISO renderer's display.

There is no Pallas original: in ``vpt_tpu`` the display is XLA work
(``vpt_tpu/renderers/iso.py:109-130``): six TF fetches for the
central-difference gradient, the normal, the Lambert term against the
texture-space light and the material color at the hit.  Here it is

- :func:`iso_shade_plain`, ``renderers/iso.shade`` on the scene with
  ``kernels=False``, on any device;
- the CUDA kernel ``csrc/iso_shade.cu``: one thread a pixel, in
  row-major order, issues the seven corner-row reads of a hit before it
  folds them (the fetch of ``csrc/ray.cuh``, the TF lookup of
  ``csrc/tf1d.cuh`` through the read-only cache), and writes white where
  nothing was hit; a two-channel or filtered volume runs its ext instance
  (``csrc/ray.cuh``: the filtered fetch, the two-channel row, the 2D TF
  lookup).

:func:`shade` takes the plain version for CPU state and launches the kernel
for CUDA state; it raises on what the kernel does not take (unpacked
scenes, images of 2^31 pixels or more) and never falls back.  A display
of a ``parallel.halo.HaloScene`` (a rank's z slab) runs the kernel's halo
instance on the card (:func:`halo_shade`); its plain twin is
:func:`iso_shade_plain` over the same scene.  What a
display takes of the scene, the Params and the resolution it prepares once
(``VptIsoShadeExt``, passed as one pointer): the table, the TF row, h and
the float32 2h from ``_build.f32`` arithmetic, and the light direction that
the plain version's own function computes on the scene's device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the halo instance (2 a display), likewise
HALO_LAUNCHES = 0
#: the hits of the last halo display whose values were all-reduced (their
#: count read from the card), or None
HALO_HITS = None
#: slab rows from which the halo fetch indexes them with 64 bits
ROWS32 = 2 ** 31
#: pixels of a tile of the halo fetch (``kTileRounds`` x 128)
HALO_TILE = 512
#: the fetches of a hit: +h and −h on x, y, z, then the hit
TAPS = 7


def iso_shade_plain(state, scene, params):
    """The display in plain PyTorch: (H, W, 4)."""
    from ..renderers import iso

    return iso.shade(state, dataclasses.replace(scene, kernels=False),
                     params)


class _Args(ctypes.Structure):
    """``VptIsoShadeExt`` of ``csrc/iso_shade.cu``: the ``VptIsoShadeArgs``
    fields, then the ext instances'."""
    _fields_ = [("table", ctypes.c_void_p), ("tf_row", ctypes.c_void_p),
                ("table_bf16", ctypes.c_int), ("d", ctypes.c_int),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("tw", ctypes.c_int), ("tf_mode", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("step", ctypes.c_float), ("two_step", ctypes.c_float),
                ("lx", ctypes.c_float), ("ly", ctypes.c_float),
                ("lz", ctypes.c_float), ("device", ctypes.c_int),
                ("tf_table", ctypes.c_void_p), ("th", ctypes.c_int),
                ("channels", ctypes.c_int), ("filter", ctypes.c_int)]


def _fields(scene):
    return (scene.volume_packed, scene.transfer_1d, scene.tf_mxu,
            scene.model_view, scene.transfer_packed, scene.filter)


def _prepare(scene, key):
    """What every display of ``key`` = (params, height, width) takes of the
    scene: the checked tensors and the ``VptIsoShadeExt`` with h, the
    float32 2h (``central_value_gradient``'s) and the light direction."""
    from ..renderers import iso

    params, height, width = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the ISO shade kernel indexes "
                         "pixels with 32-bit integers")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, _, *ext) = \
        _build.scene_args(scene, scene.volume_packed, "ISO shade", ext=True)
    step = _build.f32(params.gradient_step)
    two_step = _build.f32(2.0 * step)
    light = tuple(iso.light_direction(scene, params).tolist())
    device = scene.volume.get_device()
    args = _Args(table, row, bf16, d, h, w, tw, tf_mode, width, height, step,
                 two_step, *light, device, *ext)
    return _build.Prepared(
        tensors=tensors, args=args, address=ctypes.addressof(args),
        device=device, shape=torch.Size((height, width, 4)),
        launch=_build.library().vpt_iso_shade_launch if device >= 0
        else None)


#: the last (scene, params, resolution)'s preparation: a renderer displays
#: one scene at one resolution again and again
_scene_cache = _build.LastScene(_prepare, _fields)


def shade(state, scene, params):
    """The shaded image of an ISO state (the nearest hit a pixel), (H, W,
    4): a new tensor."""
    if not state.is_cuda:
        return iso_shade_plain(state, scene, params)
    if _build.is_halo(scene):
        return halo_shade(state, scene, params)
    global LAUNCHES
    p = _scene_cache.get(scene, (params,) + tuple(state.shape[:2]))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("the iso state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a 16-byte boundary")
    out = state.new_empty(p.shape)
    err = p.launch(p.address, state.data_ptr(), out.data_ptr(),
                   _build.current_stream(p.device))
    if err:
        _build.check("vpt_iso_shade_launch", err)
    LAUNCHES += 1
    return out


def _halo_fields(scene):
    return (scene.slab_packed, scene.transfer_1d, scene.tf_mxu,
            scene.model_view, scene.transfer_packed)


class _HaloArgs(_Args):
    """``VptIsoHalo``: ``VptIsoShadeExt``, the slab's plane map, the
    display's scratch, the slab, the rows' index width and the shade's
    grid where no count is read."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("planes", "value", "pixel", "status", "ticket", "count")]
                + [(name, ctypes.c_int) for name in
                   ("slab_index", "num_slabs", "interleave", "masked",
                    "rows64", "shade_blocks")])


def _prepare_halo(scene, key):
    """What every halo display of ``key`` = (params, height, width, slab
    index, slabs, interleave, masked) takes of a HaloScene, checked once
    (``vpt_iso_halo_check``): the ``VptIsoHalo`` of its slab rows (32-bit
    rows below :data:`ROWS32` slab rows, else 64) and plane map, and the
    display's scratch: the slots' (n, TAPS, channels) values and pixels,
    the fetch's look-back words (one a tile of :data:`HALO_TILE` pixels),
    its ticket and the hits' count (zeroed), the pinned word the count is
    read into and the event it waits on; the shade's grid where no count
    is read is one wave of the card."""
    from ..renderers import iso

    params, height, width, *slab = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the ISO shade kernel indexes "
                         "pixels with 32-bit integers")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, _, _, _, _, tf_table,
              th, channels) = _build.slab_scene(scene)
    step = _build.f32(params.gradient_step)
    light = tuple(iso.light_direction(scene, params).tolist())
    dev = tensors[0].device
    n = height * width
    planes = _build.scene_plane_map(scene)
    scratch = {"value": torch.empty(n * TAPS * channels, dtype=torch.float32,
                                    device=dev),
               "pixel": torch.empty(n, dtype=torch.int32, device=dev),
               "status": torch.zeros(max(1, -(-n // HALO_TILE)),
                                     dtype=torch.int64, device=dev),
               "counts": torch.zeros(2, dtype=torch.int32, device=dev)}
    rows64 = int(tensors[0].shape[0] >= ROWS32)
    occ = halo_occupancy(1, tensors[0].dtype, tf_mode, dev.index, channels)
    shade_blocks = max(1, min(-(-n // occ["threads_per_block"]),
                              occ["blocks_per_sm"] * occ["sms"]))
    counts = scratch["counts"].data_ptr()
    args = _HaloArgs(table, row, bf16, d, h, w, tw, tf_mode, width, height,
                     step, _build.f32(2.0 * step), *light, dev.index,
                     tf_table, th, channels, 0, planes.data_ptr(),
                     scratch["value"].data_ptr(), scratch["pixel"].data_ptr(),
                     scratch["status"].data_ptr(), counts, counts + 4, *slab,
                     rows64, shade_blocks)
    lib = _build.library()
    _build.check("vpt_iso_halo_check",
                 lib.vpt_iso_halo_check(ctypes.addressof(args)))
    read = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    return _build.Prepared(
        tensors=(*tensors, planes), args=args, address=ctypes.addressof(args),
        device=dev.index, shape=torch.Size((height, width, 4)),
        scratch=scratch, value=scratch["value"], pixel=scratch["pixel"],
        channels=channels, epoch=0, read=read,
        count=ctypes.c_int.from_address(read.data_ptr()),
        event=torch.cuda.Event(), launch=lib.vpt_iso_halo_launch)


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_shade(state, scene, params):
    """The display of an ISO state over a HaloScene on the card: a launch
    of the halo instance's fetch (white where nothing was hit; each hit's
    pixel and its seven fetches' masked values at its slot, the slots in
    pixel order on every rank), one all-reduce of the hits' values alone
    (``HaloScene.reduce_``; the hits' count read from the card first, 4
    bytes; nothing read and nothing summed without a group, nor where
    nothing was hit) and a launch of its shade over the slots, where
    vpt_tpu and the plain twin sum each of the seven ``sample_color``
    calls of every pixel on its own (seven all-reduces): the same sums, so
    on one slab the image equals :func:`shade`'s on the whole scene bit
    for bit.  A new (H, W, 4) tensor."""
    global HALO_LAUNCHES, HALO_HITS
    if not state.is_cuda:
        return iso_shade_plain(state, scene, params)
    p = _halo_cache.get(scene, (params,) + tuple(state.shape[:2])
                        + (scene.slab_index, scene.num_slabs,
                           scene.interleave, int(scene.collective)))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    if state.dtype is not torch.float32 or state.shape != p.shape \
            or not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("the iso state must be a contiguous float32 "
                         f"{tuple(p.shape)} tensor on a 16-byte boundary")
    out = state.new_empty(p.shape)
    stream = _build.current_stream(p.device)
    p.epoch = p.epoch % (2 ** 30 - 1) + 1
    reduces = scene.reduces
    head = (p.address, state.data_ptr(), out.data_ptr(), p.epoch)
    _build.check("vpt_iso_halo_launch", p.launch(
        *head, 0, 0, p.read.data_ptr() if reduces else None, stream))
    hits = -1
    if reduces:
        p.event.record(torch.cuda.current_stream(p.device))
        p.event.synchronize()
        hits = HALO_HITS = p.count.value
        if hits:
            scene.reduce_(p.value[:TAPS * hits * p.channels])
    _build.check("vpt_iso_halo_launch",
                 p.launch(*head, 1, hits, None, stream))
    HALO_LAUNCHES += 2
    return out


def halo_occupancy(stage: int, table_dtype, tf_mode: int = 0,
                   device: int = 0, channels: int = 1,
                   rows64: bool = False) -> dict:
    """The launch shape of the halo instance's fetch (``stage`` 0, 64-bit
    rows or not) or shade (1), as :func:`occupancy`'s.  Launches
    nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 4 * (channels == 2) \
        | 16 * rows64
    _build.check("vpt_iso_halo_info", _build.library().vpt_iso_halo_info(
        stage, flags, tf_mode, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


#: the fields of :func:`occupancy`, in the order ``vpt_iso_shade_info``
#: writes them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes")


def occupancy(table_dtype, tf_mode: int = 0, device: int = 0,
              channels: int = 1, filtered: bool = False) -> dict:
    """The kernel's launch shape on CUDA ``device`` for a corner table of
    ``table_dtype``, the TF lookup mode ``tf_mode`` (``tf1d.mode_code``)
    and the fetch (``channels`` 2, or ``filtered``: an ext instance):
    threads a block, resident blocks an SM, SMs, registers and local
    (spill) bytes a thread, static shared memory a block.  Launches
    nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) \
        | 2 * (filtered and channels == 1) | 4 * (channels == 2)
    _build.check("vpt_iso_shade_info", _build.library().vpt_iso_shade_info(
        flags, tf_mode, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
