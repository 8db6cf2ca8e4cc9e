"""The LAO march kernel (K10): one frame of the LAO renderer.

There is no Pallas original: in ``vpt_tpu`` the frame is an XLA
``lax.scan`` over 64 slices (``vpt_tpu/renderers/lao.py:63-183``).  Here it
is

- :func:`lao_frame_plain`, ``renderers/lao.generate`` on the scene with
  ``kernels=False``, on any device;
- the CUDA kernel ``csrc/lao_march.cu``: one thread a pixel of an 8×4 warp
  tile marches its ray in registers, each slice taking the value and the
  six-tap raw gradient (the seven cells from each axis's coordinates
  computed once), the AO taps along the half-vector, the soft-shadow tap
  (the corner fetch of ``csrc/ray.cuh``), the 2D TF lookup of (value,
  |∇|) from the packed TF table and the composite, and leaves its loop once
  the pixel is inactive; it writes the frame into the state.  A
  two-channel or filtered scene, or ``baked_gradient``, runs the kernel's
  ext instance: every read through the scene's filter, channel 0 of a row
  of its channels, and with ``baked_gradient`` one two-channel read for
  (value, |∇|) in place of the seven gradient reads.

:func:`lao_frame` takes the plain version for CPU state and launches the
kernel for CUDA state; it raises on what the kernel does not take
(unpacked scenes, ``baked_gradient`` on one channel, images of 2^31 pixels
or more, ext scenes of :data:`ROWS32` rows or more) and never falls back.
What a launch takes of the scene, the Params and the resolution it
prepares once (``VptLaoArgs``, passed as one pointer),
computing with the plain version's own functions on the scene's device what
it needs of them: the per-pixel random value ``rx`` (an (H, W) tensor), the
constant ``rconst``, the light and the AO taps, so that the kernel reads
the bits the plain version computes and evaluates no ``cos``/``sin`` itself.
Corner rows are indexed with 32-bit integers in tables of fewer than
:data:`ROWS32` rows, else with 64.

A frame over a ``parallel.halo.HaloScene`` (a rank's z slab) runs the
kernel's halo instance on the card (:func:`halo_lao_frame`): ceil(slices /
:data:`HALO_CHUNK`) + 1 launches around an all-reduce of each chunk's
masked tap values, each tap placed in the slab through the slab's plane
map (``_build.slab_plane_map``) and its row indexed with 32 bits below
:data:`ROWS32` slab rows; its plain twin is :func:`lao_frame_plain` over
the same scene.
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
#: slices a halo fetch samples (``kHaloChunk``)
HALO_CHUNK = 8
#: corner tables of fewer rows than this index them with 32-bit integers,
#: larger ones with 64
ROWS32 = 2 ** 31


def lao_frame_plain(state, scene, params, window=None):
    """One frame in plain PyTorch, written into ``state``."""
    from ..renderers import lao

    height, width = state.shape[:2]
    state.copy_(lao.generate(dataclasses.replace(scene, kernels=False),
                             params, 0.0, height, width, window=window))


class _Args(ctypes.Structure):
    """``VptLaoExt`` of ``csrc/lao_march.cu``: the ``VptLaoArgs`` fields,
    the ext instances' and the row window."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("table", "tf_table", "mvp", "rx", "taps")]
                + [(name, ctypes.c_int) for name in
                   ("table_bf16", "tf_bf16", "d", "h", "w", "tw", "th",
                    "width", "height", "slices", "n_taps", "lao_samples",
                    "lao_on", "soft_on")]
                + [(name, ctypes.c_float) for name in
                   ("step", "extinction", "lao_weight", "soft_weight",
                    "light_radius", "light_coefficient", "lx", "ly", "lz",
                    "rconst")]
                + [(name, ctypes.c_int) for name in ("device", "rows64")]
                + [(name, ctypes.c_int) for name in
                   ("channels", "filter", "baked", "row0", "full_height")])


class _HaloArgs(_Args):
    """``VptLaoHalo``: ``VptLaoExt`` and the slab's plane map."""
    _fields_ = [("planes", ctypes.c_void_p)]


def _fields(scene):
    return (scene.volume_packed, scene.transfer_packed, scene.mvp_inverse,
            scene.filter)


def _transfer_table(scene):
    """The scene's packed (TH·TW, 16) float32 or bfloat16 TF table, checked
    and contiguous: the kernel's 2D TF lookup reads no other."""
    table = scene.transfer_packed
    if table is None:
        raise NotImplementedError(
            "the LAO kernel reads the packed TF table only, and this scene "
            "has none: build it with make_scene (pack=True, or any scene on "
            "the card)")
    th, tw = scene.transfer.shape[:2]
    if table.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(table.shape) != (th * tw, 16):
        raise ValueError("the packed TF table must be (TH*TW, 16) float32 "
                         "or bfloat16")
    table = table.contiguous()
    _build.check_aligned(table, "the packed TF table")
    return table


def _frame_inputs(scene, params, height, width, row0, full_height):
    """What the kernel reads of the plain version's setup, computed with
    its own functions on the scene's device: the per-pixel random value
    ``rx``, the constant ``rconst``, the light and the AO taps (a (T, 4)
    float32 tensor of t2, light_radius·t2, the weight and 0)."""
    from ..renderers import lao

    device = scene.device
    rx = lao.pixel_random(height, width, device,
                          window=(row0, full_height)).contiguous()
    rconst = float(lao.random_constant(device))
    light = lao.light_of(scene, params).tolist()
    rows = lao.lao_taps(params)
    taps = torch.zeros((max(len(rows), 1), 4), dtype=torch.float32)
    taps[:len(rows), :3] = torch.from_numpy(rows)
    return rx, rconst, light, taps.to(device), len(rows)


def _args(table, bf16, d, h, w, mvp, tf, th, tw, params, height, width,
          inputs, device, rows64, channels, filt, row0, full_height,
          cls=_Args):
    """The ``VptLaoExt`` of a frame: the scene's pointers and sizes, the
    Params, the resolution and its window, and :func:`_frame_inputs`."""
    rx, rconst, light, taps, n_taps = inputs

    def f32(v):
        return float(np.float32(v))

    return cls(table, tf.data_ptr(), mvp, rx.data_ptr(), taps.data_ptr(),
                 bf16, int(tf.dtype == torch.bfloat16), d, h, w, tw, th,
                 width, height, params.slices, n_taps,
                 params.num_lao_samples, int(params.local_ambient_occlusion),
                 int(params.soft_shadows), f32(1.0 / params.slices),
                 f32(params.extinction), f32(params.lao_weight),
                 f32(params.soft_shadows_weight), f32(params.light_radius),
                 f32(params.light_coefficient), *light, rconst, device,
                 rows64, channels, filt, int(params.baked_gradient), row0,
                 full_height)


def _prepare(scene, key):
    """What every frame of ``key`` = (params, height, width), then (row0,
    full_height) for a window other than the whole image
    (``_build.window_key``), takes of the scene: the checked tensors, the
    plain version's ``rx``, ``rconst``, light and AO taps, and the
    ``VptLaoArgs``."""
    from ..renderers import lao

    params, height, width, *window = key
    row0, full_height = window or (0, height)
    lao.check_params(params, scene)
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the LAO kernel indexes pixels "
                         "with 32-bit integers")
    tensors, (table, bf16, d, h, w, _, _, _, mvp, _, _, channels, filt) = \
        _build.scene_args(scene, scene.volume_packed, "LAO", ext=True)
    tf = _transfer_table(scene)
    th, tw = scene.transfer.shape[:2]
    rows64 = int(d * h * w >= ROWS32)
    if (channels, filt, params.baked_gradient) != (1, 0, False):
        # the ext instances: 32-bit rows, and a TF of the rows' type
        if rows64:
            raise ValueError(f"{d}x{h}x{w}: the LAO kernel's two-channel "
                             "and filtered instances index corner rows "
                             "with 32-bit integers")
        if tf.dtype != tensors[0].dtype:
            raise ValueError("the LAO kernel's two-channel and filtered "
                             "instances take a packed TF table of the "
                             "corner table's dtype")
    inputs = _frame_inputs(scene, params, height, width, row0, full_height)
    args = _args(table, bf16, d, h, w, mvp, tf, th, tw, params, height,
                 width, inputs, scene.volume.get_device(), rows64, channels,
                 filt, row0, full_height)
    lib = _build.library() if args.device >= 0 else None
    rx, _, _, taps, _ = inputs
    return _build.Prepared(
        tensors=(*tensors, tf, rx, taps), args=args,
        address=ctypes.addressof(args), device=args.device,
        shape=torch.Size((height, width, 4)), rx=rx,
        launch=lib.vpt_lao_launch if lib else None,
        count=lib.vpt_lao_count if lib else None)


#: the last (scene, params, resolution)'s preparation
_scene_cache = _build.LastScene(_prepare, _fields)


def lao_frame(state, scene, params, counts=None, window=None):
    """One LAO frame written into ``state`` (H, W, 4).  ``counts``: None,
    or a CUDA int64 tensor of 2 on the state's device to which the frame
    adds its pixels' active slices (the lane-slices that do work) and the
    slices its warps step through (lane-slices over 32 times those is the
    share of the lanes that work).  ``window``: None, or ``(row0,
    full_height)``: the state holds those rows of the image
    (``sampling.pixel_ndc``)."""
    if not state.is_cuda:
        if counts is not None:
            raise ValueError("the plain LAO frame counts nothing")
        lao_frame_plain(state, scene, params, window)
        return
    if _build.is_halo(scene):
        if counts is not None:
            raise ValueError("the LAO halo frame counts nothing")
        halo_lao_frame(state, scene, params, window)
        return
    global LAUNCHES
    p = _scene_cache.get(scene, (params,) + tuple(state.shape[:2])
                         + _build.window_key(window, state.shape[0]))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    _build.check_image(state, p.shape, state.device, "the lao state")
    _build.check_aligned(state, "the lao state")
    if counts is not None and (
            counts.dtype is not torch.int64 or counts.shape != (2,)
            or counts.get_device() != p.device
            or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int64 (2,) tensor on "
                         "the state's device")
    stream = _build.current_stream(p.device)
    if counts is None:
        err = p.launch(p.address, state.data_ptr(), stream)
    else:
        err = p.count(p.address, state.data_ptr(), counts.data_ptr(), stream)
    if err:
        _build.check("vpt_lao_launch", err)
    LAUNCHES += 1


def _halo_fields(scene):
    return (scene.slab_packed, scene.transfer_packed, scene.mvp_inverse)


def halo_values(params) -> int:
    """The values a pixel-slice of the halo instance sums
    (``lao_halo_values``): the raw gradient's three differences and the
    value (with ``baked_gradient`` the (value, |∇|) pair), the AO taps'
    weighted sum and the shadow tap; a two-channel volume sums channel 0
    of each, or the baked pair."""
    return (2 if params.baked_gradient else 4) \
        + int(params.local_ambient_occlusion) + int(params.soft_shadows)


def _prepare_halo(scene, key):
    """What every halo frame of ``key`` = (params, height, width, row0,
    full_height) takes of a HaloScene: the ``VptLaoHalo`` of its slab rows
    (no filter; 32-bit rows below :data:`ROWS32` slab rows, else 64) and
    its plane map (``_build.slab_plane_map``), and the chunk's values,
    (HALO_CHUNK, values, n) float32, zero before the first frame (the
    kernel keeps them so between frames)."""
    from ..renderers import lao

    params, height, width, row0, full_height = key
    lao.check_params(params, scene)
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the LAO kernel indexes pixels "
                         "with 32-bit integers")
    values = HALO_CHUNK * halo_values(params) * height * width
    if values >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the LAO halo instance indexes "
                         f"its {values} chunk values with 32-bit integers")
    tensors, (table, bf16, d, h, w, _, _, _, _, _, _, mvp, _, _,
              channels) = _build.slab_scene(scene)
    tf = _transfer_table(scene)
    if channels == 2 and tf.dtype != tensors[0].dtype:
        raise ValueError("the LAO halo instance of two channels takes a "
                         "packed TF table of the slab rows' dtype")
    th, tw = scene.transfer.shape[:2]
    dev = tensors[0].device
    device = dev.index if dev.type == "cuda" else -1
    planes = _build.scene_plane_map(scene)
    inputs = _frame_inputs(scene, params, height, width, row0, full_height)
    rows64 = int(tensors[0].shape[0] >= ROWS32)
    args = _args(table, bf16, d, h, w, mvp, tf, th, tw, params, height,
                 width, inputs, device, rows64, channels, 0, row0,
                 full_height, _HaloArgs)
    args.planes = planes.data_ptr()
    rx, _, _, taps, _ = inputs
    value = torch.zeros(values, dtype=torch.float32, device=dev)
    return _build.Prepared(
        tensors=(*tensors, tf, rx, taps, planes), args=args,
        address=ctypes.addressof(args), device=device,
        shape=torch.Size((height, width, 4)),
        chunks=-(-params.slices // HALO_CHUNK), value=value,
        launch=_build.library().vpt_lao_halo_launch)


_halo_cache = _build.LastScene(_prepare_halo, _halo_fields)


def halo_lao_frame(state, scene, params, window=None):
    """One LAO frame over a HaloScene on the card, written into CUDA
    ``state``: ``C = ceil(slices / HALO_CHUNK)`` all-reduces
    (``HaloScene.reduce_`` of the chunk's masked values of each of
    HALO_CHUNK slices: the raw gradient's three differences and the value,
    or the baked pair, the AO taps' weighted sum and the shadow tap, each
    summed over the rank's own taps first, where vpt_tpu and the plain
    twin sum each tap's fetch a slice) between ``C + 1`` launches of the
    halo instance: launch e folds chunk e − 1's summed values (K10's
    fold) and writes chunk e's masked values from this rank's slab rows;
    the state holds the accumulator between launches, and the last writes
    the frame.  Equal bit for bit to :func:`lao_frame` on the whole scene:
    only the owner's value is non-zero; over several slabs the AO sum adds
    the owners' partial sums (the rest is exact).  The slabs may be
    interleaved, the fetch unmasked, the volume two-channel (channel 0, or
    the baked pair).  ``window`` as in :func:`lao_frame`."""
    global HALO_LAUNCHES
    from .. import sampling

    if not state.is_cuda:
        lao_frame_plain(state, scene, params, window)
        return
    height, width = state.shape[:2]
    p = _halo_cache.get(scene, (params, height, width)
                        + sampling.row_window(window, height))
    if state.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    _build.check_image(state, p.shape, state.device, "the lao state")
    _build.check_aligned(state, "the lao state")
    stream = _build.current_stream(p.device)
    head = (p.address, scene.slab_index, scene.num_slabs, scene.interleave,
            int(scene.collective), p.value.data_ptr(), state.data_ptr())
    for chunk in range(p.chunks + 1):
        _build.check("vpt_lao_halo_launch", p.launch(*head, chunk, stream))
        HALO_LAUNCHES += 1
        if chunk < p.chunks:
            scene.reduce_(p.value)


#: the fields of :func:`occupancy`, in the order ``vpt_lao_info`` writes
#: them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "tile_width", "tile_height", "warp_width", "group")


def occupancy(table_dtype, tf_dtype=None, rows64: bool = False,
              device: int = 0, channels: int = 1, filtered: bool = False,
              baked: bool = False) -> dict:
    """The kernel's launch shape on CUDA ``device`` for a corner table of
    ``table_dtype``, a packed TF table of ``tf_dtype`` (default: the same),
    32-bit (or, ``rows64``, 64-bit) row indices and the fetch (``channels``
    2, ``filtered`` or ``baked``: an ext instance): threads a block,
    resident blocks an SM, SMs, registers and local (spill) bytes a thread,
    static shared memory a block, its pixel tile and the AO taps it reads
    ahead of their fold.  Launches nothing."""
    tf_dtype = table_dtype if tf_dtype is None else tf_dtype
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) \
        | 2 * (filtered and channels == 1) | 4 * (channels == 2) \
        | 8 * bool(baked)
    _build.check("vpt_lao_info", _build.library().vpt_lao_info(
        flags, int(tf_dtype == torch.bfloat16), int(rows64), device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


def halo_occupancy(table_dtype, tf_dtype=None, device: int = 0,
                   channels: int = 1, baked: bool = False,
                   rows64: bool = False) -> dict:
    """The halo instance's launch shape, as :func:`occupancy`'s
    (``group``: the slices of a fetch, HALO_CHUNK; the plane map's D·8
    bytes of shared memory a block come on top), with 32-bit (or,
    ``rows64``, 64-bit) slab rows.  Launches nothing."""
    tf_dtype = table_dtype if tf_dtype is None else tf_dtype
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    flags = int(table_dtype == torch.bfloat16) | 4 * (channels == 2) \
        | 8 * bool(baked) | 16 * bool(rows64)
    _build.check("vpt_lao_halo_info", _build.library().vpt_lao_halo_info(
        flags, int(tf_dtype == torch.bfloat16), device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


def halo_frame_launches(params) -> int:
    """The halo instance's launches a frame of ``params``: ceil(slices /
    HALO_CHUNK) + 1."""
    return -(-params.slices // HALO_CHUNK) + 1
