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
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0


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
    global LAUNCHES
    _build.refuse_halo(scene, "an MCS frame (K8)", "7")
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
