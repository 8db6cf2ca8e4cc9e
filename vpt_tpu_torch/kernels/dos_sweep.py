"""The DOS slice kernel (K9): one frame of DOS's slice sweep.

There is no Pallas original: in ``vpt_tpu`` a frame is an XLA ``lax.scan``
over the slices (``vpt_tpu/renderers/dos.py:126-212``, the taps of
``_shifted_occlusion_taps`` ``:43-86``).  Here it is

- :func:`sweep_frame_plain`, ``renderers/dos.composite_slices`` on the
  scene with ``kernels=False``, on any device;
- the CUDA kernel ``csrc/dos_sweep.cu``: one launch a slice, one thread a
  pixel, which unprojects the pixel at the slice's NDC depth, takes one
  colour fetch (the corner fetch of ``csrc/ray.cuh``, the TF lookup of
  ``csrc/tf1d.cuh``), composites it into the colour state in place and
  writes the new occlusion (the mean of the disk taps of the previous
  buffer times the slice transmittance) into the other of two occlusion
  buffers.  One C call issues the frame's ``steps`` launches.

Every slice reads its neighbours' previous occlusion, so a slice is a step
across the whole image: the launches ping-pong the state's occlusion buffer
and a scratch buffer of the same shape, and the state ends with the buffer
that holds the last slice's (the scratch one when ``steps`` is odd).

:func:`sweep_frame` takes the plain version for CPU state and launches the
kernel for CUDA state; it raises on what the kernel does not take
(unpacked scenes, images of 2^31 pixels or more) and never falls back.
Both read the frame's per-slice constants (NDC depth, active flag, slice
distance, each tap's shift and fraction) from ``dos.slice_table``, built on
the state's device, so they hold the same bits and the frame reads nothing
back to the host.  What a launch takes of the scene, the Params and the
resolution it prepares once (``VptDosArgs``, passed as one pointer).
:data:`LAUNCHES` counts kernel launches: ``steps`` a frame.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build

#: kernel launches (one a slice) since the last reset (set to 0 to reset)
LAUNCHES = 0


def sweep_frame_plain(state, scene, params):
    """One frame of DOS in plain PyTorch, in place on the state."""
    from ..renderers import dos

    table = dos.slice_table(state, scene, params)
    dos.composite_slices(state, dataclasses.replace(scene, kernels=False),
                         params, table)
    dos.advance_depth(state, table)


class _Args(ctypes.Structure):
    """``VptDosArgs`` of ``csrc/dos_sweep.cu``."""
    _fields_ = [("table", ctypes.c_void_p), ("tf_row", ctypes.c_void_p),
                ("mvp", ctypes.c_void_p), ("table_bf16", ctypes.c_int),
                ("d", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("tw", ctypes.c_int), ("tf_mode", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("samples", ctypes.c_int), ("extinction", ctypes.c_float),
                ("device", ctypes.c_int)]


def _fields(scene):
    return (scene.volume_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.tf_mxu)


def _prepare(scene, key):
    """What every frame of ``key`` = (params, height, width) takes of the
    scene: the checked tensors and the ``VptDosArgs``."""
    params, height, width = key
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the DOS kernel indexes pixels "
                         "with 32-bit integers")
    tensors, (table, bf16, d, h, w, row, tw, tf_mode, mvp) = \
        _build.scene_args(scene, scene.volume_packed, "DOS")
    device = scene.volume.get_device()
    args = _Args(table, row, mvp, bf16, d, h, w, tw, tf_mode, width, height,
                 params.samples, float(np.float32(params.extinction)), device)
    return _build.Prepared(
        tensors=tensors, args=args, address=ctypes.addressof(args),
        device=device, color_shape=torch.Size((height, width, 4)),
        occlusion_shape=torch.Size((height, width)),
        launch=_build.library().vpt_dos_sweep_launch if device >= 0
        else None)


#: the last (scene, params, resolution)'s preparation
_scene_cache = _build.LastScene(_prepare, _fields)


def sweep_frame(state, scene, params):
    """``params.steps`` slices of the sweep, in place on the DOS state
    (whose ``occlusion`` entry may become the other buffer), then the
    depth advanced by the active slices."""
    from ..renderers import dos

    color, occlusion = state["color"], state["occlusion"]
    if not color.is_cuda:
        sweep_frame_plain(state, scene, params)
        return
    global LAUNCHES
    p = _scene_cache.get(scene, (params,) + tuple(color.shape[:2]))
    if color.get_device() != p.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{color.device}")
    _build.check_image(color, p.color_shape, color.device, "the DOS color")
    _build.check_image(occlusion, p.occlusion_shape, color.device,
                       "the DOS occlusion")
    _build.check_aligned(color, "the DOS color")
    if tuple(state["offsets"].shape) != (params.samples, 2):
        raise ValueError(f"the DOS offsets must be ({params.samples}, 2)")
    table = dos.slice_table(state, scene, params)
    scratch = occlusion.new_empty(occlusion.shape)
    err = p.launch(p.address, color.data_ptr(), occlusion.data_ptr(),
                   scratch.data_ptr(), table.data_ptr(), params.steps,
                   _build.current_stream(p.device))
    if err:
        _build.check("vpt_dos_sweep_launch", err)
    LAUNCHES += params.steps
    if params.steps % 2:
        state["occlusion"] = scratch
    dos.advance_depth(state, table)


#: the fields of :func:`occupancy`, in the order ``vpt_dos_sweep_info``
#: writes them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes")


def occupancy(table_dtype, tf_mode: int = 0, device: int = 0) -> dict:
    """The slice kernel's launch shape on CUDA ``device`` for a corner
    table of ``table_dtype`` and the TF lookup mode ``tf_mode``
    (``tf1d.mode_code``): threads a block, resident blocks an SM, SMs,
    registers and local (spill) bytes a thread, static shared memory a
    block.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    _build.check("vpt_dos_sweep_info", _build.library().vpt_dos_sweep_info(
        int(table_dtype == torch.bfloat16), tf_mode, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
