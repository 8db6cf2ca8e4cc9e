"""The march kernel: one progressive frame of a fixed-schedule renderer.

There is no Pallas original: in ``vpt_tpu`` a frame of EAM, MIP, Depth or
ISO is an XLA ``lax.scan`` (``vpt_tpu/renderers/_march.py:29-55``) over the
slices, folding the renderer's composite, then its integrate.  Here it is

- :func:`march_frame_plain`, the renderer's plain PyTorch ``generate`` and
  ``integrate`` on the scene with ``kernels=False``, on any device;
- the CUDA kernel ``csrc/march.cu``: one thread a pixel computes its ray
  from the pixel index, runs the slice loop (the corner fetch of
  ``csrc/ray.cuh`` and the TF lookup of ``csrc/tf1d.cuh``) with the
  renderer's composite in registers, and integrates into the state in
  place, reading and writing it once.

:func:`march_frame` takes the plain version for CPU state and launches the
kernel for CUDA state; it raises on what the kernel does not take
(unpacked scenes, images of 2^31 pixels or more) and never falls back.
What a launch needs of the scene it prepares once per scene; the frame's
scalars (the schedule's first parameter and step, the running
mean's weight) are float32 values computed on the host, the ones the plain
version uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0

#: the kernel's code for each renderer's composite (``csrc/march.cu``)
MODES = {"eam": 0, "mip": 1, "depth": 2, "iso": 3}


def _module(mode):
    from ..renderers import depth, eam, iso, mip

    return {"eam": eam, "mip": mip, "depth": depth, "iso": iso}[mode]


def state_shape(mode, height, width):
    return (height, width) if mode == "mip" else (height, width, 4)


def march_frame_plain(mode, state, scene, params, seed, frame_number):
    """One frame of renderer ``mode`` in plain PyTorch, in place on
    ``state``."""
    module = _module(mode)
    height, width = state.shape[:2]
    frame = module.generate(dataclasses.replace(scene, kernels=False),
                            params, seed, height, width)
    module.integrate(state, frame, frame_number)


def _fields(scene):
    return (scene.volume_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.tf_mxu)


def _prepare(scene, key):
    return _build.scene_args(scene, scene.volume_packed, "march")


_scene_cache = _build.LastScene(_prepare, _fields)


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


def launch_args(mode, state, scene, params, seed, frame_number):
    """The arguments of one ``vpt_march_frame`` call for CUDA ``state``."""
    height, width = state.shape[:2]
    _build.check_image(state, state_shape(mode, height, width), state.device,
                       f"the {mode} state")
    if scene.device != state.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    _, args = _scene_cache.get(scene)
    return (state.data_ptr(), MODES[mode], *args, width, height,
            *frame_scalars(mode, params, seed, frame_number),
            _build.stream_ptr(state))


def march_frame(mode, state, scene, params, seed, frame_number):
    """One frame of renderer ``mode`` ("eam", "mip", "depth" or "iso"),
    generate and integrate, in place on ``state``."""
    if mode not in MODES:
        raise ValueError(f"unknown march mode {mode!r}")
    if not state.is_cuda:
        march_frame_plain(mode, state, scene, params, seed, frame_number)
        return
    global LAUNCHES
    args = launch_args(mode, state, scene, params, seed, frame_number)
    # the stream and the shared-memory opt-in belong to the state's device
    with torch.cuda.device(state.device):
        _build.check("vpt_march_frame",
                     _build.library().vpt_march_frame(*args))
    LAUNCHES += 1
