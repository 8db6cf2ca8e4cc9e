"""The MCS kernel: one progressive frame of single scattering.

There is no Pallas original: in ``vpt_tpu`` the frame is two XLA
``lax.while_loop``s over the pixel grid (``vpt_tpu/renderers/mcs.py:47-178``,
the free path and the shadow transmittance) and the incremental mean.
Here it is

- :func:`mcs_frame_plain`, ``renderers/mcs.generate`` and ``integrate`` on
  the scene with ``kernels=False``, on any device;
- the CUDA kernel ``csrc/mcs_frame.cu``: one thread a pixel runs both
  tracking loops to its own exit (the RNG, ray setup, corner fetch and TF
  lookup of ``csrc/ray.cuh`` and ``csrc/tf1d.cuh``), then the incremental
  mean, reading and writing its state once.

:func:`mcs_frame` takes the plain version for CPU state and launches the
kernel for CUDA state; it raises on what the kernel does not take
(unpacked scenes, environment maps larger than 1×1, images of 2^31 pixels
or more).  The frame's scatter direction is ``mcs.scatter_direction``,
computed on the host, where the plain version takes it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0


def mcs_frame_plain(state, scene, params, seed, frame_number):
    """One frame in plain PyTorch, in place on ``state``."""
    from ..renderers import mcs

    height, width = state.shape[:2]
    frame = mcs.generate(dataclasses.replace(scene, kernels=False), params,
                         seed, height, width)
    mcs.integrate(state, frame, frame_number)


def _fields(scene):
    return (scene.volume_packed, scene.tracking_packed, scene.transfer_1d,
            scene.mvp_inverse, scene.tf_mxu, scene.environment)


def _prepare(scene, key):
    from ..renderers import mcs

    env = _build.one_texel_environment(scene, "MCS")
    use_skip = scene.tracking_packed is not None
    tensors, args = _build.scene_args(
        scene, scene.tracking_packed if use_skip else scene.volume_packed,
        "MCS")
    cell = mcs.skip_cell_size(scene) if use_skip else 0.0
    return (*tensors, env), (*args, env.data_ptr()), (cell, int(use_skip))


_scene_cache = _build.LastScene(_prepare, _fields)


def launch_args(state, scene, params, seed, frame_number):
    """The arguments of one ``vpt_mcs_frame`` call for CUDA ``state``."""
    from ..renderers import mcs

    height, width = state.shape[:2]
    _build.check_image(state, (height, width, 4), state.device,
                       "the mcs state")
    _build.check_aligned(state, "the mcs state")
    if scene.device != state.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    _, args, (cell, use_skip) = _scene_cache.get(scene)
    direction = [float(x) for x in mcs.scatter_direction(seed)]
    # ctypes rounds each Python float to the nearest float32
    return (state.data_ptr(), *args, width, height, float(np.float32(seed)),
            float(np.float32(params.extinction)), cell, use_skip,
            *direction, float(np.float32(frame_number)),
            _build.stream_ptr(state))


def mcs_frame(state, scene, params, seed, frame_number):
    """One frame of MCS, generate and integrate, in place on ``state``."""
    if not state.is_cuda:
        mcs_frame_plain(state, scene, params, seed, frame_number)
        return
    global LAUNCHES
    args = launch_args(state, scene, params, seed, frame_number)
    with torch.cuda.device(state.device):
        _build.check("vpt_mcs_frame", _build.library().vpt_mcs_frame(*args))
    LAUNCHES += 1
