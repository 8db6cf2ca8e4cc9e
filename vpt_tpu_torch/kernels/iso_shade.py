"""The ISO shade kernel: the ISO renderer's display.

There is no Pallas original: in ``vpt_tpu`` the display is XLA work
(``vpt_tpu/renderers/iso.py:109-130``): six TF fetches for the
central-difference gradient, the normal, the Lambert term against the
texture-space light and the material color at the hit.  Here it is

- :func:`iso_shade_plain`, ``renderers/iso.shade`` on the scene with
  ``kernels=False``, on any device;
- the CUDA kernel ``csrc/iso_shade.cu``: one thread a pixel, the seven
  fetches and TF lookups of ``csrc/ray.cuh`` and ``csrc/tf1d.cuh``, white
  where nothing was hit.

:func:`shade` takes the plain version for CPU state and launches the kernel
for CUDA state; it raises on what the kernel does not take (unpacked
scenes, images of 2^31 pixels or more).  The light direction is computed
once per (scene, light) by the plain version's own function on the scene's
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0


def iso_shade_plain(state, scene, params):
    """The display in plain PyTorch: (H, W, 4)."""
    from ..renderers import iso

    return iso.shade(state, dataclasses.replace(scene, kernels=False),
                     params)


def _fields(scene):
    return (scene.volume_packed, scene.transfer_1d, scene.mvp_inverse,
            scene.tf_mxu, scene.model_view)


def _prepare(scene, light):
    from ..renderers import iso

    tensors, args = _build.scene_args(scene, scene.volume_packed,
                                      "ISO shade")
    direction = iso.light_direction(scene, iso.Params(light=light))
    return tensors, args[:-1], tuple(float(x) for x in direction.tolist())


_scene_cache = _build.LastScene(_prepare, _fields)


def shade(state, scene, params):
    """The shaded image of an ISO state (the nearest hit a pixel), (H, W,
    4): a new tensor."""
    if not state.is_cuda:
        return iso_shade_plain(state, scene, params)
    global LAUNCHES
    height, width = state.shape[:2]
    _build.check_image(state, (height, width, 4), state.device,
                       "the iso state")
    _build.check_aligned(state, "the iso state")
    if scene.device != state.device:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{state.device}")
    _, args, light = _scene_cache.get(scene, tuple(params.light))
    out = state.new_empty((height, width, 4))
    step = np.float32(params.gradient_step)
    with torch.cuda.device(state.device):
        _build.check("vpt_iso_shade", _build.library().vpt_iso_shade(
            state.data_ptr(), out.data_ptr(), *args, width, height,
            float(step), float(2 * step), *light, _build.stream_ptr(state)))
    LAUNCHES += 1
    return out
