"""The MCM event machine: one progressive frame of null-collision events.

There is no Pallas original: in ``vpt_tpu`` the frame is an XLA
``fori_loop`` (``vpt_tpu/renderers/mcm.py:197-310``) over ``flight_phase``,
``Scene.sample_color_tracking`` and ``interact_phase``.  Here it is

- :func:`event_frame_plain`, a Python loop over the plain PyTorch phases of
  ``renderers/mcm.py``, on any device;
- the CUDA kernel ``csrc/mcm_event.cu``: one thread per pixel runs all
  ``steps`` events with the photon in registers, fetching one corner row
  per event and looking the TF up in shared memory (``csrc/tf1d.cuh``).

:func:`event_frame` takes the plain loop for CPU state and launches the
kernel for CUDA state; both update the state tensors in place.  For CUDA
state it raises on what the kernel does not take: unpacked scenes and
environment maps larger than 1×1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng, sampling
from . import _build, tf1d

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0

_VEC3 = ("position", "direction", "transmittance", "radiance")
_SCALAR = ("bounces", "samples")


def event_frame_plain(state, scene, params, seed):
    """``params.steps`` events for every pixel in plain PyTorch."""
    from ..renderers import mcm

    height, width = state["position"].shape[:2]
    dev = state["position"].device
    ndc = sampling.pixel_ndc(height, width, device=dev)
    inv_res = mcm.inverse_resolution(height, width, dev)
    # per-pixel stream: hash(uvec3(bits(mapped.xy), bits(seed))) (glsl:128)
    rstate = rng.seed_pixels(ndc * 0.5 + 0.5, np.float32(seed))
    use_skip = mcm.uses_skip(state, scene)
    cell = mcm.skip_cell_size(scene) if use_skip else None
    ph = dict(state)
    for _ in range(params.steps):
        rstate, position = mcm.flight_phase(ph, rstate, params, use_skip,
                                            cell)
        if use_skip:
            vs, cheb_new = scene.sample_color_tracking(
                position, lookup=tf1d.lookup_plain)
        else:
            vs = scene.sample_color(position, lookup=tf1d.lookup_plain)
            cheb_new = None
        ph, rstate = mcm.interact_phase(ph, rstate, position, vs, cheb_new,
                                        scene, params, ndc, inv_res,
                                        use_skip)
    for key, value in state.items():
        value.copy_(ph[key])


def _check_state(state, height, width, device):
    for key in _VEC3 + _SCALAR + (("cheb",) if "cheb" in state else ()):
        t = state[key]
        want = (height, width, 3) if key in _VEC3 else (height, width)
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"mcm state {key!r} must be a contiguous "
                             f"float32 {want} tensor on {device}")


def event_frame(state, scene, params, seed):
    """One frame of ``params.steps`` events, in place on ``state``."""
    position = state["position"]
    if not position.is_cuda:
        event_frame_plain(state, scene, params, seed)
        return
    from ..renderers import mcm

    global LAUNCHES
    dev = position.device
    height, width = position.shape[:2]
    _check_state(state, height, width, dev)
    if scene.device != dev:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{dev}")
    use_skip = mcm.uses_skip(state, scene)
    table = scene.tracking_packed if use_skip else scene.volume_packed
    if table is None:
        raise NotImplementedError(
            "the MCM event kernel samples corner-packed tables only; build "
            "the scene with pack=True")
    if tuple(scene.environment.shape[:2]) != (1, 1):
        raise NotImplementedError(
            "the MCM event kernel takes 1x1 environment maps only "
            "(ROADMAP.md queue 2, equirect environments in K5)")
    d, h, w = scene.volume.shape[:3]
    if table.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(table.shape) != (d * h * w, 8):
        raise ValueError("the corner table must be (D*H*W, 8) float32 or "
                         "bfloat16")
    row = scene.transfer_1d
    tf1d.check_width(row.shape[0])
    table = table.contiguous()
    row = row.to(torch.float32).contiguous()
    _build.check_aligned(table, "the corner table")
    _build.check_aligned(row, "the TF row")
    env = scene.environment[0, 0].to(torch.float32).contiguous()
    mvp = scene.mvp_inverse.to(torch.float32).contiguous()
    ndc = sampling.pixel_ndc(height, width, device=dev)
    cheb = state["cheb"].data_ptr() if use_skip else None
    lib = _build.library()
    # ctypes rounds each Python float to the nearest float32, as
    # np.float32 and JAX's weak types do
    _build.check("vpt_mcm_event", lib.vpt_mcm_event(
        state["position"].data_ptr(), state["direction"].data_ptr(),
        state["bounces"].data_ptr(), state["transmittance"].data_ptr(),
        state["radiance"].data_ptr(), state["samples"].data_ptr(), cheb,
        table.data_ptr(), int(table.dtype == torch.bfloat16), d, h, w,
        row.data_ptr(), row.shape[0], env.data_ptr(), mvp.data_ptr(),
        ndc.data_ptr(), 1.0 / width, 1.0 / height, float(seed),
        params.extinction, params.anisotropy, params.blur,
        mcm.skip_cell_size(scene), params.max_bounces, params.steps,
        int(use_skip), height * width, _build.stream_ptr(position)))
    LAUNCHES += 1
