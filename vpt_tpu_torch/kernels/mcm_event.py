"""The MCM event machine: one progressive frame of null-collision events.

There is no Pallas original: in ``vpt_tpu`` the frame is an XLA
``fori_loop`` (``vpt_tpu/renderers/mcm.py:197-310``) over ``flight_phase``,
``Scene.sample_color_tracking`` and ``interact_phase``.  Here it is

- :func:`event_frame_plain`, a Python loop over the plain PyTorch phases of
  ``renderers/mcm.py``, on any device;
- the CUDA kernel ``csrc/mcm_event.cu``: one thread a pixel keeps its
  photon in registers for all ``steps`` events (flight, one corner row, the
  TF lookup of ``csrc/tf1d.cuh``, classification, then the deposit and
  reset or the scatter), computing its NDC and stream seed from the pixel
  index.

:func:`event_frame` takes the plain loop for CPU state and launches the
kernel for CUDA state; both update the state tensors in place.  For CUDA
state it raises on what the kernel does not take: unpacked scenes,
environment maps larger than 1×1 and images of 2^31 pixels or more.  What a
launch needs of the scene it prepares once per (scene, resolution); a frame
then does no tensor work besides the launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

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
    scene = dataclasses.replace(scene, kernels=False)
    ph = dict(state)
    for _ in range(params.steps):
        rstate, position = mcm.flight_phase(ph, rstate, params, use_skip,
                                            cell)
        if use_skip:
            vs, cheb_new = scene.sample_color_tracking(position)
        else:
            vs, cheb_new = scene.sample_color(position), None
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


@dataclasses.dataclass
class _Prepared:
    """What the launches of one (scene, table, resolution) share: the
    tensors whose pointers they pass (held so the pointers stay valid) and
    the launch arguments that come from the scene.  It holds the scene
    weakly: when the scene goes, so does the preparation and what it
    holds."""
    scene: weakref.ref
    fields: tuple
    tensors: tuple
    args: tuple


#: the last preparation; a renderer launches one scene at one resolution
#: frame after frame
_prepared = None


def _forget(ref):
    global _prepared
    if _prepared is not None and _prepared.scene is ref:
        _prepared = None


def _scene_fields(scene, table):
    return (table, scene.transfer_1d, scene.environment, scene.mvp_inverse,
            scene.tf_mxu)


def _prepare(scene, use_skip, height, width):
    """Check the scene and build the scene's part of the launch arguments,
    unless the last call did for this scene, table and resolution."""
    global _prepared
    table = scene.tracking_packed if use_skip else scene.volume_packed
    p = _prepared
    if p is not None and p.scene() is scene \
            and p.args[-2:] == (width, height) \
            and all(a is b for a, b in zip(p.fields,
                                           _scene_fields(scene, table))):
        return p
    if table is None:
        raise NotImplementedError(
            "the MCM event kernel samples corner-packed tables only; build "
            "the scene with pack=True")
    if tuple(scene.environment.shape[:2]) != (1, 1):
        raise NotImplementedError(
            "the MCM event kernel takes 1x1 environment maps only "
            "(ROADMAP.md queue 2, equirect environments in K5)")
    if height * width >= 2 ** 31:
        raise ValueError(f"{height}x{width}: the MCM event kernel indexes "
                         "pixels with 32-bit integers")
    d, h, w = scene.volume.shape[:3]
    if table.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(table.shape) != (d * h * w, 8):
        raise ValueError("the corner table must be (D*H*W, 8) float32 or "
                         "bfloat16")
    row = scene.transfer_1d
    tf1d.check_width(row.shape[0])
    fields = _scene_fields(scene, table)
    table = table.contiguous()
    row = row.to(torch.float32).contiguous()
    _build.check_aligned(table, "the corner table")
    _build.check_aligned(row, "the TF row")
    env = scene.environment[0, 0].to(torch.float32).contiguous()
    mvp = scene.mvp_inverse.to(torch.float32).contiguous()
    args = (table.data_ptr(), int(table.dtype == torch.bfloat16), d, h, w,
            row.data_ptr(), row.shape[0], tf1d.mode_code(scene.tf_mxu),
            env.data_ptr(), mvp.data_ptr(), width, height)
    _prepared = _Prepared(weakref.ref(scene, _forget), fields,
                          (table, row, env, mvp), args)
    return _prepared


def launch_args(state, scene, params, seed):
    """The arguments of one ``vpt_mcm_event`` call for CUDA ``state``: the
    state's pointers, the scene's part (prepared once per scene and
    resolution), the frame's seed and ``params``, the current stream."""
    from ..renderers import mcm

    position = state["position"]
    dev = position.device
    height, width = position.shape[:2]
    _check_state(state, height, width, dev)
    if scene.device != dev:
        raise ValueError(f"the scene lives on {scene.device}, the state on "
                         f"{dev}")
    use_skip = mcm.uses_skip(state, scene)
    prepared = _prepare(scene, use_skip, height, width)
    cheb = state["cheb"].data_ptr() if use_skip else None
    # ctypes rounds each Python float to the nearest float32, as
    # np.float32 and JAX's weak types do
    return (position.data_ptr(), state["direction"].data_ptr(),
            state["bounces"].data_ptr(), state["transmittance"].data_ptr(),
            state["radiance"].data_ptr(), state["samples"].data_ptr(), cheb,
            *prepared.args, 1.0 / width, 1.0 / height, float(seed),
            params.extinction, params.anisotropy, params.blur,
            mcm.skip_cell_size(scene), params.max_bounces, params.steps,
            int(use_skip), _build.stream_ptr(position))


def event_frame(state, scene, params, seed):
    """One frame of ``params.steps`` events, in place on ``state``."""
    if not state["position"].is_cuda:
        event_frame_plain(state, scene, params, seed)
        return
    global LAUNCHES
    args = launch_args(state, scene, params, seed)
    # the stream and the shared-memory opt-in belong to the state's device
    with torch.cuda.device(state["position"].device):
        _build.check("vpt_mcm_event", _build.library().vpt_mcm_event(*args))
    LAUNCHES += 1


#: the fields of :func:`occupancy`, in the order ``vpt_mcm_event_info``
#: writes them
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                    "registers", "local_bytes", "static_smem_bytes",
                    "dynamic_smem_bytes")


def occupancy(table_dtype, tf_width: int) -> dict:
    """The kernel's launch shape on the current CUDA device for a corner
    table of ``table_dtype`` and a TF row of ``tf_width`` texels: threads a
    block, resident blocks an SM, SMs, registers and local (spill) bytes a
    thread, static and dynamic shared memory a block.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    _build.check("vpt_mcm_event_info", _build.library().vpt_mcm_event_info(
        int(table_dtype == torch.bfloat16), tf_width, out))
    return dict(zip(OCCUPANCY_FIELDS, out))
