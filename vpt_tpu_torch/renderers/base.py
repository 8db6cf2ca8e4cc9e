"""Renderer protocol and the scene a renderer samples.

Mirrors ``vpt_tpu/renderers/base.py`` for the MCM slice: ``Scene``,
``make_scene`` (the same keyword surface), ``Renderer`` and
``AUTO_TRACKING_MIN_EMPTY``.  A renderer module provides

- ``reset(params, height, width, scene) -> state``
- ``render_frame(state, scene, params, seed, frame) -> state``: one
  progressive frame.  JAX threads the state functionally (and the jitted
  frame donates it); the port updates the state tensors in place.
- ``display(state, scene, params) -> (H, W, 4)``

The single-channel TF lookup of a rendering scene goes through
``kernels/tf1d.py``: the JAX package's ``tf_banks`` (Pallas lane shuffles)
is a TPU layout of its bilinear formula, and ``tf_mxu`` (an MXU one-hot
matmul) is the same lookup with its lerp weights rounded to the table dtype,
which the scene records as ``Scene.tf_mxu`` and the lookup reproduces.

A scene whose corner tables require grad (the fit's scene,
``train.fit_mc``) samples through the differentiable route instead: the
fused fetch of ``sampling.sample_volume_packed`` (K3 forward, K4 backward)
and the packed bilinear TF texture, as JAX's fit scene does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import environment as envmod
from .. import sampling, skipgrid
from ..kernels import tf1d
from ..scene import CameraState, default_camera
from ..volume import Volume


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to vpt_tpu_torch yet (ROADMAP.md {item})")


@dataclasses.dataclass
class Scene:
    """The volume, the transfer function, the environment map and the camera
    matrices, all on one device.

    ``volume_packed`` and ``tracking_packed`` are corner-packed (D·H·W, 8)
    tables in float32 or bfloat16; ``transfer_packed`` is the (TH·TW, 16)
    TF corner table in the same dtype; ``transfer_1d`` is the (TW, 4)
    float32 y = 0 row that the tf1d lookup reads, rounded through the pack
    dtype when the scene is packed (JAX samples its packed TF table, so a
    bf16 scene sees bf16 TF values).

    ``tf_mxu``: None for the bilinear TF lookup, or the dtype the
    ``tf_mxu`` lookup rounds its lerp weights to (``kernels/tf1d.py``).
    ``kernels``: False runs the plain PyTorch version of every kernel the
    scene's samplers reach, on any device: the reference the kernels are
    held against on the card."""

    volume: torch.Tensor               # (D, H, W, C) float32
    transfer: torch.Tensor             # (TH, TW, 4) float32
    environment: torch.Tensor          # (EH, EW, 4) float32
    mvp_inverse: torch.Tensor          # (4, 4)
    model_view: torch.Tensor           # (4, 4)
    projection: torch.Tensor           # (4, 4)
    transfer_1d: torch.Tensor          # (TW, 4) float32
    volume_packed: Any = None          # (D·H·W, 8·C) or None
    transfer_packed: Any = None        # (TH·TW, 16) or None
    tracking_packed: Any = None        # (D·H·W, 8) cheb-skip table or None
    filter: str = "linear"
    tf_mxu: Any = None                 # None, torch.float32 or bfloat16
    kernels: bool = True

    @property
    def device(self):
        return self.volume.device

    @property
    def majorant(self):
        """The local-majorant grid is not ported; always None."""
        return None

    def _lookup(self, values):
        lookup = tf1d.lookup if self.kernels else tf1d.lookup_plain
        return lookup(self.transfer_1d, values.contiguous(), self.tf_mxu)

    def sample_volume_rg(self, position):
        """texture(uVolume, p).rg: (value, 0) for a single-channel volume."""
        if self.volume_packed is not None:
            s = sampling.sample_volume_packed(
                self.volume_packed, tuple(self.volume.shape), position,
                fused=self.kernels)
        else:
            s = sampling.sample_volume(self.volume, position)
        return torch.cat([s, torch.zeros_like(s)], dim=-1)

    def sample_color(self, position):
        """TF(volume(p)).  A rendering scene takes the single-channel value
        through the tf1d lookup (the kernel for CUDA positions); a
        differentiable scene samples the packed TF texture at (value, 0),
        so autograd reaches the TF table through the gather and the value
        through the filter fraction.  A scene is differentiable when
        autograd records and a corner table requires grad."""
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (self.volume_packed, self.transfer_packed)):
            if self.transfer_packed is None:
                raise ValueError("a differentiable scene needs the packed "
                                 "TF texture (transfer_packed)")
            return sampling.sample_texture2d_packed(
                self.transfer_packed, tuple(self.transfer.shape),
                self.sample_volume_rg(position))
        return self._lookup(self.sample_volume_rg(position)[..., 0])

    def sample_color_tracking(self, position):
        """Color and Chebyshev distance from the cheb-skip table
        (skipgrid.pack_tracking_volume) in one fetch.  Returns
        ``(color, cheb)``: alpha is 0 in empty cells; cheb is the distance
        in voxels to the nearest occupied cell, recovered exactly by
        rounding (half to even, as jnp.round)."""
        v = sampling.sample_volume_packed(
            self.tracking_packed, tuple(self.volume.shape[:3]) + (1,),
            position)[..., 0]
        empty = v < -0.5
        cheb = torch.round(torch.clamp(-v, min=0.0))
        vs = self._lookup(torch.clamp(v, min=0.0))
        alpha = torch.where(empty, torch.zeros_like(vs[..., 3]), vs[..., 3])
        return torch.cat([vs[..., :3], alpha[..., None]], dim=-1), cheb

    def sample_env(self, direction):
        """Equirect environment lookup; a 1×1 map is a constant."""
        eh, ew = self.environment.shape[:2]
        if eh == 1 and ew == 1:
            return self.environment[0, 0].expand(direction.shape[:-1] + (4,))
        return sampling.sample_environment(self.environment, direction)


#: tracking="auto" engages cheb-skip when at least this fraction of voxel
#: cells is TF-empty.
AUTO_TRACKING_MIN_EMPTY = 0.05


def transfer_row(transfer, transfer_packed=None, mxu=None):
    """The (TW, 4) float32 y = 0 TF row the tf1d lookup reads: taken from
    the packed TF table when there is one, since that (possibly bf16) table
    is what JAX samples, else from the texture itself.  A ``tf_mxu`` lookup
    reads JAX's (TW, 4) table in the weight dtype ``mxu``, packed or not."""
    if transfer_packed is None:
        row = tf1d.pack_table(transfer)[0]
    else:
        tw = transfer.shape[1]
        row = transfer_packed[:tw, :4].to(torch.float32).contiguous()
    if mxu is not None:
        row = row.to(mxu).to(torch.float32)
    return row


def make_scene(volume, transfer, camera: Optional[Any] = None,
               environment=None, volume_transform=None,
               pack: Optional[bool] = None, pack_dtype=None,
               tf_banks: bool = False, tf_mxu: bool = False,
               tf_srgb: bool = False,
               majorant_grid: Optional[int] = None,
               tracking: str = "none",
               march_clamp: bool = False,
               iso_clamp_min: float = 0.0,
               device="cpu") -> Scene:
    """Assemble a Scene on ``device``.  ``volume`` is a Volume or a
    (D, H, W, C) tensor; ``camera`` a scene-graph Node, a CameraState or
    None (the default camera).

    ``pack``: build the corner-packed tables (default: volumes up to 256³).
    ``pack_dtype``: their dtype, ``torch.float32`` (default) or
    ``torch.bfloat16``.
    ``tf_banks``: accepted for parity with ``vpt_tpu``; the bilinear tf1d
    lookup is the port's only layout of it.
    ``tf_mxu``: the TF lookup rounds its lerp weights to ``pack_dtype``
    (float32 by default), as ``vpt_tpu``'s one-hot matmul does.
    ``tf_srgb``: the reference's SRGB8_ALPHA8 TF texture
    (``transfer.to_gl_texture``).
    ``tracking``: ``"none"``, ``"cheb"`` or ``"auto"`` (cheb-skip when at
    least :data:`AUTO_TRACKING_MIN_EMPTY` of the cells are TF-empty).

    Not ported, and raising ``NotImplementedError``: ``majorant_grid`` and
    ``tracking="grid"``, ``march_clamp``, ``iso_clamp_min``, multi-channel
    volumes and the nearest/cubic filters."""
    from ..transfer import to_gl_texture

    del tf_banks  # the bilinear lookup (see the module docstring)
    vol_filter = "linear"
    if isinstance(volume, Volume):
        vol_filter = volume.filter
        volume = volume.data
    if vol_filter != "linear":
        raise _not_ported(f"the {vol_filter!r} volume filter",
                          "queue 2, volume filters")
    if majorant_grid or tracking == "grid":
        raise _not_ported("the majorant grid (tracking='grid')",
                          "queue 2, K5 majorant-grid branch")
    if march_clamp:
        raise _not_ported("march_clamp", "queue 1 item 13")
    if iso_clamp_min > 0.0:
        raise _not_ported("iso_clamp_min", "queue 1 item 13")
    if tracking not in ("none", "cheb", "auto"):
        raise ValueError(f"unknown tracking mode {tracking!r}")
    volume = torch.as_tensor(volume, dtype=torch.float32)
    if volume.shape[-1] != 1:
        raise _not_ported("multi-channel volumes",
                          "queue 2, multi-channel volumes")
    if camera is None:
        camera = default_camera()
    if not isinstance(camera, CameraState):
        camera = CameraState.from_nodes(camera, volume_transform)
    if environment is None:
        environment = envmod.white(device=device)
    transfer = torch.as_tensor(transfer, dtype=torch.float32)
    if tf_srgb:
        transfer = to_gl_texture(transfer, srgb=True, quantize=True)
    volume = volume.to(device)
    transfer = transfer.to(device)
    if pack is None:
        pack = volume.shape[0] * volume.shape[1] * volume.shape[2] \
            <= 256 ** 3
    volume_packed = transfer_packed = None
    if pack:
        volume_packed = sampling.pack_corner_volume(volume)
        transfer_packed = sampling.pack_corner_texture2d(transfer)
        if pack_dtype is not None:
            volume_packed = volume_packed.to(pack_dtype)
            transfer_packed = transfer_packed.to(pack_dtype)
    mxu = (pack_dtype or torch.float32) if tf_mxu else None
    tracking_packed = None
    if tracking in ("cheb", "auto"):
        tracking_packed = skipgrid.pack_tracking_volume(
            volume, transfer,
            min_empty_fraction=(AUTO_TRACKING_MIN_EMPTY
                                if tracking == "auto" else 0.0))
        if tracking_packed is None and tracking == "cheb":
            import warnings

            warnings.warn(
                "tracking='cheb' requested but the tracking table is "
                "unsupported for this volume (negative values) — "
                "rendering with the exact machine", stacklevel=2)
        if tracking_packed is not None and pack_dtype is not None:
            tracking_packed = tracking_packed.to(pack_dtype)
    return Scene(
        volume=volume,
        transfer=transfer,
        environment=torch.as_tensor(environment,
                                    dtype=torch.float32).to(device),
        mvp_inverse=camera.mvp_inverse.to(device),
        model_view=camera.model_view.to(device),
        projection=camera.projection.to(device),
        transfer_1d=transfer_row(transfer, transfer_packed, mxu),
        volume_packed=volume_packed,
        transfer_packed=transfer_packed,
        tracking_packed=tracking_packed,
        filter=vol_filter,
        tf_mxu=mxu,
    )


class Renderer:
    """Object-style wrapper over a renderer module's functions, mirroring the
    AbstractRenderer API (reset / render / display)."""

    module = None
    Params = None

    def __init__(self, params=None, height: int = 512, width: int = 512):
        self.params = params if params is not None else self.Params()
        self.height = height
        self.width = width
        self.frame_number = 0
        self.state = None

    def reset(self, scene: Scene):
        self.frame_number = 0
        self.state = self.module.reset(self.params, self.height, self.width,
                                       scene)
        return self.state

    def render(self, scene: Scene, seed: float):
        """One progressive frame, in place on ``self.state``."""
        if self.state is None:
            self.reset(scene)
        self.frame_number += 1
        self.state = self.module.render_frame(
            self.state, scene, self.params, np.float32(seed),
            self.frame_number)
        return self.state

    def display(self, scene: Scene):
        return self.module.display(self.state, scene, self.params)

    def render_progressive(self, scene: Scene, frames: int, seed0: int = 0):
        """Run ``frames`` progressive frames and return the HDR image; the
        seeds are those of ``vpt_tpu``'s Renderer for the same ``seed0``."""
        rs = np.random.default_rng(seed0)
        self.reset(scene)
        for _ in range(frames):
            self.render(scene, float(rs.random(dtype=np.float32)))
        return self.display(scene)
