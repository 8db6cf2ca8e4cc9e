"""Renderer protocol and the scene a renderer samples.

Mirrors ``vpt_tpu/renderers/base.py`` for the ported renderers: ``Scene``,
``make_scene`` (the same keyword surface), ``march_interval``,
``Renderer`` and ``AUTO_TRACKING_MIN_EMPTY``.  A renderer module provides

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

A scene whose corner tables require grad (:func:`fit_scene`: the fits of
``train`` and ``diff_iso.depth_loss``) samples through the differentiable
route instead: the fused fetch of ``sampling.sample_volume_packed`` (K3
forward, K4 backward) and the packed bilinear TF texture, as JAX's fit
scene does.
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
from ..utils import resolve_device
from ..volume import Volume


def static_field(**kwargs):
    """A Params field marked ``static``, as ``vpt_tpu`` marks its
    structural knobs (loop trip counts, branches): the viewer rebuilds the
    renderer when one changes and swaps the Params for any other."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


@dataclasses.dataclass
class Scene:
    """The volume, the transfer function, the environment map and the camera
    matrices, all on one device.

    ``volume_packed`` is the corner-packed (D·H·W, 8·C) table of channels
    0:C (C = 1, or 2 for a multi-channel volume) and ``tracking_packed``
    the (D·H·W, 8) cheb-skip table, in float32 or bfloat16;
    ``transfer_packed`` is the (TH·TW, 16)
    TF corner table in the same dtype; ``transfer_1d`` is the (TW, 4)
    float32 y = 0 row that the tf1d lookup reads, rounded through the pack
    dtype when the scene is packed (JAX samples its packed TF table, so a
    bf16 scene sees bf16 TF values).

    ``tf_mxu``: None for the bilinear TF lookup, or the dtype the
    ``tf_mxu`` lookup rounds its lerp weights to (``kernels/tf1d.py``).
    ``kernels``: False runs the plain PyTorch version of every kernel the
    scene's samplers reach, on any device: the reference the kernels are
    held against on the card.
    ``kernel_tables``: the corner tables are the kernels' alone, and the
    samplers read the unpacked volume and TF texture (a ``pack=False``
    scene on the card, :func:`make_scene`)."""

    volume: torch.Tensor               # (D, H, W, C) float32
    transfer: torch.Tensor             # (TH, TW, 4) float32
    environment: torch.Tensor          # (EH, EW, 4) float32
    mvp_inverse: torch.Tensor          # (4, 4)
    model_view: torch.Tensor           # (4, 4)
    projection: torch.Tensor           # (4, 4)
    transfer_1d: torch.Tensor          # (TW, 4) float32
    volume_packed: Any = None          # (D·H·W, 8·min(C, 2)) or None
    transfer_packed: Any = None        # (TH·TW, 16) or None
    tracking_packed: Any = None        # (D·H·W, 8) cheb-skip table or None
    majorant: Any = None               # (N, N, N, 2) [maxalpha, chebdist]
    occupied_aabb: Any = None          # (2, 3) [lo, hi] march clamp box
    iso_aabb: Any = None               # (2, 3) ISO clamp box
    #: the alpha floor ``iso_aabb`` was built at: the box holds for
    #: isovalues of at least this (renderers/iso.py)
    iso_clamp_min: float = 0.0
    filter: str = "linear"
    tf_mxu: Any = None                 # None, torch.float32 or bfloat16
    kernels: bool = True
    kernel_tables: bool = False

    @property
    def device(self):
        return self.volume.device

    @property
    def channels(self) -> int:
        """The channels the samplers read: 1, or 2 (value, gradient
        magnitude) for a multi-channel volume, whose channels past the
        second no sampler reads."""
        return min(self.volume.shape[-1], 2)

    def _lookup(self, values):
        lookup = tf1d.lookup if self.kernels else tf1d.lookup_plain
        return lookup(self.transfer_1d, values, self.tf_mxu)

    def _sample_packed(self, position):
        """The linear fetch of the corner table, (..., channels): K3 for
        CUDA positions unless ``kernels=False``."""
        return sampling.sample_volume_packed(
            self.volume_packed,
            tuple(self.volume.shape[:3]) + (self.channels,), position,
            fused=self.kernels)

    def _packed_samples(self) -> bool:
        """Whether the samplers read the corner table: a linear scene that
        has one.  A filtered scene's samplers read the volume through its
        filter (``sampling.volume_rg``), as ``vpt_tpu`` does; on the card
        its float32 corner table is the kernels' alone, as is an unpacked
        scene's (``kernel_tables``)."""
        return self.volume_packed is not None and self.filter == "linear" \
            and not self.kernel_tables

    def sample_value(self, position):
        """The raw channel-0 value at ``position``, (...) (LAO's
        sampleVolume): the packed corner fetch or the filtered fetch of the
        volume."""
        if self._packed_samples():
            return self._sample_packed(position)[..., 0]
        return sampling.volume_rg(self.volume, position, self.filter)[..., 0]

    def sample_volume_rg(self, position):
        """texture(uVolume, p).rg: (value, channel 1), (..., 2); channel 1
        reads 0 for a single-channel volume."""
        if self._packed_samples():
            s = self._sample_packed(position)
            if s.shape[-1] >= 2:
                return s
            return torch.cat([s, torch.zeros_like(s)], dim=-1)
        return sampling.volume_rg(self.volume, position, self.filter)

    def sample_transfer(self, uv):
        """The 2D bilinear TF lookup at (..., 2) ``uv`` = (value, y), (...,
        4): the packed (TH·TW, 16) TF table when the scene has one for
        its samplers (its dtype's values, float32 weights: never the
        ``tf_mxu`` rounding), else the (TH, TW, 4) texture."""
        if self.transfer_packed is not None and not self.kernel_tables:
            return sampling.sample_texture2d_packed(
                self.transfer_packed, tuple(self.transfer.shape), uv)
        return sampling.sample_texture2d(self.transfer, uv)

    def sample_color(self, position):
        """TF(volume(p)).  A rendering scene takes a single-channel value
        straight to the tf1d lookup (the kernels for CUDA positions), and
        a multi-channel volume's (value, channel 1) to the 2D TF lookup
        (:meth:`sample_transfer`), as ``vpt_tpu`` does; a differentiable
        scene samples the packed TF texture at (value, 0), so autograd
        reaches the TF table through the gather and the value through the
        filter fraction.  A scene is differentiable when autograd records
        and a corner table requires grad."""
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (self.volume_packed, self.transfer_packed)):
            if self.transfer_packed is None:
                raise ValueError("a differentiable scene needs the packed "
                                 "TF texture (transfer_packed)")
            return sampling.sample_texture2d_packed(
                self.transfer_packed, tuple(self.transfer.shape),
                self.sample_volume_rg(position))
        if self.channels == 2:
            return self.sample_transfer(self.sample_volume_rg(position))
        return self._lookup(self.sample_value(position))

    def sample_color_tracking(self, position):
        """Color and Chebyshev distance from the cheb-skip table
        (skipgrid.pack_tracking_volume) in one fetch.  Returns
        ``(color, cheb)``: alpha is 0 in empty cells; cheb is the distance
        in voxels to the nearest occupied cell, recovered exactly by
        rounding (half to even, as jnp.round)."""
        v = sampling.sample_volume_packed(
            self.tracking_packed, tuple(self.volume.shape[:3]) + (1,),
            position, fused=self.kernels)[..., 0]
        empty = v < -0.5
        cheb = torch.round(torch.clamp(-v, min=0.0))
        vs = self._lookup(torch.clamp(v, min=0.0))
        alpha = torch.where(empty, torch.zeros_like(vs[..., 3]), vs[..., 3])
        return torch.cat([vs[..., :3], alpha[..., None]], dim=-1), cheb

    def value_gradient(self, position, h):
        """Central-difference gradient of TF alpha
        (ISORenderer.glsl:165-177)."""
        return sampling.central_value_gradient(self.sample_color, position, h)

    def raw_gradient(self, position, voxel_size):
        """LAO's negated central difference of the raw value
        (LAORenderer.glsl:73-80)."""
        return sampling.central_raw_gradient(self.sample_value, position,
                                             voxel_size)

    def sample_env(self, direction):
        """Equirect environment lookup; a 1×1 map is a constant."""
        eh, ew = self.environment.shape[:2]
        if eh == 1 and ew == 1:
            return self.environment[0, 0].expand(direction.shape[:-1] + (4,))
        return sampling.sample_environment(self.environment, direction)


#: tracking="auto" engages cheb-skip when at least this fraction of voxel
#: cells is TF-empty.
AUTO_TRACKING_MIN_EMPTY = 0.05

#: ``make_scene(pack=None)`` packs volumes of up to this many voxels in
#: ``pack_dtype``, as ``vpt_tpu`` does; above it ``vpt_tpu`` samples the
#: unpacked float32 volume.
PACK_MAX_VOXELS = 256 ** 3


def volume_shape(scene) -> tuple:
    """The whole volume's (D, H, W, C): a ``parallel.halo.HaloScene``
    holds only its slab and names the whole shape (``volume_shape``), as
    ``vpt_tpu``'s renderers read it."""
    shape = getattr(scene, "volume_shape", None)
    return tuple(shape if shape is not None else scene.volume.shape)


def kernels_sample(device) -> bool:
    """Whether frames on ``device`` run the CUDA kernels, which sample
    corner-packed tables only."""
    return torch.device(device).type == "cuda"


def cube_interval(ray_from, direction):
    """The unit-cube slab test clamped at 0, (..., 2) = (tnear, tfar);
    tnear >= tfar is a miss."""
    return torch.clamp(sampling.intersect_cube(ray_from, direction),
                       min=0.0)


def clamp_to_box(tb, ray_from, direction, box):
    """The interval ``tb`` intersected with the box's slab interval
    clamped at 0 (the box may poke out of the cube by the CLAMP_TO_EDGE
    half-texel; the cube bounds stay authoritative)."""
    tbb = torch.clamp(sampling.intersect_box(ray_from, direction, box[0],
                                             box[1]), min=0.0)
    return torch.stack([torch.maximum(tb[..., 0], tbb[..., 0]),
                        torch.minimum(tb[..., 1], tbb[..., 1])], dim=-1)


def march_interval(scene, ray_from, direction):
    """The ray segment EAM, MIP and Depth sample: :func:`cube_interval`,
    clamped to the scene's occupied box when it has one (``march_clamp``:
    samples outside it are provably TF-invisible, so the slices
    concentrate on the visible support)."""
    tb = cube_interval(ray_from, direction)
    if scene.occupied_aabb is None:
        return tb
    return clamp_to_box(tb, ray_from, direction, scene.occupied_aabb)


def state_device(scene=None) -> torch.device:
    """The device of a renderer's state: the scene's, else the port's
    default (the card)."""
    return scene.device if scene is not None else resolve_device(None)


def frame_weight(frame_number) -> np.float32:
    """1 / n as the IEEE float32 quotient, the running mean's weight of
    frame ``n`` (JAX: ``1.0 / frame_number.astype(float32)``)."""
    return np.float32(1.0) / np.float32(frame_number)


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


def fit_scene(scene_template, volume=None, tf=None):
    """The fits' differentiable scene: ``scene_template`` with the given
    volume and/or TF texture and their float32 corner tables packed from
    them (in the graph, so gradients reach the leaves), sampled through the
    bilinear packed TF (``transfer_mxu=None`` in JAX's fit scenes).  The
    packing is bit for bit the unpacked fetch, which ``vpt_tpu``'s EAM and
    ISO fits sample.  A volume joined from z buckets
    (``sampling.BucketedTable``, ``parallel.overlap``) packs through its
    buckets, whose gradients then come back one bucket at a time."""
    vol = scene_template.volume if volume is None else volume
    tf_tex = scene_template.transfer if tf is None else tf
    transfer_packed = sampling.pack_corner_texture2d(tf_tex)
    return dataclasses.replace(
        scene_template, volume=vol, transfer=tf_tex,
        volume_packed=sampling.pack_fit_table(vol),
        transfer_packed=transfer_packed,
        transfer_1d=transfer_row(tf_tex, transfer_packed),
        tracking_packed=None, tf_mxu=None, kernel_tables=False)


def make_scene(volume, transfer, camera: Optional[Any] = None,
               environment=None, volume_transform=None,
               pack: Optional[bool] = None, pack_dtype=None,
               tf_banks: bool = False, tf_mxu: bool = False,
               tf_srgb: bool = False,
               majorant_grid: Optional[int] = None,
               tracking: str = "none",
               march_clamp: bool = False,
               iso_clamp_min: float = 0.0,
               device=None) -> Scene:
    """Assemble a Scene on ``device`` (default: the card; without one,
    pass ``device="cpu"``).  ``volume`` is a Volume or a
    (D, H, W, C) tensor; ``camera`` a scene-graph Node, a CameraState or
    None (the default camera).

    ``pack``: build the corner-packed tables.  The default packs volumes
    of up to :data:`PACK_MAX_VOXELS` voxels in ``pack_dtype``.  Above it
    ``vpt_tpu`` samples the unpacked float32 volume: the port does so on
    the CPU, and on the card, whose kernels sample corner tables only, it
    packs the volume and the TF in float32 (their values are the unpacked
    ones), while the ``tf_mxu`` weights and the tracking table keep
    ``pack_dtype``, as ``vpt_tpu`` keeps them unpacked.  ``pack=False``
    on the card keeps the samplers unpacked, as ``vpt_tpu`` does, and
    gives the kernels float32 corner tables of the unpacked values
    (``Scene.kernel_tables``), so a frame equals the plain frame; they
    cost 8× the volume's memory (its channels 0:2) in float32, beside the
    volume itself.  A volume whose
    filter is not ``"linear"`` is never packed for the samplers
    (``vpt_tpu``'s rule); on the card it gets float32 tables all the same,
    which only the kernels read.
    ``pack_dtype``: the tables' dtype, ``torch.float32`` (default) or
    ``torch.bfloat16``.
    ``tf_banks``: accepted for parity with ``vpt_tpu``; the bilinear tf1d
    lookup is the port's only layout of it.
    ``tf_mxu``: the TF lookup of a single-channel volume rounds its lerp
    weights to ``pack_dtype`` (float32 by default), as ``vpt_tpu``'s
    one-hot matmul does.
    ``tf_srgb``: the reference's SRGB8_ALPHA8 TF texture
    (``transfer.to_gl_texture``).
    ``tracking``: ``"none"``, ``"cheb"``, ``"grid"`` (the majorant grid,
    ``majorant_grid=16`` unless given) or ``"auto"`` (cheb-skip when at
    least :data:`AUTO_TRACKING_MIN_EMPTY` of the cells are TF-empty).
    ``majorant_grid``: N for an N³ local-majorant grid
    (``skipgrid.build_majorant_grid``); a volume it does not tile falls
    back to the exact machine, with ``vpt_tpu``'s warning under
    ``tracking="grid"``.
    ``march_clamp``: EAM, MIP, Depth and ISO march the part of each ray
    inside the occupied box (``skipgrid.occupied_aabb``).
    ``iso_clamp_min``: ISO marches inside the box of the cells whose alpha
    can reach this floor (``skipgrid.iso_value_aabb``) at isovalues of at
    least it.

    A multi-channel volume (a two-channel BVP, or
    ``volume.with_gradient_magnitude``) samples its TF in 2D at (value,
    channel 1), with no grid, tracking table, clamp box or ``tf_mxu``
    (``vpt_tpu`` warns where they were asked for); its corner table holds
    channels 0:2 only, the channels ``vpt_tpu``'s samplers read.  A
    ``"nearest"`` or ``"cubic"`` volume gets no tracking table and no
    clamp box (with the same warnings); its majorant grid is built."""
    import warnings

    from ..transfer import to_gl_texture

    del tf_banks  # the bilinear lookup (see the module docstring)
    device = resolve_device(device)
    vol_filter = "linear"
    if isinstance(volume, Volume):
        vol_filter = volume.filter
        volume = volume.data
    if tracking not in ("none", "cheb", "grid", "auto"):
        raise ValueError(f"unknown tracking mode {tracking!r}")
    if tracking == "cheb" and majorant_grid:
        raise ValueError("tracking='cheb' conflicts with majorant_grid — "
                         "the tracking machines are mutually exclusive")
    if tracking == "grid" and not majorant_grid:
        majorant_grid = 16
    volume = torch.as_tensor(volume, dtype=torch.float32)
    channels = volume.shape[-1]
    linear = vol_filter == "linear"
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
    table_dtype = pack_dtype
    kernel_tables = False
    if pack is None:
        pack = volume.shape[0] * volume.shape[1] * volume.shape[2] \
            <= PACK_MAX_VOXELS
        if not pack and kernels_sample(device):
            pack, table_dtype = True, None
    elif not pack and linear and kernels_sample(device):
        # the samplers stay unpacked; the kernels read float32 tables
        pack, table_dtype, kernel_tables = True, None, True
    if not linear:
        # packed tables implement the linear filter only; the kernels
        # filter a float32 table of the unpacked values
        pack, table_dtype = kernels_sample(device), None
    volume_packed = transfer_packed = None
    if pack:
        volume_packed = sampling.pack_corner_volume(volume[..., :2])
        transfer_packed = sampling.pack_corner_texture2d(transfer)
        if table_dtype is not None:
            volume_packed = volume_packed.to(table_dtype)
            transfer_packed = transfer_packed.to(table_dtype)
    mxu = (pack_dtype or torch.float32) if tf_mxu and channels == 1 \
        else None
    majorant = None
    if majorant_grid:
        majorant = skipgrid.build_majorant_grid(volume, transfer,
                                                majorant_grid)
        if majorant is None and tracking == "grid":
            warnings.warn(
                "tracking='grid' requested but the majorant grid is "
                "unsupported for this volume (multi-channel, or dims not "
                "divisible by the grid size) — falling back to the exact "
                "machine", stacklevel=2)
    tracking_packed = None
    if tracking in ("cheb", "auto") and majorant is None and linear:
        tracking_packed = skipgrid.pack_tracking_volume(
            volume, transfer,
            min_empty_fraction=(AUTO_TRACKING_MIN_EMPTY
                                if tracking == "auto" else 0.0))
        if tracking_packed is None and tracking == "cheb":
            warnings.warn(
                "tracking='cheb' requested but the tracking table is "
                "unsupported for this volume (multi-channel, or negative "
                "values) — falling back to the exact machine",
                stacklevel=2)
        if tracking_packed is not None and pack_dtype is not None:
            tracking_packed = tracking_packed.to(pack_dtype)
    elif tracking == "cheb" and not linear:
        warnings.warn(
            "tracking='cheb' requested but the tracking table implements "
            "the linear filter only (volume filter is "
            f"{vol_filter!r}) — falling back to the exact machine",
            stacklevel=2)
    boxed = channels == 1 and linear
    for asked, what, name in ((march_clamp, "occupied", "march_clamp"),
                              (iso_clamp_min > 0.0, "value",
                               "iso_clamp_min")):
        if asked and not boxed:
            warnings.warn(
                f"{name} requested but the {what}-AABB derivation "
                "supports single-channel linear-filter volumes only — "
                "marching the full segment", stacklevel=2)
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
        majorant=majorant,
        occupied_aabb=(skipgrid.occupied_aabb(volume, transfer)
                       if march_clamp and boxed else None),
        iso_aabb=(skipgrid.iso_value_aabb(volume, transfer, iso_clamp_min)
                  if iso_clamp_min > 0.0 and boxed else None),
        iso_clamp_min=float(iso_clamp_min),
        filter=vol_filter,
        tf_mxu=mxu,
        kernel_tables=kernel_tables,
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
