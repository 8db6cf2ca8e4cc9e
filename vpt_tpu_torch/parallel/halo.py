"""Spatially sharded volumes: z slabs with a halo plane, sampled by
ownership masking.

Mirrors ``vpt_tpu/parallel/halo.py``.  For volumes too large to keep whole
on every card, the volume splits into z slabs over the mesh's ``space``
axis; each rank holds its slab plus one halo plane from the +z neighbour,
so that a trilinear read at the slab's face never needs a remote tap.  Any
sample position (MCM photons jump anywhere) is handled by ownership
masking: every rank fetches the positions whose cell it owns from its
slab's rows and contributes zero elsewhere, and a sum over ``space``
(``torch.distributed.all_reduce``, JAX's ``psum``) assembles the value.
Only the owner's term is non-zero, so the sum is the value itself, bit for
bit: a halo frame equals the replicated frame.

:class:`HaloScene` duck-types the port's ``Scene`` samplers, so every
renderer's plain frame runs through it unchanged, on any device, in the
order JAX's does: the masked trilinear value is reduced first and the TF
applied to the reduced value.  On the card every frame runs a halo
instance of its kernel, split around the masked slab-local fetch (the
value, or the value pair of a two-channel volume) with
:meth:`HaloScene.reduce_` (the all-reduce) between launches, over
contiguous or interleaved slabs, masked or not:

- MCM, K5's (``kernels/mcm_event.halo_event_frame``): steps + 1 launches,
  one all-reduce an event;
- EAM, MIP, Depth and ISO, K6's (``kernels/march.halo_march_frame``):
  a fetch of every slice and a fold, one all-reduce between them (the
  plain twin sums a fetch of 8 slices at a time);
- ISO's display, K7's (``kernels/iso_shade.halo_shade``): 2 launches
  around one all-reduce of the hits' seven fetches, their slots in pixel
  order (the plain twin sums each fetch of every pixel);
- MCS, K8's (``kernels/mcs_frame.halo_mcs_frame``): a launch a fetch of
  the slowest pixel and up to a batch more, the host reading the count
  of pixels that fetch once a batch;
- DOS, K9's (``kernels/dos_sweep.halo_sweep_frame``): a fetch of every
  slice, an all-reduce and a cooperative fold a frame; with rows
  over ``data`` as well, a band of rows (``dos.render_band``: each slice
  all-gathers the occlusion over ``data``) through K9's halo band
  instance (``dos_sweep.band_slice``): a fetch of the band and an
  all-reduce a chunk of 8 active slices, a fold a slice;
- LAO, K10's (``kernels/lao_march.halo_lao_frame``): ceil(slices / 8) + 1
  launches, one all-reduce a chunk of 8 slices' 6 values (4 with the
  baked gradient): the gradient's differences, the value, the AO taps'
  weighted sum and the shadow tap, each rank's taps summed first.

The differentiable masked fetch is ``sampling.SlabCornerFetch`` (K3's slab
instance forward, K4 backward); :class:`SpaceSum` is the all-reduce as an
autograd function.  ``resident.py`` samples a ``HaloScene(collective=
False)``: no mask and no sum, every position owned by the rank.

:data:`COLLECTIVES` counts the collectives this module, ``halo_grad`` and
``dos_halo`` issue, by kind, in place of JAX's count of them in the HLO.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

from .. import sampling
from ..kernels import corner_gather, tf1d
from .mesh import axis_group, axis_index, axis_size, block_of

#: collectives issued since the last reset, by kind ("all_reduce",
#: "all_gather"); ``COLLECTIVES.clear()`` resets it
COLLECTIVES = collections.Counter()


def _group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t, group):
    """``t`` summed over ``group`` in place (counted); nothing for a group
    of one rank or none."""
    import torch.distributed as dist

    if _group_size(group) > 1:
        dist.all_reduce(t, group=group)
        COLLECTIVES["all_reduce"] += 1
    return t


def all_reduce_async(t, group):
    """``t`` summed over ``group`` in place, asynchronously (counted): the
    handle to wait on."""
    import torch.distributed as dist

    COLLECTIVES["all_reduce"] += 1
    return dist.all_reduce(t, group=group, async_op=True)


class SpaceSum(torch.autograd.Function):
    """The sum of each rank's masked partial over ``group``, differentiable.

    Every rank computes the same loss from the sum, so each rank's partial
    receives the replicated cotangent itself: the backward is the identity,
    with no all-reduce and no 1/S.  (JAX differentiates inside its manual
    ``shard_map`` and gets the same result from ``psum``'s transpose, which
    sums the S ranks' identical seeds, and its explicit ``/ num_slabs``,
    ``vpt_tpu/parallel/halo_grad.py:108-121``.)"""

    @staticmethod
    def forward(ctx, partial, group):
        return all_reduce_(partial.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def slab_depth(depth: int, num_slabs: int, interleave: int = 1) -> int:
    """The planes of a rank's slab: Ds + 1 (one halo plane), or m thin
    slabs of thin_ds + 1 with ``interleave`` m."""
    if depth % (num_slabs * interleave):
        raise ValueError(f"depth {depth} not divisible by "
                         f"{num_slabs * interleave} slabs")
    return interleave * (depth // (interleave * num_slabs) + 1)


def slab_planes(depth: int, num_slabs: int, slab_index: int,
                interleave: int = 1) -> torch.Tensor:
    """The volume's z planes that slab ``slab_index`` holds, in order, as
    int64: [k·Ds, (k+1)·Ds] (the last slab repeats plane D − 1), or with
    ``interleave`` m the thin slabs k, k + S, ..., each with its halo plane
    (``vpt_tpu.parallel.resident.shard_volume_cyclic``)."""
    slab_depth(depth, num_slabs, interleave)
    thin = depth // (interleave * num_slabs)
    planes = []
    for j in range(interleave):
        t = j * num_slabs + slab_index
        planes.extend(min(z, depth - 1)
                      for z in range(t * thin, (t + 1) * thin + 1))
    return torch.tensor(planes, dtype=torch.int64)


def shard_volume_with_halo(volume, num_slabs: int):
    """(D, H, W, C) → (S, Ds+1, H, W, C): slab k holds z planes [k·Ds,
    (k+1)·Ds], one halo plane from the next slab; the last slab repeats
    its final plane, as CLAMP_TO_EDGE does."""
    d = volume.shape[0]
    if d % num_slabs != 0:
        raise ValueError(f"depth {d} not divisible by {num_slabs} slabs")
    return torch.stack([slab_of(volume, num_slabs, k)
                        for k in range(num_slabs)])


def slab_of(volume, num_slabs: int, slab_index: int, interleave: int = 1):
    """Slab ``slab_index``'s planes of a (D, ...) volume (a copy)."""
    planes = slab_planes(volume.shape[0], num_slabs, slab_index, interleave)
    return volume[planes.to(volume.device)]


def slab_table(table, volume_shape, num_slabs: int, slab_index: int,
               interleave: int = 1):
    """Slab ``slab_index``'s rows of a corner-packed (D·H·W, L) table (the
    volume's or the cheb-skip table): the rows of its planes, a copy of
    (planes·H·W, L).  A cell never reads its slab's halo plane as its own,
    so these rows serve every cell the slab owns, as JAX's slab tables
    (packed from the slab, or sliced from the global cheb table) do."""
    d, h, w = volume_shape[:3]
    planes = table.reshape(d, h * w, table.shape[-1])
    return slab_of(planes, num_slabs, slab_index,
                   interleave).reshape(-1, table.shape[-1])


@dataclasses.dataclass
class HaloScene:
    """A scene over this rank's z slab: the samplers fetch the positions
    whose cells this rank owns from the slab's rows, zero elsewhere, and
    sum over ``group`` (the mesh's ``space`` axis); everything else is the
    replicated scene's.  ``group`` None leaves the masked partial unsummed
    (a caller sums the slabs' partials itself).  ``collective`` False
    samples every position from the slab with no mask and no sum (the
    caller guarantees that the rank owns each of them: ``resident.py``).
    ``interleave`` m > 1: the rank holds m thin slabs (``slab_planes``).
    The slab kernels (K3's slab, K5's halo and resident instances) take
    both on the card, as their plain twins do on the CPU.

    ``slab`` is (planes, H, W, C); ``slab_packed`` and ``tracking_packed``
    the slab's rows of the corner and cheb-skip tables (:func:`slab_table`)
    or None; ``volume_shape`` the whole (D, H, W, C).  There is no majorant
    grid, clamp box or filter, as in JAX (``vpt_tpu/parallel/halo.py:82``):
    the fields the renderers read of a Scene keep those no-op values.
    """

    slab: torch.Tensor
    slab_index: int
    num_slabs: int
    volume_shape: tuple
    transfer: torch.Tensor
    environment: torch.Tensor
    mvp_inverse: torch.Tensor
    model_view: torch.Tensor
    projection: torch.Tensor
    transfer_1d: torch.Tensor
    group: Any = None
    slab_packed: Any = None
    transfer_packed: Any = None
    tracking_packed: Any = None
    tf_mxu: Any = None
    collective: bool = True
    interleave: int = 1
    kernels: bool = True
    majorant: Any = None
    occupied_aabb: Any = None
    iso_aabb: Any = None
    iso_clamp_min: float = 0.0
    filter: str = "linear"

    def __post_init__(self):
        self.volume_shape = tuple(int(n) for n in self.volume_shape)
        d, h, w = self.volume_shape[:3]
        want = (slab_depth(d, self.num_slabs, self.interleave), h, w)
        if tuple(self.slab.shape[:3]) != want:
            raise ValueError(f"slab shape {tuple(self.slab.shape)} != "
                             f"expected {want}")

    @property
    def device(self):
        return self.slab.device

    @property
    def channels(self) -> int:
        return min(self.volume_shape[3], 2)

    def reduce(self, partial):
        """The sum of the masked partials over ``group`` (differentiable:
        :class:`SpaceSum`); the partial itself without a collective."""
        if not self.reduces:
            return partial
        return SpaceSum.apply(partial, self.group)

    @property
    def reduces(self) -> bool:
        """Whether :meth:`reduce` and :meth:`reduce_` issue a collective:
        the fetch is masked and the group holds more than one rank."""
        return self.collective and _group_size(self.group) > 1

    def reduce_(self, partial):
        """:meth:`reduce` in place, outside autograd (K5's halo frame)."""
        if self.reduces:
            all_reduce_(partial, self.group)
        return partial

    # -- the masked slab-local trilinear fetch ---------------------------
    def _fetch(self, table, c, position):
        """The masked fetch of a slab corner table, (..., c), summed."""
        return self.reduce(sampling.sample_slab_packed(
            table, self.volume_shape[:3] + (c,), self.slab_index,
            self.num_slabs, self.interleave, position, self.collective,
            fused=self.kernels))

    def _sample(self, position):
        """(..., channels) of the volume at ``position``: the slab's corner
        table, or with none the slab's taps (the plain twin of JAX's
        unpacked branch)."""
        if self.slab_packed is not None:
            return self._fetch(self.slab_packed, self.channels, position)
        return self.reduce(self._sample_unpacked(position))

    def _sample_unpacked(self, position):
        d, h, w = self.volume_shape[:3]
        zloc, y0, x0, f, local = corner_gather.slab_cells(
            position, self.volume_shape, self.slab_index, self.num_slabs,
            self.interleave)
        flat = self.slab[..., :self.channels].reshape(-1, self.channels)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        z1 = zloc + 1

        def g(x, y, z):
            return flat[(z * h + y) * w + x]

        fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
        c00 = g(x0, y0, zloc) * (1 - fx) + g(x1, y0, zloc) * fx
        c10 = g(x0, y1, zloc) * (1 - fx) + g(x1, y1, zloc) * fx
        c01 = g(x0, y0, z1) * (1 - fx) + g(x1, y0, z1) * fx
        c11 = g(x0, y1, z1) * (1 - fx) + g(x1, y1, z1) * fx
        val = (c00 * (1 - fy) + c10 * fy) * (1 - fz) \
            + (c01 * (1 - fy) + c11 * fy) * fz
        if not self.collective:
            return val
        return torch.where(local[..., None], val, torch.zeros_like(val))

    def _lookup(self, values):
        lookup = tf1d.lookup if self.kernels else tf1d.lookup_plain
        return lookup(self.transfer_1d, values, self.tf_mxu)

    # -- the Scene sampler interface -------------------------------------
    def sample_color_tracking(self, position):
        """Colour and cheb distance from the slab's rows of the cheb-skip
        table: one masked fetch and one sum yield both, then
        ``Scene.sample_color_tracking``'s rounding and lookup."""
        v = self._fetch(self.tracking_packed, 1, position)[..., 0]
        empty = v < -0.5
        cheb = torch.round(torch.clamp(-v, min=0.0))
        vs = self._lookup(torch.clamp(v, min=0.0))
        alpha = torch.where(empty, torch.zeros_like(vs[..., 3]), vs[..., 3])
        return torch.cat([vs[..., :3], alpha[..., None]], dim=-1), cheb

    def sample_volume_rg(self, position):
        s = self._sample(position)
        if s.shape[-1] >= 2:
            return s[..., :2]
        return torch.cat([s, torch.zeros_like(s)], dim=-1)

    def sample_value(self, position):
        return self._sample(position)[..., 0]

    def sample_transfer(self, uv):
        if self.transfer_packed is not None:
            return sampling.sample_texture2d_packed(
                self.transfer_packed, tuple(self.transfer.shape), uv)
        return sampling.sample_texture2d(self.transfer, uv)

    def sample_color(self, position):
        """TF(volume(p)), as ``Scene.sample_color``: the packed TF texture
        at (value, channel 1) when a table requires grad or the volume has
        two channels, else the tf1d lookup of the value."""
        if self.channels == 2 or torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (self.slab_packed, self.transfer_packed)):
            return self.sample_transfer(self.sample_volume_rg(position))
        return self._lookup(self.sample_value(position))

    def sample_env(self, direction):
        eh, ew = self.environment.shape[:2]
        if eh == 1 and ew == 1:
            return self.environment[0, 0].expand(direction.shape[:-1] + (4,))
        return sampling.sample_environment(self.environment, direction)

    def value_gradient(self, position, h):
        return sampling.central_value_gradient(self.sample_color, position, h)

    def raw_gradient(self, position, voxel_size):
        return sampling.central_raw_gradient(self.sample_value, position,
                                             voxel_size)


#: the replicated fields a HaloScene takes from its scene
_SCENE_FIELDS = ("transfer", "environment", "mvp_inverse", "model_view",
                 "projection", "transfer_1d", "transfer_packed", "tf_mxu",
                 "kernels")


def halo_scene(scene, slab_index: int, num_slabs: int, group=None,
               slabs=None, interleave: int = 1,
               collective: bool = True, volume_shape=None) -> HaloScene:
    """A :class:`HaloScene` of ``scene`` (a Scene, or a dict of its
    replicated fields, :data:`_SCENE_FIELDS`) for slab ``slab_index``:
    ``slabs`` = (volume slab, corner rows or None, cheb-skip rows or None),
    else cut from the scene (:func:`place_scene_slabs`)."""
    fields = scene if isinstance(scene, dict) else {
        name: getattr(scene, name) for name in _SCENE_FIELDS}
    if volume_shape is None:
        volume_shape = tuple(scene.volume.shape)
    if slabs is None:
        slabs = place_scene_slabs(scene, num_slabs, slab_index, interleave)
    vol, packed, tracking = slabs
    return HaloScene(slab=vol, slab_index=slab_index, num_slabs=num_slabs,
                     volume_shape=volume_shape, group=group,
                     slab_packed=packed, tracking_packed=tracking,
                     collective=collective, interleave=interleave, **fields)


def place_scene_slabs(scene, num_slabs: int, slab_index: int,
                      interleave: int = 1):
    """(volume slab, corner-table rows or None, cheb-skip rows or None) of
    slab ``slab_index``: copies, so that the whole tables can go."""
    shape = tuple(scene.volume.shape)
    vol = slab_of(scene.volume, num_slabs, slab_index, interleave)
    packed = tracking = None
    if scene.volume_packed is not None:
        packed = slab_table(scene.volume_packed, shape, num_slabs,
                            slab_index, interleave)
    if scene.tracking_packed is not None and scene.majorant is None:
        tracking = slab_table(scene.tracking_packed, shape, num_slabs,
                              slab_index, interleave)
    return vol, packed, tracking


def sharded_render_frame(module, mesh, scene, num_slabs: int, state_example,
                         data_axis: str = "data", space_axis: str = "space"):
    """A frame function over a halo-sharded volume.

    Returns ``(frame_fn, slabs)``: call ``frame_fn(state, slabs, params,
    seed, frame_number)`` with this rank's block of rows of the state
    (``shard.place_state`` over ``data``; ``state_example`` is the
    whole-image state, which gives the height) and ``slabs`` this rank's
    (volume slab, corner rows, cheb-skip rows) over ``space``, whose size
    must be ``num_slabs``.  The frame renders the rows with their window
    (``render_frame(..., window=)``), in place, through a
    :class:`HaloScene`; ``module`` is any renderer whose frame reaches the
    volume through the sampler interface.  On the card every renderer
    (MCM, EAM, MIP, Depth, ISO and its ``display``, MCS, DOS, LAO) runs
    its kernel's halo instance.  DOS's band of rows reads its neighbours'
    occlusion, so with ``data`` > 1 its frame is ``dos.render_band``, each
    slice all-gathering the whole occlusion buffer over ``data`` as
    ``shard.shard_render_frame`` does (vpt_tpu's partitioner does the
    same; it also takes a camera inside the volume).

    A rank keeps only its slab's tables: (Ds+1)·H·W rows of 8·C lanes.
    For config 4's 512³ float32 volume on S = 2 slabs that is 257·512²·32
    B = 2.16 GB a rank, against 4.29 GB for the whole table (plus the
    volume slab, 257·512²·4 B = 0.27 GB); the frame function holds the
    scene's TF, camera and environment, not its tables, so a caller may
    drop the scene."""
    from .shard import gather_blocks, state_height

    if axis_size(mesh, space_axis) != num_slabs:
        raise ValueError(f"{num_slabs} slabs on a {space_axis} axis of "
                         f"{axis_size(mesh, space_axis)} ranks: one slab a "
                         "rank")
    height = state_height(state_example)
    window = (block_of(height, mesh, (data_axis,))[0], height)
    index = axis_index(mesh, space_axis)
    group = axis_group(mesh, space_axis)
    fields = {name: getattr(scene, name) for name in _SCENE_FIELDS}
    volume_shape = tuple(scene.volume.shape)
    slabs = place_scene_slabs(scene, num_slabs, index)
    band = getattr(module, "render_band", None) \
        if axis_size(mesh, data_axis) > 1 else None
    last = {}

    def extend(occlusion):
        COLLECTIVES["all_gather"] += 1
        return gather_blocks(occlusion, height, mesh, (data_axis,)), 0

    def frame_fn(state, slabs, params, seed, frame_number):
        key = tuple(id(t) for t in slabs)
        if last.get("key") != key:
            last["key"], last["scene"] = key, halo_scene(
                fields, index, num_slabs, group, slabs,
                volume_shape=volume_shape)
        if band is not None:
            return band(state, last["scene"], params, window, extend)
        return module.render_frame(state, last["scene"], params, seed,
                                   frame_number, window=window)

    return frame_fn, slabs
