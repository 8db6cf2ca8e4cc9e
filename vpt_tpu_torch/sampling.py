"""Ray/volume sampling primitives of the ported renderers.

Mirrors the main-path subset of ``vpt_tpu/sampling.py``: ray setup
(``pixel_ndc``, ``intersect_cube``, ``intersect_box``, ``unproject``,
``unproject_rand``), the GL LINEAR + CLAMP_TO_EDGE volume and texture
fetches with their corner-packed tables, the nearest and cubic volume
filters (``volume_rg``), the equirect environment lookup, ISO's and
LAO's central-difference gradients (``value_gradient`` over a raw volume
and TF too), Henyey-Greenstein sampling, ``max3`` and ``mean3``.  Every
operation runs in the JAX package's order so that the float32 results
agree.

The TPU-only layouts are not ported: the scatter fold and two-level fold of
the corner table (a fix for a TPU scatter cliff) and the MXU one-hot TF
matmul.  The port's single-channel TF lookup is ``kernels/tf1d.py``, which
reproduces the matmul's rounded weights (``tf_mxu``).

The packed volume fetch (:func:`sample_volume_packed`) is the corner fetch
of ``kernels/corner_gather.py`` (K3), which takes positions: on a table
that requires grad it runs through :class:`CornerFetch`, the port of
``vpt_tpu.sampling._select_trilerp`` (the fit's fused VJP), whose backward
is the corner scatter-add of ``kernels/corner_scatter.py`` (K4).  A table
packed from z buckets (:class:`BucketedTable`, the bucketed fits of
``parallel/overlap.py`` and ``parallel/halo_grad.py``) defers that
scatter: its fetches keep their entries, and the buckets' gradients are
scattered, folded and reduced one bucket at a time in ascending z.

The per-axis bounds of the texture fetches are tensors built once per
(sizes, device) (``utils.constant``): a CUDA tensor built from Python
values at every call would wait for the stream at every call.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .kernels import corner_gather, corner_scatter
from .math3d import apply_mat4
from .utils import constant

EPS = np.float32(1e-5)
INVPI = np.float32(0.31830988618)


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------

def intersect_cube(origin, direction):
    """Slab test against the unit cube → (..., 2) = (tnear, tfar).  min/max
    propagate NaN, as ``jnp.minimum``/``jnp.maximum`` do."""
    tmin = (0.0 - origin) / direction
    tmax = (1.0 - origin) / direction
    t1 = torch.minimum(tmin, tmax)
    t2 = torch.maximum(tmin, tmax)
    tnear = torch.amax(t1, dim=-1)
    tfar = torch.amin(t2, dim=-1)
    return torch.stack([tnear, tfar], dim=-1)


def intersect_box(origin, direction, lo, hi):
    """Slab test against the box [lo, hi] → (..., 2) = (tnear, tfar);
    ``lo`` and ``hi`` are (3,) corners in the space of ``origin`` (the
    march clamp's box, ``skipgrid.occupied_aabb``), with the NaN-propagating
    min and max of :func:`intersect_cube`."""
    tmin = (lo - origin) / direction
    tmax = (hi - origin) / direction
    t1 = torch.minimum(tmin, tmax)
    t2 = torch.maximum(tmin, tmax)
    tnear = torch.amax(t1, dim=-1)
    tfar = torch.amin(t2, dim=-1)
    return torch.stack([tnear, tfar], dim=-1)


def _unproject(near_xy, far_xy, mvp_inverse):
    """The near (z = −1) and far (z = 1) points through the inverse MVP,
    dehomogenised: (from, to)."""
    ones = torch.ones(near_xy.shape[:-1] + (1,), dtype=torch.float32,
                      device=near_xy.device)
    f = apply_mat4(mvp_inverse, torch.cat([near_xy, -ones, ones], dim=-1))
    t = apply_mat4(mvp_inverse, torch.cat([far_xy, ones, ones], dim=-1))
    return f[..., :3] / f[..., 3:4], t[..., :3] / t[..., 3:4]


def unproject(ndc, mvp_inverse):
    """NDC position (..., 2) → (from, to) ray endpoints in texture space."""
    return _unproject(ndc, ndc, mvp_inverse)


def unproject_rand(state, ndc, mvp_inverse, inverse_resolution, blur):
    """Stochastic unproject: disk jitter on the near plane (depth of field),
    square jitter on the far plane (antialiasing).  Consumes 4 uniforms in
    the GLSL order."""
    state, disk_offset = rng.disk(state)
    state, aa = rng.square(state)
    near_xy = ndc + disk_offset * blur
    far_xy = ndc + (aa * 2.0 - 1.0) * inverse_resolution
    return (state, *_unproject(near_xy, far_xy, mvp_inverse))


def pixel_ndc(height, width, device="cpu", window=None):
    """NDC coordinates of pixel centers, (H, W, 2); row 0 is the bottom of
    the image (y up, OpenGL convention).  The true quotient on every device:
    CUDA divides by a Python scalar through its reciprocal, so the divisor
    is a tensor (see ``rng.exponential``).

    ``window``: None for the whole image, or ``(row0, full_height)``: the
    ``height`` rows from ``row0`` of a ``full_height``-row image, equal bit
    for bit to those rows of ``pixel_ndc(full_height, width)``."""
    row0, full_height = row_window(window, height)

    def centers(first, count, n):
        i = torch.arange(first, first + count, dtype=torch.float32,
                         device=device) + 0.5
        return i / torch.full_like(i, n) * 2.0 - 1.0

    yy, xx = torch.meshgrid(centers(row0, height, full_height),
                            centers(0, width, width), indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def row_window(window, height):
    """``(row0, full_height)`` of a frame of ``height`` rows: ``window``
    checked, or ``(0, height)`` for None (the whole image)."""
    if window is None:
        return 0, height
    row0, full_height = (int(v) for v in window)
    if row0 < 0 or row0 + height > full_height:
        raise ValueError(f"rows [{row0}, {row0 + height}) do not lie in an "
                         f"image of {full_height} rows")
    return row0, full_height


# ---------------------------------------------------------------------------
# Texture sampling
# ---------------------------------------------------------------------------

def _filter_coords(position, dims):
    """GL CLAMP_TO_EDGE filter coordinate: (i0 float, fraction)."""
    dev = position.device
    size = constant(tuple(dims), torch.float32, dev)
    lo = constant((0.0,) * len(dims), torch.float32, dev)
    hi = constant(tuple(float(n - 1) for n in dims), torch.float32, dev)
    u = torch.clamp(position * size - 0.5, min=lo, max=hi)
    i0 = torch.floor(u)
    return i0, u - i0


def _max_index(dims, device):
    return constant(tuple(n - 1 for n in dims), torch.int64, device)


def _clamp_index(i0f, dims):
    return torch.minimum(torch.clamp(i0f.to(torch.int64), min=0),
                         _max_index(dims, i0f.device))


def sample_volume(volume, position):
    """Trilinear fetch of a (D, H, W, C) texture at (..., 3) xyz positions in
    [0, 1], GL LINEAR + CLAMP_TO_EDGE."""
    d, h, w, _ = volume.shape
    i0f, f = _filter_coords(position, (w, h, d))
    i0 = _clamp_index(i0f, (w, h, d))
    i1 = torch.minimum(i0 + 1, _max_index((w, h, d), i0.device))
    flat = volume.reshape(d * h * w, -1)

    def tap(ix, iy, iz):
        return flat[(iz * h + iy) * w + ix]

    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = tap(x0, y0, z0) * (1 - fx) + tap(x1, y0, z0) * fx
    c10 = tap(x0, y1, z0) * (1 - fx) + tap(x1, y1, z0) * fx
    c01 = tap(x0, y0, z1) * (1 - fx) + tap(x1, y0, z1) * fx
    c11 = tap(x0, y1, z1) * (1 - fx) + tap(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_volume_nearest(volume, position):
    """NEAREST + CLAMP_TO_EDGE fetch of a (D, H, W, C) texture
    (Volume.setFilter('nearest')): texel ``int(clip(p·N, 0, N − 0.5))``
    on each axis."""
    d, h, w, _ = volume.shape
    dev = position.device
    size = constant((w, h, d), torch.float32, dev)
    lo = constant((0.0, 0.0, 0.0), torch.float32, dev)
    hi = constant((w - 0.5, h - 0.5, d - 0.5), torch.float32, dev)
    u = torch.clamp(position * size, min=lo, max=hi)
    i = torch.minimum(torch.clamp(u.to(torch.int64), min=0),
                      _max_index((w, h, d), dev))
    flat = volume.reshape(d * h * w, -1)
    return flat[(i[..., 2] * h + i[..., 1]) * w + i[..., 0]]


def cubic_warp(position, dims):
    """The smoothstep warp of ``sample_volume_cubic``
    (mixins/quasiCubicSampling.glsl:3-9) of (..., 3) positions in a
    volume of ``dims`` = (W, H, D): u = p·N + 0.5, f = u − floor(u),
    ``(floor(u) + (f·f)·(3 − 2f) − 0.5) / N``, the true quotient."""
    size = constant(tuple(dims), torch.float32, position.device)
    u = position * size + 0.5
    fl = torch.floor(u)
    f = u - fl
    u = fl + f * f * (3.0 - 2.0 * f)
    return (u - 0.5) / size


def sample_volume_cubic(volume, position):
    """Smoothstep-warped trilinear ≈ cubic filter: the linear fetch at
    :func:`cubic_warp` of the position."""
    d, h, w, _ = volume.shape
    return sample_volume(volume, cubic_warp(position, (w, h, d)))


#: the volume filters of ``Volume.filter``, by the code the kernels take
FILTERS = {"linear": 0, "nearest": 1, "cubic": 2}


def volume_rg(volume, position, filter="linear"):
    """``texture(uVolume, p).rg``: the (value, gradient-magnitude) pair
    (..., 2) through the volume's filter; the second channel reads 0 for a
    single-channel volume (GL RED format), and channels past the second
    are not read."""
    if filter == "nearest":
        s = sample_volume_nearest(volume, position)
    elif filter == "cubic":
        s = sample_volume_cubic(volume, position)
    else:
        s = sample_volume(volume, position)
    if s.shape[-1] >= 2:
        return s[..., :2]
    return torch.cat([s, torch.zeros_like(s)], dim=-1)


def sample_volume_color(volume, tf, position, filter="linear"):
    """The shared composite sampler: the 3D fetch feeding the bilinear 2D
    transfer-function lookup at (value, channel 1)
    (MCMRenderer.glsl:85-89 et al.) → (..., 4)."""
    return sample_texture2d(tf, volume_rg(volume, position, filter))


def sample_texture2d(texture, uv):
    """Bilinear fetch of an (H, W, C) texture at (..., 2) uv, CLAMP_TO_EDGE."""
    h, w, _ = texture.shape
    i0f, f = _filter_coords(uv, (w, h))
    i0 = _clamp_index(i0f, (w, h))
    i1 = torch.minimum(i0 + 1, _max_index((w, h), i0.device))
    flat = texture.reshape(h * w, -1)

    def tap(ix, iy):
        return flat[iy * w + ix]

    fx, fy = f[..., 0:1], f[..., 1:2]
    c0 = tap(i0[..., 0], i0[..., 1]) * (1 - fx) \
        + tap(i1[..., 0], i0[..., 1]) * fx
    c1 = tap(i0[..., 0], i1[..., 1]) * (1 - fx) \
        + tap(i1[..., 0], i1[..., 1]) * fx
    return c0 * (1 - fy) + c1 * fy


def pack_corner_volume(volume):
    """(D, H, W, C) → (D·H·W, 8·C) rows of the 2×2×2 cell corners, corner
    order (z, y, x) with x minor, clamped at the +1 edges (fold 0 of
    ``vpt_tpu.sampling.pack_corner_volume``)."""
    d, h, w, c = volume.shape
    vp = torch.cat([volume, volume[:, :, -1:]], dim=2)
    vp = torch.cat([vp, vp[:, -1:]], dim=1)
    vp = torch.cat([vp, vp[-1:]], dim=0)
    corners = [vp[dz:dz + d, dy:dy + h, dx:dx + w]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(corners, dim=3).reshape(d * h * w, 8 * c)


def trilerp_chain(rows, f):
    """The 3-level lerp over (..., 8, C) corner rows, in the order of
    ``vpt_tpu.sampling._trilerp_chain``."""
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
        + rows[..., 1::2, :] * fx[..., None]
    cy = cx[..., 0::2, :] * (1 - fy)[..., None] \
        + cx[..., 1::2, :] * fy[..., None]
    return cy[..., 0, :] * (1 - fz) + cy[..., 1, :] * fz


def corner_cells(position, shape):
    """The corner-table row (cell) and the filter fractions of each (..., 3)
    position in a (D, H, W, C) volume: ((...) int64, (..., 3) float32)."""
    d, h, w = shape[:3]
    i0f, f = _filter_coords(position, (w, h, d))
    i0 = _clamp_index(i0f, (w, h, d))
    return (i0[..., 2] * h + i0[..., 1]) * w + i0[..., 0], f


class CornerFetch(torch.autograd.Function):
    """The differentiable packed volume fetch: forward
    ``corner_gather.corner_fetch`` with ``save=True`` (the cells, the
    gather and the lerp in one launch, bit for bit :func:`trilerp_chain`
    over the gathered row), backward ``corner_scatter.corner_grad``
    (``w8(f) ⊗ ct`` scattered into the table's gradient).  Only the cells
    and fractions are saved, as ``vpt_tpu.sampling._select_trilerp_fwd``
    saves them; positions are detached (no gradient reaches them), the
    contract of the MC gradient estimators
    (``vpt_tpu/sampling.py:415-421``).  From a :class:`BucketedTable`'s
    table (``buckets``) the backward keeps the cells, fractions and
    cotangents for the buckets' scatter and scatters nothing."""

    @staticmethod
    def forward(ctx, table, shape, position, buckets=None):
        out, idx, f = corner_gather.corner_fetch(table, shape, position,
                                                 save=True)
        ctx.save_for_backward(idx, f)
        ctx.table_shape = tuple(table.shape)
        ctx.buckets = buckets
        return out

    @staticmethod
    def backward(ctx, ct):
        idx, f = ctx.saved_tensors
        if ctx.buckets is not None:
            ctx.buckets.record(idx, f, ct)
            return None, None, None, None
        rows, lanes = ctx.table_shape
        grad = corner_scatter.corner_grad(idx, f, ct.contiguous(), rows,
                                          lanes // 8)
        return grad, None, None, None


def sample_volume_packed(packed, shape, position, fused: bool = True):
    """Trilinear fetch from a corner-packed (D·H·W, 8·C) table, float32 or
    bfloat16 rows; identical to :func:`sample_volume` on a float32 table.

    ``fused`` (the default) runs the corner fetch (K3 for CUDA tensors),
    with or without autograd, and gives no gradient to the positions:
    through :class:`CornerFetch` when autograd records and the table
    requires grad (the fit packs float32 tables in the graph; positions are
    detached, and a bfloat16 table that requires grad raises), else
    directly.  Positions that alone require grad raise: a caller that needs
    their gradient passes ``fused=False``, the plain gather and lerp, whose
    autograd backward is the full-Jacobian reference."""
    if not fused:
        return corner_gather.corner_fetch_plain(packed, shape, position)
    if torch.is_grad_enabled() and packed.requires_grad:
        if packed.dtype != torch.float32:
            raise ValueError("the differentiable fetch takes float32 corner "
                             f"tables, not {packed.dtype}")
        return CornerFetch.apply(packed, tuple(shape), position.detach(),
                                 buckets_of_table(packed))
    if torch.is_grad_enabled() and position.requires_grad:
        raise ValueError("the fused fetch gives no gradient to positions: "
                         "pass fused=False for one")
    return corner_gather.corner_fetch(packed, shape, position)


class SlabCornerFetch(torch.autograd.Function):
    """The differentiable masked slab fetch of a spatially sharded volume
    (``parallel/halo.py``): forward ``corner_gather.slab_fetch`` with
    ``save=True`` (K3's slab instance: 0 where another slab owns the cell,
    whose saved cell is -1), backward ``corner_scatter.corner_grad`` into
    the slab table's gradient (K4, which skips the -1 cells: an owned
    sample's ``w8(f) ⊗ ct``, nothing for the others, whose masked value
    does not depend on the table).  Positions are detached, and a
    :class:`BucketedTable`'s entries kept, as :class:`CornerFetch`'s."""

    @staticmethod
    def forward(ctx, table, shape, slab, position, buckets=None):
        out, idx, f = corner_gather.slab_fetch(table, shape, *slab,
                                               position, True, save=True)
        ctx.save_for_backward(idx, f)
        ctx.table_shape = tuple(table.shape)
        ctx.buckets = buckets
        return out

    @staticmethod
    def backward(ctx, ct):
        idx, f = ctx.saved_tensors
        if ctx.buckets is not None:
            ctx.buckets.record(idx, f, ct)
            return None, None, None, None, None
        rows, lanes = ctx.table_shape
        grad = corner_scatter.corner_grad(idx, f, ct.contiguous(), rows,
                                          lanes // 8)
        return grad, None, None, None, None


def sample_slab_packed(packed, shape, slab_index: int, num_slabs: int,
                       interleave: int, position, masked: bool = True,
                       fused: bool = True):
    """The fetch from slab ``slab_index``'s rows of the corner table of a
    (D, H, W, C) volume (``corner_gather.slab_fetch``): 0 where another
    slab owns the cell when ``masked``.  Routed as
    :func:`sample_volume_packed`: :class:`SlabCornerFetch` when autograd
    records and the (float32) table requires grad (masked only), the
    plain version for ``fused=False``, else the fetch."""
    slab = (slab_index, num_slabs, interleave)
    if not fused:
        return corner_gather.slab_fetch_plain(packed, shape, *slab,
                                              position, masked)
    if torch.is_grad_enabled() and packed.requires_grad:
        if packed.dtype != torch.float32 or not masked:
            raise ValueError("the differentiable slab fetch takes masked "
                             "float32 slab tables")
        return SlabCornerFetch.apply(packed, tuple(shape), slab,
                                     position.detach(),
                                     buckets_of_table(packed))
    if torch.is_grad_enabled() and position.requires_grad:
        raise ValueError("the fused fetch gives no gradient to positions: "
                         "pass fused=False for one")
    return corner_gather.slab_fetch(packed, shape, *slab, position, masked)


# ---------------------------------------------------------------------------
# Bucketed corner tables: the voxel gradient a z bucket at a time
# ---------------------------------------------------------------------------

class BucketedTable:
    """The fits' corner table over a volume joined from z buckets, whose
    gradient comes back one bucket at a time, each as soon as it is final.

    :meth:`join` concatenates the buckets (each a leaf of its own) into the
    (D, H, W, C) volume a loss reads, through one autograd node
    (:class:`_JoinBuckets`); :func:`pack_fit_table`, which the fits pack
    their tables with (``renderers.base.fit_scene``,
    ``parallel.halo_grad``), finds the buckets behind that volume through
    its ``grad_fn`` and packs the corner table through
    :class:`_PackBuckets`.  A fused fetch of that table
    (:class:`CornerFetch`, :class:`SlabCornerFetch`: K3 forward) keeps its
    cells, fractions and cotangents here in its backward and scatters
    nothing.  The join's backward runs once every fetch has run its own;
    then, for the buckets in ascending z, it launches K4's bucket instance
    over bucket b's rows (``corner_scatter.corner_grad_bucket``), folds
    that table gradient into bucket b's voxels (:func:`fold_corner_grad`)
    and calls ``reduce(b, grad)`` before bucket b + 1's scatter.

    Ascending z is what makes a bucket final: the rows of plane z read the
    voxels of planes z and z + 1, so the voxels of plane z take gradient
    from the rows of planes z − 1 and z.  Bucket b's last rows add to
    bucket b + 1's first plane, which carries over; the last bucket's
    rows clamp onto its own last plane.  A gradient that reaches the table
    or the joined volume by another route (a plain ``fused=False`` fetch,
    a read of the volume) arrives whole and is added to each bucket's
    share before its reduction.

    ``reduce`` (None: no reduction) receives each bucket's gradient
    tensor, which it may sum in place asynchronously; :meth:`gradients`
    returns them after the backward pass."""

    def __init__(self, depths, reduce=None):
        self.depths = [int(n) for n in depths]
        self.reduce = reduce
        self.entries = []
        self.table_grad = None
        self.grads = None

    def join(self, buckets):
        """The (D, H, W, C) volume of the buckets in z order."""
        if [int(b.shape[0]) for b in buckets] != self.depths:
            raise ValueError(f"buckets of {[b.shape[0] for b in buckets]} "
                             f"planes for a table of {self.depths}")
        return _JoinBuckets.apply(self, *buckets)

    def record(self, idx, f, ct):
        """A fetch's saved cells and fractions and its cotangent."""
        self.entries.append((idx.reshape(-1), f.reshape(-1, 3),
                             ct.reshape(-1, ct.shape[-1])))

    def add_table_grad(self, grad):
        self.table_grad = grad if self.table_grad is None \
            else self.table_grad + grad

    def gradients(self):
        """Each bucket's voxel gradient, after the backward pass."""
        if self.grads is None:
            raise RuntimeError("the backward pass did not reach the "
                               "buckets' join")
        return self.grads

    def _backward(self, grad_volume, shape, device):
        _, h, w, channels = shape
        c = min(channels, 2)
        plane = h * w
        entries, self.entries = self.entries, []
        table_grad, self.table_grad = self.table_grad, None
        saved = [torch.cat([e[i] for e in entries]) for i in range(3)] \
            if entries else None
        del entries
        grads, carry, z0 = [], None, 0
        for b, n in enumerate(self.depths):
            z1 = z0 + n
            r0, r1 = z0 * plane, z1 * plane
            if saved is not None:
                tg = corner_scatter.corner_grad_bucket(*saved, r0, r1, c)
                if table_grad is not None:
                    tg += table_grad[r0:r1]
            elif table_grad is not None:
                tg = table_grad[r0:r1]
            else:
                tg = torch.zeros(r1 - r0, 8 * c, device=device)
            last = b == len(self.depths) - 1
            vox = fold_corner_grad(tg, n, h, w, last)
            del tg
            g = vox.new_zeros((n, h, w, channels))
            g[..., :c] = vox[:n]
            if carry is not None:
                g[0, ..., :c] += carry
            carry = None if last else vox[n]
            if grad_volume is not None:
                g += grad_volume[z0:z1]
            grads.append(g)
            if self.reduce is not None:
                self.reduce(b, g)
            z0 = z1
        self.grads = grads


class _JoinBuckets(torch.autograd.Function):
    """The join of a :class:`BucketedTable`'s buckets; its backward takes
    their gradients (``BucketedTable._backward``) and hands autograd none:
    a bucket's gradient may be in flight in its reduction."""

    @staticmethod
    def forward(ctx, table, *buckets):
        ctx.set_materialize_grads(False)
        ctx.joins = table
        volume = torch.cat(buckets, dim=0)
        ctx.shape, ctx.device = tuple(volume.shape), volume.device
        return volume

    @staticmethod
    def backward(ctx, grad):
        ctx.joins._backward(grad, ctx.shape, ctx.device)
        return (None,) * (1 + len(ctx.joins.depths))


class _PackBuckets(torch.autograd.Function):
    """:func:`pack_corner_volume` of a :class:`BucketedTable`'s joined
    volume (channels 0:2); the gradient of its fetches goes to the table's
    entries, and only another route's whole table gradient comes back
    here."""

    @staticmethod
    def forward(ctx, table, volume):
        ctx.set_materialize_grads(False)
        ctx.packs = table
        return pack_corner_volume(volume[..., :2])

    @staticmethod
    def backward(ctx, grad):
        if grad is not None:
            ctx.packs.add_table_grad(grad)
        return None, None


def buckets_of_table(table):
    """The :class:`BucketedTable` whose packed table ``table`` is, or
    None."""
    return getattr(table.grad_fn, "packs", None)


def pack_fit_table(volume):
    """The fits' float32 corner table of ``volume``'s channels 0:2, packed
    in the graph so that gradients reach the volume: through its
    :class:`BucketedTable` when ``volume`` is one's join."""
    buckets = getattr(volume.grad_fn, "joins", None)
    if buckets is None:
        return pack_corner_volume(volume[..., :2])
    return _PackBuckets.apply(buckets, volume)


def fold_corner_grad(grad, planes: int, h: int, w: int, edge: bool):
    """The transpose of :func:`pack_corner_volume` over ``planes`` planes
    of rows: their (planes·H·W, 8·C) gradient → the (planes + 1, H, W, C)
    gradient of the voxels they read, the last plane being the next
    plane's share (the rows' +1 corners in z); with ``edge`` (the
    volume's last planes, whose +1 corners clamp onto their own plane)
    the (planes, H, W, C) gradient.  The +1 corners in y and x clamp at
    the edges, as the packing does."""
    c = grad.shape[1] // 8
    g = grad.reshape(planes, h, w, 2, 2, 2, c)
    out = grad.new_zeros((planes + 1, h + 1, w + 1, c))
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out[dz:dz + planes, dy:dy + h, dx:dx + w] += \
                    g[:, :, :, dz, dy, dx]
    out[:, h - 1] += out[:, h]
    out[:, :, w - 1] += out[:, :, w]
    out = out[:, :h, :w]
    if edge:
        out[planes - 1] += out[planes]
        return out[:planes]
    return out


def pack_corner_texture2d(texture):
    """(H, W, C) → (H·W, 4·C) rows of the 2×2 texel corners (x minor)."""
    h, w, c = texture.shape
    tp = torch.cat([texture, texture[:, -1:]], dim=1)
    tp = torch.cat([tp, tp[-1:]], dim=0)
    corners = [tp[dy:dy + h, dx:dx + w] for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(corners, dim=2).reshape(h * w, 4 * c)


def sample_texture2d_packed(packed, shape, uv):
    """Bilinear fetch from a corner-packed 2D texture (one row per sample)."""
    h, w, c = shape
    i0f, f = _filter_coords(uv, (w, h))
    i0 = _clamp_index(i0f, (w, h))
    rows = packed[i0[..., 1] * w + i0[..., 0]].to(torch.float32)
    rows = rows.reshape(rows.shape[:-1] + (4, c))
    fx, fy = f[..., 0:1], f[..., 1:2]
    cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
        + rows[..., 1::2, :] * fx[..., None]
    return cx[..., 0, :] * (1 - fy) + cx[..., 1, :] * fy


def environment_uv(direction):
    """The equirect map coordinates (..., 2) of a direction
    (MCMRenderer.glsl:80-83)."""
    d = direction
    u = torch.atan2(d[..., 0], -d[..., 2]) * float(INVPI) * 0.5 + 0.5
    v = torch.asin(torch.clamp(-d[..., 1], -1.0, 1.0)) * 2.0 \
        * float(INVPI) * 0.5 + 0.5
    return torch.stack([u, v], dim=-1)


def sample_environment(env, direction):
    """Equirectangular environment lookup (MCMRenderer.glsl:80-83)."""
    return sample_texture2d(env, environment_uv(direction))


# ---------------------------------------------------------------------------
# Shading helpers
# ---------------------------------------------------------------------------

def central_value_gradient(sample_color_fn, position, h):
    """Central-difference gradient of TF alpha through any color sampler
    (ISORenderer.glsl:165-177), (..., 3).  ``h`` rounds to float32 and the
    differences divide by the float32 ``2h`` as a tensor: the true
    quotient on every device."""
    h = np.float32(h)
    grads = []
    for axis in range(3):
        offset = torch.zeros(3, dtype=torch.float32, device=position.device)
        offset[axis] = float(h)
        grads.append(sample_color_fn(position + offset)[..., 3]
                     - sample_color_fn(position - offset)[..., 3])
    grad = torch.stack(grads, dim=-1)
    return grad / torch.full_like(grad, float(2 * h))


def value_gradient(volume, tf, position, h):
    """:func:`central_value_gradient` of the TF alpha over a raw (D, H, W,
    C) volume and (TH, TW, 4) TF texture (:func:`sample_volume_color`), on
    their device: ``vpt_tpu.sampling.value_gradient``."""
    return central_value_gradient(
        lambda p: sample_volume_color(volume, tf, p), position, h)


def central_raw_gradient(sample_value_fn, position, voxel_size):
    """LAO's negated central difference of the raw value
    (LAORenderer.glsl:73-80), (..., 3): ``value(p − e_i·vs) − value(p +
    e_i·vs)`` with the offsets ``eye(3) · vs`` in float32."""
    vs = float(np.float32(voxel_size))
    grads = []
    for axis in range(3):
        offset = torch.zeros(3, dtype=torch.float32, device=position.device)
        offset[axis] = vs
        grads.append(sample_value_fn(position - offset)
                     - sample_value_fn(position + offset))
    return torch.stack(grads, dim=-1)


def raw_gradient(volume, position, voxel_size):
    """:func:`central_raw_gradient` of channel 0 of a (D, H, W, C) volume
    through the GL trilinear sampler (:func:`sample_volume`), LAO's
    convention: ``vpt_tpu.sampling.raw_gradient``."""
    return central_raw_gradient(
        lambda p: sample_volume(volume, p)[..., 0], position, voxel_size)


def henyey_greenstein_cosine(state, g):
    """HG scattering-angle cosine (MCMRenderer.glsl:91-95)."""
    state, u = rng.uniform(state)
    g2 = g * g
    c = (1.0 - g2) / (1.0 - g + 2.0 * g * u)
    return state, (1.0 + g2 - c * c) / (2.0 * g)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def henyey_greenstein(state, g, direction):
    """Sample an HG-distributed direction around ``direction``
    (MCMRenderer.glsl:97-106).  Like the shader, |g| < EPS returns the raw
    sphere sample and draws one uniform fewer."""
    g = np.float32(g)
    state, u = rng.sphere(state)
    if abs(g) < EPS:
        return state, u
    # a float32 scalar tensor, so that g·g and 1 − g round as in float32
    g = constant(g, torch.float32, direction.device)
    state, hgcos = henyey_greenstein_cosine(state, g)
    proj = _dot3(u, direction)[..., None]
    perp = u - proj * direction
    circle = perp / torch.sqrt(
        torch.clamp(_dot3(perp, perp)[..., None], min=1e-12))
    hgcos = hgcos[..., None]
    return state, torch.sqrt(torch.clamp(1.0 - hgcos * hgcos, min=0.0)) \
        * circle + hgcos * direction


def max3(v):
    return torch.amax(v, dim=-1)


def mean3(v):
    return torch.mean(v, dim=-1)
