"""Corner-row gather (K3): the port of ``benchmarks/pallas_gather.py``.

The TPU probe ``make_dma_gather`` gathers rows ``out[j] = table[idx[j]]``
with one async DMA per row.  On the H100 a row gather is a coalesced copy:
neighbouring threads read neighbouring 16-byte pieces of a row
(``csrc/corner_gather.cu``).  Two entry points:

- :func:`gather_rows` is the probe's function: float32 rows of any lane
  count, the counterpart of its benchmark;
- :func:`corner_fetch` is the packed volume fetch of
  ``vpt_tpu.sampling.sample_volume_packed``, which ``sampling`` runs for
  every fused fetch: it takes (..., 3) positions, computes each one's cell
  and filter fractions (``sampling.corner_cells``), reads the cell's corner
  row from a (rows, 8·C) float32 or bfloat16 table and returns
  ``trilerp_chain(row, f)`` (..., C) in float32, bit for bit the plain
  version's result: the kernel runs the same float32 operations in the
  same order, built with ``-fmad=false``.  A one-ulp difference would flip
  MC branches, and the kernel and the plain run would then walk different
  path trees.  With ``save=True`` it also returns the cells and fractions,
  which the fit's backward (``corner_scatter.corner_grad``) takes.

- :func:`slab_fetch` is the masked fetch of a spatially sharded volume
  (``parallel/halo.py``, ``vpt_tpu.parallel.halo.HaloScene._cell_coords``
  and ``_trilinear_packed``): the table is a rank's slab of the corner
  table, a position's cell is the global one mapped to the slab's rows,
  and a position whose cell another rank owns reads nothing and gives 0
  (with ``save``, the cell -1, which K4 skips), so the sum over the ranks
  of their masked values is :func:`corner_fetch`'s value, bit for bit.
  The slabs are contiguous or interleaved thin slabs (``interleave``);
  ``masked`` False reads every position from the slab's rows (the
  resident machine's fetch, whose caller owns every position).

Positions: a coordinate below the volume or above it clamps to the edge
cell with fraction 0 (GL CLAMP_TO_EDGE); a NaN coordinate takes index 0 on
its axis and a NaN fraction, so the value is NaN, in the kernel as in the
plain version.

Each function takes its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back.  An index outside
``[0, rows)`` gives a NaN row in ``gather_rows``'s kernel (the plain
version raises).  What a fetch needs of its table is prepared once per
table and volume shape (``_build.TableCache``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the slab instance (:func:`slab_fetch`), likewise
SLAB_LAUNCHES = 0


def gather_rows_plain(table, idx):
    return table[idx]


def corner_fetch_plain(table, shape, position, save: bool = False):
    """(rows, 8·C) table, (D, H, W, C) volume shape, (..., 3) positions →
    (..., C) float32; with ``save`` also the (...) int64 cells and (..., 3)
    fractions."""
    from ..sampling import corner_cells, trilerp_chain

    c = shape[3]
    idx, f = corner_cells(position, shape)
    rows = table[idx].to(torch.float32).reshape(idx.shape + (8, c))
    out = trilerp_chain(rows, f)
    return (out, idx, f) if save else out


def gather_rows(table, idx):
    """(rows, lanes) float32, (n,) int64 → (n, lanes): ``table[idx]``."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    global LAUNCHES
    if idx.device != table.device:
        raise ValueError("gather_rows: table and indices must be on one "
                         "CUDA device")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError("gather_rows needs a 2-D float32 table")
    if idx.dtype != torch.int64:
        raise ValueError("gather_rows needs int64 indices")
    table, idx = table.contiguous(), idx.contiguous()
    _build.check_aligned(table, "the table")
    rows, lanes = table.shape
    out = torch.empty(idx.shape + (lanes,), dtype=torch.float32,
                      device=table.device)
    _build.check("vpt_gather_rows", _build.library().vpt_gather_rows(
        table.data_ptr(), rows, lanes, idx.data_ptr(), idx.numel(),
        out.data_ptr(), _build.stream_ptr(table)))
    LAUNCHES += 1
    return out


class _Table(ctypes.Structure):
    """``VptCornerTable`` of ``csrc/corner_gather.cu``: what a fetch needs
    of the corner table, passed as one pointer."""
    _fields_ = [("table", ctypes.c_void_p), ("bf16", ctypes.c_int),
                ("c", ctypes.c_int), ("w", ctypes.c_int), ("h", ctypes.c_int),
                ("d", ctypes.c_int), ("device", ctypes.c_int)]


def _prepare(table, shape):
    d, h, w, c = shape
    if not table.is_cuda or table.dim() != 2 \
            or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("corner_fetch needs a 2-D float32 or bfloat16 "
                         "corner table on the positions' CUDA device")
    if tuple(table.shape) != (d * h * w, 8 * c):
        raise ValueError(f"a corner table of the volume {tuple(shape)} has "
                         f"{(d * h * w, 8 * c)} rows and lanes, not "
                         f"{tuple(table.shape)}")
    _build.check_aligned(table, "the corner table")
    device = table.get_device()
    args = _Table(table.data_ptr(), int(table.dtype == torch.bfloat16), c, w,
                  h, d, device)
    return _build.Prepared(ptr=table.data_ptr(), c=c, device=device,
                           args=args, address=ctypes.addressof(args),
                           launch=_build.library().vpt_corner_fetch)


_tables = _build.TableCache(_prepare)


def corner_fetch(table, shape, position, save: bool = False):
    """Trilinear fetch from a corner-packed (D·H·W, 8·C) float32 or
    bfloat16 table at (..., 3) float32 positions → (..., C) float32; with
    ``save`` also the (...) int64 cells and (..., 3) float32 fractions."""
    if not table.is_cuda:
        return corner_fetch_plain(table, shape, position, save)
    global LAUNCHES
    p = _tables.get(table, tuple(shape))
    if position.dtype is not torch.float32 or position.shape[-1] != 3 \
            or position.get_device() != p.device:
        raise ValueError("corner_fetch needs (..., 3) float32 positions on "
                         "the table's CUDA device")
    if not position.is_contiguous():
        position = position.contiguous()
    batch = position.shape[:-1]
    out = position.new_empty(batch + (p.c,))
    cells = fractions = None
    if save:
        cells = position.new_empty(batch, dtype=torch.int64)
        fractions = position.new_empty(position.shape)
    err = p.launch(p.address, position.data_ptr(), position.numel() // 3,
                   out.data_ptr(), None if cells is None else cells.data_ptr(),
                   None if fractions is None else fractions.data_ptr(),
                   _build.current_stream(p.device))
    if err:
        _build.check("vpt_corner_fetch", err)
    LAUNCHES += 1
    return (out, cells, fractions) if save else out


def slab_owners(z0, depth: int, num_slabs: int, interleave: int = 1):
    """The slab that owns each cell of (...) int64 planes ``z0`` of a
    volume of ``depth`` planes: ``clip(z0 // Ds, 0, S − 1)`` for
    contiguous slabs, ``(z0 // thin_ds) mod S`` with ``interleave`` m."""
    if interleave == 1:
        return torch.clamp(z0 // (depth // num_slabs), 0, num_slabs - 1)
    return (z0 // (depth // (interleave * num_slabs))) % num_slabs


def slab_cells(position, shape, slab_index: int, num_slabs: int,
               interleave: int = 1):
    """``(zloc, y0, x0, f, local)`` of (..., 3) positions in a (D, H, W,
    C) volume split into z slabs (``HaloScene._cell_coords``): the global
    cell's x and y, its plane in slab ``slab_index``'s rows, the (..., 3)
    fractions, and whether that slab owns it (:func:`slab_owners`).
    Contiguous slabs (interleave 1): plane ``clip(z0 − k·Ds, 0, Ds − 1)``;
    ``interleave`` m: thin slab ``t = z0 // thin_ds`` belongs to ``t mod
    S`` and lies at plane ``(t div S)·(thin_ds + 1) + z0 − t·thin_ds``."""
    from ..sampling import _clamp_index, _filter_coords

    d, h, w = shape[:3]
    i0f, f = _filter_coords(position, (w, h, d))
    x0, y0, z0 = _clamp_index(i0f, (w, h, d)).unbind(-1)
    local = slab_owners(z0, d, num_slabs, interleave) == slab_index
    if interleave == 1:
        ds = d // num_slabs
        zloc = torch.clamp(z0 - slab_index * ds, 0, ds - 1)
    else:
        thin_ds = d // (interleave * num_slabs)
        thin = z0 // thin_ds
        zloc = (thin // num_slabs) * (thin_ds + 1) + (z0 - thin * thin_ds)
    return zloc, y0, x0, f, local


def slab_fetch_plain(table, shape, slab_index: int, num_slabs: int,
                     interleave: int, position, masked: bool = True,
                     save: bool = False):
    """The masked slab fetch in plain PyTorch: a (rows, 8·C) slab table of
    the (D, H, W, C) volume ``shape``, (..., 3) positions → (..., C)
    float32, 0 where another slab owns the cell (``masked``); with
    ``save`` also the (...) int64 slab cells (-1 where masked out) and the
    (..., 3) fractions."""
    from ..sampling import trilerp_chain

    h, w, c = shape[1], shape[2], shape[3]
    zloc, y0, x0, f, local = slab_cells(position, shape, slab_index,
                                        num_slabs, interleave)
    idx = (zloc * h + y0) * w + x0
    rows = table[idx].to(torch.float32).reshape(idx.shape + (8, c))
    out = trilerp_chain(rows, f)
    if masked:
        out = torch.where(local[..., None], out, torch.zeros_like(out))
        idx = torch.where(local, idx, torch.full_like(idx, -1))
    return (out, idx, f) if save else out


def _prepare_slab(table, key):
    shape, slab_rows = key
    d, h, w, c = shape
    if not table.is_cuda or table.dim() != 2 \
            or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("slab_fetch needs a 2-D float32 or bfloat16 slab "
                         "table on the positions' CUDA device")
    if tuple(table.shape) != (slab_rows, 8 * c):
        raise ValueError(f"a slab table of the volume {tuple(shape)} has "
                         f"{(slab_rows, 8 * c)} rows and lanes, not "
                         f"{tuple(table.shape)}")
    _build.check_aligned(table, "the slab table")
    device = table.get_device()
    args = _Table(table.data_ptr(), int(table.dtype == torch.bfloat16), c, w,
                  h, slab_rows // (h * w), device)
    return _build.Prepared(ptr=table.data_ptr(), c=c, device=device,
                           args=args, address=ctypes.addressof(args),
                           launch=_build.library().vpt_slab_fetch)


_slabs = _build.TableCache(_prepare_slab)


def slab_fetch(table, shape, slab_index: int, num_slabs: int,
               interleave: int, position, masked: bool = True,
               save: bool = False):
    """The fetch from slab ``slab_index``'s rows of the corner table of a
    (D, H, W, C) volume (K3's slab instance for CUDA tensors, the plain
    version for CPU ones); as :func:`slab_fetch_plain`: contiguous or
    interleaved thin slabs, masked by ownership or not."""
    if not table.is_cuda:
        return slab_fetch_plain(table, shape, slab_index, num_slabs,
                                interleave, position, masked, save)
    global SLAB_LAUNCHES
    d, h, w, c = (int(n) for n in shape)
    if table.shape[0] % (h * w):
        raise ValueError("a slab table holds whole planes of H*W rows")
    p = _slabs.get(table, ((d, h, w, c), table.shape[0]))
    if position.dtype is not torch.float32 or position.shape[-1] != 3 \
            or position.get_device() != p.device:
        raise ValueError("slab_fetch needs (..., 3) float32 positions on "
                         "the table's CUDA device")
    if not position.is_contiguous():
        position = position.contiguous()
    batch = position.shape[:-1]
    out = position.new_empty(batch + (c,))
    cells = fractions = None
    if save:
        cells = position.new_empty(batch, dtype=torch.int64)
        fractions = position.new_empty(position.shape)
    err = p.launch(p.address, d, slab_index, num_slabs, interleave,
                   int(masked), position.data_ptr(), position.numel() // 3,
                   out.data_ptr(), None if cells is None else cells.data_ptr(),
                   None if fractions is None else fractions.data_ptr(),
                   _build.current_stream(p.device))
    if err:
        _build.check("vpt_slab_fetch", err)
    SLAB_LAUNCHES += 1
    return (out, cells, fractions) if save else out
