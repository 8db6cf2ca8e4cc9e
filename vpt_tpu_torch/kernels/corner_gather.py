"""Corner-row gather (K3): the port of ``benchmarks/pallas_gather.py``.

The TPU probe ``make_dma_gather`` gathers rows ``out[j] = table[idx[j]]``
with one async DMA per row.  On the H100 a row gather is a coalesced copy:
neighbouring threads read neighbouring 16-byte pieces of a row
(``csrc/corner_gather.cu``).  Two entry points:

- :func:`gather_rows` is the probe's function: float32 rows of any lane
  count, the counterpart of its benchmark;
- :func:`corner_fetch` is the gather plus the trilinear lerp that the fit's
  forward runs once per event (``sampling.sample_volume_packed`` on a table
  that requires grad): it reads cell ``idx[j]``'s corner row from a
  (rows, 8·C) float32 table and returns ``trilerp_chain(row, f[j])`` (C,),
  bit for bit the plain version's result: the kernel runs the same float32
  operations in the same order, built with ``-fmad=false``.  A one-ulp
  difference would flip MC branches, and the kernel and the plain run
  would then walk different path trees.

Each function takes its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back.  An index outside
``[0, rows)`` gives a NaN row in the kernels (the plain versions raise).
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0


def gather_rows_plain(table, idx):
    return table[idx]


def corner_fetch_plain(table, idx, f):
    """(rows, 8·C) table, (...) int64 cells, (..., 3) fractions → (..., C)."""
    from ..sampling import trilerp_chain

    c = table.shape[1] // 8
    rows = table[idx].to(torch.float32).reshape(idx.shape + (8, c))
    return trilerp_chain(rows, f)


def _check(table, idx, what):
    if not (table.is_cuda and idx.device == table.device):
        raise ValueError(f"{what}: table and indices must be on one CUDA "
                         "device")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"{what} needs a 2-D float32 table")
    if idx.dtype != torch.int64:
        raise ValueError(f"{what} needs int64 indices")
    table = table.contiguous()
    _build.check_aligned(table, "the table")
    return table, idx.contiguous()


def gather_rows(table, idx):
    """(rows, lanes) float32, (n,) int64 → (n, lanes): ``table[idx]``."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    global LAUNCHES
    table, idx = _check(table, idx, "gather_rows")
    rows, lanes = table.shape
    out = torch.empty(idx.shape + (lanes,), dtype=torch.float32,
                      device=table.device)
    _build.check("vpt_gather_rows", _build.library().vpt_gather_rows(
        table.data_ptr(), rows, lanes, idx.data_ptr(), idx.numel(),
        out.data_ptr(), _build.stream_ptr(table)))
    LAUNCHES += 1
    return out


def corner_fetch(table, idx, f):
    """Fused corner-row gather and trilinear lerp: (rows, 8·C) float32
    table, (...) int64 cells, (..., 3) float32 fractions → (..., C)."""
    if not table.is_cuda:
        return corner_fetch_plain(table, idx, f)
    global LAUNCHES
    table, idx = _check(table, idx, "corner_fetch")
    rows, lanes = table.shape
    if lanes % 8:
        raise ValueError("a corner table has 8·C lanes")
    if f.dtype != torch.float32 or f.device != table.device \
            or tuple(f.shape) != tuple(idx.shape) + (3,):
        raise ValueError("corner_fetch needs (..., 3) float32 fractions "
                         "beside (...) indices")
    f = f.contiguous()
    c = lanes // 8
    out = torch.empty(idx.shape + (c,), dtype=torch.float32,
                      device=table.device)
    _build.check("vpt_corner_fetch", _build.library().vpt_corner_fetch(
        table.data_ptr(), rows, c, idx.data_ptr(), f.data_ptr(), idx.numel(),
        out.data_ptr(), _build.stream_ptr(table)))
    LAUNCHES += 1
    return out
