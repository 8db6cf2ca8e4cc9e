"""Corner-row scatter-add (K4): the port of
``benchmarks/pallas_scatter_bwd.py``.

The TPU probe ``make_fused_scatter`` adds 8-lane cotangent rows into a
(rows, 128) table folded 16 cells to a row, ``table[idx>>4, 8·(idx&15)+k]
+= ct[j, k]``, one serial read-modify-write per update.  That is an 8-lane
scatter-add into row ``idx`` of the table's unfolded (rows·16, 8) view.  On
the H100 no fold is needed (``csrc/corner_scatter.cu``).  Three entry
points:

- :func:`scatter_add_rows8` is the probe's function, in place on the table,
  one ``atomicAdd`` a lane at an int64 offset;
- :func:`corner_grad` is the backward of the fit's fused fetch
  (``corner_gather.corner_fetch``): ``grad[idx[j], 8c] += w8(f[j]) ⊗
  ct[j]``, with the trilinear corner weights ``w8`` computed in the kernel,
  as ``vpt_tpu.sampling._select_trilerp_bwd`` forms them, so the (N, 8·C)
  cotangent never exists in memory;
- :func:`corner_grad_bucket` is its bucket instance, the same kernel with
  a row offset: the gradient of rows [r0, r1) alone, from every saved
  entry of a bucketed fit step (``sampling.BucketedTable``), which launches
  it once a z bucket.

The corner-gradient kernel sums a warp's entries of one row, then a
block's chunk of entries by row in a table in shared memory, and adds
each row to the gradient in float4 atomics (a row that finds no slot
adds directly), so its sums are taken in an order that changes from run
to run: the kernels agree
with the plain versions to rounding, not bit for bit.  Each function takes
its plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors; it never falls back.  The kernels skip an index outside the table
(the plain versions raise).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: what :func:`occupancy` returns, in order
OCCUPANCY_FIELDS = ("threads_per_block", "blocks_per_sm", "sms", "registers",
                    "local_bytes", "static_smem_bytes", "chunk_entries",
                    "table_slots")

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: launches of the bucket instance (:func:`corner_grad_bucket`), likewise
BUCKET_LAUNCHES = 0


def corner_weights(f):
    """(..., 3) fractions → (..., 8) trilinear corner weights, corner order
    (z, y, x) with x minor, products in ``_select_trilerp_bwd``'s order."""
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    wx = torch.stack([1.0 - fx, fx], dim=-1)
    wy = torch.stack([1.0 - fy, fy], dim=-1)
    wz = torch.stack([1.0 - fz, fz], dim=-1)
    return (wz[..., :, None, None] * wy[..., None, :, None]
            * wx[..., None, None, :]).reshape(f.shape[:-1] + (8,))


def scatter_add_rows8_plain(table, idx, ct):
    table.view(-1, 8).index_add_(0, idx, ct)
    return table


def corner_grad_plain(idx, f, ct, rows: int, c: int):
    """(...) cells, (..., 3) fractions, (..., C) cotangents → the (rows, 8·C)
    gradient of the corner table.  A cell of -1 (a sample that
    ``corner_gather.slab_fetch`` masked out) adds nothing, as the kernel
    skips it."""
    outside = idx < 0
    if bool(outside.any()):
        idx = torch.where(outside, torch.zeros_like(idx), idx)
        ct = torch.where(outside[..., None], torch.zeros_like(ct), ct)
    ct8 = corner_weights(f)[..., :, None] * ct[..., None, :]
    grad = torch.zeros(rows, 8 * c, dtype=torch.float32, device=ct.device)
    return grad.index_add_(0, idx.reshape(-1), ct8.reshape(-1, 8 * c))


def corner_grad_bucket_plain(idx, f, ct, r0: int, r1: int, c: int):
    """The (r1 − r0, 8·C) gradient of rows [r0, r1) of the corner table:
    :func:`corner_grad_plain` of the entries whose cell lies in the range,
    shifted by r0."""
    idx, f, ct = idx.reshape(-1), f.reshape(-1, 3), ct.reshape(-1, c)
    inside = (idx >= r0) & (idx < r1)
    return corner_grad_plain(idx[inside] - r0, f[inside], ct[inside],
                             r1 - r0, c)


def scatter_add_rows8(table, idx, ct):
    """``table.view(-1, 8)[idx[j]] += ct[j]`` in place on a float32 table
    whose lanes are a multiple of 8; (n,) int64 idx, (n, 8) float32 ct.
    Returns the table."""
    if not table.is_cuda:
        return scatter_add_rows8_plain(table, idx, ct)
    global LAUNCHES
    if not table.is_contiguous() or table.dtype != torch.float32 \
            or table.numel() % 8:
        raise ValueError("scatter_add_rows8 needs a contiguous float32 "
                         "table of 8-lane rows")
    if idx.dtype != torch.int64 or idx.dim() != 1 \
            or ct.dtype != torch.float32 or tuple(ct.shape) != (len(idx), 8) \
            or idx.device != table.device or ct.device != table.device:
        raise ValueError("scatter_add_rows8 needs (n,) int64 indices and "
                         "(n, 8) float32 cotangents on the table's device")
    idx, ct = idx.contiguous(), ct.contiguous()
    _build.check("vpt_scatter_add_rows8",
                 _build.library().vpt_scatter_add_rows8(
                     table.data_ptr(), table.numel() // 8, idx.data_ptr(),
                     ct.data_ptr(), idx.numel(), _build.stream_ptr(table)))
    LAUNCHES += 1
    return table


def corner_grad(idx, f, ct, rows: int, c: int):
    """The (rows, 8·C) float32 gradient of the corner table of
    ``corner_fetch(table, shape, position)``, whose cells and fractions are
    ``idx`` and ``f``, for the output cotangent ``ct`` (..., C)."""
    if not ct.is_cuda:
        return corner_grad_plain(idx, f, ct, rows, c)
    global LAUNCHES
    grad = _launch_corner_grad(idx, f, ct, 0, rows, c, "corner_grad")
    LAUNCHES += 1
    return grad


def corner_grad_bucket(idx, f, ct, r0: int, r1: int, c: int):
    """The (r1 − r0, 8·C) float32 gradient of rows [r0, r1) of the corner
    table, from the cells ``idx``, fractions ``f`` and cotangents ``ct``
    of every fetch of it (cells outside the range add nothing)."""
    if not ct.is_cuda:
        return corner_grad_bucket_plain(idx, f, ct, r0, r1, c)
    global BUCKET_LAUNCHES
    if not 0 <= r0 <= r1:
        raise ValueError(f"corner_grad_bucket: rows [{r0}, {r1})")
    grad = _launch_corner_grad(idx, f, ct, r0, r1 - r0, c,
                               "corner_grad_bucket")
    BUCKET_LAUNCHES += 1
    return grad


def occupancy(c: int = 1, device: int = 0) -> dict:
    """The corner-gradient kernel's launch shape for ``c`` channels (1 or
    2) on CUDA ``device``: threads a block, resident blocks an SM, SMs,
    registers and local (spill) bytes a thread, static shared bytes a
    block, the most entries a block's chunk holds (a small call's chunks
    are shorter) and the rows its table holds.  Launches nothing."""
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    _build.check("vpt_corner_grad_info",
                 _build.library().vpt_corner_grad_info(c, device, out))
    return dict(zip(OCCUPANCY_FIELDS, out))


def _launch_corner_grad(idx, f, ct, r0, rows, c, what):
    if c not in (1, 2) or rows >= 2 ** 32 - 1:
        raise ValueError(f"{what} takes 1 or 2 channels and fewer than "
                         f"2^32 - 1 rows, not {c} and {rows}")
    if idx.dtype != torch.int64 or f.dtype != torch.float32 \
            or ct.dtype != torch.float32:
        raise ValueError(f"{what} needs int64 indices, float32 "
                         "fractions and float32 cotangents")
    if tuple(f.shape) != tuple(idx.shape) + (3,) \
            or tuple(ct.shape) != tuple(idx.shape) + (c,) \
            or not (idx.device == f.device == ct.device):
        raise ValueError(f"{what}: (...) indices, (..., 3) fractions "
                         "and (..., C) cotangents on one CUDA device")
    idx, f, ct = idx.contiguous(), f.contiguous(), ct.contiguous()
    grad = torch.zeros(rows, 8 * c, dtype=torch.float32, device=ct.device)
    _build.check("vpt_corner_grad", _build.library().vpt_corner_grad(
        grad.data_ptr(), r0, rows, c, idx.data_ptr(), f.data_ptr(),
        ct.data_ptr(), idx.numel(), _build.stream_ptr(ct)))
    return grad
