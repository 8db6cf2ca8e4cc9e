"""1D transfer-function lookup: the port of ``vpt_tpu/pallas/tf1d.py``.

Single-channel volumes sample the TF at uv = (value, 0), so the bilinear 2D
lookup collapses to a piecewise-linear table over the TF's y = 0 row:
``u = clip(v·W − 0.5, 0, W−1)``, ``i0 = floor(u)``, ``i1 = min(i0+1, W−1)``,
``c[i0]·(1−f) + c[i1]·f``.  The TPU kept the row in 128-lane register banks;
here it is a plain (TW, 4) float32 row that the CUDA kernel
(``csrc/tf1d.cu``) stages in shared memory.  The same lookup runs as a
device function inside the MCM event kernel (``csrc/tf1d.cuh``).

``mxu``: the weights of ``vpt_tpu.sampling.sample_transfer_1d_mxu``, the
lookup of a ``make_scene(tf_mxu=True)`` scene.  JAX evaluates it as a
one-hot matmul whose weights ``w_i = clip(1 − |u − i|, 0, 1)`` are cast to
the table dtype, so with ``mxu=torch.bfloat16`` the two nonzero weights are
rounded to bfloat16 before ``w_i0·c[i0] + w_i1·c[i1]`` (float32).  ``None``
keeps the bilinear formula.

:func:`lookup` takes the plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; it never falls back.  What a launch
needs of the table (its checks, pointer, width, mode, device and the grid's
cap) is prepared once per table and mode (``_build.TableCache``); a call
then checks the values, allocates the output and launches on PyTorch's
current stream.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
#: the largest row a kernel stages in shared memory: 48 KiB of (TW, 4)
#: float32, what a launch may take without opting in (the MCM event kernel
#: opts in for the MVP and the environment texel beside the row)
MAX_WIDTH = 48 * 1024 // 16

#: the kernels' code for each lookup mode (``csrc/tf1d.cuh``)
MODES = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def check_width(width: int) -> None:
    """Raise for a TF row wider than the kernels' shared-memory cap."""
    if width > MAX_WIDTH:
        raise ValueError(f"TF row of {width} texels exceeds the kernels' "
                         f"shared-memory cap of {MAX_WIDTH}")


def mode_code(mxu) -> int:
    if mxu not in MODES:
        raise ValueError(f"unknown TF lookup mode {mxu!r}: None (bilinear), "
                         "torch.float32 or torch.bfloat16 (tf_mxu weights)")
    return MODES[mxu]


def pack_table(tf_texture):
    """(TH, TW, 4) TF texture → ((TW, 4) float32 y = 0 row, TW)."""
    row = torch.as_tensor(tf_texture)[0].to(torch.float32).contiguous()
    return row, row.shape[0]


def lookup_plain(table, values, mxu=None):
    """The lookup in plain PyTorch: values (...) → (..., 4)."""
    mode_code(mxu)
    width = table.shape[0]
    u = torch.clamp(values * width - 0.5, 0.0, width - 1.0)
    i0f = torch.floor(u)
    i0 = torch.clamp(i0f.to(torch.int64), 0, width - 1)
    i1 = torch.clamp(i0 + 1, max=width - 1)
    if mxu is None:
        f = (u - i0f)[..., None]
        return table[i0] * (1.0 - f) + table[i1] * f
    # the two nonzero one-hot weights (at u = W−1 the second is 0 and its
    # clamped index is harmless)
    w0 = torch.clamp(1.0 - torch.abs(u - i0f), 0.0, 1.0)
    w1 = torch.clamp(1.0 - torch.abs(u - (i0f + 1.0)), 0.0, 1.0)
    w0 = w0.to(mxu).to(torch.float32)[..., None]
    w1 = w1.to(mxu).to(torch.float32)[..., None]
    return w0 * table[i0] + w1 * table[i1]


#: the fields of :func:`launch_shape`, in the order ``vpt_tf1d_info``
#: writes them
LAUNCH_FIELDS = ("threads_per_block", "blocks_per_sm", "sms",
                 "static_smem_bytes", "dynamic_smem_bytes")


def launch_shape(width: int, device: int) -> dict:
    """The standalone kernel's launch shape for a row of ``width`` texels
    on CUDA device ``device``: threads a block, resident blocks an SM, SMs,
    static and dynamic shared memory a block.  Launches nothing."""
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    _build.check("vpt_tf1d_info",
                 _build.library().vpt_tf1d_info(width, device, out))
    return dict(zip(LAUNCH_FIELDS, out))


class _Table(ctypes.Structure):
    """``VptTf1dTable`` of ``csrc/tf1d.cu``: what a launch needs of the
    table, passed as one pointer."""
    _fields_ = [("table", ctypes.c_void_p), ("width", ctypes.c_int),
                ("mode", ctypes.c_int), ("max_blocks", ctypes.c_int),
                ("device", ctypes.c_int)]


def _prepare(table, mxu):
    mode = mode_code(mxu)
    if not table.is_cuda or table.dtype != torch.float32 \
            or table.dim() != 2 or table.shape[1] != 4:
        raise ValueError("tf1d.lookup needs a (TW, 4) float32 table on the "
                         "values' CUDA device")
    width = table.shape[0]
    check_width(width)
    _build.check_aligned(table, "the TF table")
    device = table.get_device()
    shape = launch_shape(width, device)
    args = _Table(table.data_ptr(), width, mode,
                  max(1, shape["blocks_per_sm"] * shape["sms"]), device)
    return _build.Prepared(ptr=table.data_ptr(), width=width, device=device,
                           args=args, address=ctypes.addressof(args),
                           launch=_build.library().vpt_tf1d_lookup)


_tables = _build.TableCache(_prepare)


def _launch(p, values, n):
    """The kernel on the ``n`` CUDA ``values`` through the prepared table
    ``p``."""
    global LAUNCHES
    if values.dtype is not torch.float32 or values.get_device() != p.device:
        raise ValueError("tf1d.lookup needs float32 values on the table's "
                         "CUDA device")
    if not values.is_contiguous():
        values = values.contiguous()
    out = values.new_empty(values.shape + (4,))
    err = p.launch(p.address, values.data_ptr(), out.data_ptr(), n,
                   _build.current_stream(p.device))
    if err:
        _build.check("vpt_tf1d_lookup", err)
    LAUNCHES += 1
    return out


def lookup(table, values, mxu=None):
    """values (...) float32 → (..., 4) float32 through the TF row
    ``table`` (from :func:`pack_table`), in the mode ``mxu``."""
    if not values.is_cuda:
        return lookup_plain(table, values, mxu)
    return _launch(_tables.get(table, mxu), values, values.numel())


def lookup_1d(table, values, width: int, mxu=None):
    """values (H, W) in [0, 1] → (H, W, 4), the signature of
    ``vpt_tpu.pallas.tf1d.lookup_1d``.  Like the Pallas kernel it requires
    a pixel count that is a multiple of 128."""
    n = values.numel()
    if values.ndim != 2 or n % 128:
        raise ValueError("(H, W) values whose pixel count is a multiple of "
                         "128")
    # on the card the prepared table knows its width
    p = _tables.get(table, mxu) if values.is_cuda else None
    rows = table.shape[0] if p is None else p.width
    if width != rows:
        raise ValueError(f"width {width} does not match the table's {rows} "
                         "texels")
    return lookup_plain(table, values, mxu) if p is None \
        else _launch(p, values, n)
