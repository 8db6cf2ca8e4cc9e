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
launches the kernel for a CUDA tensor; it never falls back.
"""

from __future__ import annotations

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


def lookup(table, values, mxu=None):
    """values (...) float32 → (..., 4) float32 through the TF row
    ``table`` (from :func:`pack_table`), in the mode ``mxu``."""
    if not values.is_cuda:
        return lookup_plain(table, values, mxu)
    global LAUNCHES
    mode = mode_code(mxu)
    width = table.shape[0]
    check_width(width)
    if table.device != values.device or table.dtype != torch.float32 \
            or values.dtype != torch.float32 or table.shape[1:] != (4,):
        raise ValueError("tf1d.lookup needs a (TW, 4) float32 table and "
                         "float32 values on one CUDA device")
    table = table.contiguous()
    _build.check_aligned(table, "the TF table")
    flat = values.contiguous()
    out = torch.empty(values.shape + (4,), dtype=torch.float32,
                      device=values.device)
    lib = _build.library()
    _build.check("vpt_tf1d_lookup", lib.vpt_tf1d_lookup(
        table.data_ptr(), width, mode, flat.data_ptr(), out.data_ptr(),
        flat.numel(), _build.stream_ptr(values)))
    LAUNCHES += 1
    return out


def lookup_1d(table, values, width: int, mxu=None):
    """values (H, W) in [0, 1] → (H, W, 4), the signature of
    ``vpt_tpu.pallas.tf1d.lookup_1d``.  Like the Pallas kernel it requires
    a pixel count that is a multiple of 128."""
    h, w = values.shape
    if (h * w) % 128 != 0:
        raise ValueError("pixel count must be a multiple of 128")
    if width != table.shape[0]:
        raise ValueError(f"width {width} does not match the table's "
                         f"{table.shape[0]} texels")
    return lookup(table, values, mxu)
