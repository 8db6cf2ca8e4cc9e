"""Build and load the port's CUDA kernels.

All sources in ``vpt_tpu_torch/csrc/`` compile with ``nvcc`` into one shared
library with a plain C interface, ``build/vpt_tpu_torch/libvpt_tpu_torch.so``
at the root of the checkout, loaded with ``ctypes``: one ``nvcc -c`` a
source, all started together, then one link.  The build runs at the first
kernel launch and again whenever a hash of the sources and flags changes.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into one fused
multiply-add: the plain PyTorch versions round after every operation, and a
one-ulp change in a photon's position can flip a branch and with it the
pixel's whole random stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
import time
import types
import weakref

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "vpt_tpu_torch"
LIB_NAME = "libvpt_tpu_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry points: name -> argument types (every one returns 0 or a CUDA
#: error code)
SIGNATURES = {
    "vpt_tf1d_lookup": [_P, _P, _P, _L, _P],
    "vpt_tf1d_info": [_I, _I, _P],
    "vpt_tonemap": [_P, _P, _L, _I, _F, _F, _F, _F, _P],
    "vpt_mcm_event": ([_P] * 7 + [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I,
                                  _I] + [_F] * 7 + [_I, _I, _I, _P]),
    "vpt_mcm_event_info": [_I, _I, _P],
    "vpt_gather_rows": [_P, _L, _I, _P, _L, _P, _P],
    "vpt_corner_fetch": [_P, _P, _L, _P, _P, _P, _P],
    "vpt_scatter_add_rows8": [_P, _L, _P, _P, _L, _P],
    "vpt_corner_grad": [_P, _L, _I, _P, _P, _P, _L, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds nvcc took in this process (0 while the cached library is current)
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build() -> pathlib.Path:
    """Compile the library unless the one on disk matches the sources."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".hash")
    digest = source_hash()
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return lib_path
    t0 = time.perf_counter()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for source in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, source.stem + ".o")
            cmd = [_nvcc(), *compile_flags, "-c", "-I", str(CSRC), "-o",
                   obj, str(source)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = os.path.join(tmp, LIB_NAME)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-shared", "-o", lib_tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib_tmp, lib_path)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_aligned(tensor, name: str) -> None:
    """The kernels read rows as 16-byte vectors."""
    if tensor.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


#: the raw ``cudaStream_t`` of PyTorch's current stream on a device index:
#: it follows ``torch.cuda.stream(s)`` and, unlike
#: ``torch.cuda.current_stream(device).cuda_stream``, builds no Stream object
#: (None in a CPU-only build of PyTorch, which launches nothing)
current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(tensor) -> int:
    return current_stream(tensor.get_device())


class Prepared(types.SimpleNamespace):
    """The launch arguments that come from one table: its checked pointer
    and whatever else a wrapper derives from it once (sizes, mode, device,
    the bound C function)."""


class TableCache:
    """Preparations of tables, one per live table tensor and key.

    ``prepare(table, key)`` checks a contiguous table and returns a
    :class:`Prepared` with ``ptr``, its data pointer.  An entry holds its
    table weakly and goes with it, and a table whose storage moved
    (``.set_``, ``.data =``) is prepared anew; so an entry always points
    into its live table and sees in-place updates.  A non-contiguous table
    is copied and prepared at every call, never cached."""

    def __init__(self, prepare):
        self._prepare = prepare
        self._entries = {}

    def __len__(self):
        return len(self._entries)

    def get(self, table, key=None) -> Prepared:
        k = (id(table), key)
        entry = self._entries.get(k)
        if entry is None or entry.table() is not table \
                or entry.ptr != table.data_ptr():
            if not table.is_contiguous():
                copy = table.contiguous()
                entry = self._prepare(copy, key)
                entry.table = lambda: copy      # held for this call only
                return entry
            entry = self._prepare(table, key)
            entry.table = weakref.ref(table, lambda ref: self._drop(k, ref))
            self._entries[k] = entry
        return entry

    def _drop(self, k, ref):
        entry = self._entries.get(k)
        if entry is not None and entry.table is ref:
            del self._entries[k]
