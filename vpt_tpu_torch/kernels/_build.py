"""Build and load the port's CUDA kernels.

All sources in ``vpt_tpu_torch/csrc/`` compile with ``nvcc`` into one shared
library with a plain C interface, ``build/vpt_tpu_torch/libvpt_tpu_torch.so``
at the root of the checkout, loaded with ``ctypes``.  The build runs at the
first kernel launch and again whenever a hash of the sources and flags
changes.  Nothing here runs at import time: the CPU tests import every
module on machines without ``nvcc``.

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

#: C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES = {
    "vpt_tf1d_lookup": [_P, _I, _I, _P, _P, _L, _P],
    "vpt_tonemap": [_P, _P, _L, _I, _F, _F, _F, _F, _P],
    "vpt_mcm_event": ([_P] * 7 + [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P]
                      + [_F] * 7 + [_I, _I, _I, _I, _P]),
    "vpt_gather_rows": [_P, _L, _I, _P, _L, _P, _P],
    "vpt_corner_fetch": [_P, _L, _I, _P, _P, _L, _P, _P],
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
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


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
