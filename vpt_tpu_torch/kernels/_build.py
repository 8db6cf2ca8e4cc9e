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
import operator
import os
import pathlib
import struct
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
    # the argument list every build since K5's redesign exports: state (7);
    # table, bf16, D, H, W, TF row, TW, TF mode; the 1x1 env texel; MVP,
    # width, height; 7 floats; max bounces, steps, use_skip; stream
    "vpt_mcm_event": ([_P] * 7 + [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I,
                                  _I] + [_F] * 7 + [_I, _I, _I, _P]),
    # the same with an (EH, EW, 4) env map: env, EH, EW; grid or null, N;
    # and before the stream the 2D TF table, TH, channels and filter
    "vpt_mcm_event_frame": ([_P] * 7 + [_P, _I, _I, _I, _I, _P, _I, _I, _P,
                                        _I, _I, _P, _I, _P, _I, _I]
                            + [_F] * 7 + [_I, _I, _I, _P, _I, _I, _I, _I, _I,
                                          _P]),
    "vpt_mcm_event_info": [_I, _I, _P],
    # a launch of the halo instance: state (7); table, bf16, D, H, W, TF
    # row, TW, TF mode; env, EH, EW; MVP; 2D TF table, TH, channels;
    # width, height; 7 floats; max bounces, use_skip, row0, full height;
    # rng, value; slab index, slabs, interleave, masked, interact, flight;
    # stream
    "vpt_mcm_halo_event": ([_P] * 7 + [_P, _I, _I, _I, _I, _P, _I, _I, _P,
                                       _I, _I, _P, _P, _I, _I, _I, _I]
                           + [_F] * 7 + [_I] * 4 + [_P] * 2 + [_I] * 6
                           + [_P]),
    "vpt_mcm_halo_info": [_I, _I, _P],
    # a launch of the resident instance: state (7); table, bf16, D, H, W,
    # TF row, TW, TF mode; env, EH, EW; MVP; 2D TF table, TH, channels;
    # rows; 7 floats; max bounces, use_skip; rstate, ndc, pixel_id,
    # occupied, pending; slab index, slabs, interleave, reseed, interact,
    # flight; stream
    "vpt_mcm_resident_event": ([_P] * 7 + [_P, _I, _I, _I, _I, _P, _I, _I,
                                           _P, _I, _I, _P, _P, _I, _I, _I]
                               + [_F] * 7 + [_I] * 2 + [_P] * 5 + [_I] * 6
                               + [_P]),
    "vpt_mcm_resident_info": [_I, _I, _P],
    "vpt_gather_rows": [_P, _L, _I, _P, _L, _P, _P],
    "vpt_corner_fetch": [_P, _P, _L, _P, _P, _P, _P],
    # prepared VptCornerTable of the slab, D, slab index, slabs,
    # interleave, masked, position, n, out, cells, fractions, stream
    "vpt_slab_fetch": [_P, _I, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P],
    "vpt_scatter_add_rows8": [_P, _L, _P, _P, _L, _P],
    "vpt_corner_grad": [_P, _L, _L, _I, _P, _P, _P, _L, _P],
    "vpt_corner_grad_info": [_I, _I, _P],
    # prepared VptMarchExt, state; first, mix; stream
    "vpt_march_launch": [_P, _P, _F, _F, _P],
    # a prepared VptMarchHalo
    "vpt_march_halo_check": [_P],
    # a checked VptMarchHalo; value, carry, state; first, mix; k0, count,
    # stages (1 fetch, 2 fold); stream
    "vpt_march_halo_launch": [_P, _P, _P, _P, _F, _F, _I, _I, _I, _P],
    # stage (0 fetch, 1 fold), mode, flags (1 bf16, 8 two channels, 16
    # 64-bit rows), TW, TF mode, D, device, out
    "vpt_march_halo_info": [_I, _I, _I, _I, _I, _I, _I, _P],
    # mode, flags (1 bf16, 2 clamp boxes, 4 ext of one channel, 8 of two),
    # TW, TF mode, device, out
    "vpt_march_info": [_I, _I, _I, _I, _I, _P],
    # the argument list every build since the port exports: state, mode;
    # table, bf16, D, H, W, TF row, TW, TF mode, MVP; width, height,
    # slices; step, first, extinction, level, mix; stream
    "vpt_march_frame": ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I,
                         _I, _I] + [_F] * 5 + [_P]),
    # prepared VptIsoShadeExt, state, out; stream
    "vpt_iso_shade_launch": [_P, _P, _P, _P],
    # flags (1 bf16, 2 ext of one channel, 4 of two), TF mode, device, out
    "vpt_iso_shade_info": [_I, _I, _I, _P],
    # a prepared VptIsoHalo
    "vpt_iso_halo_check": [_P],
    # a checked VptIsoHalo; state, out; epoch; stage (0 fetch, 1 shade),
    # hits (-1: read on the card), pinned host int or null; stream
    "vpt_iso_halo_launch": [_P, _P, _P, _I, _I, _I, _P, _P],
    # stage, flags (1 bf16, 4 two channels, 16 64-bit rows), TF mode,
    # device, out
    "vpt_iso_halo_info": [_I, _I, _I, _I, _P],
    # the argument list every build since the port exports: state, out;
    # table, bf16, D, H, W, TF row, TW, TF mode; width, height; h, 2h,
    # light xyz; stream
    "vpt_iso_shade": ([_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I]
                      + [_F] * 5 + [_P]),
    # prepared VptMcsExt, state; seed, direction xyz, n; counts; stream
    "vpt_mcs_launch": [_P, _P] + [_F] * 5 + [_P, _P],
    # flags (1 bf16, 4 an environment map, 8 ext, 16 two channels), TW,
    # device, out
    "vpt_mcs_info": [_I, _I, _I, _P],
    # a prepared VptMcsHaloFrame
    "vpt_mcs_halo_check": [_P],
    # a checked VptMcsHaloFrame; first launch, launches, read (pinned host
    # int or null); stream
    "vpt_mcs_halo_run": [_P, _I, _I, _P, _P],
    # flags (1 bf16, 4 an environment map, 16 two channels, 32 the tail),
    # TW, device, out
    "vpt_mcs_halo_info": [_I, _I, _I, _P],
    # the argument list every build since the port exports: state; table,
    # bf16, D, H, W, TF row, TW, TF mode, MVP, env; width, height; seed,
    # extinction, cell; use_skip; direction xyz, n; stream
    "vpt_mcs_frame": ([_P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I]
                      + [_F] * 3 + [_I] + [_F] * 4 + [_P]),
    # prepared VptDosArgs; color, occlusion, scratch occlusion, depth,
    # max depth, slice distance, offsets, the table's rows or null; stream
    "vpt_dos_frame": [_P] * 10,
    # flags (1 bf16, 2 ext of one channel, 4 of two), TF mode, steps, disk
    # taps, device, out
    "vpt_dos_sweep_info": [_I, _I, _I, _I, _I, _P],
    # a prepared VptDosBandFrame
    "vpt_dos_band_check": [_P],
    # a prepared VptDosBandFrame; ext, ext row0, ext rows, slice; stream
    "vpt_dos_band_slice": [_P, _P, _I, _I, _I, _P],
    # a prepared VptDosBandFrame of a HaloScene; slice; stream
    "vpt_dos_band_fetch": [_P, _I, _P],
    # prepared VptDosExt of a slab; color, occlusion, scratch occlusion,
    # depth, max depth, slice distance, offsets; slab index, slabs,
    # interleave, masked; value; k0, count, stage, advance; stream
    "vpt_dos_halo_launch": [_P] * 8 + [_I] * 4 + [_P] + [_I] * 4 + [_P],
    # stage (0 the fetch of a frame or a band, 1 the fold), flags (1 bf16,
    # 4 two channels), TF mode, disk taps, the fold's slices, device, out
    "vpt_dos_halo_info": [_I, _I, _I, _I, _I, _I, _P],
    # prepared VptLaoArgs, state; stream
    "vpt_lao_launch": [_P, _P, _P],
    # prepared VptLaoArgs, state, counts; stream
    "vpt_lao_count": [_P, _P, _P, _P],
    # flags (1 bf16 corner table, 2 ext of one channel, 4 of two, 8
    # baked), bf16 TF table, 64-bit rows, device, out
    "vpt_lao_info": [_I, _I, _I, _I, _P],
    # prepared VptLaoHalo of a slab; slab index, slabs, interleave, masked;
    # value, state; chunk; stream
    "vpt_lao_halo_launch": [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    # flags (1 bf16 slab rows, 4 two channels, 8 baked, 16 64-bit rows),
    # bf16 TF table, device, out (11 ints)
    "vpt_lao_halo_info": [_I, _I, _I, _P],
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


_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


def f32(x) -> float:
    """``x`` rounded to the nearest float32 (ties to even), as a Python
    float: the value ``np.float32(x)`` holds, at a fraction of numpy's
    per-scalar cost.  One IEEE operation on float32 values done in float64
    and rounded so gives the float32 operation's result: float64 carries
    more than 2·24 + 2 bits, which makes the double rounding innocuous for
    +, −, ×, ÷ and √."""
    return _F32.unpack(_F32.pack(x))[0]


def f32_bits(x) -> int:
    """The bits of float32(x) as an int (``np.float32(x).view(uint32)``)."""
    return _U32.unpack(_F32.pack(x))[0]


def tile_pixels(width: int, height: int, tile_w: int, tile_h: int,
                warp_w: int):
    """(x, y, inside) of every thread of a frame kernel's launch over a
    ``width`` × ``height`` image, in launch order (block by block, thread
    by thread): ``vpt_tile_pixel`` of ``csrc/ray.cuh`` for block tiles
    ``tile_w`` × ``tile_h`` pixels and warp tiles ``warp_w`` wide, as the
    kernels' info entry points report them (``march.occupancy``,
    ``mcs_frame.occupancy``).  Three numpy arrays; ``inside`` is False past
    the image's edge."""
    import numpy as np

    threads = tile_w * tile_h
    warp_h = 32 // warp_w
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    block = np.arange(tiles_x * tiles_y)[:, None]
    thread = np.arange(threads)[None, :]
    warp, lane = thread >> 5, thread & 31
    warps_x = tile_w // warp_w
    by, bx = block // tiles_x, block % tiles_x
    x = bx * tile_w + (warp % warps_x) * warp_w + lane % warp_w
    y = by * tile_h + (warp // warps_x) * warp_h + lane // warp_w
    x, y = x.ravel(), y.ravel()
    return x, y, (x < width) & (y < height)


class LastScene:
    """The scene's part of a kernel's launch arguments, prepared once for
    the last (scene, key): a renderer launches one scene at one resolution
    frame after frame.

    ``prepare(scene, key)`` checks the scene and returns what the launches
    pass (it holds the tensors whose pointers they pass); ``fields(scene)``
    names the scene's tensors it reads.  The entry holds the scene weakly
    and goes with it, and is prepared anew when the scene, the key or one
    of those fields changed."""

    def __init__(self, prepare, fields):
        self._prepare = prepare
        self._fields = fields
        self._last = None

    def get(self, scene, key=None):
        fields = self._fields(scene)
        last = self._last
        if last is not None and last.scene() is scene and last.key == key \
                and all(map(operator.is_, last.fields, fields)):
            return last.value
        value = self._prepare(scene, key)
        self._last = types.SimpleNamespace(
            scene=weakref.ref(scene, self._forget), key=key, fields=fields,
            value=value)
        return value

    def _forget(self, ref):
        if self._last is not None and self._last.scene is ref:
            self._last = None


def check_image(state, shape, device, what):
    """Raise unless ``state`` is a contiguous float32 tensor of ``shape``
    on ``device`` whose pixels a 32-bit integer indexes."""
    if state.device != device or state.dtype != torch.float32 \
            or tuple(state.shape) != tuple(shape) \
            or not state.is_contiguous():
        raise ValueError(f"{what} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}")
    if shape[0] * shape[1] >= 2 ** 31:
        raise ValueError(f"{shape[0]}x{shape[1]}: the kernels index pixels "
                         "with 32-bit integers")


def window_key(window, height):
    """What a row window adds to a wrapper's preparation key: nothing for
    the whole image (None or ``(0, height)``), else ``(row0,
    full_height)`` (``sampling.row_window``)."""
    from ..sampling import row_window

    window = row_window(window, height)
    return () if window == (0, height) else window


def corner_table(table, volume_shape, what, channels: int = 1):
    """The (D·H·W, 8·channels) float32 or bfloat16 corner table a
    per-pixel kernel fetches from: raises for a scene without one (a
    hand-built Scene: ``make_scene`` gives every scene on the card its
    tables) or of another shape, and returns it contiguous."""
    if table is None:
        raise NotImplementedError(
            f"the {what} kernel samples corner-packed tables only, and this "
            "scene has none: build it with make_scene (pack=True, or any "
            "scene on the card)")
    d, h, w = volume_shape[:3]
    if table.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(table.shape) != (d * h * w, 8 * channels):
        raise ValueError(f"the corner table must be (D*H*W, {8 * channels}) "
                         "float32 or bfloat16")
    table = table.contiguous()
    check_aligned(table, "the corner table")
    return table


def scene_args(scene, table, what, ext: bool = False):
    """The launch arguments a per-pixel kernel takes from a scene and one
    of its corner tables: ``(tensors, args)`` with ``args`` = (table,
    table is bf16, D, H, W, TF row, TW, TF mode, inverse MVP) and
    ``tensors`` the tensors they point into.  ``what`` names the kernel in
    the errors.

    ``ext``: the kernel has ext instances for two-channel and filtered
    scenes (K5–K10); ``args`` then ends with (2D TF table or None, TH,
    channels, filter).  A two-channel scene passes its packed (TH·TW, 16)
    TF table, which must have the corner table's dtype; a filtered one
    must have float32 rows.  A kernel without them raises for such
    scenes, before any launch.  The cheb-skip table is always a
    single-channel linear fetch; (1, 0) is the headline's fetch, anything
    else runs a kernel's ext instances (``csrc/ray.cuh``)."""
    from .. import sampling
    from . import tf1d

    if scene.filter not in sampling.FILTERS:
        raise ValueError(f"unknown volume filter {scene.filter!r}: one of "
                         f"{sorted(sampling.FILTERS)}")
    channels, filt = (1, 0) if table is scene.tracking_packed \
        and table is not None \
        else (scene.channels, sampling.FILTERS[scene.filter])
    if (channels, filt) != (1, 0) and not ext:
        raise NotImplementedError(
            f"the {what} kernel takes single-channel linear-filter volumes "
            f"only, not {channels} channels with the {scene.filter!r} "
            "filter")
    table = corner_table(table, scene.volume.shape, what, channels)
    row = scene.transfer_1d.to(torch.float32).contiguous()
    tf1d.check_width(row.shape[0])
    check_aligned(row, "the TF row")
    mvp = scene.mvp_inverse.to(torch.float32).contiguous()
    d, h, w = scene.volume.shape[:3]
    args = (table.data_ptr(), int(table.dtype == torch.bfloat16), d, h, w,
            row.data_ptr(), row.shape[0], tf1d.mode_code(scene.tf_mxu),
            mvp.data_ptr())
    tensors = (table, row, mvp)
    if not ext:
        return tensors, args
    if filt and table.dtype != torch.float32:
        raise ValueError(f"the {what} kernel filters float32 corner tables "
                         f"only, not {table.dtype}")
    tf_table, th = None, 0
    if channels == 2:
        tf_table = scene.transfer_packed
        th, tw = scene.transfer.shape[:2]
        if tf_table is None or tf_table.dtype != table.dtype \
                or tuple(tf_table.shape) != (th * tw, 16):
            raise ValueError("a two-channel scene's kernels take the packed "
                             "(TH*TW, 16) TF table in the corner table's "
                             "dtype")
        tf_table = tf_table.contiguous()
        check_aligned(tf_table, "the packed TF table")
        tensors += (tf_table,)
    return tensors, args + (
        None if tf_table is None else tf_table.data_ptr(), th, channels,
        filt)


def is_halo(scene) -> bool:
    """Whether ``scene`` is a ``parallel.halo.HaloScene`` (a rank's z slab
    of the volume)."""
    return hasattr(scene, "num_slabs")


def slab_scene(scene, use_skip: bool = False):
    """What a kernel's halo or resident launch takes of a HaloScene:
    ``(tensors, args)``, ``args`` = (the slab's corner rows, or with
    ``use_skip`` its cheb-skip rows, bf16, D, H, W, TF row, TW, TF mode,
    environment, EH, EW, inverse MVP, the packed 2D TF table or None, TH,
    channels) and ``tensors`` the tensors they point into.  A two-channel
    scene samples its (rows, 16) slab rows and looks the pair up in the
    packed TF table of the rows' dtype."""
    from . import tf1d
    from ..parallel.halo import slab_depth

    if scene.filter != "linear":
        raise ValueError("a HaloScene has no filter")
    channels = 1 if use_skip else scene.channels
    table = scene.tracking_packed if use_skip else scene.slab_packed
    d, h, w = scene.volume_shape[:3]
    rows = slab_depth(d, scene.num_slabs, scene.interleave) * h * w
    if table is None or table.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(table.shape) != (rows, 8 * channels):
        raise ValueError("a HaloScene frame on the card samples the slab's "
                         f"({rows}, {8 * channels}) float32 or bfloat16 "
                         "corner rows (halo.slab_table)")
    table = table.contiguous()
    check_aligned(table, "the slab table")
    row = scene.transfer_1d.to(torch.float32).contiguous()
    tf1d.check_width(row.shape[0])
    check_aligned(row, "the TF row")
    mvp = scene.mvp_inverse.to(torch.float32).contiguous()
    env, eh, ew = environment_map(scene)
    tf_table, th = None, 0
    if channels == 2:
        tf_table = scene.transfer_packed
        th, tw = scene.transfer.shape[:2]
        if tf_table is None or tf_table.dtype != table.dtype \
                or tuple(tf_table.shape) != (th * tw, 16):
            raise ValueError("a two-channel HaloScene's kernels take the "
                             "packed (TH*TW, 16) TF table in the slab "
                             "rows' dtype")
        tf_table = tf_table.contiguous()
        check_aligned(tf_table, "the packed TF table")
    return (table, row, mvp, env, tf_table), (
        table.data_ptr(), int(table.dtype == torch.bfloat16), d, h, w,
        row.data_ptr(), row.shape[0], tf1d.mode_code(scene.tf_mxu),
        env.data_ptr(), eh, ew, mvp.data_ptr(),
        None if tf_table is None else tf_table.data_ptr(), th, channels)


#: the most z planes of a slab's plane map (``kMaxPlanes``: its copy in a
#: block's shared memory stays under 48 KB)
MAX_PLANES = 6144


def slab_plane_map(depth: int, num_slabs: int, slab_index: int,
                   interleave: int = 1):
    """The slab's plane map (``csrc/slab.cuh``'s ``vpt_slab_plane``): a
    (depth, 2) int32 tensor on the CPU whose row z0 is (the slab-local
    plane, the owning slab) of the volume's plane z0, ``vpt_slab_z``'s
    integers: contiguous slabs (interleave 1) of ds = depth / S planes give
    (clip(z0 − k·ds, 0, ds − 1), clip(z0 / ds, 0, S − 1)); ``interleave`` m
    thin slabs of thin_ds = depth / (m·S) give ((t / S)·(thin_ds + 1) + z0
    − t·thin_ds, t mod S) for t = z0 / thin_ds.  A kernel places a cell
    with one load of it in place of those divisions."""
    if not 0 < depth <= MAX_PLANES:
        raise ValueError(f"a slab's plane map holds 1 to {MAX_PLANES} "
                         f"planes, not {depth}")
    if num_slabs < 1 or interleave < 1 or depth % (num_slabs * interleave) \
            or not 0 <= slab_index < num_slabs:
        raise ValueError(f"slab {slab_index} of {num_slabs} (interleave "
                         f"{interleave}) of {depth} planes")
    rows = []
    for z0 in range(depth):
        if interleave == 1:
            ds = depth // num_slabs
            rows.append((min(max(z0 - slab_index * ds, 0), ds - 1),
                         min(max(z0 // ds, 0), num_slabs - 1)))
        else:
            thin_ds = depth // (interleave * num_slabs)
            thin = z0 // thin_ds
            rows.append(((thin // num_slabs) * (thin_ds + 1)
                         + (z0 - thin * thin_ds), thin % num_slabs))
    return torch.tensor(rows, dtype=torch.int32)


def scene_plane_map(scene):
    """:func:`slab_plane_map` of a HaloScene, on its slab table's device."""
    return slab_plane_map(scene.volume_shape[0], scene.num_slabs,
                          scene.slab_index, scene.interleave).to(
        scene.slab_packed.device)


#: the most bytes of a halo frame's values that one fetch writes
HALO_VALUE_BYTES = 1 << 30


def halo_chunk(steps: int, pixels: int, channels: int, cap=None) -> int:
    """The slices a halo frame (K6's, K9's) samples in one fetch: all of its
    ``steps`` where their values (4 bytes a pixel, channel and slice) fit
    in ``cap`` bytes (by default HALO_VALUE_BYTES), else the most that fit,
    at least 1."""
    cap = HALO_VALUE_BYTES if cap is None else cap
    per_slice = 4 * max(pixels, 1) * channels
    return max(1, min(steps, cap // per_slice))


def halo_chunks(steps: int, chunk: int):
    """A halo frame's chunks of slices, as (first slice, slices, last)
    tuples: one of all ``steps`` where ``chunk`` (:func:`halo_chunk`) holds
    them, each a fetch, an all-reduce and a fold, the last fold ending the
    frame."""
    return [(k0, min(chunk, steps - k0), k0 + chunk >= steps)
            for k0 in range(0, steps, chunk)]


def environment_map(scene):
    """``(map, EH, EW)``: the scene's (EH, EW, 4) equirect environment as a
    contiguous float32 tensor that the MC kernels read as float4 texels (a
    1×1 map is one texel, which they keep in shared memory)."""
    env = scene.environment
    if env.dim() != 3 or env.shape[-1] != 4:
        raise ValueError("the environment map must be (EH, EW, 4)")
    env = env.to(torch.float32).contiguous()
    check_aligned(env, "the environment map")
    return env, env.shape[0], env.shape[1]


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
