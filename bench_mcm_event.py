"""Time a kernel of the port against other builds of it, in turns, on one
GPU: on the render headline the MCM event kernel (K5), the march kernel
(K6), the ISO shade kernel (K7), the MCS kernel (K8) or the LAO march
kernel (K10); on the fits' calls the corner-gradient kernel (K4).

    python3 bench_mcm_event.py [--kernel mcm_event|march|iso_shade|mcs|lao]
        [--variant NAME=PATH ...] [--frames 30]
        [--size 512] [--registers]
    python3 bench_mcm_event.py --kernel dos|corner_gather --registers
        [--variant ...]
    python3 bench_mcm_event.py --kernel lao_halo [--variant ...]
        [--scenes headline,blobs128 f32,config4]
    python3 bench_mcm_event.py --kernel corner_scatter [--variant ...]
        [--rounds 2] [--registers]

``current`` is the kernel's source in ``vpt_tpu_torch/csrc/`` as it
stands.  Each ``--variant`` is another source of the same kernel that
exports the same C interface (K5: ``vpt_mcm_event`` and
``vpt_mcm_event_info``; K6: ``vpt_march_frame``; K7: ``vpt_iso_shade``;
K8: ``vpt_mcs_frame``, the argument lists of ``kernels/_build.SIGNATURES``
that every build since the kernel's port exports; K10: ``vpt_lao_launch``,
which takes the tree's prepared ``VptLaoArgs``, whose fields are only ever
appended): an edited copy under
``build/`` with one design
lever changed (such as ``kChunk`` of ``march.cu``, or the tile constants of
a ``ray.cuh`` copied beside it), or an older design, such as an older
commit's from ``git archive COMMIT vpt_tpu_torch/csrc | tar -x -C
build/NAME`` (made before the run: a copy of the checkout without its git
history has no commits to archive).  Every source is built with the
headers beside it first, then those of ``csrc/``, with the port's nvcc
flags plus ``-Xptxas -v``, all builds at once; a build that fails to build
or to launch is reported and left out.

K5 is driven through the port's wrapper (``kernels/mcm_event.launch_args``,
cut to ``vpt_mcm_event``'s list by :func:`mcm_event_args`)
on the headline's scene (``sphere_volume(128)``, sRGB gray ramp at alpha
0.8, cheb-skip, bf16 tables, ``tf_mxu``), 512², extinction 40, anisotropy
0.3, at steps 0 (a launch that only loads, seeds and stores the state), 8
and 32.  K6 (in each of its four modes) and K8 are driven through their
argument lists (:func:`march_args`, :func:`mcs_args`, the float32 frame
scalars of ``march.frame_scalars`` and ``mcs.scatter_direction``) on the
same scene at 512² (``--size``) with the renderers' default Params.  K7
is driven through its argument list (:func:`iso_args`) on the display of
one ISO frame's hits at 512², on three scenes (:data:`SHADE_SCENES`: the
headline's, float32 rows, and a TF row of 3072 texels) and of a state that
hits in every pixel, with L2 warm and flushed.  K10 is driven through
its build's entry point with the tree's prepared arguments
(``kernels/lao_march``, :func:`lao_launcher`) on the headline's scene and
a float32 ``blobs_volume(64)`` at 512², default Params; each build's
shape adds its SASS a slice, warp-slices, lanes' busy share and issue
floor (:func:`bench_lao`).

For each steps (K5), mode (K6, K8) or scene (K7) the builds run in a
palindromic order (current, the variants, the variants reversed, current;
K7 ``--rounds`` times), each from the
same reset state with the same frame seeds, so each is read twice,
symmetrically in time.  A reading is the kernel's device time per launch
(``torch.profiler``), the frame time (K5: host clock, synchronized; K6,
K8: CUDA events over back-to-back launches) and whether the state after
the frames equals ``current``'s bit for bit.  Prints the card and its SM
clock, each build's registers and spills (ptxas), its launch shape (the
info entry point where the build has one), its slice loop's SASS
instruction count (``cuobjdump -sass``: the largest backward branch's
body, over the rows it reads ahead) and, for K6, the instruction-issue
floor of the frame (that count times the slices the warps step through,
over 132 SMs × 4 warp-instructions a clock) beside the frame's bytes
bound; one JSON line per reading and one ``summary`` line per (steps or
mode, build) with its times over the baseline's (``--baseline``, default
``current``); and writes all of it as JSON to ``--out``.  With
``--registers`` it builds the sources and prints each build's registers
and spills per kernel instance (ptxas) and a digest of its code
(:func:`sass_digests`), launching nothing: a build whose C interface
differs from the tree's can be compared so.  The DOS slice kernel (K9)
and the corner gather (K3, whose slab instance shares ``slab.cuh``) take
``--registers`` only; ``chip_smoke.py --launch-path --part sweep`` times
K9's trees.  ``--kernel lao_halo`` times K10's halo instance of each
build in turns on a one-slab HaloScene of each of ``--scenes``
(:func:`bench_lao_halo`).  ``--kernel corner_scatter`` times K4's
corner-gradient kernel of each build (``vpt_corner_grad``, whose
argument list every build with K4's bucket instance exports) in turns,
the variants first (P C C P, ``--rounds`` 2: four readings a build), on
the four buckets of a bucketed EAM step, config 4's bucket 0, K4's row
shape and ``path fit eam``'s call shape (:func:`bench_corner_scatter`),
and K4's row shape again at C = 3, 4 and 5 (a build that refuses a
channel count is left out of that case alone); with ``--registers`` it
adds each build's residency from ``vpt_corner_grad_info`` for C = 1 to
5 where the build exports it (ptxas gives registers and shared bytes).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HEIGHT = WIDTH = 512
OCCUPANCY = ("threads_per_block", "blocks_per_sm", "sms", "registers",
             "local_bytes", "static_smem_bytes", "dynamic_smem_bytes")
#: each kernel: its source, the entry points every build exports, its info
#: entry point where a build has one, and its kernel's name
KERNELS = {
    "mcm_event": ("mcm_event.cu", ("vpt_mcm_event", "vpt_mcm_event_info"),
                  None, "mcm_event_kernel"),
    "march": ("march.cu", ("vpt_march_frame",), "vpt_march_info",
              "march_kernel"),
    "mcs": ("mcs_frame.cu", ("vpt_mcs_frame",), "vpt_mcs_info",
            "mcs_frame_kernel"),
    "iso_shade": ("iso_shade.cu", ("vpt_iso_shade",), "vpt_iso_shade_info",
                  "iso_shade_kernel"),
    "lao": ("lao_march.cu", ("vpt_lao_launch",), "vpt_lao_info",
            "lao_kernel"),
    "lao_halo": ("lao_march.cu", ("vpt_lao_launch", "vpt_lao_halo_launch"),
                 None, "lao_halo"),
    "dos": ("dos_sweep.cu", ("vpt_dos_frame",), "vpt_dos_sweep_info",
            "dos_sweep_kernel"),
    "corner_gather": ("corner_gather.cu", (), None, "slab_fetch_kernel"),
    "corner_scatter": ("corner_scatter.cu", ("vpt_corner_grad",),
                       "vpt_corner_grad_info", "corner_grad_kernel"),
}
#: the H100's SMs and warp schedulers an SM (one warp-instruction a clock)
SMS, SCHEDULERS = 132, 4


def compile_all(sources: dict, out_dir: pathlib.Path) -> dict:
    """Start one nvcc a source, all at once; return {name: (library path,
    ptxas output)} for those that built, and print the others' errors."""
    from vpt_tpu_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        lib = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(source.parent), "-I", str(_build.CSRC),
               "-o", str(lib), str(source)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{text}", flush=True)
            continue
        built[name] = (lib, text)
    return built


def ptxas_kernels(text: str, match: str) -> dict:
    """{mangled kernel name: registers and spills} of every entry function
    whose name holds ``match``, from -Xptxas -v."""
    out = {}
    blocks = re.split(r"ptxas info\s*: Compiling entry function", text)
    for block in blocks[1:]:
        head = block.splitlines()[0]
        name = re.search(r"'([^']+)'", head)
        if not name or match not in name.group(1):
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out[name.group(1)] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None,
            "smem_bytes": int(smem.group(1)) if smem else 0}
    return out


def sass_functions(lib_path, match: str) -> dict:
    """{mangled kernel name: (instruction addresses, backward branches)}
    of the functions whose name holds ``match``, from ``cuobjdump -sass``;
    the branches as {target: the last address that branches back to
    it}."""
    from vpt_tpu_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                           "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300)
    out, name = {}, None
    for line in proc.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            if match in name:
                out[name] = ([], {})
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if not ins or name not in out:
            continue
        addrs, back = out[name]
        at = int(ins.group(1), 16)
        addrs.append(at)
        branch = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins.group(2))
        if branch and int(branch.group(1), 16) < at:
            target = int(branch.group(1), 16)
            back[target] = max(back.get(target, 0), at)
    return out


def sass_digests(lib_path) -> dict:
    """{mangled kernel name: digest of its instructions} from ``cuobjdump
    -sass``, the addresses and encodings left out: two builds' kernels
    whose digests agree run the same code (compare by name without the
    anonymous namespace, whose mangled hash differs between trees)."""
    import hashlib

    from vpt_tpu_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                           "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300)
    out, name = {}, None
    for line in proc.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = hashlib.sha256()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if ins and name is not None:
            out[name].update(" ".join(ins.group(1).split()).encode())
    return {k: h.hexdigest()[:16] for k, h in out.items()}


def same_name(kernel: str) -> str:
    """A mangled kernel name without its anonymous namespace, whose hash
    differs between trees."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "",
                  kernel)


def digest_summary(name, mine, theirs) -> dict:
    """The kernels of build ``name`` against the current build's by name
    (:func:`same_name`): how many keep the same SASS digest, and the names
    that differ or are in one build only."""
    both = sorted(set(mine) & set(theirs))
    return {"build": name, "same_digest": sum(mine[k] == theirs[k]
                                              for k in both),
            "differs": [k for k in both if mine[k] != theirs[k]],
            "current_only": sorted(set(mine) - set(theirs)),
            f"{name}_only": sorted(set(theirs) - set(mine))}


def _span(addrs, span):
    return sum(1 for a in addrs if span[0] <= a <= span[1])


def sass_loops(lib_path, match: str) -> dict:
    """{mangled kernel name: (instructions, largest loop's instructions)}
    from ``cuobjdump -sass``: a loop is the body of a backward branch."""
    return {name: (len(addrs), max((_span(addrs, span)
                                    for span in back.items()), default=0))
            for name, (addrs, back) in sass_functions(lib_path,
                                                      match).items()}


def load(lib_path, names):
    from vpt_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(lib_path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def device_ms(launch, state, frames, match="mcm_event_kernel"):
    """(kernel device time per launch, launches the profiler recorded) by
    torch.profiler over ``frames`` launches; (None, 0) if it saw none.  The
    mean is over the launches it recorded, which may be fewer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            launch(state, 0.9 + 0.001 * i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if match in e.key]
    total = sum(getattr(e, "device_time_total", 0.0) for e in kernels)
    count = sum(e.count for e in kernels)
    return (total / 1e3 / count, count) if total > 0 else (None, 0)


def reading(name, launch, start, steps, frames):
    """One reading of a build from the reset state ``start``; returns it
    and the state after its host-clock frames."""
    import torch

    state = {k: v.clone() for k, v in start.items()}
    launch(state, 0.123)                                   # warm-up frame
    torch.cuda.synchronize()
    paths0 = float(state["samples"].sum(dtype=torch.float64))
    t0 = time.perf_counter()
    for i in range(frames):
        launch(state, 0.2 + 0.001 * i)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    paths = float(state["samples"].sum(dtype=torch.float64)) - paths0
    after = {k: v.clone() for k, v in state.items()}
    dev_ms, profiled = device_ms(launch, state, 10)
    events = HEIGHT * WIDTH * steps
    host_ms = host_s * 1e3 / frames
    return {
        "variant": name, "steps": steps, "frames": frames,
        "device_ms": dev_ms, "profiled_launches": profiled,
        "device_events_per_s": events / dev_ms * 1e3 if dev_ms else None,
        "host_ms_per_frame": host_ms,
        "host_events_per_s": events / host_ms * 1e3,
        "host_paths_per_s": paths / host_s,
        "mean_path_events": events * frames / paths if paths else None,
    }, after


def summarize(readings, key, keys, baseline):
    """Per (``key``, build): the mean of its readings, and its times over
    the baseline build's."""
    def mean(values):
        values = [v for v in values if v is not None]
        return sum(values) / len(values) if values else None

    rows = {}
    for r in readings:
        rows.setdefault((r[key], r["variant"]), []).append(r)
    out = []
    for (at, name), group in rows.items():
        line = {"summary": name, key: at, "readings": len(group),
                "state_equal_to_current": all(
                    r["state_equal_to_current"] for r in group)}
        line.update({k: mean([r.get(k) for r in group]) for k in keys})
        out.append(line)
    for line in out:
        base = next((x for x in out if x[key] == line[key]
                     and x["summary"] == baseline), None)
        for k in ("device_ms", "device_ms_cold", "host_ms_per_frame", "ms"):
            if base and line.get(k) and base.get(k):
                line[f"{k}_over_{baseline}"] = line[k] / base[k]
    return out


def variant(text: str):
    name, sep, path = text.partition("=")
    if not sep or not name or name == "current" or not path:
        raise argparse.ArgumentTypeError(
            f"{text!r}: expected NAME=PATH, NAME not 'current'")
    return name, pathlib.Path(path).resolve()


def headline_scene():
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    return make_scene(volume.sphere_volume(128),
                      transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                      tracking="auto", pack_dtype=torch.bfloat16,
                      tf_mxu=True)


def mcm_event_args(state, scene, params, seed):
    """``vpt_mcm_event``'s arguments (a 1x1 environment texel, no grid):
    the wrapper's ``vpt_mcm_event_frame`` list without EH, EW, the grid
    and its N."""
    from vpt_tpu_torch.kernels import mcm_event

    args = mcm_event.launch_args(state, scene, params, seed)
    env = 15                        # 7 state pointers, 8 of the table's
    if args[env + 1:env + 5] != (1, 1, None, 0):
        raise ValueError("vpt_mcm_event takes a 1x1 environment texel and "
                         "no majorant grid")
    return (*args[:env + 1], *args[env + 5:])


def bench_mcm_event(libs, frames):
    import torch

    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.renderers import mcm

    scene = headline_scene()

    def launcher(lib):
        def launch(state, seed):
            _build.check("vpt_mcm_event", lib.vpt_mcm_event(
                *mcm_event_args(state, scene, params, seed)))
        return launch

    readings, failed = [], set()
    with torch.cuda.stream(torch.cuda.Stream()):
        for steps in (0, 8, 32):
            params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
            start = mcm.reset(params, HEIGHT, WIDTH, scene)
            torch.cuda.synchronize()
            order = [n for n in libs if n != "current"]
            reference = None
            for name in ["current", *order, *order[::-1], "current"]:
                if name in failed:
                    continue
                try:
                    r, after = reading(name, launcher(libs[name]), start,
                                       steps, frames)
                except RuntimeError as exc:
                    print(f"{name}: {exc}, left out", flush=True)
                    failed.add(name)
                    continue
                if reference is None:
                    reference = after
                r["state_equal_to_current"] = all(
                    torch.equal(after[k], reference[k]) for k in after)
                r["samples_equal_to_current"] = float(
                    (after["samples"] == reference["samples"]).float().mean())
                readings.append(r)
                print(json.dumps(r), flush=True)
    return [r for r in readings if r["variant"] not in failed], failed


# -- K6 and K8 through the argument lists every build exports -------------

def march_args(mode, state, scene, params, seed, frame_number):
    """The arguments of one ``vpt_march_frame`` call (every build of K6
    since its port takes them): the state, the mode, the scene's table, TF
    row and inverse MVP, the image and ``march.frame_scalars``."""
    from vpt_tpu_torch.kernels import _build, march

    height, width = state.shape[:2]
    _, args = _build.scene_args(scene, scene.volume_packed, "march")
    return (state.data_ptr(), march.MODES[mode], *args, width, height,
            *march.frame_scalars(mode, params, seed, frame_number),
            _build.stream_ptr(state))


def mcs_args(state, scene, params, seed, frame_number):
    """The arguments of one ``vpt_mcs_frame`` call (every build of K8 since
    its port takes them), with the frame's ``mcs.scatter_direction``."""
    import numpy as np

    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.renderers import mcs

    height, width = state.shape[:2]
    use_skip = scene.tracking_packed is not None
    _, args = _build.scene_args(
        scene, scene.tracking_packed if use_skip else scene.volume_packed,
        "MCS")
    env, eh, ew = _build.environment_map(scene)
    if (eh, ew) != (1, 1):
        raise ValueError("vpt_mcs_frame takes a 1x1 environment texel")
    cell = mcs.skip_cell_size(scene) if use_skip else 0.0
    return (state.data_ptr(), *args, env.data_ptr(), width, height,
            float(np.float32(seed)), float(np.float32(params.extinction)),
            cell, int(use_skip),
            *(float(x) for x in mcs.scatter_direction(seed)),
            float(np.float32(frame_number)), _build.stream_ptr(state))


def iso_args(state, out, scene, params):
    """The arguments of one ``vpt_iso_shade`` call (every build of K7 since
    its port takes them): the ISO state, the image, the scene's table and
    TF row, h and the float32 2h, and ``iso.light_direction``."""
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.renderers import iso

    height, width = state.shape[:2]
    _, args = _build.scene_args(scene, scene.volume_packed, "ISO shade")
    step = _build.f32(params.gradient_step)
    return (state.data_ptr(), out.data_ptr(), *args[:-1], width, height,
            step, _build.f32(2.0 * step),
            *iso.light_direction(scene, params).tolist(),
            _build.stream_ptr(state))


def kernel_name(kind, mode, bf16=True):
    """The fragment of the mangled name of K6's (mode, dtype), K7's (dtype)
    or K8's (dtype, render path) instantiation."""
    from vpt_tpu_torch.kernels import march

    b = int(bf16)
    if kind == "march":
        return f"march_kernelILi{march.MODES[mode]}ELb{b}E"
    if kind == "iso_shade":
        return f"iso_shade_kernelILb{b}E"
    return f"mcs_frame_kernelILb{b}E"


def pick(table: dict, fragment: str):
    """The entry of the render path's instantiation whose name holds
    ``fragment`` (K8's counting one, ``fragment`` + ``Lb1E``, is not it)."""
    for name, value in table.items():
        at = name.find(fragment)
        if at >= 0 and not name[at + len(fragment):].startswith("Lb1E"):
            return value
    return None


def pick_kernel(table: dict, kind, mode, bf16, tf):
    """:func:`pick` of the headline's instantiation: K6's or K7's with the
    TF lookup mode ``tf`` as a template argument where the build has
    one."""
    fragment = kernel_name(kind, mode, bf16)
    if kind in ("march", "iso_shade"):
        found = pick(table, fragment + f"Li{tf}E")
        if found is not None:
            return found
    return pick(table, fragment)


def resident_blocks(registers):
    """Blocks of 128 threads an SM holds by registers alone (65536 an SM,
    allocated 256 a warp, 64 warps and 32 blocks at most)."""
    warp = -(-registers * 32 // 256) * 256
    warps = min(64, 65536 // warp // 4 * 4)
    return min(32, warps // 4)


def sm_clock_mhz():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    now, peak = (int(v) for v in smi.stdout.split(",")[:2])
    return now, peak


def bench_frames(kind, libs, built, frames):
    """K6 (each mode) or K8 of every build in turns; returns the readings,
    the per-(mode, build) shapes and the failed builds."""
    import torch

    import chip_smoke
    from vpt_tpu_torch.kernels import _build, march, mcs_frame, tf1d
    from vpt_tpu_torch.renderers import depth, eam, iso, mcs, mip

    modules = {"eam": eam, "mip": mip, "depth": depth, "iso": iso} \
        if kind == "march" else {"mcs": mcs}
    _, _, info_name, match = KERNELS[kind]
    scene = headline_scene()
    tw = scene.transfer_1d.shape[0]
    tf = tf1d.mode_code(scene.tf_mxu)
    table = scene.volume_packed if kind == "march" else scene.tracking_packed
    bf16 = table.dtype == torch.bfloat16
    readings, shapes, failed, clocks = [], {}, set(), []
    sass_of = {name: sass_loops(built[name][0], match) for name in libs}
    for mode, module in modules.items():
        params = module.Params()
        start = module.reset(params, HEIGHT, WIDTH, scene)
        work = {}
        if kind == "march":
            samples, rows, per_pixel, miss = chip_smoke.march_work(
                mode, scene, params, 0.5, HEIGHT, WIDTH)
            work = {"samples": samples, "corner_rows": rows}
            slices = params.slices if mode in ("eam", "depth") \
                else params.steps
            bound_ms, bound_by, _ = chip_smoke.frame_bound(
                scene, table, HEIGHT * WIDTH, 4 if mode == "mip" else 16,
                samples * chip_smoke.MARCH_OPS_SAMPLE
                + HEIGHT * WIDTH * chip_smoke.MARCH_OPS_PIXEL, rows)
            work.update(bound_ms=bound_ms, bound_by=bound_by)
        for name, lib in libs.items():
            shape = {"build": name, "mode": mode}
            ptx = pick_kernel(ptxas_kernels(built[name][1], match), kind,
                              mode, bf16, tf)
            shape.update(ptx or {})
            # the info entry point, which builds older than it lack
            info = getattr(lib, info_name, None)
            if info is not None:
                fields = (march.OCCUPANCY_FIELDS if kind == "march"
                          else mcs_frame.OCCUPANCY_FIELDS)
                out = (ctypes.c_int * len(fields))()
                info.argtypes = _build.SIGNATURES[info_name]
                args = ((march.MODES[mode], int(bf16), tw, tf)
                        if kind == "march" else (int(bf16), tw)) + (0, out)
                if info(*args) == 0:
                    shape.update(dict(zip(fields, out)))
            elif shape.get("registers"):
                shape["blocks_per_sm"] = resident_blocks(shape["registers"])
                shape["blocks_per_sm_from"] = "registers"
            sass = pick_kernel(sass_of[name], kind, mode, bf16, tf)
            if sass:
                shape["sass_instructions"], shape["sass_loop"] = sass
            if kind == "march":
                chunk = shape.get("chunk", 1)
                pixels = (_build.tile_pixels(WIDTH, HEIGHT,
                                             shape["tile_width"],
                                             shape["tile_height"],
                                             shape["warp_width"])
                          if "tile_width" in shape
                          else row_pixels(WIDTH, HEIGHT))
                shape["warp_slices"] = chip_smoke.warp_slices(per_pixel,
                                                              pixels)
                shape["lane_share"] = samples / 32 / shape["warp_slices"]
                shape["reads"] = chip_smoke.march_reads(
                    mode, per_pixel, miss, slices, chunk) \
                    if "chunk" in shape else samples
                if shape.get("sass_loop"):
                    shape["sass_per_slice"] = shape["sass_loop"] / chunk
            shapes[(mode, name)] = shape
            print(json.dumps(shape), flush=True)

        def launcher(lib):
            if kind == "march":
                def launch(state, seed, n):
                    _build.check("vpt_march_frame", lib.vpt_march_frame(
                        *march_args(mode, state, scene, params, seed, n)))
            else:
                def launch(state, seed, n):
                    _build.check("vpt_mcs_frame", lib.vpt_mcs_frame(
                        *mcs_args(state, scene, params, seed, n)))
            return launch

        order = [n for n in libs if n != "current"]
        reference = None
        for name in ["current", *order, *order[::-1], "current"]:
            if name in failed:
                continue
            launch = launcher(libs[name])
            state = start.clone()
            try:
                for n in range(1, frames + 1):
                    launch(state, 0.2 + 0.01 * n, n)
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"{name}: {exc}, left out", flush=True)
                failed.add(name)
                continue
            if reference is None:
                reference = state.clone()
            r = {"variant": name, "mode": mode, "frames": frames,
                 "state_equal_to_current": torch.equal(state, reference)}
            r["device_ms"] = chip_smoke.profiler_device_ms(
                lambda: launch(state, 0.5, 2), match, 20)
            r["ms"] = chip_smoke.cuda_ms(lambda: launch(state, 0.5, 2), 20)
            clocks.append(sm_clock_mhz())
            r["sm_clock_mhz"] = clocks[-1][0]
            shape = shapes[(mode, name)]
            if kind == "march" and shape.get("sass_per_slice"):
                hz = clocks[-1][0] * 1e6
                r["issue_floor_ms"] = shape["sass_per_slice"] \
                    * shape["warp_slices"] / (SMS * SCHEDULERS * hz) * 1e3
                r["full_lane_floor_ms"] = shape["sass_per_slice"] \
                    * work["samples"] / 32 / (SMS * SCHEDULERS * hz) * 1e3
            r.update(work)
            readings.append(r)
            print(json.dumps(r), flush=True)
    return readings, shapes, failed


#: K7's scenes: the headline's (bf16 rows, the bf16-weight TF lookup), one
#: of float32 rows (``blobs_volume(64)``, chip_smoke.py's second scene),
#: the headline's with a TF row as wide as the kernels take, and the
#: headline's with a state that hits in every pixel (:func:`dense_hits`)
SHADE_SCENES = ("headline", "f32", "tw3072", "dense")


def shade_scene(label):
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import tf1d
    from vpt_tpu_torch.renderers import make_scene

    if label in ("headline", "dense"):
        return headline_scene()
    if label == "f32":
        return make_scene(volume.blobs_volume(64),
                          transfer.gray_ramp(alpha_scale=0.8), pack=True)
    return make_scene(volume.sphere_volume(128),
                      transfer.gray_ramp(width=tf1d.MAX_WIDTH,
                                         alpha_scale=0.8),
                      tf_srgb=True, tracking="auto",
                      pack_dtype=torch.bfloat16, tf_mxu=True)


def dense_hits(height, width, device):
    """An ISO state that hits in every pixel, on a smooth surface across
    the volume (x, y from the pixel, z = 0.35 + 0.3·x·y): the display of
    an isosurface that fills the view, with neighbouring pixels' taps on
    neighbouring corner rows as in a rendered one."""
    import torch

    y, x = torch.meshgrid(
        (torch.arange(height, device=device) + 0.5) / height,
        (torch.arange(width, device=device) + 0.5) / width, indexing="ij")
    return torch.stack([x, y, 0.35 + 0.3 * x * y, torch.full_like(x, 0.5)],
                       dim=-1).contiguous()


def bench_shade(libs, built, frames, rounds):
    """K7 of every build in turns (``rounds`` palindromes), on each of
    :data:`SHADE_SCENES`: the display of one ISO frame's hits at
    ``HEIGHT`` × ``WIDTH``, timed with the state and image in L2 (the loop)
    and with L2 flushed before each display by a 64 MiB fill
    (``device_ms_cold``), beside the device time of a copy of the state
    into the image (``copy_device_ms``, warm and cold: the bytes every
    pixel moves, with no fetch); returns the readings, the per-(scene,
    build) shapes and the failed builds."""
    import torch

    import chip_smoke
    from vpt_tpu_torch.kernels import _build, iso_shade, tf1d
    from vpt_tpu_torch.renderers import iso

    _, _, info_name, match = KERNELS["iso_shade"]
    sass_of = {name: sass_loops(built[name][0], match) for name in libs}
    readings, shapes, failed = [], {}, set()
    params = iso.Params()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for label in SHADE_SCENES:
        scene = shade_scene(label)
        tf = tf1d.mode_code(scene.tf_mxu)
        bf16 = scene.volume_packed.dtype == torch.bfloat16
        if label == "dense":
            state = dense_hits(HEIGHT, WIDTH, scene.device)
        else:
            state = iso.reset(params, HEIGHT, WIDTH, scene)
            iso.render_frame(state, scene, params, 0.4, 1)
        hits, rows = chip_smoke.shade_work(scene, state,
                                           params.gradient_step)
        bound_ms, bound_by, _ = chip_smoke.frame_bound(
            scene, scene.volume_packed, HEIGHT * WIDTH, 16,
            hits * (7 * chip_smoke.SHADE_OPS_TAP
                    + chip_smoke.SHADE_OPS_PIXEL), rows)
        image = torch.empty_like(state)

        def copy():
            image.copy_(state)

        def copy_cold():
            flush.zero_()
            copy()

        work = {"hits": hits, "corner_rows": rows, "bound_ms": bound_ms,
                "bound_by": bound_by, "tw": scene.transfer_1d.shape[0],
                "copy_device_ms": chip_smoke.profiler_device_ms(
                    copy, "Memcpy", frames),
                "copy_device_ms_cold": chip_smoke.profiler_device_ms(
                    copy_cold, "Memcpy", frames)}
        for name, lib in libs.items():
            shape = {"build": name, "mode": label}
            shape.update(pick_kernel(ptxas_kernels(built[name][1], match),
                                     "iso_shade", label, bf16, tf) or {})
            # the info entry point, which builds older than it lack; a
            # variant's may write more fields than this tree's reads
            info = getattr(lib, info_name, None)
            if info is not None:
                out = (ctypes.c_int * 16)()
                info.argtypes = _build.SIGNATURES[info_name]
                if info(int(bf16), tf, 0, out) == 0:
                    shape.update(dict(zip(iso_shade.OCCUPANCY_FIELDS, out)))
            elif shape.get("registers"):
                shape["blocks_per_sm"] = resident_blocks(shape["registers"])
                shape["blocks_per_sm_from"] = "registers"
            sass = pick_kernel(sass_of[name], "iso_shade", label, bf16, tf)
            if sass:
                shape["sass_instructions"] = sass[0]
            shapes[(label, name)] = shape
            print(json.dumps(shape), flush=True)

        order = [n for n in libs if n != "current"]
        reference = None
        for name in ["current", *order, *order[::-1], "current"] * rounds:
            if name in failed:
                continue
            image = torch.empty_like(state)
            args = iso_args(state, image, scene, params)

            def launch(lib=libs[name], args=args):
                _build.check("vpt_iso_shade", lib.vpt_iso_shade(*args))

            def cold(launch=launch):
                flush.zero_()
                launch()

            try:
                launch()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"{name}: {exc}, left out", flush=True)
                failed.add(name)
                continue
            if reference is None:
                reference = image.clone()
            r = {"variant": name, "mode": label, "frames": frames,
                 "state_equal_to_current": torch.equal(image, reference),
                 "device_ms": chip_smoke.profiler_device_ms(launch, match,
                                                            frames),
                 "device_ms_cold": chip_smoke.profiler_device_ms(
                     cold, match, frames),
                 "ms": chip_smoke.cuda_ms(launch, frames),
                 "sm_clock_mhz": sm_clock_mhz()[0]}
            r.update(work)
            readings.append(r)
            print(json.dumps(r), flush=True)
    return readings, shapes, failed


def sass_slice(lib_path, match: str, trips: int) -> dict:
    """{mangled kernel name: warp instructions of one slice} for K10's
    builds from ``cuobjdump -sass``: the body of the largest loop (the
    slice loop, or a persistent warp loop whose iteration is one slice)
    with the largest loop inside it (the AO tap loop) counted ``trips``
    times and every other instruction of the body once.  Code that a
    branch skips (a miss, the slow path of a division) counts as run, so
    this is an upper estimate of the issued instructions."""
    out = {}
    for name, (addrs, back) in sass_functions(lib_path, match).items():
        loops = sorted(back.items(), key=lambda span: span[1] - span[0],
                       reverse=True)
        if not loops:
            continue
        outer = loops[0]
        inner = [span for span in loops[1:]
                 if outer[0] <= span[0] and span[1] <= outer[1]]
        out[name] = _span(addrs, outer) + (
            (trips - 1) * _span(addrs, inner[0]) if inner else 0)
    return out


def lao_launcher(lib, p, state, counts=None):
    """One K10 frame of build ``lib`` from the tree's preparation ``p``:
    ``vpt_lao_launch``, or with ``counts`` the build's ``vpt_lao_count``."""
    from vpt_tpu_torch.kernels import _build

    stream = _build.current_stream(p.device)
    if counts is not None:
        lib.vpt_lao_count.argtypes = _build.SIGNATURES["vpt_lao_count"]

        def launch():
            _build.check("vpt_lao_count", lib.vpt_lao_count(
                p.address, state.data_ptr(), counts.data_ptr(), stream))
    else:
        def launch():
            _build.check("vpt_lao_launch", lib.vpt_lao_launch(
                p.address, state.data_ptr(), stream))
    return launch


def bench_lao(libs, built, frames, rounds):
    """K10 of every build in turns (``rounds`` palindromes) on the
    headline's scene and a float32 one, one frame a launch from the tree's
    prepared arguments; returns the readings, the per-(scene, build)
    shapes and the failed builds.  A build's shape holds its kernel's
    registers, its SASS a slice (:func:`sass_slice`), its warp-slices (the
    kernel's own count where it exports ``vpt_lao_count``, else those of
    one thread a pixel on the 8x4 tiles, modelled from the plain frame's
    per-pixel slices), the lanes' busy share and the frame's issue floor:
    SASS a slice times warp-slices over 4 schedulers x 132 SMs at the SM
    clock."""
    import torch

    import chip_smoke
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import _build, lao_march
    from vpt_tpu_torch.renderers import lao, make_scene

    readings, shapes, failed = [], {}, set()
    params = lao.Params()
    trips = -(-len(lao.lao_taps(params)) // 2)
    scenes = {"headline": headline_scene(),
              "blobs64 f32": make_scene(volume.blobs_volume(64),
                                        transfer.gray_ramp(alpha_scale=0.8),
                                        pack=True)}
    sass_of = {name: sass_slice(built[name][0], "lao_kernel", trips)
               for name in libs}
    for label, scene in scenes.items():
        bf16 = scene.volume_packed.dtype == torch.bfloat16
        p = lao_march._scene_cache.get(scene, (params, HEIGHT, WIDTH))
        samples, _, _, _, per_pixel = chip_smoke.lao_work(scene, params,
                                                          HEIGHT, WIDTH)
        occ = lao_march.occupancy(scene.volume_packed.dtype)
        tile = chip_smoke.warp_slices(per_pixel, _build.tile_pixels(
            WIDTH, HEIGHT, occ["tile_width"], occ["tile_height"],
            occ["warp_width"]))
        clock = sm_clock_mhz()[0]
        for name in libs:
            shape = {"build": name, "mode": label, "samples": samples}
            # the 32-bit row instantiation where the build has one
            fragment = f"ILb{int(bf16)}ELb{int(bf16)}E"
            shape.update(pick(ptxas_kernels(built[name][1], "lao_kernel"),
                              fragment + "i") or pick(
                ptxas_kernels(built[name][1], "lao_kernel"), fragment) or {})
            sass = pick(sass_of[name], fragment + "i") \
                or pick(sass_of[name], fragment)
            state = torch.empty((HEIGHT, WIDTH, 4), device="cuda")
            if hasattr(libs[name], "vpt_lao_count"):
                counts = torch.zeros(2, dtype=torch.int64, device="cuda")
                lao_launcher(libs[name], p, state, counts)()
                lanes, warps = counts.tolist()
                shape["warp_slices_from"] = "the kernel's count"
            else:
                lanes, warps = samples, tile
                shape["warp_slices_from"] = "one thread a pixel on the tiles"
            shape.update(lane_slices=lanes, warp_slices=warps,
                         lane_share=lanes / 32 / max(warps, 1))
            if sass:
                shape["sass_per_slice"] = sass
                shape["issue_floor_ms"] = sass * warps / (
                    SMS * SCHEDULERS * clock * 1e6) * 1e3
                shape["full_lane_floor_ms"] = sass * samples / 32 / (
                    SMS * SCHEDULERS * clock * 1e6) * 1e3
            shapes[(label, name)] = shape
            print(json.dumps(shape), flush=True)
        order = [n for n in libs if n != "current"]
        reference = None
        for name in ["current", *order, *order[::-1], "current"] * rounds:
            if name in failed:
                continue
            state = torch.empty((HEIGHT, WIDTH, 4), device="cuda")
            launch = lao_launcher(libs[name], p, state)
            try:
                launch()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"{name}: {exc}, left out", flush=True)
                failed.add(name)
                continue
            if reference is None:
                reference = state.clone()
            r = {"variant": name, "mode": label, "frames": frames,
                 "state_equal_to_current": torch.equal(state, reference),
                 "device_ms": chip_smoke.profiler_device_ms(launch, "lao_",
                                                            frames),
                 "ms": chip_smoke.cuda_ms(launch, frames),
                 "sm_clock_mhz": sm_clock_mhz()[0]}
            readings.append(r)
            print(json.dumps(r), flush=True)
    return readings, shapes, failed


def sass_tree(lib_path, match: str) -> dict:
    """{mangled kernel name: {"instructions": n, "loops": [[first, last,
    instructions, depth], ...]}} of the functions whose name holds
    ``match`` (``cuobjdump -sass``): every backward branch's body and how
    many other bodies hold it, to read a kernel's slice loops by."""
    out = {}
    for name, (addrs, back) in sass_functions(lib_path, match).items():
        spans = sorted(back.items())
        out[name] = {"instructions": len(addrs), "loops": [
            [a, b, _span(addrs, (a, b)),
             sum(1 for c, d in spans if (c, d) != (a, b) and c <= a
                 and b <= d)] for a, b in spans]}
    return out


def halo_sass_slice(tree: dict, trips) -> int:
    """SASS a pixel-slice of K10's halo kernel from :func:`sass_tree`: its
    two largest outermost loops, in address order the fold's and the
    fetch's slice loops, each with its largest inner loop (the AO taps)
    counted ``trips`` = (fold, fetch) times and every other instruction of
    the body once, as :func:`sass_slice` counts K10's: an upper estimate,
    as that one."""
    outer = sorted(sorted((lp for lp in tree["loops"] if lp[3] == 0),
                          key=lambda lp: -lp[2])[:2])
    total = 0
    for (first, last, size, _), n in zip(outer, trips):
        inner = [lp[2] for lp in tree["loops"]
                 if lp[3] == 1 and first <= lp[0] and lp[1] <= last]
        total += size + (n - 1) * max(inner, default=0)
    return total


def halo_taps(taps: int, kernel: str):
    """(fold, fetch) trips of the AO loops in K10 halo's slice loops for
    ``taps`` AO taps: the fetch reads a tap an iteration (``lao_march.cu``'s
    ``#pragma unroll 1``); a kernel that takes a ``VptLaoHalo`` (each
    rank's AO sum formed in the fetch) folds no taps (its largest inner
    loop, the AO fold of ``lao_ao``, counts once, as in K10), an older one
    (a ``VptLaoExt``) folded four taps an iteration (the compiler's
    unroll)."""
    return (1 if "VptLaoHalo" in kernel else -(-taps // 4)), taps


def halo_chunks(lib, bf16: bool, slices: int) -> int:
    """The chunks of a frame of ``slices`` slices of a build's K10 halo
    instance: its ``vpt_lao_halo_info`` gives the slices of a fetch (the
    value buffer, sized for 8, holds any smaller chunk)."""
    from vpt_tpu_torch.kernels import _build

    out = (ctypes.c_int * 10)()
    fn = lib.vpt_lao_halo_info
    fn.argtypes = _build.SIGNATURES["vpt_lao_halo_info"]
    _build.check("vpt_lao_halo_info", fn(int(bf16), int(bf16), 0, out))
    if not 1 <= out[9] <= 8:
        raise RuntimeError(f"a fetch of {out[9]} slices")
    return -(-slices // out[9])


def halo_scenes(names):
    """The K10 halo bench's scenes by name: the headline (bf16, 512²), a
    float32 ``blobs_volume(128)`` (512²) and config 4's float32
    ``blobs_volume(512)`` (1024²); (scene, size) each."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    make = {
        "headline": lambda: (headline_scene(), HEIGHT),
        "blobs128 f32": lambda: (make_scene(
            volume.blobs_volume(128), transfer.gray_ramp(alpha_scale=0.8),
            pack=True, pack_dtype=torch.float32), HEIGHT),
        "config4": lambda: (make_scene(
            volume.blobs_volume(512), transfer.gray_ramp(alpha_scale=0.8),
            pack=True, pack_dtype=torch.float32), 1024)}
    return {name: make[name] for name in names}


def bench_lao_halo(libs, built, frames, rounds, scene_names):
    """K10's halo instance of every build in turns (``rounds``
    palindromes) on a one-slab HaloScene of each scene, one frame a call
    of ``vpt_lao_halo_launch`` for each chunk e = 0 .. C (one slab: no
    all-reduce between them) from the tree's prepared ``VptLaoHalo``,
    whose ``VptLaoExt`` prefix older builds read; beside each, the current
    build's whole-scene K10 on the same scene.  A reading's device ms is
    the build's halo kernel's mean a launch (torch.profiler) times its C +
    1 launches a frame, ``ms`` the frame's CUDA-event time; each
    build's frame is checked against K10's bit for bit (``state_equal_to_
    k10``) and the current build's.  A build's shape holds its halo
    kernel's registers and spills (ptxas), its SASS loop tree
    (:func:`sass_tree`) and the SASS a pixel-slice (:func:`halo_sass_slice`
    with :func:`halo_taps`) with the issue floor (that times the frame's
    warp-slices as K10's own count gives them, over 4 schedulers x 132 SMs
    at the SM clock)."""
    import torch

    import chip_smoke
    from vpt_tpu_torch.kernels import _build, lao_march
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import lao

    readings, shapes, failed = [], {}, set()
    params = lao.Params()
    trees = {name: sass_tree(built[name][0], "lao_halo") for name in libs}
    for label, make in halo_scenes(scene_names).items():
        scene, size = make()
        bf16 = scene.volume_packed.dtype == torch.bfloat16
        hs = halo.halo_scene(scene, 0, 1)
        p = lao_march._halo_cache.get(hs, (params, size, size, 0, size))
        whole = lao_march._scene_cache.get(scene, (params, size, size))
        k10 = torch.empty((size, size, 4), device="cuda")
        counts = torch.zeros(2, dtype=torch.int64, device="cuda")
        lao_launcher(libs["current"], whole, k10, counts)()
        lanes, warps = counts.tolist()
        clock = sm_clock_mhz()[0]
        # this scene's instance (mangled template arguments): <rows' and
        # TF's type, one channel, not baked, 32-bit rows>, or in an older
        # build without the row type
        b = int(bf16)
        tags = (f"ILb{b}ELb{b}ELi0ELb0EiE", f"ILb{b}ELb{b}ELi0ELb0EE")
        for name in libs:
            regs = ptxas_kernels(built[name][1], "lao_halo")
            mine = {k: v for k, v in regs.items()
                    if any(tag in k for tag in tags)}
            tree = {k: v for k, v in trees[name].items() if k in mine}
            taps = len(lao.lao_taps(params))
            sass = sum(halo_sass_slice(v, halo_taps(taps, k))
                       for k, v in tree.items())
            shape = {"build": name, "mode": label,
                     "registers": mine, "sass_tree": tree,
                     "sass_per_slice": sass, "lane_slices": lanes,
                     "warp_slices": warps,
                     "issue_floor_ms": sass * warps / (
                         SMS * SCHEDULERS * clock * 1e6) * 1e3}
            shapes[(label, name)] = shape
            print(json.dumps(shape), flush=True)
        order = [n for n in libs if n != "current"]
        reference = None
        # values between the calls, zero between frames, of any build: 8
        # slices of the most values a pixel-slice any design sums (each of
        # the 28 taps in older builds)
        value = torch.zeros(8 * (8 + len(lao.lao_taps(params))) * size * size,
                            device="cuda")
        k10_ms = chip_smoke.profiler_device_ms(
            lao_launcher(libs["current"], whole, k10), "lao_kernel", frames)
        for name in ["current", *order, *order[::-1], "current"] * rounds:
            if name in failed:
                continue
            lib = libs[name]
            state = torch.empty((size, size, 4), device="cuda")
            stream = _build.current_stream(p.device)
            chunks = halo_chunks(lib, bf16, params.slices)

            def launch(lib=lib, state=state, chunks=chunks):
                for e in range(chunks + 1):
                    err = lib.vpt_lao_halo_launch(
                        p.address, 0, 1, 1, 1, value.data_ptr(),
                        state.data_ptr(), e, stream)
                    if err:
                        raise RuntimeError(f"vpt_lao_halo_launch: {err}")
            try:
                launch()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"{name}: {exc}, left out", flush=True)
                failed.add(name)
                continue
            if reference is None:
                reference = state.clone()
            means = chip_smoke.kernel_means(launch, frames)
            dev = sum(v * (chunks + 1) for k, v in means.items()
                      if "lao_halo" in k)
            r = {"variant": name, "mode": label, "frames": frames,
                 "state_equal_to_current": torch.equal(state, reference),
                 "state_equal_to_k10": torch.equal(state, k10),
                 "device_ms": dev or None, "k10_device_ms": k10_ms,
                 "over_k10": dev / k10_ms if dev and k10_ms else None,
                 "ms": chip_smoke.cuda_ms(launch, frames),
                 "sm_clock_mhz": sm_clock_mhz()[0]}
            readings.append(r)
            print(json.dumps(r), flush=True)
        del scene, hs, p, whole, value
        lao_march._halo_cache._last = lao_march._scene_cache._last = None
        torch.cuda.empty_cache()
    return readings, shapes, failed


def scatter_cases():
    """The corner-gradient calls (K4) the bench times, each (cells,
    fractions, cotangents, r0, rows, C) on the card, made as
    ``chip_smoke.py`` makes them: the four buckets of one bucketed EAM
    value-and-grad (64³ blobs, 4 views of 256², 64 slices, 4 buckets; the
    entries its fetches saved), config 4's bucket 0 (2^20 uniform
    positions in 512³, rows [0, 128·512²)), the whole-table call at K4's
    row shape (a 256³ table, 256² positions crowded into a cube 13 cells
    a side; also with C cotangents for each C above 2 that
    ``chip_smoke.py`` holds) and at ``path fit eam``'s call shape (64³,
    the middle of the 8 fetches of one view's value-and-grad from a flat
    0.1)."""
    import torch

    import chip_smoke
    from vpt_tpu_torch import sampling, volume

    dev = torch.device("cuda", 0)
    truth = volume.blobs_volume(64, seed=1).data
    tf, eparams, views, targets = chip_smoke.eam_fit_views(truth)
    cases = {f"eam bucket {b}": (idx, f, ct, r0, r1 - r0, c)
             for b, (idx, f, ct, r0, r1, c) in enumerate(
                 chip_smoke.eam_bucket_calls(truth, tf, eparams, views,
                                             targets))}
    cases["config4 bucket 0"] = chip_smoke.config4_bucket_call(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    crowd = 0.45 + 0.05 * torch.rand(256 * 256, 3, device=dev, generator=g)
    cells, f = sampling.corner_cells(crowd, (256, 256, 256, 1))
    ct = torch.randn(256 * 256, 1, device=dev, generator=g)
    cases["k4 row shape"] = (cells, f, ct, 0, 256 ** 3, 1)
    for c in chip_smoke.WIDE_ROWS:
        cases[f"k4 row shape c{c}"] = (
            cells, f, torch.randn(256 * 256, c, device=dev, generator=g), 0,
            256 ** 3, c)
    idx, f, ct, rows, c = chip_smoke.fit_eam_calls(truth, tf, eparams,
                                                   views[0], targets[0])[4]
    cases["fit eam call"] = (idx, f, ct, 0, rows, c)
    return cases


def bench_corner_scatter(libs, rounds, baseline, reps=20):
    """K4's corner-gradient kernel of every build in turns on each case of
    :func:`scatter_cases`: per case, the builds in palindromes (the
    variants, current, current, the variants reversed; ``rounds`` times),
    each reading a call's device ms (torch.profiler over ``reps`` calls:
    the zero fill of the gradient, in as many launches as PyTorch splits
    it into, and the scatter, as the wrapper calls it; and the scatter
    kernel alone) and its CUDA-event ms, through
    ``vpt_corner_grad``'s argument list, which every build with the
    bucket instance's row offset exports; each build's gradient held
    against the plain version within the float32 reordering bound
    (``chip_smoke.order_bound``).  Returns
    the readings and a summary line a (case, build) with the medians and
    the bound of the case (``chip_smoke.bucket_bound``) and its device ms
    over the ``baseline`` build's, plus a line for the four EAM buckets
    together.  A build whose call fails in a case is left out of that
    case (an older build refuses channel counts it has no instance
    for)."""
    import torch

    import chip_smoke
    from vpt_tpu_torch.kernels import _build, corner_scatter

    cases = scatter_cases()
    names = [n for n in libs if n != "current"]
    order = [*names, "current", "current", *names[::-1]] * rounds
    readings, summary, failed = [], [], set()
    for label, (idx, f, ct, r0, rows, c) in cases.items():
        inside = (idx >= r0) & (idx < r0 + rows)
        bound_ms, by = chip_smoke.bucket_bound(idx, int(inside.sum()), rows,
                                               c)
        want = corner_scatter.corner_grad_bucket_plain(idx, f, ct, r0,
                                                       r0 + rows, c)
        limit = chip_smoke.order_bound(
            torch.bincount(idx[inside] - r0, minlength=rows)[:, None],
            corner_scatter.corner_grad_bucket_plain(idx, f, ct.abs(), r0,
                                                    r0 + rows, c))
        for name in order:
            if (name, label) in failed:
                continue
            lib = libs[name]

            def call(lib=lib):
                grad = torch.zeros(rows, 8 * c, device=idx.device)
                err = lib.vpt_corner_grad(
                    grad.data_ptr(), r0, rows, c, idx.data_ptr(),
                    f.data_ptr(), ct.data_ptr(), idx.numel(),
                    _build.stream_ptr(idx))
                if err:
                    raise RuntimeError(f"vpt_corner_grad: error {err}")
                return grad
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"{name}: {exc}, left out of {label}", flush=True)
                failed.add((name, label))
                continue
            diff = (got - want).abs()
            del got
            r = {"variant": name, "mode": label, "rows": rows, "c": c,
                 "entries": idx.numel(), "in_range": int(inside.sum()),
                 "max_abs_err": float(diff.max()),
                 "within_order_bound": bool((diff <= limit).all()),
                 "device_ms": chip_smoke.profiler_device_ms(
                     call, "", reps, counted=True),
                 "scatter_device_ms": chip_smoke.profiler_device_ms(
                     call, "corner_grad", reps),
                 "ms": chip_smoke.cuda_ms(call, reps),
                 "bound_ms": bound_ms, "bound_by": by}
            del diff
            readings.append(r)
            print(json.dumps(r), flush=True)
        del want, limit
        torch.cuda.empty_cache()

    def median(values):
        values = sorted(v for v in values if v is not None)
        return values[len(values) // 2] if values else None

    for label in cases:
        for name in libs:
            mine = [r for r in readings
                    if r["mode"] == label and r["variant"] == name]
            if not mine:
                continue
            line = {"summary": name, "mode": label, "readings": len(mine),
                    "within_order_bound": all(r["within_order_bound"]
                                              for r in mine),
                    "bound_ms": mine[0]["bound_ms"],
                    **{k: median([r[k] for r in mine])
                       for k in ("device_ms", "scatter_device_ms", "ms")}}
            line["share_of_bound"] = line["bound_ms"] / line["device_ms"] \
                if line["device_ms"] else None
            summary.append(line)
    buckets = [k for k in cases if k.startswith("eam bucket")]
    for name in libs:
        mine = [x for x in summary if x["summary"] == name
                and x["mode"] in buckets]
        if len(mine) == len(buckets):
            summary.append({
                "summary": name, "mode": "eam four buckets",
                **{k: sum(x[k] for x in mine) if all(
                    x[k] is not None for x in mine) else None
                   for k in ("device_ms", "scatter_device_ms", "ms",
                             "bound_ms")}})
    for line in summary:
        base = next((x for x in summary if x["mode"] == line["mode"]
                     and x["summary"] == baseline), None)
        if base and base.get("device_ms") and line.get("device_ms"):
            line[f"device_ms_over_{baseline}"] = \
                line["device_ms"] / base["device_ms"]
    return readings, summary, failed


def row_pixels(width, height):
    """(x, y, inside) of a launch of 128-thread blocks over the pixels in
    row-major order (the frame kernels before their pixel tiles)."""
    import numpy as np

    n = -(-width * height // 128) * 128
    i = np.arange(n)
    return i % width, i // width, i < width * height


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="mcm_event")
    ap.add_argument("--variant", type=variant, action="append", default=[],
                    help="NAME=PATH of another source of the kernel "
                         "(repeatable)")
    ap.add_argument("--frames", type=int, default=30,
                    help="frames of a reading")
    ap.add_argument("--size", type=int, default=512,
                    help="K6/K8: the image's width and height")
    ap.add_argument("--rounds", type=int,
                    help="K4, K7, K10: palindromic rounds of readings "
                         "(default 2 for K4, else 1)")
    ap.add_argument("--scenes", default="headline,blobs128 f32",
                    help="K10 halo: the scenes (headline, blobs128 f32, "
                         "config4), comma-separated")
    ap.add_argument("--baseline", default="current",
                    help="the build the summary divides by")
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--registers", action="store_true",
                    help="print each build's registers and spills per "
                         "kernel instance and launch nothing")
    args = ap.parse_args()
    if args.kernel in ("dos", "corner_gather") and not args.registers:
        ap.error(f"--kernel {args.kernel} takes --registers only "
                 "(chip_smoke.py --launch-path --part sweep times K9)")
    sys.path.insert(0, str(ROOT))
    import torch

    global HEIGHT, WIDTH
    if args.kernel != "mcm_event":
        HEIGHT = WIDTH = args.size
    if not torch.cuda.is_available():
        print("bench_mcm_event: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    from vpt_tpu_torch.kernels import _build

    source, entries, _, _ = KERNELS[args.kernel]
    sources = {"current": _build.CSRC / source, **dict(args.variant)}
    t0 = time.perf_counter()
    built = compile_all(sources, ROOT / "build" / f"bench_{args.kernel}")
    print(f"built {len(built)} of {len(sources)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)", flush=True)
    if "current" not in built:
        return 1
    if args.registers:
        # every kernel of the source, with a digest of its code, then each
        # other build's kernels against the current build's by name
        by_build = {}
        for name, (path, text) in built.items():
            digests = sass_digests(path)
            by_build[name] = {same_name(k): v for k, v in digests.items()}
            for kernel, regs in sorted(ptxas_kernels(text, "").items()):
                print(json.dumps({"build": name, "kernel": kernel, **regs,
                                  "sass_digest": digests.get(kernel)}),
                      flush=True)
        if args.kernel == "corner_scatter":
            # residency from the build's info entry point, where it has one
            from vpt_tpu_torch.kernels import corner_scatter

            for name, (path, _) in built.items():
                lib = ctypes.CDLL(str(path))
                if not hasattr(lib, "vpt_corner_grad_info"):
                    print(json.dumps({"build": name, "shape": "no "
                                      "vpt_corner_grad_info"}), flush=True)
                    continue
                lib.vpt_corner_grad_info.argtypes = \
                    _build.SIGNATURES["vpt_corner_grad_info"]
                for c in (1, 2, 3, 4, 5):
                    out = (ctypes.c_int
                           * len(corner_scatter.OCCUPANCY_FIELDS))()
                    err = lib.vpt_corner_grad_info(c, 0, out)
                    print(json.dumps({"build": name, "c": c, "error": err,
                                      **dict(zip(corner_scatter
                                                 .OCCUPANCY_FIELDS, out))}),
                          flush=True)
        mine = by_build["current"]
        for name, theirs in by_build.items():
            if name != "current":
                print(json.dumps(digest_summary(name, mine, theirs)),
                      flush=True)
        return 0
    libs = {name: load(path, entries) for name, (path, _) in built.items()}
    shapes = {}
    if args.kernel == "corner_scatter":
        readings, summary, failed = bench_corner_scatter(
            libs, args.rounds or 2, args.baseline)
    elif args.kernel == "mcm_event":
        scene = headline_scene()
        tw = scene.transfer_1d.shape[0]
        for name in list(libs):
            out = (ctypes.c_int * len(OCCUPANCY))()
            err = libs[name].vpt_mcm_event_info(1, tw, out)
            if err:
                print(f"{name}: vpt_mcm_event_info error {err}, left out",
                      flush=True)
                del libs[name]
                continue
            shape = dict(pick(ptxas_kernels(built[name][1],
                                            "mcm_event_kernel"), "ILb1E")
                         or {}, **dict(zip(OCCUPANCY, out)))
            shape["resident_threads_per_sm"] = \
                shape["blocks_per_sm"] * shape["threads_per_block"]
            shapes[name] = shape
            print(f"{name}: {json.dumps(shape)}", flush=True)
        readings, failed = bench_mcm_event(libs, args.frames)
        summary = summarize(readings, "steps", (
            "device_ms", "host_ms_per_frame", "device_events_per_s",
            "host_events_per_s", "host_paths_per_s", "mean_path_events"),
            args.baseline)
    else:
        if args.kernel == "iso_shade":
            readings, frame_shapes, failed = bench_shade(
                libs, built, args.frames, args.rounds or 1)
            keys = ("device_ms", "device_ms_cold", "ms", "copy_device_ms",
                    "copy_device_ms_cold", "sm_clock_mhz")
        elif args.kernel == "lao":
            readings, frame_shapes, failed = bench_lao(
                libs, built, args.frames, args.rounds or 1)
            keys = ("device_ms", "ms", "sm_clock_mhz")
        elif args.kernel == "lao_halo":
            readings, frame_shapes, failed = bench_lao_halo(
                libs, built, args.frames, args.rounds or 1,
                args.scenes.split(","))
            keys = ("device_ms", "k10_device_ms", "over_k10", "ms",
                    "sm_clock_mhz")
        else:
            readings, frame_shapes, failed = bench_frames(
                args.kernel, libs, built, args.frames)
            keys = ("device_ms", "ms", "issue_floor_ms",
                    "full_lane_floor_ms", "sm_clock_mhz")
        shapes = {f"{mode} {name}": s
                  for (mode, name), s in frame_shapes.items()}
        summary = summarize([r for r in readings
                             if r["variant"] not in failed], "mode", keys,
                            args.baseline)
    for line in summary:
        print(json.dumps(line), flush=True)
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel": args.kernel,
              "height": HEIGHT, "width": WIDTH,
              "sources": {k: str(p) for k, p in sources.items()},
              "shapes": shapes, "readings": readings, "summary": summary,
              "failed": sorted(failed)}
    out = args.out or ROOT / "build" / f"bench_{args.kernel}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
