"""Time the MCM event kernel (K5) against other builds of it, in turns, on
the render headline, on one GPU.

    python3 bench_mcm_event.py [--variant NAME=PATH ...] [--frames 30]

``current`` is ``vpt_tpu_torch/csrc/mcm_event.cu`` as it stands.  Each
``--variant`` is another source of the same kernel that exports the same C
interface (``vpt_mcm_event`` and ``vpt_mcm_event_info``, as
``kernels/_build.SIGNATURES`` lists them): a copy with one design lever
changed, or an older design brought to this interface.  Every source is
built with the headers beside it first, then those of ``csrc/``, with the
port's nvcc flags plus ``-Xptxas -v``, all builds at once; every build is
driven through the port's own wrapper (``kernels/mcm_event.launch_args``).
A variant that fails to build or to launch is reported and left out.

The scene is the headline's (``sphere_volume(128)``, sRGB gray ramp at
alpha 0.8, cheb-skip, bf16 tables, ``tf_mxu``), 512², extinction 40,
anisotropy 0.3, at steps 0 (a launch that only loads, seeds and stores the
state), 8 and 32.  For each steps the builds run in a palindromic order
(current, the variants, the variants reversed, current), each from the
same reset state with the same frame seeds, so each is read twice,
symmetrically in time.  A reading is the kernel's device time per launch
(``torch.profiler``), the frame time on the host clock (synchronized, over
``--frames`` frames), events/s and paths/s on both clocks, mean path events,
and whether the state after the frames equals ``current``'s bit for bit.
Prints the card, each build's registers and spills (ptxas) and launch shape
(``vpt_mcm_event_info``), one JSON line per reading and one ``summary``
line per (steps, build) with its times over ``current``'s, and writes all of
it as JSON to ``--out``.
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


def ptxas_kernel(text: str) -> dict:
    """Registers and spills of the bf16 event kernel from -Xptxas -v."""
    blocks = re.split(r"ptxas info\s*: Compiling entry function", text)
    for block in blocks[1:]:
        head = block.splitlines()[0]
        if "mcm_event_kernel" in head and "ILb1E" in head:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            regs = re.search(r"Used (\d+) registers", block)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "spill_loads": int(spill.group(2)) if spill else None}
    return {"registers": None, "spill_stores": None, "spill_loads": None}


def load(lib_path):
    from vpt_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(lib_path))
    for name in ("vpt_mcm_event", "vpt_mcm_event_info"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def device_ms(launch, state, frames):
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
    kernels = [e for e in prof.key_averages() if "mcm_event_kernel" in e.key]
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


def summarize(readings):
    """Per (steps, build): the mean of its readings, and its device and
    host time over ``current``'s."""
    def mean(values):
        values = [v for v in values if v is not None]
        return sum(values) / len(values) if values else None

    keys = ("device_ms", "host_ms_per_frame", "device_events_per_s",
            "host_events_per_s", "host_paths_per_s", "mean_path_events")
    rows = {}
    for r in readings:
        rows.setdefault((r["steps"], r["variant"]), []).append(r)
    out = []
    for (steps, name), group in rows.items():
        line = {"summary": name, "steps": steps, "readings": len(group),
                "state_equal_to_current": all(
                    r["state_equal_to_current"] for r in group)}
        line.update({k: mean([r[k] for r in group]) for k in keys})
        out.append(line)
    for line in out:
        base = next(x for x in out
                    if x["steps"] == line["steps"] and x["summary"] == "current")
        for k in ("device_ms", "host_ms_per_frame"):
            if line[k] and base[k]:
                line[f"{k}_over_current"] = line[k] / base[k]
    return out


def variant(text: str):
    name, sep, path = text.partition("=")
    if not sep or not name or name == "current":
        raise argparse.ArgumentTypeError(
            f"{text!r}: expected NAME=PATH, NAME not 'current'")
    return name, pathlib.Path(path).resolve()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", type=variant, action="append", default=[],
                    help="NAME=PATH of another mcm_event.cu (repeatable)")
    ap.add_argument("--frames", type=int, default=30,
                    help="frames of a host-clock reading")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "bench_mcm_event.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bench_mcm_event: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import _build, mcm_event
    from vpt_tpu_torch.renderers import make_scene, mcm

    sources = {"current": _build.CSRC / "mcm_event.cu", **dict(args.variant)}
    t0 = time.perf_counter()
    built = compile_all(sources, ROOT / "build" / "bench_mcm_event")
    print(f"built {len(built)} of {len(sources)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)", flush=True)
    if "current" not in built:
        return 1

    scene = make_scene(volume.sphere_volume(128),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking="auto", pack_dtype=torch.bfloat16,
                       tf_mxu=True)
    tw = scene.transfer_1d.shape[0]
    libs, shapes = {}, {}
    for name, (path, text) in built.items():
        lib = load(path)
        out = (ctypes.c_int * len(OCCUPANCY))()
        err = lib.vpt_mcm_event_info(1, tw, out)
        if err:
            print(f"{name}: vpt_mcm_event_info error {err}, left out",
                  flush=True)
            continue
        libs[name] = lib
        shape = dict(ptxas_kernel(text), **dict(zip(OCCUPANCY, out)))
        shape["resident_threads_per_sm"] = \
            shape["blocks_per_sm"] * shape["threads_per_block"]
        shapes[name] = shape
        print(f"{name}: {json.dumps(shape)}", flush=True)

    def launcher(lib):
        def launch(state, seed):
            _build.check("vpt_mcm_event", lib.vpt_mcm_event(
                *mcm_event.launch_args(state, scene, params, seed)))
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
                                       steps, args.frames)
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
    summary = summarize([r for r in readings if r["variant"] not in failed])
    for line in summary:
        print(json.dumps(line), flush=True)
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "height": HEIGHT, "width": WIDTH,
              "sources": {k: str(v) for k, v in sources.items()},
              "shapes": shapes, "readings": readings, "summary": summary,
              "failed": sorted(failed)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
