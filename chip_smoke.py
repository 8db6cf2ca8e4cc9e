"""Drive the PyTorch/CUDA port's MCM forward render once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit.  The phases, in order; any failure exits non-zero and
prints no result:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from ``vpt_tpu_torch/csrc`` (nvcc, sm_90a);
3. the tone-map kernel against its plain version, all eight curves;
4. the TF-lookup kernel against its plain version, float32 and bf16 rows;
5. the MCM event kernel against the plain event loop on the card;
6. the main path with every launch counter at 0: ``make_scene`` (128³
   sphere, sRGB gray ramp, cheb-skip auto tracking, bf16 tables),
   ``make_renderer("mcm")`` frames at 512², steps 8 and 32, ``display``,
   and the ``reinhard`` tone mapper.  The tracking table is checked against
   the TF through ``Scene.sample_color``, which launches the standalone
   TF-lookup kernel; inside frames the same lookup runs as a device
   function of the event kernel;
7. every kernel launched in phase 6; the JSON line says which call
   launched each.

Then one JSON line with each kernel's launches, error and time beside its
plain version's, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_tonemap(dev):
    import torch

    from vpt_tpu_torch import tonemap as tm
    from vpt_tpu_torch.kernels import tonemap_kernel

    g = torch.Generator().manual_seed(1)
    img = (torch.rand(512, 512, 4, generator=g) * 4.0).to(dev)
    worst = 0.0
    for name in tm.RAW_CURVES:
        got = tonemap_kernel.tonemap(img, name, exposure=1.3)
        want = tonemap_kernel.tonemap_plain(img, name, exposure=1.3)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        # powf/expf differ from PyTorch's by a few ulps on O(1) values
        check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"tonemap {name}: max abs err {err}")
    ms = cuda_ms(lambda: tonemap_kernel.tonemap(img, "reinhard"), 200)
    plain_ms = cuda_ms(lambda: tonemap_kernel.tonemap_plain(img, "reinhard"),
                       50)
    print(f"tonemap: 8 curves agree (atol 1e-6, rtol 1e-6), max abs err "
          f"{worst}; reinhard 512x512x4 {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_tf1d(dev):
    import torch

    from vpt_tpu_torch.kernels import tf1d

    g = torch.Generator().manual_seed(2)
    values = (torch.rand(512, 512, generator=g) * 1.2 - 0.1).to(dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tf = torch.rand(2, 256, 4, generator=g).to(dtype).to(torch.float32)
        table, width = tf1d.pack_table(tf.to(dev))
        got = tf1d.lookup_1d(table, values, width)
        want = tf1d.lookup_plain(table, values)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(err <= 1e-6, f"tf1d ({dtype} row): max abs err {err}")
    ms = cuda_ms(lambda: tf1d.lookup_1d(table, values, width), 200)
    plain_ms = cuda_ms(lambda: tf1d.lookup_plain(table, values), 50)
    print(f"tf1d: f32 and bf16 rows agree (atol 1e-6), max abs err {worst}; "
          f"(512, 512) values, TW=256 {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _frames_agree(scene, params, res, frames, label):
    """Run the kernel and the plain loop from one reset state; return the
    samples-agreement fraction and the max radiance error where the
    samples agree."""
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    state = mcm.reset(params, res, res, scene)
    plain = {k: v.clone() for k, v in state.items()}
    for f in range(frames):
        mcm_event.event_frame(state, scene, params, 0.3 + 0.01 * f)
        mcm_event.event_frame_plain(plain, scene, params, 0.3 + 0.01 * f)
    torch.cuda.synchronize()
    match = state["samples"] == plain["samples"]
    agree = float(match.float().mean())
    err = float((state["radiance"] - plain["radiance"])[match].abs().max())
    mean_gap = abs(float(state["radiance"].mean())
                   - float(plain["radiance"].mean()))
    for key, value in state.items():
        check(bool(torch.isfinite(value).all()), f"{label}: {key} not finite")
    # bounds: the kernel runs the plain loop's float32 operations without
    # contraction, and on the H100 every run so far agreed on all pixels
    # (radiance within 1.2e-7, image means equal).  A last-bit difference
    # in logf/sinf/cosf could still part one pixel's stream: at most one
    # in 10^4 may part, and with radiance in [0, 1] the means stay within
    # 1e-4
    check(agree >= 0.9999, f"{label}: samples agree on only {agree:.6f}")
    check(err <= 1e-6, f"{label}: radiance err {err} where samples agree")
    check(mean_gap <= 1e-4, f"{label}: image means {mean_gap} apart")
    print(f"mcm_event {label}: samples agree {agree:.6f} (bound 0.9999), "
          f"radiance max abs err {err} (bound 1e-6), image means "
          f"{mean_gap:.3g} apart (bound 1e-4)", flush=True)
    return agree, err


def phase_mcm_event(dev):
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene, mcm

    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    worst = 0.0
    for tracking in ("none", "auto"):
        for dtype in (None, torch.bfloat16):
            scene = make_scene(volume.blobs_volume(32, seed=1),
                               transfer.gray_ramp(alpha_scale=0.8),
                               tf_srgb=True, tracking=tracking,
                               pack_dtype=dtype, device=dev)
            check((scene.tracking_packed is not None) == (tracking == "auto"),
                  f"blobs scene, tracking={tracking}: table not as expected")
            label = f"128^2 blobs32 tracking={tracking} " \
                    f"{'bf16' if dtype else 'f32'} 8 frames"
            worst = max(worst, _frames_agree(scene, params, 128, 8, label)[1])
    return {"max_abs_err": worst}


def print_kernel_device_ms(scene, steps, frames=10):
    """Print the event kernel's own device time per launch, measured by
    torch.profiler (the CUDA-event time of a frame also holds the host's
    per-frame work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    state = mcm.reset(params, 512, 512, scene)
    mcm_event.event_frame(state, scene, params, 0.1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            mcm_event.event_frame(state, scene, params, 0.2 + 0.001 * i)
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages() if "mcm_event_kernel" in e.key)
    if total <= 0.0:
        print(f"mcm_event steps {steps}: device time not measured (the "
              "profiler saw no kernel)", flush=True)
        return
    ms = total / 1e3 / frames
    print(f"mcm_event 512^2 headline steps {steps}: {ms:.4f} ms device time "
          f"per launch (torch.profiler), {512 * 512 * steps / ms * 1e3:.6g} "
          "events/s of device time", flush=True)


def time_event_kernel(scene, params):
    """Per-frame ms of the kernel and of the plain loop at the main path's
    shape, from the same state, plus their samples agreement."""
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    state = mcm.reset(params, 512, 512, scene)
    plain = {k: v.clone() for k, v in state.items()}
    timed = {k: v.clone() for k, v in state.items()}
    ms = cuda_ms(lambda: mcm_event.event_frame(timed, scene, params, 0.5), 20)
    # the plain loop: one warm-up frame and two timed ones
    plain_ms = cuda_ms(
        lambda: mcm_event.event_frame_plain(plain, scene, params, 0.5), 2)
    for _ in range(3):
        mcm_event.event_frame(state, scene, params, 0.5)
    torch.cuda.synchronize()
    agree = float((state["samples"] == plain["samples"]).float().mean())
    check(agree >= 0.9999,
          f"512^2 headline: samples agree on only {agree}")
    events = 512 * 512 * params.steps
    print(f"mcm_event 512^2 headline steps {params.steps}: {ms:.4f} ms/frame "
          f"({events / ms * 1e3:.6g} events/s), plain loop {plain_ms:.4f} "
          f"ms/frame ({events / plain_ms * 1e3:.6g} events/s); samples "
          f"agree {agree:.6f} after 3 frames from one state (bound 0.9999)",
          flush=True)
    return ms, plain_ms


def phase_main_path(dev, counters):
    """The port's main path through the user's entry points, with every
    launch counter at 0 first.  Returns the headline rates and each
    kernel's launches in this run."""
    import torch

    from vpt_tpu_torch import skipgrid, tonemap, transfer, volume
    from vpt_tpu_torch.renderers import make_renderer, make_scene, mcm

    for module in counters.values():
        module.LAUNCHES = 0
    t0 = time.perf_counter()
    scene = make_scene(volume.sphere_volume(128),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking="auto", pack_dtype=torch.bfloat16,
                       tf_mxu=True, device=dev)
    check(scene.tracking_packed is not None,
          "headline scene: the auto policy built no tracking table")
    check(scene.tracking_packed.dtype == torch.bfloat16,
          "headline scene: tracking table is not bf16")
    # the tracking table against the TF: the TF gives alpha 0 at the center
    # of every cell the table marks empty.  Scene.sample_color launches the
    # standalone tf1d kernel; the frames below run the same lookup inside
    # the event kernel
    d, h, w = scene.volume.shape[:3]
    empty = (scene.tracking_packed[:, 0] < -0.5).reshape(d, h, w)
    cells = empty.nonzero().to(torch.float32)           # (n, 3) z, y, x
    centers = (cells.flip(-1) + 1.0) / torch.tensor([w, h, d], device=dev)
    color = scene.sample_color(centers)
    check(bool((color[:, 3] == 0.0).all()),
          "tracking table marks cells empty that the TF makes visible")
    torch.cuda.synchronize()
    frac = skipgrid.empty_fraction(scene.tracking_packed)
    print(f"scene: 128^3 sphere, bf16 tables, tracking table built, "
          f"{frac:.4f} of the cells empty, alpha 0 at all {len(cells)} "
          f"empty-cell centers; build {time.perf_counter() - t0:.3f} s",
          flush=True)

    rates = {}
    for steps, frames in ((8, 30), (32, 15)):
        params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
        renderer = make_renderer("mcm", params, height=512, width=512)
        renderer.reset(scene)
        renderer.render(scene, 0.123)                       # warm-up frame
        torch.cuda.synchronize()
        paths0 = float(renderer.state["samples"].sum(dtype=torch.float64))
        t0 = time.perf_counter()
        for i in range(frames):
            renderer.render(scene, 0.2 + 0.001 * i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        paths1 = float(renderer.state["samples"].sum(dtype=torch.float64))
        events = 512 * 512 * steps * frames / dt
        paths = (paths1 - paths0) / dt
        check(paths > 0, f"steps {steps}: no photon path completed")
        rates[steps] = (events, paths)
        print(f"headline steps={steps}: {events:.6g} events/s", flush=True)
        print(f"headline steps={steps}: {paths:.6g} paths/s", flush=True)
        print(f"headline steps={steps}: {events / paths:.6g} mean path "
              f"events ({frames} frames, {dt * 1e3:.3f} ms)", flush=True)

    hdr = renderer.display(scene)
    image = tonemap.ToneMapper("reinhard")(hdr)
    torch.cuda.synchronize()
    check(tuple(image.shape) == (512, 512, 4), f"image shape {image.shape}")
    check(bool(torch.isfinite(image).all()), "display image is not finite")
    check(bool((image[..., 3] == 1.0).all()), "display alpha is not 1")
    check(0.0 <= float(image[..., :3].min())
          and float(image[..., :3].max()) <= 1.0, "display out of [0, 1]")
    mean = float(hdr[..., :3].mean())
    check(0.05 < mean < 1.0, f"HDR image mean {mean} out of range")
    print(f"display: 512x512x4 finite, alpha 1, HDR mean {mean:.6f}, "
          f"reinhard mean {float(image[..., :3].mean()):.6f}", flush=True)
    return rates, {name: m.LAUNCHES for name, m in counters.items()}


def run():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from vpt_tpu_torch.kernels import _build, mcm_event, tf1d
        from vpt_tpu_torch.kernels import tonemap_kernel
    except ImportError as exc:
        raise SmokeFailure(f"vpt_tpu_torch is not importable from {root}: "
                           f"{exc}") from exc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds:.2f} s)", flush=True)

    k2 = phase_tonemap(dev)
    k1 = phase_tf1d(dev)
    k5 = phase_mcm_event(dev)

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene, mcm

    headline = make_scene(volume.sphere_volume(128),
                          transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                          tracking="auto", pack_dtype=torch.bfloat16,
                          device=dev)
    k5["ms"], k5["plain_ms"] = time_event_kernel(
        headline, mcm.Params(extinction=40.0, anisotropy=0.3, steps=8))
    for steps in (8, 32):
        print_kernel_device_ms(headline, steps)
    del headline

    counters = {"mcm_event": mcm_event, "tf1d_lookup": tf1d,
                "tonemap": tonemap_kernel}
    rates, launches = phase_main_path(dev, counters)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    print("launches on the main path: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), flush=True)

    rows = [
        {"name": "mcm_event", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcm_event.cu",
         "replaces": "vpt_tpu/renderers/mcm.py:197",
         "launched_by": "Renderer.render (every frame); runs the "
                        "csrc/tf1d.cuh TF lookup on every event", **k5},
        {"name": "tf1d_lookup", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/tf1d.cu",
         "replaces": "vpt_tpu/pallas/tf1d.py:75",
         "launched_by": "Scene.sample_color, called by this script to check "
                        "the tracking table; frames run the lookup inside "
                        "mcm_event", **k1},
        {"name": "tonemap", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/tonemap.cu",
         "replaces": "vpt_tpu/pallas/tonemap_kernel.py:36",
         "launched_by": "ToneMapper('reinhard') on the display image", **k2},
    ]
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "launched_by",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}), flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except (SmokeFailure, ImportError, RuntimeError, ValueError,
            NotImplementedError, subprocess.SubprocessError, OSError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
