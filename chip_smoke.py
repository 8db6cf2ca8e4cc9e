"""Drive the PyTorch/CUDA port's MCM forward render and its differentiable
MCM fit once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit.  The phases, in order; any failure exits non-zero and
prints no result:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from ``vpt_tpu_torch/csrc`` (nvcc, sm_90a);
3. the tone-map kernel against its plain version, all eight curves;
4. the TF-lookup kernel against its plain version, float32 and bf16 rows,
   in the bilinear and both ``tf_mxu`` modes;
5. the MCM event kernel against the plain event loop on the card, the
   headline's ``tf_mxu`` bf16 mode included;
6. the corner-gather kernel (K3) against its plain version, bit for bit:
   the probe's shapes (2^21 × 128 table, 2^17 indices) and the fit's fused
   fetch (256³ table, 256² photons); the corner-scatter kernel (K4) against
   ``index_add_``, with indices heavy in duplicates, at the probe's and the
   fit's shapes: atomics sum in another order, so the two must agree
   within the float32 bound of reordering each sum (:func:`order_bound`);
7. one value-and-grad of the fit's loss at 64², ``blobs_volume(32)``, steps
   8 × 2 frames, the kernels against the plain versions on the card;
8. the forward main path with every launch counter at 0: ``make_scene``
   (128³ sphere, sRGB gray ramp, cheb-skip auto tracking, bf16 tables,
   ``tf_mxu``), ``make_renderer("mcm")`` frames at 512², steps 8 and 32,
   ``display``, and the ``reinhard`` tone mapper.  The tracking table is
   checked against the TF through ``Scene.sample_color``, which launches
   the standalone TF-lookup kernel; inside frames the same lookup runs as a
   device function of the event kernel;
9. the fit path with every launch counter at 0 again: BASELINE config 3's
   256³ volume (``blobs_volume(256)`` as truth, a constant 0.2 volume as
   init, ``gray_ramp(alpha_scale=0.8)``), a 256² target rendered by the
   port's ``mcm_expected_image`` under ``no_grad``, one timed value-and-grad
   (grad events/s, peak memory), then ``train.fit_mc`` with its default
   Params (extinction 10, steps 16) for 3 Adam steps.  Frames are cut from
   the fit's default 64 to 16 for this script's time limit;
10. every kernel launched on its path (8 or 9); the JSON line says which
    call launched each.

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
        for mxu in (None, torch.float32, torch.bfloat16):
            got = tf1d.lookup_1d(table, values, width, mxu)
            want = tf1d.lookup_plain(table, values, mxu)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(err <= 1e-6, f"tf1d ({dtype} row, mode {mxu}): max abs "
                  f"err {err}")
    # the headline's mode: a bf16 row with bf16 lerp weights
    mxu = torch.bfloat16
    ms = cuda_ms(lambda: tf1d.lookup_1d(table, values, width, mxu), 200)
    plain_ms = cuda_ms(lambda: tf1d.lookup_plain(table, values, mxu), 50)
    print(f"tf1d: f32 and bf16 rows, bilinear and tf_mxu f32/bf16 weights "
          f"agree (atol 1e-6), max abs err {worst}; (512, 512) values, "
          f"TW=256, bf16 weights {ms:.4f} ms, plain {plain_ms:.4f} ms",
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
    for tracking, dtype, tf_mxu in (("none", None, False),
                                    ("none", torch.bfloat16, False),
                                    ("auto", None, False),
                                    ("auto", torch.bfloat16, False),
                                    ("auto", torch.bfloat16, True)):
        scene = make_scene(volume.blobs_volume(32, seed=1),
                           transfer.gray_ramp(alpha_scale=0.8),
                           tf_srgb=True, tracking=tracking, pack_dtype=dtype,
                           tf_mxu=tf_mxu, device=dev)
        check((scene.tracking_packed is not None) == (tracking == "auto"),
              f"blobs scene, tracking={tracking}: table not as expected")
        label = f"128^2 blobs32 tracking={tracking} " \
                f"{'bf16' if dtype else 'f32'}" \
                f"{' tf_mxu' if tf_mxu else ''} 8 frames"
        worst = max(worst, _frames_agree(scene, params, 128, 8, label)[1])
    return {"max_abs_err": worst}


def order_bound(counts, abs_sums):
    """Bound on |a - b| for two float32 sums of the same terms in different
    orders: each lies within (n - 1)·2^-24·Σ|x| of the exact sum of its n
    terms.  ``counts`` and ``abs_sums`` per output element."""
    return 2.0 * counts * 2.0 ** -24 * abs_sums


def phase_corner_kernels(dev):
    """K3 and K4 against their plain versions at the probes' and the fit's
    shapes.  Returns the JSON fields of both; their times are those of the
    fit's entry points (corner_fetch, corner_grad) at 256³ / 256²."""
    import torch

    from vpt_tpu_torch import sampling
    from vpt_tpu_torch.kernels import corner_gather, corner_scatter

    g = torch.Generator(device=dev).manual_seed(3)
    # K3, the probe: 2^21 rows of 128 lanes (1 GiB), 2^17 indices
    table = torch.randn(1 << 21, 128, device=dev, generator=g)
    idx = torch.randint(0, 1 << 21, (1 << 17,), device=dev, generator=g)
    got = corner_gather.gather_rows(table, idx)
    want = corner_gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "gather_rows differs from table[idx]")
    probe_ms = cuda_ms(lambda: corner_gather.gather_rows(table, idx), 50)
    probe_plain = cuda_ms(
        lambda: corner_gather.gather_rows_plain(table, idx), 50)
    print(f"corner_gather gather_rows (2^21, 128) table, 2^17 rows: equal; "
          f"{probe_ms:.4f} ms, plain table[idx] {probe_plain:.4f} ms",
          flush=True)
    del table, idx, got, want

    # K3, the fit's fused fetch: a 256³ corner table, one photon per pixel
    shape = (256, 256, 256, 1)
    packed = sampling.pack_corner_volume(
        torch.rand(shape, device=dev, generator=g))
    pos = torch.rand(256 * 256, 3, device=dev, generator=g) * 1.2 - 0.1
    cells, f = sampling.corner_cells(pos, shape)
    got = corner_gather.corner_fetch(packed, cells, f)
    want = corner_gather.corner_fetch_plain(packed, cells, f)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "corner_fetch is not bit for bit the "
          "plain gather and lerp")
    ms = cuda_ms(lambda: corner_gather.corner_fetch(packed, cells, f), 200)
    plain_ms = cuda_ms(
        lambda: corner_gather.corner_fetch_plain(packed, cells, f), 50)
    print(f"corner_gather corner_fetch 256^3 table, 256^2 photons: bit for "
          f"bit; {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    k3 = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}

    # K4, the probe: a (2^20, 128) table, 2^15 updates onto 2^10 of its
    # 2^24 8-lane rows (32 updates per row on average)
    t4 = torch.zeros(1 << 20, 128, device=dev)
    idx4 = torch.randint(0, 1 << 10, (1 << 15,), device=dev,
                         generator=g) * 16381
    ct4 = torch.randn(1 << 15, 8, device=dev, generator=g)
    got = corner_scatter.scatter_add_rows8(t4.clone(), idx4, ct4)
    want = corner_scatter.scatter_add_rows8_plain(t4.clone(), idx4, ct4)
    # the same sums in another order: within the reordering bound
    bound = order_bound(
        torch.bincount(idx4, minlength=1 << 24)[:, None],
        corner_scatter.scatter_add_rows8_plain(torch.zeros_like(t4), idx4,
                                               ct4.abs()).view(-1, 8))
    torch.cuda.synchronize()
    diff = (got - want).view(-1, 8).abs()
    err_probe = float(diff.max())
    check(bool((diff <= bound).all()),
          f"scatter_add_rows8: max abs err {err_probe} beyond the bound")
    probe_ms = cuda_ms(
        lambda: corner_scatter.scatter_add_rows8(t4, idx4, ct4), 200)
    probe_plain = cuda_ms(
        lambda: corner_scatter.scatter_add_rows8_plain(t4, idx4, ct4), 50)
    print(f"corner_scatter scatter_add_rows8 (2^20, 128) table, 2^15 "
          f"updates on 2^10 rows: max abs err {err_probe} (within the "
          f"reordering bound, max {float(bound.max()):.3g}); "
          f"{probe_ms:.4f} ms, plain index_add_ {probe_plain:.4f} ms",
          flush=True)
    del t4, got, want

    # K4, the fit's backward: photons crowded into a cube 13 cells a side
    # (about 2200 cells, ~30 photons a cell), as a frame's entry cells are
    crowd = 0.45 + 0.05 * torch.rand(256 * 256, 3, device=dev, generator=g)
    cells, f = sampling.corner_cells(crowd, shape)
    ct = torch.randn(256 * 256, 1, device=dev, generator=g)
    rows = packed.shape[0]
    got = corner_scatter.corner_grad(cells, f, ct, rows, 1)
    want = corner_scatter.corner_grad_plain(cells, f, ct, rows, 1)
    bound = order_bound(
        torch.bincount(cells, minlength=rows)[:, None],
        corner_scatter.corner_grad_plain(cells, f, ct.abs(), rows, 1))
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= bound).all()),
          f"corner_grad: max abs err {err} beyond the reordering bound")
    ms = cuda_ms(lambda: corner_scatter.corner_grad(cells, f, ct, rows, 1),
                 50)
    plain_ms = cuda_ms(
        lambda: corner_scatter.corner_grad_plain(cells, f, ct, rows, 1), 20)
    print(f"corner_scatter corner_grad 256^3 table, 256^2 photons on "
          f"{int(cells.unique().numel())} cells: max abs err {err} (within "
          f"the reordering bound, max {float(bound.max()):.3g}); {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms (both allocate and zero the 512 MiB "
          "gradient)", flush=True)
    k4 = {"max_abs_err": max(err, err_probe), "ms": ms, "plain_ms": plain_ms}
    return k3, k4


def phase_fit_check(dev):
    """One value-and-grad of the fit's loss, the kernels against the plain
    versions on the card (Scene.kernels=False)."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch import train, transfer, volume
    from vpt_tpu_torch.renderers import make_scene, mcm

    scene = make_scene(volume.blobs_volume(32, seed=1),
                       transfer.gray_ramp(alpha_scale=0.8), device=dev)
    params = mcm.Params(extinction=10.0, anisotropy=0.3, steps=8)
    target = torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(
        4)).to(dev)
    out = []
    for kernels in (True, False):
        vol = torch.full((32, 32, 32, 1), 0.2, device=dev,
                         requires_grad=True)
        loss = train.mc_loss({"volume": vol},
                             dataclasses.replace(scene, kernels=kernels),
                             target, params, 2, np.float32(0.1))
        loss.backward()
        out.append((loss.item(), vol.grad))
    torch.cuda.synchronize()
    (loss, grad), (plain_loss, plain_grad) = out
    check(bool(torch.isfinite(grad).all()), "fit gradient is not finite")
    check(float(grad.abs().max()) > 0.0, "fit gradient is all zero")
    rel = float((grad - plain_grad).norm() / plain_grad.norm())
    # the fetch is bit for bit, so the loss is; the gradients are sums of
    # atomics in another order
    check(loss == plain_loss, f"fit loss {loss} != plain {plain_loss}")
    check(rel <= 1e-4, f"fit gradient: relative L2 error {rel}")
    print(f"fit value-and-grad 64^2 blobs32 steps 8 x 2 frames: loss "
          f"{loss!r} equal to the plain version's; volume gradient relative "
          f"L2 error {rel:.3g} (bound 1e-4)", flush=True)


#: the fit path's sizes: BASELINE config 3's volume and image; frames cut
#: from fit_mc's default 64 for this script's time limit
FIT_VOLUME, FIT_RES, FIT_FRAMES = 256, 256, 16


def phase_fit_path(dev, counters):
    """The fit at BASELINE config 3's size through ``train.fit_mc``, with
    every launch counter at 0 first.  Returns each kernel's launches."""
    import numpy as np
    import torch

    from vpt_tpu_torch import train, transfer, volume
    from vpt_tpu_torch.renderers import diff_mc, make_scene, mcm

    for module in counters.values():
        module.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    n, res, frames, steps = FIT_VOLUME, FIT_RES, FIT_FRAMES, 3
    params = mcm.Params(extinction=train.MC_FIT_EXTINCTION["mcm"], steps=16)
    t0 = time.perf_counter()
    truth = make_scene(volume.blobs_volume(n),
                       transfer.gray_ramp(alpha_scale=0.8), device=dev)
    with torch.no_grad():
        target = diff_mc.mcm_expected_image(truth, params, res, res, frames)
    torch.cuda.synchronize()
    check(tuple(target.shape) == (res, res, 3)
          and bool(torch.isfinite(target).all()), "target not finite")
    print(f"fit target: {n}^3 blobs truth, {res}^2, steps 16 x {frames} "
          f"frames under no_grad in {time.perf_counter() - t0:.3f} s, mean "
          f"{float(target.mean()):.6f}", flush=True)

    init = torch.full((n, n, n, 1), 0.2, device=dev)
    vol = init.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = train.mc_loss({"volume": vol}, truth, target, params, frames,
                         np.float32(0.1))
    loss.backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(vol.grad).all()),
          "fit loss or gradient not finite")
    check(float(vol.grad.abs().max()) > 0.0, "fit gradient is all zero")
    events = res * res * params.steps * frames
    peak = torch.cuda.max_memory_allocated()
    print(f"fit value-and-grad {n}^3 / {res}^2, steps 16 x {frames} frames: "
          f"{dt * 1e3:.3f} ms, {events / dt:.6g} grad events/s, peak "
          f"memory {peak / 2 ** 30:.3f} GiB", flush=True)
    del vol, loss

    t0 = time.perf_counter()
    fitted, _, losses = train.fit_mc(target, truth, init_volume=init,
                                     frames=frames, steps=steps)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"fit losses {losses}")
    check(bool(torch.isfinite(fitted).all()) and float(fitted.min()) >= 0.0
          and float(fitted.max()) <= 1.0, "fitted volume outside [0, 1]")
    check(not torch.equal(fitted, init), "fit_mc did not move the volume")
    print(f"fit_mc {n}^3 / {res}^2, steps 16 x {frames} frames, {steps} Adam "
          f"steps: losses {losses}; {step_s * 1e3:.3f} ms per step, "
          f"{events / step_s:.6g} grad events/s per step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
          flush=True)
    return {name: m.LAUNCHES for name, m in counters.items()}


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
        from vpt_tpu_torch.kernels import _build, corner_gather
        from vpt_tpu_torch.kernels import corner_scatter, mcm_event, tf1d
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
    k3, k4 = phase_corner_kernels(dev)
    phase_fit_check(dev)

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene, mcm

    headline = make_scene(volume.sphere_volume(128),
                          transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                          tracking="auto", pack_dtype=torch.bfloat16,
                          tf_mxu=True, device=dev)
    k5["ms"], k5["plain_ms"] = time_event_kernel(
        headline, mcm.Params(extinction=40.0, anisotropy=0.3, steps=8))
    for steps in (8, 32):
        print_kernel_device_ms(headline, steps)
    del headline

    counters = {"mcm_event": mcm_event, "tf1d_lookup": tf1d,
                "tonemap": tonemap_kernel, "corner_gather": corner_gather,
                "corner_scatter": corner_scatter}
    rates, render_launches = phase_main_path(dev, counters)
    torch.cuda.empty_cache()
    fit_launches = phase_fit_path(dev, counters)
    for path, launches, names in (
            ("forward render", render_launches,
             ("mcm_event", "tf1d_lookup", "tonemap")),
            ("fit", fit_launches,
             ("corner_gather", "corner_scatter", "tf1d_lookup"))):
        for name in names:
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        print(f"launches on the {path} path: " + ", ".join(
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
                        "mcm_event (the fit path launches it too, for the "
                        "no_grad target render)", **k1},
        {"name": "tonemap", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/tonemap.cu",
         "replaces": "vpt_tpu/pallas/tonemap_kernel.py:36",
         "launched_by": "ToneMapper('reinhard') on the display image", **k2},
        {"name": "corner_gather", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/corner_gather.cu",
         "replaces": "benchmarks/pallas_gather.py:26",
         "launched_by": "train.fit_mc: sampling.CornerFetch forward, one "
                        "corner_fetch per event (fit path)", **k3},
        {"name": "corner_scatter", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/corner_scatter.cu",
         "replaces": "benchmarks/pallas_scatter_bwd.py:41",
         "launched_by": "train.fit_mc: sampling.CornerFetch backward, one "
                        "corner_grad per event (fit path)", **k4},
    ]
    for row in rows:
        launches = fit_launches if row["name"].startswith("corner") \
            else render_launches
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
