"""Drive the PyTorch/CUDA port's renderers (MCM, EAM, MIP, Depth, ISO,
MCS, DOS, LAO), its ``cli render``, its differentiable MCM and MCS fits,
its ``cli fit`` (EAM, ISO depth, MCM with the occlusion completion), its
``cli view`` server, its ``cli animate``, its config-3 recipe, its
``parallel`` package (rows over ranks, the volume in halo slabs, DOS's
row bands, photons resident on their slab's rank, the config-4 recipe)
and its three demos once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-path [--part PART] TREE ...
    (PART: frames, fetch, sweep, gloo or bucketed)

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit.  With ``--launch-path`` it times the launch paths of the
TF-lookup and corner-fetch kernels (``--part fetch``), of the march, ISO
shade and MCS kernels (``--part frames``), of all five (the default), or
the DOS and LAO paths (``--part sweep``: a DOS sweep on the host clock and
on the card, the host µs of a DOS frame call, a LAO frame's loop and
device time; ``--part gloo``: the K8 halo frame's call on two gloo ranks
of the card at each batch of :data:`GLOO_BATCHES`; ``--part bucketed``:
the bucketed EAM step in a world of one over ``nccl`` and on two gloo
ranks, and config 4's fit step, :func:`bucketed_path_numbers`) of each given
checkout of the port (:func:`launch_path_tree`, one process a tree) and
does nothing else; an older checkout goes under the git-ignored
``build/``, e.g.
``mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent``
then ``--launch-path build/parent . . build/parent``.
Without arguments, the phases, in order; any failure exits non-zero and
prints no result:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from ``vpt_tpu_torch/csrc`` (nvcc, sm_90a);
3. the tone-map kernel against its plain version, all eight curves;
4. the TF-lookup kernel against its plain version, float32 and bf16 rows,
   in the bilinear and both ``tf_mxu`` modes; its bilinear mode timed
   against ``F.grid_sample`` (border padding, ``align_corners=False``) on
   the (1, 4, 1, TW) texture;
5. the MCM event kernel against the plain event loop on the card (on the
   scene with ``kernels=False``: the reference launches no kernel), the
   headline's ``tf_mxu`` bf16 mode included; its registers, spills and
   residency on the headline;
6. the corner-gather kernel (K3) against its plain version, bit for bit:
   the probe's shapes (2^21 × 128 table, 2^17 indices) and the fit's fetch
   from positions (256³ table, 256² photons, float32 and bfloat16 rows,
   NaN and out-of-range positions, the saved cells and fractions), timed
   against ``F.grid_sample`` of the (1, C, D, H, W) volume; the
   corner-scatter kernel (K4) against
   ``index_add_``, with indices heavy in duplicates, at the probe's and the
   fit's shapes: atomics sum in another order, so the two must agree
   within the float32 bound of reordering each sum (:func:`order_bound`);
   K4's bucket instance against its plain version within that bound on
   the four buckets of a bucketed EAM step at ``path parallel``'s shape
   and on bucket 0 of config 4's slab, and the whole-table K4 at ``path
   fit eam``'s call shape, each timed beside ``index_add_`` of the
   precomputed rows and counted (entries a row, distinct rows a window
   of entries: :func:`entry_counts`) (:func:`phase_bucket_kernel`);
7. one value-and-grad of the fit's loss at 64², ``blobs_volume(32)``, steps
   8 × 2 frames, the kernels against the plain versions on the card;
8. the forward main path with every launch counter at 0: ``make_scene``
   (128³ sphere, sRGB gray ramp, cheb-skip auto tracking, bf16 tables,
   ``tf_mxu``), ``make_renderer("mcm")`` frames at 512², steps 8 and 32,
   ``display``, and the ``reinhard`` tone mapper.  The tracking table is
   checked against the TF through ``Scene.sample_color``, which launches
   the standalone TF-lookup kernel; inside frames the same lookup runs as a
   device function of the event kernel.  Before this phase the event
   kernel is held against the plain loop on the headline at 512² and at
   1024×512 (more photons than the card holds at once) and timed, its
   bound counting the distinct corner rows a frame fetches.  The entry
   points build the volumes, TFs and scenes on the card by default;
9. the march kernel (K6) in each of its four modes, the ISO shade kernel
   (K7) and the MCS kernel (K8) against their plain versions on the card
   (the renderers' plain frames on the scene with ``kernels=False``):
   the headline scene and a float32 ``blobs_volume(64)`` at 512², default
   Params, 4 frames; then timed at the headline, each bound counting the
   samples and distinct corner rows this run's frame takes (K8's from the
   kernel's own count of its fetches, checked against the plain frame's
   estimate), with K6's and K8's host µs a frame, K7's a display, and
   their registers and blocks an SM; the printed lines add K6's row reads
   and share of the warps' lanes,
   modelled from the plain frame's samples, and K8's estimate;
   then the DOS slice kernel (K9) and the LAO march kernel (K10) against
   their plain versions on the same two scenes at 512², default Params
   (DOS over its whole sweep, LAO one frame), K9's own table of each
   frame against ``dos.slice_table`` bit for bit, timed at the headline
   (K9 over a sweep: ``dos.reset`` and the frames until the depth passes
   the far depth), their bounds from this run's written pixels, active
   pixel-slices and distinct corner rows, registers and residency, K10's
   count of its lane-slices (equal to the plain frame's active
   pixel-slices) and warp-slices beside those modelled from the plain
   frame;
9a. the row window of K5, K6 (four modes), K8 and K10 at 512² on the
   headline (:func:`phase_window_checks`): each frame rendered as two
   equal bands of rows and as three uneven ones (137, 202 and 173 rows),
   each band with its ``window=(row0, 512)``, stacked and held against
   the unwindowed frame, bit for bit (K10 within its 99.99%-within-1e-6
   bound);
9b. the spatially sharded instances against their plain twins
   (:func:`phase_slab_fetch`, :func:`phase_halo_event`,
   :func:`phase_dos_band`), each timed beside the kernel it splits: K3's
   slab instance (4 slabs of 256² positions on the headline, a float32
   blobs 128³ and a two-channel blobs 128³, bit for bit to the plain twin
   and summed to the whole-table fetch; 2 interleaved slabs, masked and
   unmasked, and 2 unmasked contiguous ones bit for bit to the plain
   twin), K5's halo instance (512² frames on 2 slabs against the plain
   loop over the HaloScene and on one slab against the whole-frame K5,
   bit for bit; :func:`phase_halo_layouts`: 2 interleaved and 2 unmasked
   slabs against the plain loop, the two-channel instance on one slab
   against K5's ext frame and on 2 against the plain loop, bit for bit,
   and timed), K9's band instance (two bands of a 512² frame against the
   plain band, bit for bit, and the cooperative frame); the halo
   instances of K6 (EAM, MIP, Depth, ISO), K7 (ISO's display), K8 (MCS)
   and K9 (DOS) (:func:`phase_halo_frames`: on the headline and a
   two-channel 128³ at 512², one slab's frames bit for bit to the
   whole-scene kernels', 2 slabs' (contiguous, interleave 2) within the
   kernels' bounds of the plain twins, and each timed against its
   whole-scene kernel in turns with its bound, :func:`march_halo_frame_bytes`
   and its kin; K8's and K9's rows with their launches, host reads and
   all-reduces a frame, K8's call at each batch of 2, 4 and 8);
10. each renderer through the user's entry points at 512²
   (``make_renderer``, 10 frames, a DOS sweep, ``display``, the
   ``reinhard`` tone mapper) on the headline scene, EAM also on the 256³
   sphere, each with every launch counter at 0 just before it and read
   just after: one K6, K8, K9 or K10 launch a frame, one K2 a display,
   one K7 an ISO display, no other launch;
10a. the scene options, each path with every launch counter at 0
   just before it and read just after:
   ``path grid``: K5's majorant-grid machine (``tracking="grid"``, a 16³
   grid) against the plain grid loop at 512² on the headline's float32
   twin and on the headline, then the headline's MCM path with the grid
   (steps 8 × 30 and 32 × 15 frames, ``display``, ``reinhard``):
   events/s, paths/s, mean path events and K5's device ms a frame beside
   the cheb headline's of this run (medians in turns), the bound (state, distinct rows of
   the collisions, the grid) and the share of hop events;
   ``path env``: K5 and K8 with ``gradient_sky(64, 128)`` and a random
   1024×2048 map against their plain versions on the float32 twin, their
   device ms on the headline against the 1×1 map in turns, the MCM and
   MCS paths with the sky, and ``cli render --envmap`` on a PNG written
   by ``write_png`` (read back by ``read_image``);
   ``path clamp``: K6 with ``march_clamp=True`` (EAM, MIP, Depth, ISO)
   and ISO with ``iso_clamp_min=0.1`` at isovalues 0.05 and 0.5 against
   the plain clamped frames on the float32 twin, their device ms on the
   headline against the unclamped frames in turns, and each clamped
   renderer's path;
10b. two-channel and filtered volumes, the ext instances of K5-K8
   (``csrc/ray.cuh``), each path with every launch counter at 0 just
   before it and read just after (:func:`phase_channels_path`,
   :func:`phase_filters_path`):
   ``path channels``: ``with_gradient_magnitude(blobs_volume(256))`` as a
   256³ RG uint8 BVP and ``TransferFunctionBumps.default()`` as the
   ``--tf`` JSON through ``cli render``: MCM 512², 32 spp, then EAM, MIP,
   Depth, ISO, MCS, DOS and LAO at 10 spp (bf16 tables and 2D TF);
   ``path filters``: the headline's ``sphere_volume(128)`` through
   ``RenderingContext.set_filter("nearest")`` and ``("cubic")``: MCM steps
   8 × 30 frames, with the global majorant and ``tracking="grid"``, and
   EAM, MIP, Depth, ISO, MCS, DOS and LAO, 10 frames each.
   Each ext instance is held to its plain version on the path's scene and
   a float32 twin (K5 3 frames, K6 and K8 4, K7 on the ISO state, K9 a
   whole sweep, K10 a frame and on two channels its baked instance; the
   kernels' bounds) and timed against the linear single-channel instance
   on the same scene (medians of :func:`device_turns`; K9 a sweep's first
   frame; ``path channels``: its volume with a three-bump 2D TF, where
   ISO hits), with its bound from this run's rows;
10c. ``path baked``: ``volume.with_lao_gradient(blobs_volume(256))`` (the
   bake timed on the card) with the three-bump 2D TF through
   ``RenderingContext`` (bf16 tables), LAO with ``baked_gradient=True``
   at 512², 2 frames and the display; K10's baked instance held to its
   plain frame on that scene and a float32 twin, timed in turns against
   the seven-tap instance on the same scene, and the baked image against
   the exact seven-tap one within ``tests/test_lao_baked.py``'s bounds;
10d. ``path unpacked`` (:func:`phase_unpacked_path`): a ``pack=False``
   64³ blobs scene (the samplers unpacked, float32 corner tables for the
   kernels), one frame of each of the eight renderers at 256² through its
   kernel against its plain frame within the packed rows' bounds, ISO's
   display through K7, every launch counter at 0 first;
11. the serving entry point, ``vpt_tpu_torch.cli.main(["render", ...])``
   in-process (:func:`phase_cli_path`): a 256³ uint8 BVP written by the
   port's ``write_bvp``, MCM at 512², 32 spp, ``--precision fast``, cheb-skip,
   the sRGB TF, reinhard, a PNG and a checkpoint, with the stage seconds
   on the host clock (load, scene build, frames, display, PNG write), ms a
   frame and events/s; checked bit for bit against the renderer driven
   directly on the context's scene and seeds, a 16 + 16-frame resume and
   the PNG's zlib-decoded pixels; then the eight renderers through
   ``cli render`` on the same BVP (10 spp, DOS one sweep), and
   ``blobs:320``, a volume above the 256³ packing rule, on float32 corner
   tables, and MCM with ``--tracking grid`` on the BVP, held to the plain
   grid loop; each ``cli.main`` with every launch counter at 0 just
   before it and read just after (one launch of the renderer's kernel a
   frame, one K2 a display, one K7 an ISO display, no other);
12. the fit path with every launch counter at 0 again: BASELINE config 3's
   256³ volume (``blobs_volume(256)`` as truth, a constant 0.2 volume as
   init, ``gray_ramp(alpha_scale=0.8)``), a 256² target rendered by the
   port's ``mcm_expected_image`` under ``no_grad``, one timed value-and-grad
   (grad events/s, peak memory), then ``train.fit_mc`` with its default
   Params (extinction 10, steps 16) for 3 Adam steps.  Frames are cut from
   the fit's default 64 to 16 for this script's time limit;
12a. ``path fit mcs`` with every launch counter at 0: the value and the
   volume gradient of ``mcs_expected_image`` at 64² with the kernels
   against ``kernels=False`` (loss equal, gradient within 1e-4 relative
   L2); then BASELINE.json's MCS configuration, a 256³ ``blobs_volume``
   and a 256² target rendered by the port under ``no_grad``, a TF fit
   from a flat 0.2 init through ``train.fit_mc(renderer="mcs")``, 3 Adam
   steps at lr 0.02, frames cut from the fit's default 64 to 16 for this
   script's time limit (:data:`FIT_MCS_FRAMES`; the peak memory must stay
   under half of the card's); the seconds an Adam step, the peak memory
   and the K3/K4 launches a step; one profiled value-and-grad, and one
   with the early exit against one with the full tracking budget;
12b. the inverse-rendering entry point, ``cli fit`` in-process, each
   path with every launch counter at 0 first (:func:`phase_fit_eam_path`,
   :func:`phase_fit_iso_path`, :func:`phase_inpaint_path`):
   ``path fit eam`` (BASELINE config 1): ``blobs_volume(64)`` and 256²
   PNG targets from 4 orbit views by ``train.render_eam`` under
   ``no_grad``; one value-and-grad of the 4-view loss with the kernels
   against ``kernels=False`` (loss within 1e-6 relative, gradient within
   1e-4 relative L2, K3 and K4 launched, K1 not); then ``cli fit --grid
   64 --eam-slices 64 --steps 5 --inpaint-blind``;
   ``path fit iso`` (BASELINE config 2): ``sphere_volume(128)``, a 256²
   depth ``.npy`` by ``diff_iso.render`` under ``no_grad``; the same check
   of ``depth_loss`` at 64² and at 256² with the isovalue as a leaf; then
   ``cli fit --method iso-depth --grid 128 --steps 5``;
   ``path inpaint`` (config 3): a 256² PNG of ``blobs_volume(256)`` by
   ``mcm_expected_image``, then ``cli fit --method mcm --grid 256
   --mc-frames 16 --steps 3 --inpaint``;
   each prints the seconds an Adam step, the peak memory and the K3/K4
   launches a step (:class:`StepWatch`), ``path fit eam`` the blind tau
   table, ``path inpaint`` the seconds of ``complete_occluded`` on the
   256³ fitted volume and the filled share.  Cuts: Adam steps 200 → 5, 5
   and 3, MC frames 32 → 16, for this script's time limit;
12c. the last entry points, each path with every launch counter at 0
   first: ``path view`` (:func:`phase_view_path`): ``python -m
   vpt_tpu_torch.cli view`` on 11's BVP (MCM, 512²) as a subprocess,
   stopped by its PID, and the same server in this process on a context
   built from the same arguments, both sent the page, /info, /histogram,
   8 /frame requests of 4 spp at one pose, a pose change, a Params and a
   static Params change, a switch to each other renderer, a POST /tf with
   a /frame and /tf.png, a resolution and a filter change; every status
   200, the two servers' bodies equal bit for bit, each request's
   launches counted on this process's server (its renderer's kernel once
   a sample, K2 once a /frame, no other), the 8th /frame equal to 8 direct
   renders, the subprocess's latencies on the host clock; ``path
   animate`` (:func:`phase_animate_path`): ``cli animate`` in-process on
   the BVP, MCM 512², 16 spp, 8 orbit frames, ``--video`` a GIF then an
   ``.mp4`` (a GIF without OpenCV); ``path config3``
   (:func:`phase_config3_path`): the port's config-3 recipe at its full
   size with ``--inpaint-blind``, cut to 3 Adam steps a stage and 64-spp
   targets;
12d. ``path parallel`` (:func:`phase_parallel_path`): config 4's full
   shapes (``examples/config4_pod512.py:86-96``: ``blobs_volume(512,
   seed=3)``, ``gray_ramp(alpha_scale=0.9)``, MCM extinction 30,
   anisotropy 0.2, steps 8, 1024²) in a world of one over ``nccl``
   (``parallel.distributed.initialize`` on a free local port):
   ``make_mesh``, ``place_state``, 32 frames of
   ``halo.sharded_render_frame`` on one slab (K5's halo instance),
   ``shard_display`` and ``reinhard`` (K2), one frame on the volume
   z-sharded between frames against the replicated frame, a 1024² DOS
   frame through ``dos_halo`` on one band (K9's band instance), two
   ``overlap.bucketed_train_step`` steps of the data-parallel EAM fit at
   ``path fit eam``'s size (K3, K4's bucket instance: 4 launches a step,
   each bucket's reduction issued before the next launch, the order
   printed; the second timed, its peak memory),
   ``save_sharded(wait=False)`` / ``load_sharded`` of the state, and the
   config-4 recipe's fit phase at 512³ / 1024² (3 SGD steps of
   ``halo_grad.make_sharded_grad``: K3's slab instance, K4's bucket
   instance, its launches a step); the frame
   time, events/s, the step times and the peak memories; after the
   counts are read, a halo frame against ``shard_render_frame``'s K5
   frame (bit for bit) and both timed in turns, one halo frame from the
   reset state against the plain loop (``_frames_agree``'s bounds), the
   DOS band frame against the cooperative K9 frame and the 1024²
   display's K2 against ``tonemap_plain``; then ``path parallel gloo``
   (:func:`phase_parallel_gloo`): two spawned ranks on the card over
   ``gloo`` (its collectives take CUDA tensors), MCM 512² × 4 frames with
   the rows split in two and an EAM frame on a 128³ volume z-sharded over
   ``space``, assembled and held bit for bit against this process's
   world-one frames, and ``shard.eam_value_and_grad`` with one
   ``shard.data_parallel_train_step`` (rows over ``data``: an all-reduce;
   z slabs over ``space``: a reduce-scatter) against one process's
   ``train.render_eam`` gradient, and with ``space = 2`` the halo MCM
   frames of a 256³ volume (bit for bit to one process's K5 frames), the
   sharded EAM gradient and a DOS frame on two bands through
   ``dos_halo``, and ``path resident``'s two-rank cases
   (:func:`gloo_resident`: contiguous and interleaved slabs against the
   world-of-one frames bit for bit, ``fanout=2`` against the plain
   resident frames in every pool field, a two-channel scene), and two
   bucketed EAM steps at 256³ with rows over ``data`` = 2
   (:func:`gloo_bucketed`: each bucket's reduction issued and finished,
   the last K4 bucket launch's end, the overlap window); ``path parallel
   gloo 4`` also runs ``halo_grad.make_sharded_grad`` with 1 and 4
   buckets on data 2 × space 2 (:func:`gloo4_halo_grad`: one data
   all-reduce a bucket);
   ``path parallel halo frames`` (:func:`halo_frames_path`, in ``path
   parallel``'s world of one, every launch counter at 0 first): one frame
   each of EAM, MIP, Depth, ISO with its display, MCS and DOS of config 4
   at 1024² through ``halo.sharded_render_frame`` (the halo instances of
   K6-K9, no whole-scene kernel), then each against
   ``shard_render_frame``'s whole-scene kernel frame bit for bit and its
   plain twin within the kernel's bound, timed in turns; with ``space =
   2`` the two ranks render the same six (:func:`gloo_halo_frames`, 256³
   at 512²) bit for bit to one process's whole-scene kernel frames, with
   their all-reduces, launches and host reads a frame equal on both
   ranks;
   ``path resident`` (:func:`phase_resident_path`, in ``path
   parallel``'s world of one after its counts, every launch counter at 0
   first): 2 frames of ``resident.resident_render_frame`` on config 4 at
   1024² (K5's resident instance) and on a two-channel 128³ scene at 512²
   with 2 halo frames (the two-channel resident and halo instances),
   against ``shard_render_frame``'s K5 frames and K5's ext frames bit for
   bit, the pools against the plain resident frames', timed against K5
   with their bounds (:func:`resident_frame_bytes`); ``path demos``
   (:func:`phase_demos_path`): ``render_demo``, ``inverse_demo`` and
   ``depth_fit_demo`` at their default sizes, every launch counter at 0
   before each, then ``render_demo``'s eight images against their plain
   versions;
13. every kernel launched on its path (8, 10, 10a–d, 11, 12, 12a–d);
    the JSON line says which call launched each, and ``launches_cli``,
    ``launches_view``, ``launches_animate``, ``launches_config3``,
    ``launches_unpacked``, ``launches_parallel``, ``launches_demos``,
    ``launches_resident`` and ``launches_halo_frames`` its launches on the
    calls of 10d, 11, 12c and 12d.

Then one JSON line with each kernel's launches, error, loop time per call
(``ms``, CUDA events) and device time per launch (``device_ms``,
torch.profiler) beside its plain version's time, its bound (the larger of
its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, the
H100 SXM's data-sheet rates, from this run's inputs) and the time of one
PyTorch call computing the same function where there is one, and the last
line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import itertools
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


#: the H100 SXM's data-sheet rates (700 W): HBM bytes/s, float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: float32 operations of the event kernel (csrc/mcm_event.cu's note): every
#: event's flight, fetch, TF lookup and classification, and every
#: deposit's running mean and photon reset without blur (the headline's);
#: a scatter's ~75 are not counted (the run does not count scatters), so
#: the bound is a lower one
K5_OPS_EVENT, K5_OPS_DEPOSIT = 110, 125


def roofline(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time of the work on the
    card, the larger of its bytes over the memory rate and its operations
    over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


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


def synced_call_ms(fn, reps, setup=None):
    """Median milliseconds of one call of ``fn`` on the host clock, the
    card synchronised before the call and after it (the call's time to a
    finished frame), over ``reps`` calls after one warm-up call; ``setup``,
    if given, runs untimed before each call (a state's reset)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def profiler_device_ms(fn, match, reps=50):
    """Device milliseconds per call of ``fn`` in the kernels whose name
    holds ``match`` ("" for every kernel it runs), from torch.profiler over
    ``reps`` calls after one warm-up call: the kernels' own time on the
    card, which the CUDA events of :func:`cuda_ms` do not give when a call
    costs the host more than the card.  Each kernel that matches counts
    once a call, at its mean over the launches the profiler recorded (it
    may drop some, and at times records none: then it profiles once
    more).  None when neither window recorded one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # the card's own events only: a runtime call (cudaLaunchKernel)
        # carries its kernel's time too
        means = [e.device_time_total / e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and match in e.key
                 and e.count and e.device_time_total > 0]
        if means:
            return sum(means) / 1e3
    return None


def in_turns(fns, reps, rounds=3):
    """Median milliseconds per call of each of ``fns`` (name -> callable)
    by :func:`cuda_ms`, measured in turns (A B ... B A, ``rounds`` times),
    so that a drift of the host's speed touches every one alike."""
    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for name in order:
            times[name].append(cuda_ms(fns[name], reps))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def device_turns(fns, match, reps=50, rounds=3):
    """Median device milliseconds per call of each of ``fns`` (name ->
    callable) by :func:`profiler_device_ms` over ``reps`` calls, measured
    in turns as :func:`in_turns` (A B ... B A, ``rounds`` times): a window
    whose profiler dropped launches moves one of 2 × ``rounds`` readings,
    not the median.  None for a callable that no window measured."""
    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for name in order:
            ms = profiler_device_ms(fns[name], match, reps)
            if ms is not None:
                times[name].append(ms)
    return {name: sorted(t)[len(t) // 2] if t else None
            for name, t in times.items()}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    device_ms = profiler_device_ms(
        lambda: tonemap_kernel.tonemap(img, "reinhard"), "tonemap_kernel")
    # reinhard: exposure, x / (1 + x), max, pow: 5 operations an element;
    # the image read once and written once
    bound_ms, bound_by = roofline(2 * img.numel() * 4, 5 * img.numel())
    print(f"tonemap: 8 curves agree (atol 1e-6, rtol 1e-6), max abs err "
          f"{worst}; reinhard 512x512x4 {ms:.4f} ms a call, device "
          f"{fmt_ms(device_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); no one PyTorch call computes it",
          flush=True)
    return {"max_abs_err": worst, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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
    # the bilinear mode against its one-call counterpart: grid_sample of
    # the (1, 4, 1, TW) texture at x = 2v - 1, y = 0 (border padding is
    # the clamp, align_corners=False the - 0.5); its output is (1, 4, H, W)
    import torch.nn.functional as F

    tex = table.t().reshape(1, 4, 1, width).contiguous()
    grid = torch.stack([values * 2.0 - 1.0, torch.zeros_like(values)],
                       dim=-1)[None]

    def library():
        return F.grid_sample(tex, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    lib_err = float((library()[0].permute(1, 2, 0)
                     - tf1d.lookup_1d(table, values, width)).abs().max())
    check(lib_err <= 1e-4, f"tf1d: grid_sample differs by {lib_err}")
    # both are host-bound: one call costs the host more than the card, so
    # they are timed in turns and the medians compared
    turns = in_turns({"kernel": lambda: tf1d.lookup_1d(table, values, width),
                      "library": library}, 200)
    ms, library_ms = turns["kernel"], turns["library"]
    plain_ms = cuda_ms(lambda: tf1d.lookup_plain(table, values), 50)
    device_ms = profiler_device_ms(
        lambda: tf1d.lookup_1d(table, values, width), "tf1d_kernel")
    library_device_ms = profiler_device_ms(library, "grid_sampler")
    # the headline's mode: a bf16 row with bf16 lerp weights
    mxu = torch.bfloat16
    mxu_ms = cuda_ms(lambda: tf1d.lookup_1d(table, values, width, mxu), 200)
    mxu_plain = cuda_ms(lambda: tf1d.lookup_plain(table, values, mxu), 50)
    mxu_device = profiler_device_ms(
        lambda: tf1d.lookup_1d(table, values, width, mxu), "tf1d_kernel")
    shape = tf1d.launch_shape(width, dev.index or 0)
    # values read once, RGBA written once, the row read once; ~14
    # operations a value
    bound_ms, bound_by = roofline(values.numel() * 20 + table.numel() * 4,
                               14 * values.numel())
    print(f"tf1d: f32 and bf16 rows, bilinear and tf_mxu f32/bf16 weights "
          f"agree (atol 1e-6), max abs err {worst}; (512, 512) values, "
          f"TW=256: bilinear {ms:.4f} ms a call (median of 6 in turns with "
          f"F.grid_sample: {ms / library_ms:.3f} of its {library_ms:.4f} "
          f"ms), device {fmt_ms(device_ms)}, plain {plain_ms:.4f} ms; "
          f"F.grid_sample device {fmt_ms(library_device_ms)} (within "
          f"{lib_err:.3g}); bf16 weights {mxu_ms:.4f} ms a call, device "
          f"{fmt_ms(mxu_device)}, plain {mxu_plain:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}); launch shape {shape}",
          flush=True)
    return {"max_abs_err": worst, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bf16_weights_ms": mxu_ms, "bf16_weights_device_ms": mxu_device,
            "bf16_weights_plain_ms": mxu_plain,
            "blocks_per_sm": shape["blocks_per_sm"]}


def _frames_agree(scene, params, height, width, frames, label,
                  render=None):
    """Run the kernel and the plain loop from one reset state; return the
    samples-agreement fraction and the max radiance error where the
    samples agree.  The plain loop runs on the scene with
    ``kernels=False`` and must launch no kernel.  ``render(state, seed)``
    is the kernel's frame (default ``event_frame`` on ``scene``)."""
    import dataclasses

    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    if render is None:
        def render(state, seed):
            mcm_event.event_frame(state, scene, params, seed)

    state = mcm.reset(params, height, width, scene)
    plain = {k: v.clone() for k, v in state.items()}
    reference = dataclasses.replace(scene, kernels=False)
    for f in range(frames):
        render(state, 0.3 + 0.01 * f)
        before = launch_counts()
        mcm_event.event_frame_plain(plain, reference, params, 0.3 + 0.01 * f)
        check(launch_counts() == before,
              f"{label}: the plain loop launched a kernel")
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
    # (radiance equal, image means equal).  A last-bit difference
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
    # the entry points build on the card unless told otherwise
    for tracking, dtype, tf_mxu in (("none", None, False),
                                    ("none", torch.bfloat16, False),
                                    ("auto", None, False),
                                    ("auto", torch.bfloat16, False),
                                    ("auto", torch.bfloat16, True)):
        scene = make_scene(volume.blobs_volume(32, seed=1),
                           transfer.gray_ramp(alpha_scale=0.8),
                           tf_srgb=True, tracking=tracking, pack_dtype=dtype,
                           tf_mxu=tf_mxu)
        check(scene.device.type == "cuda", "make_scene did not default to "
              "the card")
        check((scene.tracking_packed is not None) == (tracking == "auto"),
              f"blobs scene, tracking={tracking}: table not as expected")
        label = f"128^2 blobs32 tracking={tracking} " \
                f"{'bf16' if dtype else 'f32'}" \
                f"{' tf_mxu' if tf_mxu else ''} 8 frames"
        worst = max(worst, _frames_agree(scene, params, 128, 128, 8,
                                         label)[1])
    return {"max_abs_err": worst}


def launch_counts():
    """Every kernel module's launch count, in one tuple."""
    from vpt_tpu_torch.kernels import corner_gather, corner_scatter
    from vpt_tpu_torch.kernels import dos_sweep, iso_shade, lao_march, march
    from vpt_tpu_torch.kernels import mcm_event, mcs_frame, tf1d
    from vpt_tpu_torch.kernels import tonemap_kernel

    return tuple(m.LAUNCHES for m in (corner_gather, corner_scatter,
                                      mcm_event, tf1d, tonemap_kernel, march,
                                      iso_shade, mcs_frame, dos_sweep,
                                      lao_march)) \
        + (mcm_event.HALO_LAUNCHES, corner_gather.SLAB_LAUNCHES,
           dos_sweep.BAND_LAUNCHES)


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

    # K3, the fit's fetch: a 256³ corner table, one photon per pixel; it
    # takes positions and computes the cells; float32 (the fit's) and
    # bfloat16 (the render's) rows, with and without the saved cells
    shape = (256, 256, 256, 1)
    vol = torch.rand(shape, device=dev, generator=g)
    packed = sampling.pack_corner_volume(vol)
    pos = torch.rand(256 * 256, 3, device=dev, generator=g) * 1.2 - 0.1
    pos[:4] = torch.tensor([[float("nan"), 0.5, 0.5], [-1.0, 2.0, 0.5],
                            [0.0, 1.0, 1.0 / 512], [1.0, 0.0, 0.5]])
    for table in (packed, packed.to(torch.bfloat16)):
        got, cells, f = corner_gather.corner_fetch(table, shape, pos,
                                                   save=True)
        want, want_cells, want_f = corner_gather.corner_fetch_plain(
            table, shape, pos, save=True)
        alone = corner_gather.corner_fetch(table, shape, pos)
        torch.cuda.synchronize()
        check(torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
              and torch.equal(alone.nan_to_num(7.0), want.nan_to_num(7.0))
              and bool(got[0].isnan().all()) and int(got[1:].isnan().sum())
              == 0, f"corner_fetch ({table.dtype} rows) is not bit for bit "
              "the plain gather and lerp")
        check(torch.equal(cells, want_cells)
              and torch.equal(f.nan_to_num(7.0), want_f.nan_to_num(7.0)),
              f"corner_fetch ({table.dtype} rows): saved cells or fractions "
              "differ from corner_cells")
    # its one-call counterpart: grid_sample of the (1, C, D, H, W) volume at
    # 2p - 1 (x over W, as the positions are; border padding is the clamp,
    # align_corners=False the - 0.5), the value alone; it rounds the filter
    # coordinate in its own order, so it agrees to float32 rounding, and a
    # NaN position is its own affair (row 0 is left out)
    import torch.nn.functional as F

    tex = vol.permute(3, 0, 1, 2)[None]
    grid = (pos * 2.0 - 1.0).view(1, -1, 1, 1, 3)

    def library():
        return F.grid_sample(tex, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    lib_err = float((library()[0, :, :, 0, 0].t()[1:]
                     - corner_gather.corner_fetch(packed, shape, pos)[1:])
                    .abs().max())
    check(lib_err <= 1e-4, f"corner_fetch: grid_sample differs by {lib_err}")

    def fetch():
        return corner_gather.corner_fetch(packed, shape, pos, save=True)

    def alone():
        return corner_gather.corner_fetch(packed, shape, pos)

    turns = in_turns({"kernel": fetch, "alone": alone, "library": library},
                     200)
    ms, alone_ms, library_ms = turns["kernel"], turns["alone"], \
        turns["library"]
    device_ms = profiler_device_ms(fetch, "corner_fetch_kernel")
    alone_device_ms = profiler_device_ms(alone, "corner_fetch_kernel")
    library_device_ms = profiler_device_ms(library, "grid_sampler_3d")
    plain_ms = cuda_ms(lambda: corner_gather.corner_fetch_plain(
        packed, shape, pos, save=True), 50)
    # the rows the photons need read once (32 bytes each), the positions
    # once, the values, cells and fractions written once; the coordinates'
    # ~21 and the lerp chain's 21 operations a photon
    rows_read = int(cells.unique().numel())
    k3_bound, k3_by = roofline(rows_read * packed.shape[1] * 4
                            + cells.numel() * (12 + 4 + 8 + 12),
                            42 * cells.numel())
    print(f"corner_gather corner_fetch 256^3 table, 256^2 positions: bit for "
          f"bit (f32 and bf16 rows, NaN and out-of-range positions), cells "
          f"and fractions equal corner_cells; medians of 6 in turns: with "
          f"save {ms:.4f} ms a call, device {fmt_ms(device_ms)}; without "
          f"{alone_ms:.4f} ms a call, device {fmt_ms(alone_device_ms)}; "
          f"F.grid_sample of the volume (the value alone) {library_ms:.4f} "
          f"ms a call, device {fmt_ms(library_device_ms)} (within "
          f"{lib_err:.3g}); plain {plain_ms:.4f} ms; bound {k3_bound:.4f} ms "
          f"({k3_by}, {rows_read} rows)", flush=True)
    k3 = {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
          "plain_ms": plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
          "library_ms": library_ms, "library_device_ms": library_device_ms,
          "library_max_abs_err": lib_err, "no_save_ms": alone_ms,
          "no_save_device_ms": alone_device_ms}

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
    def grad():
        return corner_scatter.corner_grad(cells, f, ct, rows, 1)

    ms = cuda_ms(grad, 50)
    # the call's whole device time (the zero fill of the dense gradient and
    # the scatter), which its bound counts; the scatter kernel beside it
    device_ms = profiler_device_ms(grad, "")
    scatter_ms = profiler_device_ms(grad, "corner_grad_kernel")
    plain_ms = cuda_ms(
        lambda: corner_scatter.corner_grad_plain(cells, f, ct, rows, 1), 20)
    library = scatter_library_ms(cells, f, ct, 0, rows, 1)
    # its contract is a dense (rows, 8) float32 gradient, written once; the
    # cells, fractions and cotangents read once; the 8 weights and products
    # are ~20 operations a photon
    k4_bound, k4_by = roofline(rows * 8 * 4 + cells.numel() * (8 + 12 + 4),
                            20 * cells.numel())
    shape_of = {c: corner_scatter.occupancy(c) for c in (1, 2)}
    print(f"corner_scatter corner_grad 256^3 table, 256^2 photons on "
          f"{int(cells.unique().numel())} cells: max abs err {err} (within "
          f"the reordering bound, max {float(bound.max()):.3g}); {ms:.4f} "
          f"ms a call, device {fmt_ms(device_ms)} (the zero fill and the "
          f"scatter; the scatter alone {fmt_ms(scatter_ms)}), plain "
          f"{plain_ms:.4f} ms (both allocate and zero the 512 MiB "
          f"gradient); bound {k4_bound:.4f} ms ({k4_by}: the dense gradient "
          f"written once); {library['text']}; the kernel's shape "
          + "; ".join(f"C = {c}: {json.dumps(v)}"
                      for c, v in shape_of.items()), flush=True)
    k4 = {"max_abs_err": max(err, err_probe), "ms": ms,
          "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": k4_bound,
          "bound_by": k4_by, "library_ms": library["ms"],
          "library_device_ms": library["device_ms"],
          "library": "index_add_ of the precomputed (n, 8C) weighted rows "
                     "into the zeroed gradient: the scatter alone",
          "scatter_device_ms": scatter_ms,
          "occupancy": {f"c{c}": v for c, v in shape_of.items()}}
    return k3, k4


def scatter_library_ms(idx, f, ct, r0, r1, c):
    """The one PyTorch call that does K4's scatter: ``index_add_`` of the
    in-range entries' (n, 8·C) weighted rows, computed beforehand as the
    plain version forms them, into a zeroed (r1 − r0, 8·C) gradient; the
    scatter alone, the fill and the weights outside the timing.  Its
    time a call (CUDA events) and its device time (torch.profiler)."""
    import torch

    from vpt_tpu_torch.kernels import corner_scatter

    idx, f, ct = idx.reshape(-1), f.reshape(-1, 3), ct.reshape(-1, c)
    inside = (idx >= r0) & (idx < r1)
    rel = idx[inside] - r0
    weighted = (corner_scatter.corner_weights(f[inside])[:, :, None]
                * ct[inside][:, None, :]).reshape(-1, 8 * c)
    grad = torch.zeros(r1 - r0, 8 * c, device=idx.device)

    def call():
        return grad.index_add_(0, rel, weighted)

    ms = cuda_ms(call, 20)
    device_ms = profiler_device_ms(call, "", reps=20)
    del grad, weighted, rel
    return {"ms": ms, "device_ms": device_ms,
            "text": f"index_add_ of the precomputed weighted rows into the "
                    f"zeroed gradient (the scatter alone, no fill) {ms:.4f} "
                    f"ms a call, device {fmt_ms(device_ms)}"}


def _captured(module, name, run):
    """The argument lists of every call of ``module.<name>`` while
    ``run()`` runs, each call passed on to the function."""
    calls, real = [], getattr(module, name)

    def capture(*args):
        calls.append(args)
        return real(*args)

    setattr(module, name, capture)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


def eam_bucket_calls(truth, tf, eparams, views, targets):
    """The 4 calls of K4's bucket instance in one bucketed EAM
    value-and-grad from a flat 0.2 (``path parallel``'s step: 4 buckets),
    each (cells, fractions, cotangents, r0, r1, C): the entries the
    fetches saved.  Checks there are 4."""
    import numpy as np
    import torch

    from vpt_tpu_torch import train
    from vpt_tpu_torch.kernels import corner_scatter
    from vpt_tpu_torch.parallel import overlap

    def loss_of_volume(v):
        return sum(train.mse_rgb(train.render_eam(
            v, tf, cams, eparams, np.float32(0.0), 256, 256), target)
            for cams, target in zip(views, targets)) / len(views)

    calls = _captured(corner_scatter, "corner_grad_bucket",
                      lambda: overlap.value_and_grad_bucketed(
                          loss_of_volume,
                          overlap.split_volume(torch.full_like(truth, 0.2),
                                               4)))
    check(len(calls) == 4, f"corner_grad_bucket: {len(calls)} calls in a "
          "bucketed EAM step")
    return calls


def fit_eam_calls(truth, tf, eparams, cams, target):
    """The 8 calls of the whole-table K4 (``corner_grad``) in one view's
    value-and-grad of ``train.render_eam`` from ``path fit eam``'s flat 0.1
    (256², 64 slices, one a fetch of 8), each (cells, fractions,
    cotangents, rows, C).  Checks there are 8."""
    import numpy as np
    import torch

    from vpt_tpu_torch import train
    from vpt_tpu_torch.kernels import corner_scatter

    def value_and_grad():
        leaf = torch.full_like(truth, 0.1).requires_grad_(True)
        train.mse_rgb(train.render_eam(leaf, tf, cams, eparams,
                                       np.float32(0.0), 256, 256),
                      target).backward()

    calls = _captured(corner_scatter, "corner_grad", value_and_grad)
    check(len(calls) == 8, f"corner_grad: {len(calls)} calls in one view's "
          "EAM value-and-grad (64 slices, 8 a fetch)")
    return calls


def config4_bucket_call(dev):
    """Bucket 0 of config 4's fit (a slab of 513 planes of 512² in 4
    buckets: 128 planes of rows) from 2^20 positions drawn uniformly in
    the 512³ volume: (cells, fractions, cotangents, 0, r1, 1)."""
    import torch

    from vpt_tpu_torch import sampling

    g = torch.Generator(device=dev).manual_seed(5)
    pos = torch.rand(1 << 20, 3, device=dev, generator=g)
    cells, f = sampling.corner_cells(pos, (512, 512, 512, 1))
    ct = torch.randn(1 << 20, 1, device=dev, generator=g)
    return cells, f, ct, 0, 128 * 512 * 512, 1


def bucket_check(label, idx, f, ct, r0, r1, c):
    """K4's bucket instance against its plain version on one bucket's
    inputs, within the reordering bound (:func:`order_bound`): (max abs
    err, entries in the bucket)."""
    import torch

    from vpt_tpu_torch.kernels import corner_scatter

    got = corner_scatter.corner_grad_bucket(idx, f, ct, r0, r1, c)
    want = corner_scatter.corner_grad_bucket_plain(idx, f, ct, r0, r1, c)
    inside = (idx >= r0) & (idx < r1)
    bound = order_bound(
        torch.bincount(idx[inside] - r0, minlength=r1 - r0)[:, None],
        corner_scatter.corner_grad_bucket_plain(idx, f, ct.abs(), r0, r1,
                                                c))
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= bound).all()), f"corner_grad_bucket {label}: max "
          f"abs err {err} beyond the reordering bound")
    return err, int(inside.sum())


def bucket_bound(idx, inside, rows, c):
    """The bound of one call of K4's bucket instance: every entry's cell
    read once (8 B), the bucket's entries' fractions and cotangents once,
    its (rows, 8·C) gradient written once; ~20 operations an entry in the
    bucket."""
    return roofline(idx.numel() * 8 + inside * (12 + 4 * c) + rows * 32 * c,
                    20 * inside)


#: the windows of consecutive entries :func:`entry_counts` counts rows in
COUNT_WINDOWS = (32, 256, 512, 2048, 4096)


def entry_counts(idx, r0, r1, c, chunk, slots):
    """What K4's design rests on, for one call over rows [r0, r1): the
    entries in the range, the rows they touch, the entries a touched row
    (mean, max), and for each window of :data:`COUNT_WINDOWS` consecutive
    entries (aligned at entry 0, as the kernel's chunks are) the distinct
    in-range rows it holds (mean and 99th percentile over the windows
    holding one, and the largest); then the global atomics the call
    issues: one float atomic a lane before (8·C an in-range entry), and
    under the chunked design 2·C float4 atomics a distinct row of each
    ``chunk``-entry chunk (the kernel's chunk at full size,
    ``corner_scatter.occupancy``; a chunk whose rows overflow its
    ``slots``-row table adds the rows past it directly, 2·C a warp's
    row), and the chunks holding more rows than the table."""
    import torch

    idx = idx.reshape(-1)
    inside = (idx >= r0) & (idx < r1)
    rel = torch.where(inside, idx - r0, torch.full_like(idx, -1))
    per_row = torch.bincount(rel[inside], minlength=r1 - r0)
    touched = per_row[per_row > 0]
    out = {"entries": int(inside.sum()), "rows_touched": touched.numel(),
           "per_row_mean": float(touched.float().mean())
           if touched.numel() else 0.0,
           "per_row_max": int(touched.max()) if touched.numel() else 0}
    for w in sorted(set(COUNT_WINDOWS) | {chunk}):
        m = -(-idx.numel() // w)
        key = torch.full((m * w,), -1, dtype=torch.int64, device=idx.device)
        key[:idx.numel()] = rel
        s = key.view(m, w).sort(dim=1).values
        distinct = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum(1) \
            + (s[:, 0] >= 0)
        held = distinct[distinct > 0].float()
        if w == chunk:
            out["chunk_rows_total"] = int(distinct.sum())
            out["chunks_over_table"] = int((distinct > slots).sum())
        out[f"rows_per_{w}"] = (
            float(held.mean()), float(torch.quantile(held, 0.99)),
            int(held.max())) if held.numel() else (0.0, 0.0, 0)
        del key, s, distinct
    out["atomics_before"] = out["entries"] * 8 * c
    out["vector_atomics_design"] = out["chunk_rows_total"] * 2 * c
    return out


def kernel_counts(idx, r0, r1, c):
    """:func:`entry_counts` at the chunk and table size of the built
    kernel (``corner_scatter.occupancy``)."""
    from vpt_tpu_torch.kernels import corner_scatter

    shape = corner_scatter.occupancy(c)
    return entry_counts(idx, r0, r1, c, shape["chunk_entries"],
                        shape["table_slots"])


def counts_text(counts):
    return (f"{counts['entries']} entries on {counts['rows_touched']} rows, "
            f"{counts['per_row_mean']:.2f} a row (max "
            f"{counts['per_row_max']}); distinct rows a window (mean, p99, "
            "max) " + ", ".join(
                f"{w}: {counts[f'rows_per_{w}'][0]:.1f} / "
                f"{counts[f'rows_per_{w}'][1]:.0f} / "
                f"{counts[f'rows_per_{w}'][2]}" for w in COUNT_WINDOWS)
            + f"; {counts['chunks_over_table']} chunks over the table's "
            f"rows; global atomics {counts['atomics_before']} float a lane "
            f"before, {counts['vector_atomics_design']} float4 a chunk's "
            "row now")


def phase_bucket_kernel(dev):
    """K4's bucket instance (``corner_scatter.corner_grad_bucket``) against
    its plain version at the shapes of its two paths: the four buckets of
    one bucketed EAM value-and-grad of ``path parallel`` (64³, 4 views of
    256², 64 slices: the entries its fetches saved, captured from the
    call), and bucket 0 of config 4's fit (a slab of 513 planes of 512²
    in 4 buckets: 128 planes of rows) from a million positions drawn
    uniformly in the 512³ volume; each within the reordering bound, each
    bucket of the EAM step and config 4's bucket timed (CUDA events, the
    profiler's device time of the call: the zero fill and the scatter)
    beside the plain version, the bound (:func:`bucket_bound`) and
    ``index_add_`` (:func:`scatter_library_ms`), with the counts the
    kernel's design rests on (:func:`entry_counts`).  Then the whole-table
    K4 (``corner_grad``) at ``path fit eam``'s call shape: the 8 calls of
    one view's value-and-grad (64³, 256², 64 slices, one a fetch of 8
    slices), each timed, and the middle fetch's (slices 32–39) checked,
    counted and timed against its bound and ``index_add_``.  Returns the
    JSON row's fields (its times those of the EAM step's bucket 0, the
    call the main path makes) and the whole-table K4's fields at the fit's
    call shape."""
    import torch

    from vpt_tpu_torch import volume
    from vpt_tpu_torch.kernels import corner_scatter

    truth = volume.blobs_volume(64, seed=1).data
    tf, eparams, views, targets = eam_fit_views(truth)
    calls = eam_bucket_calls(truth, tf, eparams, views, targets)
    real = corner_scatter.corner_grad_bucket
    errs, lines, counts = [], [], []
    for b, args in enumerate(calls):
        idx, f, ct, r0, r1, c = args
        err, inside = bucket_check(f"EAM bucket {b}", *args)
        errs.append(err)
        ms = cuda_ms(lambda: real(*args), 20)
        device_ms = profiler_device_ms(lambda: real(*args), "", reps=20)
        bound, by = bucket_bound(idx, inside, r1 - r0, c)
        lines.append((ms, device_ms, bound, by, inside))
        counts.append(kernel_counts(idx, r0, r1, c))
        if b == 0:
            scatter_ms = profiler_device_ms(lambda: real(*args),
                                            "corner_grad_kernel", reps=20)
            plain_ms = cuda_ms(lambda: corner_scatter.corner_grad_bucket_plain(
                *args), 5)
            library = scatter_library_ms(*args)
            n_all = idx.numel()
    print(f"corner_scatter corner_grad_bucket, a bucketed EAM step (64^3, 4 "
          f"views 256^2, 64 slices, 4 buckets of {calls[0][4]} rows, {n_all} "
          f"saved entries): max abs err {max(errs):.3g} (within the reordering "
          "bound); by bucket " + "; ".join(
              f"{b}: {ms:.4f} ms a call, device {fmt_ms(dms)}, bound "
              f"{bd:.4f} ms ({by}, {inside} entries)"
              for b, (ms, dms, bd, by, inside) in enumerate(lines))
          + f"; bucket 0's scatter alone {fmt_ms(scatter_ms)}, plain "
          f"{plain_ms:.4f} ms; {library['text']}", flush=True)
    for b, got in enumerate(counts):
        print(f"corner_scatter counts, EAM bucket {b}: {counts_text(got)}",
              flush=True)
    ms, device_ms, bound, by, _ = lines[0]
    row = {"max_abs_err": max(errs), "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library["ms"],
           "library_device_ms": library["device_ms"],
           "library": "index_add_ of the precomputed (n, 8C) weighted rows "
                      "of the bucket into the zeroed gradient: the scatter "
                      "alone", "scatter_device_ms": scatter_ms,
           "eam_bucket_ms": [x[0] for x in lines],
           "eam_bucket_device_ms": [x[1] for x in lines],
           "eam_bucket_bound_ms": [x[2] for x in lines],
           "eam_bucket_counts": counts}
    del calls

    # config 4's rows: bucket 0 of a 513-plane slab of 512² in 4 buckets
    n = 512
    cells, f, ct, _, r1, _ = config4_bucket_call(dev)
    err, inside = bucket_check("config 4 bucket 0", cells, f, ct, 0, r1, 1)

    def call():
        return real(cells, f, ct, 0, r1, 1)

    c4_ms = cuda_ms(call, 10)
    c4_device_ms = profiler_device_ms(call, "", reps=10)
    c4_plain_ms = cuda_ms(lambda: corner_scatter.corner_grad_bucket_plain(
        cells, f, ct, 0, r1, 1), 3)
    c4_bound, c4_by = bucket_bound(cells, inside, r1, 1)
    c4_counts = kernel_counts(cells, 0, r1, 1)
    c4_library = scatter_library_ms(cells, f, ct, 0, r1, 1)
    print(f"corner_scatter corner_grad_bucket, config 4's bucket 0 (128 "
          f"planes of {n}^2: {r1} rows, a {r1 * 32 / 2 ** 30:g} GiB "
          f"gradient; 2^20 positions, {inside} in the bucket): max abs err {err:.3g} (within the "
          f"reordering bound); {c4_ms:.4f} ms a call, device "
          f"{fmt_ms(c4_device_ms)}, plain {c4_plain_ms:.4f} ms, bound "
          f"{c4_bound:.4f} ms ({c4_by}); {c4_library['text']}", flush=True)
    print(f"corner_scatter counts, config 4 bucket 0: "
          f"{counts_text(c4_counts)}", flush=True)
    row.update({"max_abs_err": max(row["max_abs_err"], err),
                "config4_ms": c4_ms, "config4_device_ms": c4_device_ms,
                "config4_plain_ms": c4_plain_ms,
                "config4_bound_ms": c4_bound,
                "config4_library_ms": c4_library["ms"],
                "config4_library_device_ms": c4_library["device_ms"],
                "config4_counts": c4_counts})
    del cells, f, ct
    torch.cuda.empty_cache()
    return row, fit_eam_call_kernel(truth, tf, eparams, views[0], targets[0])


def fit_eam_call_kernel(truth, tf, eparams, cams, target):
    """The whole-table K4 (``corner_grad``) at ``path fit eam``'s call
    shape: one view's value-and-grad of ``train.render_eam`` (64³ from
    ``path fit eam``'s flat 0.1, 256², 64 slices) captures the 8 calls of
    ``CornerFetch``'s backward (one a fetch of 8 slices of 256²); each is
    timed (the profiler's device time of the call: the zero fill and the
    scatter), and the middle one (slices 32–39) is held against its plain
    version within the reordering bound, counted (:func:`entry_counts`)
    and timed against the bound (:func:`bucket_bound`'s rule over the
    whole table) and ``index_add_``.  Returns its fields."""
    import torch

    from vpt_tpu_torch.kernels import corner_scatter

    calls = fit_eam_calls(truth, tf, eparams, cams, target)
    real = corner_scatter.corner_grad
    each = [profiler_device_ms(lambda a=a: real(*a), "", reps=20)
            for a in calls]
    idx, f, ct, rows, c = calls[4]
    got = real(*calls[4])
    want = corner_scatter.corner_grad_plain(*calls[4])
    bound = order_bound(
        torch.bincount(idx[idx >= 0], minlength=rows)[:, None],
        corner_scatter.corner_grad_plain(idx, f, ct.abs(), rows, c))
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= bound).all()), f"corner_grad at path fit eam's call "
          f"shape: max abs err {err} beyond the reordering bound")
    inside = int(((idx >= 0) & (idx < rows)).sum())
    del got, want, bound, diff
    ms = cuda_ms(lambda: real(*calls[4]), 20)
    device_ms = profiler_device_ms(lambda: real(*calls[4]), "", reps=20)
    scatter_ms = profiler_device_ms(lambda: real(*calls[4]),
                                    "corner_grad_kernel", reps=20)
    bound, by = bucket_bound(idx, inside, rows, c)
    counts = kernel_counts(idx, 0, rows, c)
    library = scatter_library_ms(idx, f, ct, 0, rows, c)
    print(f"corner_scatter corner_grad at path fit eam's call shape (64^3, "
          f"{rows} rows, one fetch of 8 slices of 256^2, {idx.numel()} "
          f"entries): the 8 calls of one view, device "
          + ", ".join(fmt_ms(x) for x in each)
          + f"; the middle call (slices 32-39): max abs err {err:.3g} "
          f"(within the reordering bound), {ms:.4f} ms a call, device "
          f"{fmt_ms(device_ms)} (the scatter alone {fmt_ms(scatter_ms)}), "
          f"bound {bound:.4f} ms ({by}); {library['text']}", flush=True)
    print(f"corner_scatter counts, path fit eam's call: "
          f"{counts_text(counts)}", flush=True)
    return {"fit_eam_call_max_abs_err": err, "fit_eam_call_ms": ms,
            "fit_eam_call_device_ms": device_ms,
            "fit_eam_call_scatter_device_ms": scatter_ms,
            "fit_eam_call_bound_ms": bound,
            "fit_eam_call_library_ms": library["ms"],
            "fit_eam_call_library_device_ms": library["device_ms"],
            "fit_eam_calls_device_ms": each, "fit_eam_call_counts": counts}


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
                       transfer.gray_ramp(alpha_scale=0.8))
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


def env_texels(direction, environment):
    """The flat indices of the texels that equirect lookups at
    ``direction`` (..., 3) read: ``sampling.sample_environment``'s
    coordinates, the 2×2 corners of each bilinear CLAMP_TO_EDGE fetch."""
    import torch

    from vpt_tpu_torch import sampling

    eh, ew = environment.shape[:2]
    uv = sampling.environment_uv(direction.reshape(-1, 3))
    i0f, _ = sampling._filter_coords(uv, (ew, eh))
    i0 = sampling._clamp_index(i0f, (ew, eh))
    i1 = torch.minimum(i0 + 1, sampling._max_index((ew, eh), i0.device))
    return torch.cat([iy * ew + ix for ix in (i0[:, 0], i1[:, 0])
                      for iy in (i0[:, 1], i1[:, 1])])


def corner_rows(scene, pos):
    """The corner rows that the kernels' fetches at (N, 3) ``pos`` read:
    the cell of each position (of its cubic warp on a cubic scene; a
    nearest fetch reads the linear cell's row)."""
    from vpt_tpu_torch import sampling

    shape = scene.volume.shape
    d, h, w = shape[:3]
    warped = sampling.cubic_warp(pos, (w, h, d)) if scene.filter == "cubic" \
        else pos
    return sampling.corner_cells(warped, shape)[0]


def fetch_cells(scene, pos):
    """The rows that the kernels' fetches at (N, 3) ``pos`` read: the
    corner cell of each position (of its cubic warp on a cubic scene; a
    nearest fetch reads the linear cell's row), and on a two-channel scene
    also the packed 2D TF row of each fetched (value, channel 1), offset
    past the corner rows (a TF row has the corner row's 16 lanes and
    dtype, so the two count alike)."""
    import dataclasses

    import torch

    from vpt_tpu_torch import sampling

    d, h, w = scene.volume.shape[:3]
    cells = corner_rows(scene, pos)
    if scene.channels != 2:
        return cells
    th, tw = scene.transfer.shape[:2]
    rg = dataclasses.replace(scene, kernels=False).sample_volume_rg(pos)
    i0f, _ = sampling._filter_coords(rg, (tw, th))
    i0 = sampling._clamp_index(i0f, (tw, th))
    return torch.cat([cells, d * h * w + i0[:, 1] * tw + i0[:, 0]])


#: float32 operations that an ext instance's fetch adds to the headline's:
#: the second channel's lerp chain and the 2D TF lookup's second axis; the
#: cubic warp of three axes
EXT_OPS_CHANNEL, EXT_OPS_CUBIC = 26, 33


def ext_ops(scene):
    """The operations an ext fetch (``csrc/ray.cuh``) adds to a headline
    fetch on ``scene``: none on a linear single-channel one."""
    return (EXT_OPS_CHANNEL if scene.channels == 2 else 0) \
        + (EXT_OPS_CUBIC if scene.filter == "cubic" else 0)


def tf_row_bytes(scene):
    """The bytes of the TF row that a bound reads once: the (TW, 4)
    float32 row of a single-channel scene; a two-channel one's 2D TF rows
    are counted with its corner rows (:func:`fetch_cells`)."""
    return 0 if scene.channels == 2 else scene.transfer_1d.numel() * 4


def event_work(scene, state, params, seed):
    """What one event-kernel frame from ``state`` reads and does: the plain
    loop runs that frame on a copy (the kernel's frame is the same, photon
    for photon), its phases wrapped to record where every event samples
    (a hop of the grid machine samples nothing) and where photons escape.
    Returns the distinct corner rows, the hop events, the escapes and the
    distinct environment texels the escapes read (0 for a 1×1 map, which
    the kernel keeps in shared memory)."""
    import torch

    from vpt_tpu_torch import sampling
    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    rows, texels, counts = [], [], {"hops": 0, "escapes": 0}
    flight, grid_flight = mcm.flight_phase, mcm.grid_flight_phase
    interact = mcm.interact_phase
    env_map = tuple(scene.environment.shape[:2]) != (1, 1)

    def cells(position):
        rows.append(fetch_cells(scene, position.reshape(-1, 3)))

    def flight_recording(*args, **kwargs):
        rstate, position = flight(*args, **kwargs)
        cells(position)
        return rstate, position

    def grid_recording(*args, **kwargs):
        rstate, position, mu, collide = grid_flight(*args, **kwargs)
        counts["hops"] += int((~collide).sum())
        cells(position[collide])
        return rstate, position, mu, collide

    def interact_recording(ph, rstate, position, *args, **kwargs):
        oob = ((position > 1.0) | (position < 0.0)).any(-1)
        counts["escapes"] += int(oob.sum())
        if env_map:
            texels.append(env_texels(ph["direction"][oob],
                                     scene.environment))
        return interact(ph, rstate, position, *args, **kwargs)

    copy = {k: v.clone() for k, v in state.items()}
    mcm.flight_phase, mcm.grid_flight_phase = flight_recording, \
        grid_recording
    mcm.interact_phase = interact_recording
    try:
        mcm_event.event_frame_plain(copy, scene, params, seed)
    finally:
        mcm.flight_phase, mcm.grid_flight_phase = flight, grid_flight
        mcm.interact_phase = interact
    return {"rows": int(torch.cat(rows).unique().numel()), **counts,
            "texels": int(torch.cat(texels).unique().numel())
            if texels else 0}


def frame_rows(scene, state, params, seed):
    """The distinct corner rows that one frame from ``state`` fetches
    (:func:`event_work`)."""
    return event_work(scene, state, params, seed)["rows"]


#: float32 operations of the grid machine's flight beyond the exact
#: flight's (the nudged cell, the DDA boundary's 6 divisions and
#: subtractions, the hop, the collision distance), and of the fetch and
#: TF lookup that a hop skips; of one equirect lookup (atan2f and asinf,
#: the coordinates, the bilinear lerp)
K5_OPS_GRID_FLIGHT, K5_OPS_FETCH_TF, ENV_OPS_LOOKUP = 35, 35, 70


def event_bound(scene, n, steps, deposits, rows, hops=0, escapes=0,
                texels=0, state_bytes=60):
    """(ms, by, bytes, operations) of one event-kernel frame of ``n`` pixels
    with ``deposits`` deposits that fetches ``rows`` distinct corner rows:
    the state (``state_bytes`` a pixel: 60 with cheb) read and written
    once, each of those rows and the TF row read once, and on a grid scene
    the grid, and ``texels`` environment texels; the operations of
    K5_OPS_EVENT and K5_OPS_DEPOSIT, on a grid scene K5_OPS_GRID_FLIGHT
    more an event and K5_OPS_FETCH_TF fewer for each of its ``hops``, and
    ENV_OPS_LOOKUP for each escape of a map scene."""
    grid = scene.majorant is not None
    table = scene.volume_packed if grid or scene.tracking_packed is None \
        else scene.tracking_packed
    nbytes = 2 * n * state_bytes \
        + rows * table.shape[1] * table.element_size() \
        + tf_row_bytes(scene) + texels * 16 \
        + (scene.majorant.numel() * 4 if grid else 0)
    ops = n * steps * K5_OPS_EVENT + deposits * K5_OPS_DEPOSIT \
        + (n * steps - hops) * ext_ops(scene)
    if grid:
        ops += n * steps * K5_OPS_GRID_FLIGHT - hops * K5_OPS_FETCH_TF
    if texels:
        ops += escapes * ENV_OPS_LOOKUP
    return (*roofline(nbytes, ops), nbytes, ops)


def print_kernel_device_ms(scene, steps, frames=10, label="headline",
                           timed=True):
    """Print the event kernel's own device time per launch on ``scene`` at
    512², measured by torch.profiler (the CUDA-event time of a frame also
    holds the host's per-frame work), and the bound of those frames (on a
    grid scene with its hop events, on a map scene with the texels its
    escapes read).  Returns (ms, bound ms, the frame's work); with
    ``timed=False`` the frames run unprofiled (the caller times the
    kernel in turns) and ms is None."""
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    state = mcm.reset(params, 512, 512, scene)
    mcm_event.event_frame(state, scene, params, 0.1)
    torch.cuda.synchronize()
    paths0 = float(state["samples"].sum(dtype=torch.float64))
    seeds = itertools.count()

    def frame():
        mcm_event.event_frame(state, scene, params, 0.2 + 0.001 * next(seeds))

    if timed:
        ms = profiler_device_ms(frame, "mcm_event_kernel", frames)
    else:
        ms = None
        for _ in range(frames):
            frame()
    # the frames run since paths0: the warm-up and each profiled window
    deposits = (float(state["samples"].sum(dtype=torch.float64))
                - paths0) / next(seeds)
    work = event_work(scene, state, params, 0.3)
    work["deposits"] = deposits
    bound_ms, bound_by, nbytes, _ = event_bound(
        scene, 512 * 512, steps, deposits, work["rows"], work["hops"],
        work["escapes"], work["texels"], 60 if "cheb" in state else 56)
    work.update(bound_by=bound_by, bound_bytes=nbytes)
    events = 512 * 512 * steps
    extra = ""
    if scene.majorant is not None:
        extra += f", {work['hops'] / events:.4f} of the events hops"
    if work["texels"]:
        extra += (f", {work['escapes']} escapes reading "
                  f"{work['texels']} distinct map texels")
    if not timed:
        print(f"mcm_event 512^2 {label} steps {steps}: bound {bound_ms:.4f} "
              f"ms ({bound_by}, {nbytes} bytes with {work['rows']} distinct "
              f"corner rows, {deposits:.6g} deposits a frame{extra})",
              flush=True)
        return None, bound_ms, work
    if ms is None:
        print(f"mcm_event {label} steps {steps}: device time not measured "
              "(the profiler saw no kernel)", flush=True)
        return None, bound_ms, work
    print(f"mcm_event 512^2 {label} steps {steps}: {ms:.4f} ms device time "
          f"per launch (torch.profiler), {events / ms * 1e3:.6g} "
          f"events/s of device time; bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes} bytes with {work['rows']} distinct corner rows, "
          f"{deposits:.6g} deposits a frame{extra})", flush=True)
    return ms, bound_ms, work


def time_event_kernel(scene, params):
    """Per-frame ms of the kernel and of the plain loop at the main path's
    shape, and the bound of the kernel's frame from this run's deposits."""
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    height = width = 512
    state = mcm.reset(params, height, width, scene)
    plain = {k: v.clone() for k, v in state.items()}
    paths0 = float(state["samples"].sum(dtype=torch.float64))
    reps = 20
    ms = cuda_ms(lambda: mcm_event.event_frame(state, scene, params, 0.5),
                 reps)
    deposits = (float(state["samples"].sum(dtype=torch.float64)) - paths0) \
        / (reps + 1)
    # the plain loop: one warm-up frame and two timed ones
    plain_ms = cuda_ms(
        lambda: mcm_event.event_frame_plain(plain, scene, params, 0.5), 2)
    events = height * width * params.steps
    rows = frame_rows(scene, state, params, 0.5)
    bound_ms, bound_by, nbytes, ops = event_bound(scene, height * width,
                                                  params.steps, deposits,
                                                  rows)
    print(f"mcm_event 512^2 headline steps {params.steps}: {ms:.4f} ms/frame "
          f"({events / ms * 1e3:.6g} events/s), plain loop {plain_ms:.4f} "
          f"ms/frame ({events / plain_ms * 1e3:.6g} events/s); bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes} bytes with {rows} "
          f"distinct corner rows, {ops:.6g} operations, {deposits:.6g} "
          "deposits a frame)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bound_bytes": nbytes,
            "corner_rows": rows}


def print_event_occupancy(scene):
    """The event kernel's registers, spills and residency for the
    headline's launch."""
    from vpt_tpu_torch.kernels import mcm_event

    occ = mcm_event.occupancy(scene.tracking_packed.dtype,
                              scene.transfer_1d.shape[0])
    resident = occ["blocks_per_sm"] * occ["threads_per_block"]
    check(occ["blocks_per_sm"] >= 1, f"mcm_event does not fit an SM: {occ}")
    print(f"mcm_event launch shape (bf16 table, TW "
          f"{scene.transfer_1d.shape[0]}): {occ['registers']} registers, "
          f"{occ['local_bytes']} local (spill) bytes a thread, "
          f"{occ['blocks_per_sm']} blocks of {occ['threads_per_block']} "
          f"threads an SM ({resident} resident threads, "
          f"{occ['blocks_per_sm'] * occ['sms'] * occ['threads_per_block']} "
          f"on {occ['sms']} SMs), {occ['static_smem_bytes']} static + "
          f"{occ['dynamic_smem_bytes']} dynamic shared bytes a block",
          flush=True)
    return occ


def render_rates(scene, label):
    """The headline's rates on ``scene`` through ``make_renderer("mcm")``
    at 512², steps 8 × 30 and 32 × 15 frames after a warm-up frame each, on
    the host clock: events/s, paths/s and mean path events.  Returns
    ({steps: (events/s, paths/s)}, the last renderer)."""
    import torch

    from vpt_tpu_torch.renderers import make_renderer, mcm

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
        check(paths > 0, f"{label} steps {steps}: no photon path completed")
        rates[steps] = (events, paths)
        print(f"{label} steps={steps}: {events:.6g} events/s", flush=True)
        print(f"{label} steps={steps}: {paths:.6g} paths/s", flush=True)
        print(f"{label} steps={steps}: {events / paths:.6g} mean path "
              f"events ({frames} frames, {dt * 1e3:.3f} ms)", flush=True)
    return rates, renderer


def phase_main_path(dev, counters):
    """The port's main path through the user's entry points, with every
    launch counter at 0 first.  Returns the headline rates and each
    kernel's launches in this run."""
    import torch

    from vpt_tpu_torch import skipgrid, tonemap, transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    for module in counters.values():
        module.LAUNCHES = 0
    t0 = time.perf_counter()
    # the entry points' default device: the card
    scene = make_scene(volume.sphere_volume(128),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking="auto", pack_dtype=torch.bfloat16,
                       tf_mxu=True)
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

    rates, renderer = render_rates(scene, "headline")
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


# -- the march renderers and MCS (K6, K7, K8) ------------------------------

#: the slice's renderers, each frame one launch of the kernel named
FRAME_KERNEL = {"eam": "march_frame", "mip": "march_frame",
                "depth": "march_frame", "iso": "march_frame",
                "mcs": "mcs_frame"}
#: float32 operations a march sample (the position's 6, the corner fetch's
#: ~21, the TF lookup's ~14, the composite's up to ~10) and a pixel's ray
#: setup (the unproject's 28 with 6 divisions, the slab test's 18 with 6,
#: the segment's ~12, the integrate's 8); an ISO shade tap (fetch and TF)
#: and the rest of its shade; an MCS tracking step (the draw's ~8 and its
#: logf, the division, position, fetch, TF and the carry's ~10)
MARCH_OPS_SAMPLE, MARCH_OPS_PIXEL = 50, 66
#: what the redesign of K6, K7 and K8 for the H100 changed (their rows'
#: ``redesigned``)
REDESIGN = {
    "march_frame": "rows of 4 bf16 / 2 f32 slices read ahead of the fold, "
                   "8x4 warp tiles, TF mode as a template parameter, one "
                   "prepared pointer a launch",
    "iso_shade": "the seven rows read before the fold, the TF row through "
                 "the read-only cache with no block prologue, misses leave "
                 "at once, TF mode as a template parameter, pixels in "
                 "row-major order (8x4 tiles measured slower), one prepared "
                 "pointer a launch",
    "mcs_frame": "8x4 warp tiles, the state read first, its own step "
                 "count, one prepared pointer a launch"}
SHADE_OPS_TAP, SHADE_OPS_PIXEL = 35, 40
#: the kernel each renderer's path launches, and each kernel's symbol in
#: the profiler's names
PATH_KERNEL = {**FRAME_KERNEL, "dos": "dos_sweep", "lao": "lao_march"}
KERNEL_SYMBOL = {"march_frame": "march_kernel",
                 "mcs_frame": "mcs_frame_kernel",
                 "dos_sweep": "dos_sweep_kernel", "lao_march": "lao_"}
MCS_OPS_STEP, MCS_OPS_PIXEL = 70, 120


def renderer_module(key):
    from vpt_tpu_torch import renderers

    return getattr(renderers, key)


def kernel_and_plain_frames(key, scene, params, height, width, frames):
    """Run ``frames`` frames of renderer ``key`` through its kernel and its
    plain version on the scene with ``kernels=False`` (which launches no
    kernel), from one reset state; returns both states."""
    import dataclasses

    import torch

    from vpt_tpu_torch.kernels import march, mcs_frame

    module = renderer_module(key)
    reference = dataclasses.replace(scene, kernels=False)
    state = module.reset(params, height, width, scene)
    plain = state.clone()
    for n in range(1, frames + 1):
        seed = 0.3 + 0.01 * n
        module.render_frame(state, scene, params, seed, n)
        before = launch_counts()
        if key == "mcs":
            mcs_frame.mcs_frame_plain(plain, reference, params, seed, n)
        else:
            march.march_frame_plain(key, plain, reference, params, seed, n)
        check(launch_counts() == before,
              f"{key}: the plain frame launched a kernel")
    torch.cuda.synchronize()
    return state, plain


def compare_states(label, key, got, want, exact):
    """The share of pixels whose values are all within 1e-6 and the max
    abs error; ``exact`` (a hit position or a depth) demands equality,
    else at least 99.99% of the pixels within 1e-6."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{label} {key}: not finite")
    diff = (got - want).abs()
    pixels = diff <= 1e-6
    if pixels.dim() == 3:
        pixels = pixels.all(-1)
    share = float(pixels.float().mean())
    err = float(diff.max())
    if exact:
        check(torch.equal(got, want), f"{label} {key}: not equal to the "
              f"plain version (max abs err {err})")
    else:
        check(share >= 0.9999, f"{label} {key}: only {share:.6f} of the "
              "pixels within 1e-6 of the plain version")
    print(f"{key} {label}: {share:.6f} of the pixels within 1e-6 of the "
          f"plain version ({'equal required' if exact else 'bound 0.9999'})"
          f", max abs err {err}", flush=True)
    return err


def phase_frame_kernels(headline, dev):
    """K6 in each mode, K7 and K8 against their plain versions on the card
    at 512², default Params, 4 frames: the headline scene and a float32
    one.  Returns the worst error of each kernel."""
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import iso_shade
    from vpt_tpu_torch.renderers import make_scene

    blobs = make_scene(volume.blobs_volume(64), transfer.gray_ramp(
        alpha_scale=0.8), pack=True, device=dev)
    worst = {"march_frame": 0.0, "iso_shade": 0.0, "mcs_frame": 0.0}
    for label, scene in (("headline 512^2", headline),
                         ("f32 blobs64 512^2", blobs)):
        for key in FRAME_KERNEL:
            module = renderer_module(key)
            state, plain = kernel_and_plain_frames(key, scene,
                                                   module.Params(), 512, 512,
                                                   4)
            err = compare_states(label + " 4 frames", key, state, plain,
                                 key in ("depth", "iso"))
            worst[FRAME_KERNEL[key]] = max(worst[FRAME_KERNEL[key]], err)
            if key == "iso":
                check(bool((state[..., 3] > 0).any()), f"{label}: no hit")
                shaded = module.display(state, scene, module.Params())
                want = iso_shade.iso_shade_plain(state, scene,
                                                 module.Params())
                worst["iso_shade"] = max(worst["iso_shade"], compare_states(
                    label, "iso_shade", shaded, want, True))
    return worst


def march_work(key, scene, params, seed, height, width):
    """(samples, distinct corner rows, per-pixel samples, misses) of one
    march-kernel frame: the plain version's schedule replayed slice by
    slice with the kernel's exits (a miss samples nothing; EAM and Depth
    stop when inactive, ISO at the first hit from the near end, MIP
    never), counting the positions the kernel folds; the last two are
    (H, W) tensors."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch import sampling
    from vpt_tpu_torch.renderers import _march

    module = renderer_module(key)
    ref = dataclasses.replace(scene, kernels=False)
    # the renderer's interval: the cube clamped to the boxes that hold
    interval = None
    if key == "iso":
        def interval(ray_from, direction):
            return module.march_interval(ref, params, ray_from, direction)
    tb, miss, start, end = _march.rays(ref, height, width, interval)
    seg = end - start
    first, step = module.schedule(params, seed)
    slices = params.slices if key in ("eam", "depth") else params.steps
    rsl = _march.segment_length(start, end) * float(step)
    active = ~miss
    acc = torch.zeros_like(rsl)
    t = torch.full_like(rsl, float(first))
    cells, samples = [], 0
    per_pixel = torch.zeros_like(rsl, dtype=torch.int32)
    extinction = float(np.float32(getattr(params, "extinction", 0.0)))
    for s in range(slices):
        # the kernel's float32 schedule, in the kernel's order
        if key == "iso":
            ts = first - np.float32(slices - 1 - s) * step
        else:
            ts = first + np.float32(s) * step
        if key == "mip":
            ts = np.fmod(ts, np.float32(1.0))
        if key == "eam":
            active = active & (acc < 0.99) if ts < 1.0 \
                else torch.zeros_like(active)
        elif key == "depth":
            active = active & (t < 1.0) & (acc < float(params.threshold))
        ts = float(ts)
        pos = (start + ts * seg)[active]
        samples += pos.shape[0]
        per_pixel += active.to(torch.int32)
        cells.append(fetch_cells(scene, pos))
        alpha = ref.sample_color(start + ts * seg)[..., 3]
        if key == "eam":
            acc = torch.where(active, acc + (1.0 - acc) * (alpha * rsl
                                                           * extinction),
                              acc)
        elif key == "depth":
            acc = torch.where(active, acc + (1.0 - acc) * alpha * rsl
                              * extinction, acc)
            t = torch.where(active, t + float(step), t)
        elif key == "iso":
            active = active & ~(alpha >= float(params.isovalue))
    return samples, int(torch.cat(cells).unique().numel()), per_pixel, miss


def march_reads(key, per_pixel, miss, slices, chunk):
    """Corner-row reads of a frame whose kernel reads ``chunk`` slices
    ahead of its fold, from :func:`march_work`'s per-pixel samples: MIP
    reads every slice; EAM and Depth read the chunk in which they find
    themselves inactive, ISO the chunk of its hit, whole (up to the
    schedule's end).  The reads past the samples are the price of the
    overlap."""
    import torch

    m = per_pixel.to(torch.int64)
    if key == "mip":
        reads = torch.full_like(m, slices)
    elif key == "iso":
        reads = torch.clamp((m + chunk - 1) // chunk * chunk, max=slices)
    else:
        reads = torch.where(m < slices,
                            torch.clamp((m // chunk + 1) * chunk, max=slices),
                            m)
    return int(torch.where(miss, torch.zeros_like(reads), reads).sum())


def warp_slices(per_pixel, pixels):
    """Σ over the launch's warps of the most samples one of its lanes
    folds, for the thread → pixel map ``pixels`` = (x, y, inside) in launch
    order (``_build.tile_pixels``): the slices the warps step through, of
    which the samples are the lanes' useful share."""
    import numpy as np

    counts = per_pixel.cpu().numpy()
    x, y, inside = pixels
    h, w = counts.shape
    lanes = np.where(inside, counts[np.minimum(y, h - 1),
                                    np.minimum(x, w - 1)], 0)
    return int(lanes.reshape(-1, 32).max(1).sum())


def shade_work(scene, state, h):
    """(hits, distinct corner rows) of one ISO shade: the seven fetches of
    every hit pixel."""
    import torch

    from vpt_tpu_torch import sampling

    hit = state[..., 3] > 0
    pos = state[..., :3][hit]
    taps = [pos]
    for axis in range(3):
        offset = torch.zeros(3, device=pos.device)
        offset[axis] = h
        taps += [pos + offset, pos - offset]
    rows = fetch_cells(scene, torch.cat(taps))
    return int(hit.sum()), int(rows.unique().numel())


def mcs_work(scene, params, seed, height, width):
    """(corner-row fetches, distinct corner rows) of one MCS-kernel frame,
    estimated from the plain frame's fetches: a pixel whose position does
    not move between two fetches is done (its carry is frozen), a position
    outside the open unit cube is a path that left its segment, which the
    kernel does not fetch, and the shadow segment's fetches (and the
    diffuse one at its start) count only for pixels whose scattering point
    lies inside the cube (the others missed or escaped, and the kernel
    tracks no shadow for them).  A lower estimate of the kernel's own
    count (``mcs_frame(..., counts=)``): fetches on the cube's faces and at
    the free path's last step are left out."""
    import dataclasses

    import torch

    from vpt_tpu_torch import sampling

    ref = dataclasses.replace(scene, kernels=False)
    last, pending, cells, fetches = [None], [None], [], [0]
    scattered = [None]
    sampler = "sample_color_tracking" if scene.tracking_packed is not None \
        else "sample_color"
    original = getattr(ref, sampler)
    intersect, calls = sampling.intersect_cube, [0]

    def inside(pos):
        return ((pos > 0.0) & (pos < 1.0)).all(-1)

    def take(mask, pos):
        fetches[0] += int(mask.sum())
        cells.append(fetch_cells(scene, pos[mask]))

    def recording(pos):
        # a done pixel's first position after its collision is new but
        # never fetched, and stays put from then on: a position counts
        # once the next call has moved the pixel again
        if pending[0] is not None:
            before, mask = pending[0]
            take(mask & (pos != before).any(-1), before)
        moved = torch.ones_like(pos[..., 0], dtype=torch.bool) \
            if last[0] is None else (pos != last[0]).any(-1)
        mask = moved & inside(pos)
        if scattered[0] is not None:
            mask &= scattered[0]
        pending[0] = (pos, mask)
        last[0] = pos
        return original(pos)

    def shadow_start(origin, direction):
        # generate's second slab test starts the shadow phase, from the
        # scattering points; their diffuse fetch comes next.  The free
        # path's last positions are dropped (a lower estimate)
        calls[0] += 1
        if calls[0] == 2:
            scattered[0] = inside(origin)
            take(scattered[0], origin)
            last[0], pending[0] = origin, None
        return intersect(origin, direction)

    setattr(ref, sampler, recording)
    sampling.intersect_cube = shadow_start
    try:
        renderer_module("mcs").generate(ref, params, seed, height, width)
    finally:
        sampling.intersect_cube = intersect
    return fetches[0], int(torch.cat(cells).unique().numel())


def frame_bound(scene, table, pixels, state_bytes, ops, rows):
    """(ms, by, bytes): the distinct rows of ``table`` read once, the
    state read and written once, the TF row read once."""
    nbytes = rows * table.shape[1] * table.element_size() \
        + 2 * pixels * state_bytes + tf_row_bytes(scene)
    return (*roofline(nbytes, ops), nbytes)


def time_frame_kernels(scene):
    """ms (CUDA events over back-to-back frames), device ms (profiler) and
    the plain version's ms of K6 in each mode, K7 and K8 at the main
    path's shape (the headline at 512², default Params), with each
    frame's bound from this run's work (K8's from its own count of its
    fetches), and each one's host µs a call (a frame, K7's a display),
    registers and residency.  Returns the three rows' fields."""
    import dataclasses

    from vpt_tpu_torch.kernels import _build, iso_shade, march, mcs_frame
    from vpt_tpu_torch.kernels import tf1d

    import torch

    n = 512 * 512
    ref = dataclasses.replace(scene, kernels=False)
    tw = scene.transfer_1d.shape[0]
    k6 = {}
    for key in ("eam", "mip", "depth", "iso"):
        module = renderer_module(key)
        params = module.Params()
        state = module.reset(params, 512, 512, scene)
        module.render_frame(state, scene, params, 0.4, 1)
        plain = state.clone()

        def frame():
            march.march_frame(key, state, scene, params, 0.5, 2)

        ms = cuda_ms(frame, 20)
        device_ms = profiler_device_ms(frame, "march_kernel", 20)
        host_us = _host_call_us(frame)
        plain_ms = cuda_ms(lambda: march.march_frame_plain(
            key, plain, ref, params, 0.5, 2), 2)
        occ = march.occupancy(key, scene.volume_packed.dtype, tw,
                              tf1d.mode_code(scene.tf_mxu))
        slices = params.slices if key in ("eam", "depth") else params.steps
        samples, rows, per_pixel, miss = march_work(key, scene, params, 0.5,
                                                    512, 512)
        reads = march_reads(key, per_pixel, miss, slices, occ["chunk"])
        lanes = samples / 32 / warp_slices(per_pixel, _build.tile_pixels(
            512, 512, occ["tile_width"], occ["tile_height"],
            occ["warp_width"]))
        bound_ms, bound_by, nbytes = frame_bound(
            scene, scene.volume_packed, n, 4 if key == "mip" else 16,
            samples * MARCH_OPS_SAMPLE + n * MARCH_OPS_PIXEL, rows)
        print(f"march_frame {key} 512^2 headline: {ms:.4f} ms a frame, "
              f"device {fmt_ms(device_ms)}, host {host_us:.2f} us a frame, "
              f"plain {plain_ms:.4f} ms; {samples} samples ({samples / n:.4g}"
              f" a pixel), {rows} distinct corner rows; modelled from the "
              f"samples: {lanes:.4f} of the warps' lanes, {reads} row reads "
              f"({occ['chunk']} ahead of the fold); bound {bound_ms:.4f} ms ({bound_by}, {nbytes} "
              f"bytes); {occ['registers']} registers, {occ['local_bytes']} "
              f"spill bytes, {occ['blocks_per_sm']} blocks of 128 an SM",
              flush=True)
        k6[key] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "host_us": host_us, "registers": occ["registers"],
                   "blocks_per_sm": occ["blocks_per_sm"],
                   "samples": samples, "corner_rows": rows}
        if key == "iso":
            iso_state = state
    # the row's own numbers are EAM's; every mode's beside them
    row6 = {k: k6["eam"][k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by", "host_us",
                                      "registers", "blocks_per_sm")}
    row6.update(library_ms=None, redesigned=REDESIGN["march_frame"],
                chunk=occ["chunk"], tile=[occ["tile_width"],
                                          occ["tile_height"]])
    for key, fields in k6.items():
        for k, v in fields.items():
            row6[f"{k}_{key}"] = v

    iso = renderer_module("iso")
    params = iso.Params()

    def display():
        return iso.display(iso_state, scene, params)

    ms = cuda_ms(display, 20)
    device_ms = profiler_device_ms(display, "iso_shade_kernel", 20)
    host_us = _host_call_us(display)
    plain_ms = cuda_ms(lambda: iso_shade.iso_shade_plain(iso_state, scene,
                                                         params), 5)
    occ = iso_shade.occupancy(scene.volume_packed.dtype,
                              tf1d.mode_code(scene.tf_mxu))
    hits, rows = shade_work(scene, iso_state, params.gradient_step)
    bound_ms, bound_by, nbytes = frame_bound(
        scene, scene.volume_packed, n, 16,
        hits * (7 * SHADE_OPS_TAP + SHADE_OPS_PIXEL), rows)
    print(f"iso_shade 512^2 headline: {ms:.4f} ms a display, device "
          f"{fmt_ms(device_ms)}, host {host_us:.2f} us a display, plain "
          f"{plain_ms:.4f} ms; {hits} hits, {rows} distinct corner rows; "
          f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} bytes); "
          f"{occ['registers']} registers, {occ['local_bytes']} spill bytes, "
          f"{occ['blocks_per_sm']} blocks of 128 an SM", flush=True)
    row7 = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "host_us": host_us, "registers": occ["registers"],
            "blocks_per_sm": occ["blocks_per_sm"],
            "redesigned": REDESIGN["iso_shade"], "hits": hits,
            "corner_rows": rows}

    mcs = renderer_module("mcs")
    params = mcs.Params()
    state = mcs.reset(params, 512, 512, scene)
    plain = state.clone()

    def frame():
        mcs_frame.mcs_frame(state, scene, params, 0.5, 2)

    ms = cuda_ms(frame, 20)
    device_ms = profiler_device_ms(frame, "mcs_frame_kernel", 20)
    host_us = _host_call_us(frame)
    plain_ms = cuda_ms(lambda: mcs_frame.mcs_frame_plain(plain, ref, params,
                                                         0.5, 2), 2)
    occ = mcs_frame.occupancy(scene.tracking_packed.dtype, tw)
    # the kernel's own count of this frame, and the plain frame's estimate
    counts = torch.zeros(2, dtype=torch.int64, device=state.device)
    mcs_frame.mcs_frame(state.clone(), scene, params, 0.5, 2, counts=counts)
    steps, fetches = (int(v) for v in counts.tolist())
    estimate, rows = mcs_work(scene, params, 0.5, 512, 512)
    check(fetches >= estimate, f"mcs_frame counted {fetches} fetches, "
          f"fewer than the plain frame's {estimate}")
    bound_ms, bound_by, nbytes = frame_bound(
        scene, scene.tracking_packed, n, 16,
        fetches * MCS_OPS_STEP + n * MCS_OPS_PIXEL, rows)
    print(f"mcs_frame 512^2 headline: {ms:.4f} ms a frame, device "
          f"{fmt_ms(device_ms)}, host {host_us:.2f} us a frame, plain "
          f"{plain_ms:.4f} ms; the kernel's count: {steps} tracking steps "
          f"({steps / n:.4g} a pixel), {fetches} corner-row fetches (the "
          f"plain frame's estimate {estimate}), {rows} distinct corner "
          f"rows; bound {bound_ms:.4f} ms ({bound_by}, {nbytes} bytes); "
          f"{occ['registers']} registers, {occ['local_bytes']} spill bytes, "
          f"{occ['blocks_per_sm']} blocks of 128 an SM", flush=True)
    row8 = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "host_us": host_us, "registers": occ["registers"],
            "blocks_per_sm": occ["blocks_per_sm"],
            "redesigned": REDESIGN["mcs_frame"],
            "tracking_steps": steps, "fetches": fetches,
            "corner_rows": rows}
    return row6, row7, row8


# -- DOS and LAO (K9, K10) -------------------------------------------------

#: float32 operations of K9 (csrc/dos_sweep.cu): a pixel of an active slice
#: (the unproject's 28 with 3 divisions, the cube test's 6), a written
#: pixel (the fetch's ~21, the TF lookup's ~14, exp and the composite's ~15)
#: and each of its disk taps (~14)
DOS_OPS_ACTIVE, DOS_OPS_WRITTEN, DOS_OPS_TAP = 34, 50, 14
#: float32 operations of K10 (csrc/lao_march.cu): a corner-row fetch (the
#: cell's ~9, the lerp's ~21), an AO tap's half-vector (~20), an active
#: pixel-slice's rest (the position, gradient norm, AO and shadow terms,
#: the 2D TF lookup's ~40, the tints and the composite: ~80) and a pixel's
#: ray and random-value setup (~90)
LAO_OPS_FETCH, LAO_OPS_TAP, LAO_OPS_SLICE, LAO_OPS_PIXEL = 30, 20, 80, 90


def dos_sweep_frames(scene, params, height, width):
    """The frames of one DOS sweep: until the carried depth passes the far
    depth (``slices / steps`` frames, one more when the last slice's float32
    depth still lies at the far depth)."""
    from vpt_tpu_torch.renderers import dos

    state = dos.reset(params, height, width, scene)
    frames = 0
    while float(state["depth"]) <= float(state["max_depth"]):
        dos.advance_depth(state, dos.slice_table(state, scene, params))
        frames += 1
        check(frames <= params.slices, "the DOS sweep does not advance")
    return frames


def dos_sweep_run(scene, params, height, width, frames, plain=False):
    """One sweep from ``dos.reset``: ``frames`` frames of K9 (or of the
    plain sweep); returns the state."""
    from vpt_tpu_torch.kernels import dos_sweep
    from vpt_tpu_torch.renderers import dos

    state = dos.reset(params, height, width, scene)
    for n in range(1, frames + 1):
        if plain:
            dos_sweep.sweep_frame_plain(state, scene, params)
        else:
            dos.render_frame(state, scene, params, 0.1, n)
    return state


def dos_work(scene, params, height, width, frames):
    """(bytes, operations, written pixels, active slices) of ``frames``
    DOS frames on K9 from ``dos.reset``, from the sweep's own slice tables:
    an active slice reads and writes the colour of the pixels it writes
    (those inside the cube), reads the previous occlusion and writes the
    new (every pixel), reads the distinct rows of its written pixels'
    fetches once (:func:`fetch_cells`: the corner rows and, on a
    two-channel scene, the 2D TF rows) and the TF row; an inactive slice
    does nothing.  An ext fetch adds :func:`ext_ops`."""
    import torch

    from vpt_tpu_torch import math3d, sampling
    from vpt_tpu_torch.renderers import dos

    n = height * width
    state = dos.reset(params, height, width, scene)
    ndc = sampling.pixel_ndc(height, width, device=scene.device)
    ones = torch.ones((height, width, 1), device=scene.device)
    row_bytes = scene.volume_packed.shape[1] \
        * scene.volume_packed.element_size()
    tf_bytes = tf_row_bytes(scene)
    nbytes = ops = written = active = 0
    for _ in range(frames):
        table = dos.slice_table(state, scene, params)
        for row in table:
            if float(row[1]) <= 0.0:
                continue
            active += 1
            pos = math3d.apply_mat4(scene.mvp_inverse, torch.cat(
                [ndc, row[0].expand(height, width, 1), ones], dim=-1))
            pos = pos[..., :3] / pos[..., 3:4]
            inside = ~((pos > 1.0) | (pos < 0.0)).any(dim=-1)
            w = int(inside.sum())
            rows = int(fetch_cells(scene, pos[inside]).unique().numel())
            written += w
            nbytes += 32 * w + 8 * n + rows * row_bytes + tf_bytes
            ops += DOS_OPS_ACTIVE * n + (DOS_OPS_WRITTEN + ext_ops(scene)
                                         + DOS_OPS_TAP * params.samples) * w
        dos.advance_depth(state, table)
    return nbytes, ops, written, active


def lao_work(scene, params, height, width):
    """(samples, fetches, distinct corner rows, hit pixels, per-pixel
    samples) of one K10 frame: the plain frame replayed slice by slice,
    counting the active pixel-slices (the kernel leaves its loop at the
    first inactive one), each pixel's, and the corner rows their fetches
    read (a bitmap over the table's rows; :func:`corner_rows`, so a cubic
    fetch counts its warped cell), a baked slice's two-channel fetch
    included."""
    import dataclasses

    import torch

    from vpt_tpu_torch import sampling
    from vpt_tpu_torch.renderers import lao

    ref = dataclasses.replace(scene, kernels=False)
    ctx = lao.setup(ref, params, height, width)
    seen = torch.zeros(scene.volume_packed.shape[0], dtype=torch.bool,
                       device=scene.device)
    taps = []
    original = ref.sample_value

    def recording(pos):
        taps.append(pos)
        return original(pos)

    original_rg = ref.sample_volume_rg

    def recording_rg(pos):
        taps.append(pos)
        return original_rg(pos)

    ref.sample_value = recording
    ref.sample_volume_rg = recording_rg
    acc = torch.zeros((height, width, 4), device=scene.device)
    per_pixel = torch.zeros((height, width), dtype=torch.int32,
                            device=scene.device)
    samples = fetches = 0
    for i in range(params.slices):
        _, active = lao.slice_active(ctx, acc, i)
        active = active & ~ctx.miss
        taps.clear()
        acc = lao.march_slice(ref, params, ctx, acc, i)
        k = int(active.sum())
        if k == 0:
            break
        per_pixel += active.to(torch.int32)
        samples += k
        fetches += k * len(taps)
        for pos in taps:
            seen[corner_rows(scene, pos[active])] = True
    return samples, fetches, int(seen.sum()), int((~ctx.miss).sum()), \
        per_pixel


def dos_tables_agree(scene, params, label):
    """K9's own rows of every frame of a sweep from ``dos.reset`` (the
    table buffer the kernel writes) against ``dos.slice_table`` of the
    state before the frame, bit for bit, one frame past the far depth
    included; one launch a frame."""
    import torch

    from vpt_tpu_torch.kernels import dos_sweep
    from vpt_tpu_torch.renderers import dos

    state = dos.reset(params, 512, 512, scene)
    frames = dos_sweep_frames(scene, params, 512, 512) + 1
    table = torch.full((params.steps, dos.TABLE_HEAD + 4 * params.samples),
                       float("nan"), device=scene.device)
    before = dos_sweep.LAUNCHES
    for n in range(frames):
        want = dos.slice_table(state, scene, params)
        dos_sweep.sweep_frame(state, scene, params, table)
        check(torch.equal(table.view(torch.int32), want.view(torch.int32)),
              f"{label} dos: the kernel's table of frame {n + 1} is not "
              "dos.slice_table's")
    torch.cuda.synchronize()
    check(dos_sweep.LAUNCHES == before + frames,
          f"{label} dos: not one launch a frame")
    print(f"dos_sweep {label}: the kernel's rows of {frames} frames equal "
          "dos.slice_table's bit for bit; one launch a frame", flush=True)


def dos_lao_agree(label, scene, baked=False):
    """K9 over a whole DOS sweep from ``dos.reset`` and K10 over one LAO
    frame (and with ``baked`` its baked-gradient instance too) against
    their plain versions on ``scene`` at 512², default Params: 99.99% of
    the values within 1e-6, the sweeps' depths equal and past the far
    depth.  Returns each kernel's worst error."""
    import dataclasses

    import torch

    from vpt_tpu_torch.kernels import lao_march
    from vpt_tpu_torch.renderers import dos, lao

    dparams = dos.Params()
    worst = {"dos_sweep": 0.0, "lao_march": 0.0}
    ref = dataclasses.replace(scene, kernels=False)
    frames = dos_sweep_frames(scene, dparams, 512, 512)
    state = dos_sweep_run(scene, dparams, 512, 512, frames)
    before = launch_counts()
    plain = dos_sweep_run(ref, dparams, 512, 512, frames, plain=True)
    check(launch_counts() == before, "dos: the plain sweep launched")
    torch.cuda.synchronize()
    check(torch.equal(state["depth"], plain["depth"]),
          f"{label} dos: the sweeps' depths differ")
    check(float(state["depth"]) > float(state["max_depth"]),
          f"{label} dos: the sweep did not end in {frames} frames")
    for key in ("color", "occlusion"):
        worst["dos_sweep"] = max(worst["dos_sweep"], compare_states(
            f"{label} sweep of {frames} frames", f"dos_sweep {key}",
            state[key], plain[key], False))
    check(float(state["color"][..., 3].max()) > 0.0,
          f"{label} dos: nothing composited")
    for lparams in (lao.Params(),) + ((lao.Params(baked_gradient=True),)
                                      if baked else ()):
        state = lao.reset(lparams, 512, 512, scene)
        lao.render_frame(state, scene, lparams, 0.4, 1)
        plain = state.clone()
        before = launch_counts()
        lao_march.lao_frame_plain(plain, ref, lparams)
        check(launch_counts() == before, "lao: the plain frame launched")
        torch.cuda.synchronize()
        worst["lao_march"] = max(worst["lao_march"], compare_states(
            label + (" baked" if lparams.baked_gradient else ""),
            "lao_march", state, plain, False))
    return worst


def phase_dos_lao(headline):
    """K9 and K10 against their plain versions on the card at 512², default
    Params (DOS over its whole sweep, LAO one frame), and K9's own table
    against ``dos.slice_table`` bit for bit: the headline scene and a
    float32 one; then timed at the headline, each bound from this run's
    work.  Returns the two rows' fields."""
    import dataclasses

    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import _build, dos_sweep, lao_march, tf1d
    from vpt_tpu_torch.renderers import dos, lao, make_scene

    blobs = make_scene(volume.blobs_volume(64), transfer.gray_ramp(
        alpha_scale=0.8), pack=True)
    dparams, lparams = dos.Params(), lao.Params()
    n = 512 * 512
    worst = {"dos_sweep": 0.0, "lao_march": 0.0}
    for label, scene in (("headline 512^2", headline),
                         ("f32 blobs64 512^2", blobs)):
        for name, err in dos_lao_agree(label, scene).items():
            worst[name] = max(worst[name], err)
        dos_tables_agree(scene, dparams, label)

    # K9 over the headline's sweep
    scene, ref = headline, dataclasses.replace(headline, kernels=False)
    frames = dos_sweep_frames(scene, dparams, 512, 512)

    def sweep():
        dos_sweep_run(scene, dparams, 512, 512, frames)

    ms = cuda_ms(sweep, 10)
    # the launches differ (4 frames of 50 slices, then 1 slice): the
    # profiler's mean a launch times the frames
    frame_ms = profiler_device_ms(sweep, "dos_sweep_kernel", 5)
    device_ms = None if frame_ms is None else frame_ms * frames
    state = dos.reset(dparams, 512, 512, scene)
    host_us = _host_call_us(lambda: dos.render_frame(state, scene, dparams,
                                                     0.1, 1), 100)
    # the sweep's other host work: its reset
    reset_us = _host_call_us(lambda: dos.reset(dparams, 512, 512, scene), 50)
    plain_ms = cuda_ms(lambda: dos_sweep_run(ref, dparams, 512, 512, frames,
                                             plain=True), 1)
    tf_mode = tf1d.mode_code(scene.tf_mxu)
    occ = dos_sweep.occupancy(scene.volume_packed.dtype, tf_mode,
                              dparams.samples, dparams.steps)
    nbytes, ops, written, active = dos_work(scene, dparams, 512, 512, frames)
    slice_ms = None if device_ms is None else device_ms / active
    bound_ms, bound_by = roofline(nbytes, ops)
    print(f"dos_sweep 512^2 headline: {ms:.4f} ms a sweep (reset and "
          f"{frames} frames, one launch each), device {fmt_ms(device_ms)} a "
          f"sweep ({fmt_ms(slice_ms)} an active slice), host {host_us:.2f} "
          f"us a frame call and {reset_us:.2f} us the reset, plain "
          f"{plain_ms:.4f} ms; {active} active "
          f"slices, {written} written pixels; bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes} bytes, {ops} operations); "
          f"{occ['registers']} registers, {occ['local_bytes']} spill bytes, "
          f"{occ['blocks_per_sm']} blocks of {occ['threads_per_block']} an "
          f"SM ({occ['blocks_per_sm'] * occ['sms']} cooperative blocks)",
          flush=True)
    row9 = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "unit": "one sweep: dos.reset and the frames until the depth "
                    "passes the far depth",
            "sweep_frames": frames, "device_ms_slice": slice_ms,
            "host_us_frame": host_us, "host_us_reset": reset_us,
            "active_slices": active,
            "written_pixels": written, "registers": occ["registers"],
            "blocks_per_sm": occ["blocks_per_sm"]}

    # K10, one frame at the headline
    state = lao.reset(lparams, 512, 512, scene)

    def frame():
        lao.render_frame(state, scene, lparams, 0.5, 1)

    ms = cuda_ms(frame, 20)
    device_ms = profiler_device_ms(frame, "lao_", 20)
    host_us = _host_call_us(frame, 100)
    plain_ms = cuda_ms(lambda: lao_march.lao_frame_plain(
        state.clone(), ref, lparams), 1)
    occ = lao_march.occupancy(scene.volume_packed.dtype,
                              scene.transfer_packed.dtype)
    samples, fetches, rows, hits, per_pixel = lao_work(scene, lparams, 512,
                                                       512)
    counts = torch.zeros(2, dtype=torch.int64, device=scene.device)
    lao_march.lao_frame(state, scene, lparams, counts=counts)
    lanes, warps = counts.tolist()
    check(lanes == samples, f"lao: the kernel ran {lanes} lane-slices, the "
          f"plain frame {samples} active pixel-slices")
    # modelled: a warp steps through its longest pixel's slices
    tile_warps = warp_slices(per_pixel, _build.tile_pixels(
        512, 512, occ["tile_width"], occ["tile_height"], occ["warp_width"]))
    taps = len(lao.lao_taps(lparams))
    nbytes = rows * scene.volume_packed.shape[1] \
        * scene.volume_packed.element_size() + 20 * n \
        + scene.transfer_packed.numel() * scene.transfer_packed.element_size()
    ops = fetches * LAO_OPS_FETCH + samples * (taps * LAO_OPS_TAP
                                               + LAO_OPS_SLICE) \
        + hits * LAO_OPS_PIXEL
    bound_ms, bound_by = roofline(nbytes, ops)
    print(f"lao_march 512^2 headline: {ms:.4f} ms a frame, device "
          f"{fmt_ms(device_ms)}, host {host_us:.2f} us a frame, plain "
          f"{plain_ms:.4f} ms; {hits} hit pixels, {samples} active "
          f"pixel-slices ({samples / max(hits, 1):.4g} a hit pixel), "
          f"{fetches} corner-row fetches of {rows} distinct rows; {warps} "
          f"warp-slices counted, lanes busy {lanes / 32 / max(warps, 1):.4f}"
          f" (modelled from the plain frame on the tiles: {tile_warps} "
          f"warp-slices, {samples / 32 / max(tile_warps, 1):.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes} bytes, {ops} "
          f"operations); {occ['registers']} registers, "
          f"{occ['local_bytes']} spill bytes, {occ['blocks_per_sm']} blocks "
          f"of 128 an SM, {occ['group']} AO taps read ahead", flush=True)
    row10 = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "host_us": host_us, "samples": samples, "fetches": fetches,
             "corner_rows": rows, "warp_slices": warps,
             "lane_share": lanes / 32 / max(warps, 1),
             "tile_warp_slices": tile_warps,
             "registers": occ["registers"],
             "blocks_per_sm": occ["blocks_per_sm"]}
    row9["max_abs_err"] = worst["dos_sweep"]
    row10["max_abs_err"] = worst["lao_march"]
    del blobs
    return row9, row10


def phase_renderer_paths(dev, counters, headline):
    """Each renderer of the slice through the user's entry points at 512²
    (make_renderer, render, display, the reinhard tone mapper), EAM also on
    the 256³ sphere, each with every launch counter at 0 just before it
    and read just after.  Returns each path's launches."""
    import torch

    from vpt_tpu_torch import tonemap, transfer, volume
    from vpt_tpu_torch.renderers import make_renderer, make_scene

    t0 = time.perf_counter()
    sphere256 = make_scene(volume.sphere_volume(256),
                           transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                           tracking="auto", pack_dtype=torch.bfloat16,
                           tf_mxu=True)
    torch.cuda.synchronize()
    table_bytes = sphere256.volume_packed.numel() * 2
    print(f"scene: 256^3 sphere, bf16 tables ({table_bytes} bytes of corner "
          f"rows), built in {time.perf_counter() - t0:.3f} s", flush=True)
    paths = {}
    frames = 10
    for key, scene, label in (("eam", headline, "128^3"),
                              ("mip", headline, "128^3"),
                              ("depth", headline, "128^3"),
                              ("iso", headline, "128^3"),
                              ("mcs", headline, "128^3"),
                              ("dos", headline, "128^3"),
                              ("lao", headline, "128^3"),
                              ("eam", sphere256, "256^3")):
        renderer = make_renderer(key, height=512, width=512)
        kernel = PATH_KERNEL[key]
        # DOS runs sweeps: reset and the frames until the depth passes the
        # far depth, each frame one launch of K9
        sweep = dos_sweep_frames(scene, renderer.params, 512, 512) \
            if key == "dos" else None
        for module in counters.values():
            module.LAUNCHES = 0
        renderer.reset(scene)
        for i in range(sweep or 1):                    # warm-up frame/sweep
            renderer.render(scene, 0.123)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sweep:
            renderer.reset(scene)
        for i in range(sweep or frames):
            renderer.render(scene, 0.2 + 0.001 * i)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        frame_s = run_s / (sweep or frames)
        hdr = renderer.display(scene)
        image = tonemap.ToneMapper("reinhard")(hdr)
        torch.cuda.synchronize()
        launches = {name: m.LAUNCHES for name, m in counters.items()}
        name = f"{key} {label}"
        expected = {kernel: 2 * sweep if sweep else frames + 1,
                    "tonemap": 1}
        if key == "iso":
            expected["iso_shade"] = 1
        for other, count in launches.items():
            check(count == expected.get(other, 0), f"{name}: {other} "
                  f"launched {count} times on the path, not "
                  f"{expected.get(other, 0)}")
        check(tuple(image.shape) == (512, 512, 4)
              and bool(torch.isfinite(image).all())
              and bool((image[..., 3] == 1.0).all()),
              f"{name}: display image not finite RGBA with alpha 1")
        check(0.0 <= float(image[..., :3].min())
              and float(image[..., :3].max()) <= 1.0,
              f"{name}: display out of [0, 1]")
        mean = float(hdr[..., :3].mean())
        check(float(hdr[..., :3].abs().max()) > 0.0, f"{name}: black image")
        if key == "dos":
            check(0.0 < mean < 1.0, f"{name}: nothing occludes the white")
        seeds = itertools.count()

        def one():
            if sweep:
                renderer.reset(scene)
            for _ in range(sweep or 1):
                renderer.render(scene, 0.3 + 0.001 * next(seeds))

        device_ms = profiler_device_ms(one, KERNEL_SYMBOL[kernel],
                                       5 if sweep else 20)
        if sweep and device_ms is not None:
            device_ms *= sweep                     # a sweep's frames
        if key == "mcs":
            rate = f"{512 * 512 / frame_s:.6g} paths/s"
        else:
            slices = getattr(renderer.params, "slices", None) \
                or renderer.params.steps
            rate = f"{512 * 512 * slices / (run_s if sweep else frame_s):.6g}"\
                " samples/s"
        unit = f"a sweep ({sweep} frames and the reset)" if sweep \
            else "a frame"
        print(f"path {name} 512^2: {frame_s * 1e3:.4f} ms a frame (host "
              f"clock, {sweep or frames} frames"
              + (f"; {run_s * 1e3:.4f} ms {unit}" if sweep else "")
              + f"), device {fmt_ms(device_ms)} {unit}; {rate}; HDR mean "
              f"{mean:.6f}; launches: "
              + ", ".join(f"{k} {v}" for k, v in launches.items()),
              flush=True)
        paths[name] = {"frame_ms": frame_s * 1e3, "device_ms": device_ms,
                       "launches": launches}
        if sweep:
            paths[name]["sweep_ms"] = run_s * 1e3
    del sphere256
    return paths


# -- the scene options: the majorant grid, maps, clamps (K5, K6, K8) -------

def _path_launches(counters, name, expected):
    """The launches since the counters' reset, checked: ``expected`` of
    the kernels named there, none of any other."""
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    check_cli_launches(name, launches, expected)
    return launches


def _check_display(name, hdr, image, res=512):
    import torch

    check(tuple(image.shape) == (res, res, 4)
          and bool(torch.isfinite(image).all())
          and bool((image[..., 3] == 1.0).all()),
          f"{name}: display image not finite RGBA with alpha 1")
    check(float(hdr[..., :3].abs().max()) > 0.0, f"{name}: black image")


def phase_grid_path(dev, counters, headline, cheb_rates):
    """K5's majorant-grid machine (``tracking="grid"``, N = 16): the kernel
    against the plain grid loop at 512² on the float32 twin of the
    headline and on the headline itself (bf16 tables, ``tf_mxu``); then
    the headline's MCM path with the grid, with every launch counter at 0
    just before it and read just after (``make_renderer("mcm")``, steps
    8 × 30 and 32 × 15 frames, ``display``, ``reinhard``): events/s,
    paths/s and mean path events beside the cheb headline's of this run,
    K5's device ms a frame on the grid scene and on the cheb headline,
    in turns, with the grid frame's bound (the state, the distinct rows
    its collisions fetch, the grid) and the share of hop events.  Returns
    the K5 row's grid fields and the path's launches."""
    import dataclasses

    import torch

    from vpt_tpu_torch import tonemap, transfer, volume
    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import make_scene, mcm

    params8 = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    fields = {}
    worst = 0.0
    for label, dtype in (("f32 twin", None), ("headline", torch.bfloat16)):
        scene = make_scene(volume.sphere_volume(128),
                           transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                           tracking="grid", pack_dtype=dtype,
                           tf_mxu=dtype is not None)
        check(scene.majorant is not None
              and tuple(scene.majorant.shape) == (16, 16, 16, 2)
              and scene.tracking_packed is None,
              f"grid {label}: not a 16^3 grid without a tracking table")
        worst = max(worst, _frames_agree(scene, params8, 512, 512, 3,
                                         f"grid {label} 512^2 3 frames")[1])
    occ = mcm_event.occupancy(torch.bfloat16, scene.transfer_1d.shape[0],
                              grid=True)
    empty = float((scene.majorant[..., 0] == 0).float().mean())
    for module in counters.values():
        module.LAUNCHES = 0
    rates, renderer = render_rates(scene, "path grid")
    hdr = renderer.display(scene)
    image = tonemap.ToneMapper("reinhard")(hdr)
    torch.cuda.synchronize()
    launches = _path_launches(counters, "path grid",
                              {"mcm_event": 47, "tonemap": 1})
    _check_display("path grid", hdr, image)
    for steps in (8, 32):
        params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
        seeds = itertools.count()
        turns = {}
        for name, s in (("cheb", headline), ("grid", scene)):
            state = mcm.reset(params, 512, 512, s)
            turns[name] = (lambda state=state, s=s: mcm_event.event_frame(
                state, s, params, 0.2 + 0.001 * next(seeds)))
        times = device_turns(turns, "mcm_event_kernel")
        ms, cheb_ms = times["grid"], times["cheb"]
        _, bound, work = print_kernel_device_ms(scene, steps, timed=False,
                                                label="grid headline")
        events, paths = rates[steps]
        cheb_events, cheb_paths = cheb_rates[steps]
        hops = work["hops"] / (512 * 512 * steps)
        print(f"path grid steps {steps}: K5 {fmt_ms(ms)} a frame on the card "
              f"(cheb headline {fmt_ms(cheb_ms)}, medians in turns"
              + (f", {ms / cheb_ms:.4f}x" if ms and cheb_ms else "")
              + f"); {events:.6g} events/s (cheb {cheb_events:.6g}), "
              f"{paths:.6g} paths/s (cheb {cheb_paths:.6g}, "
              f"{paths / cheb_paths:.4f}x), {events / paths:.6g} mean path "
              f"events (cheb {cheb_events / cheb_paths:.6g}); {hops:.4f} of "
              f"the events hops; bound {bound:.4f} ms ({work['bound_by']}, "
              f"{work['bound_bytes']} bytes)", flush=True)
        fields.update({f"grid_device_ms_steps{steps}": ms,
                       f"grid_cheb_device_ms_steps{steps}": cheb_ms,
                       f"grid_bound_ms_steps{steps}": bound,
                       f"grid_hop_share_steps{steps}": hops,
                       f"grid_paths_per_s_steps{steps}": paths,
                       f"grid_events_per_s_steps{steps}": events})
    plain = mcm.reset(params8, 512, 512, scene)
    reference = dataclasses.replace(scene, kernels=False)
    plain_ms = cuda_ms(lambda: mcm_event.event_frame_plain(
        plain, reference, params8, 0.5), 2)
    print(f"path grid: 16^3 grid, {empty:.4f} of its cells empty; the "
          f"plain grid loop {plain_ms:.4f} ms a frame at steps 8; K5 grid "
          f"instance {occ['registers']} registers, {occ['local_bytes']} "
          f"local bytes, {occ['blocks_per_sm']} blocks of 128 an SM; "
          "launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()),
          flush=True)
    fields.update(grid_max_abs_err=worst, grid_registers=occ["registers"],
                  grid_plain_ms=plain_ms,
                  launches_grid=launches["mcm_event"])
    del scene, renderer
    return fields, launches


def _maps(dev):
    """The maps of ``path env``: ``gradient_sky(64, 128)`` and a random
    1024×2048 map (32 MB, every texel different), made from a seed."""
    import torch

    from vpt_tpu_torch import environment

    g = torch.Generator().manual_seed(11)
    return {"sky": environment.gradient_sky(64, 128),
            "1024x2048": torch.rand(1024, 2048, 4, generator=g).to(dev)}


def mcs_env_texels(scene, height, width):
    """The distinct texels that an MCS frame's map lookups read at least:
    the view rays of the pixels that miss the cube (the escapes' are left
    out, a lower count) and the frame's light (4)."""
    import torch

    from vpt_tpu_torch import sampling
    from vpt_tpu_torch.renderers import _march

    ndc = sampling.pixel_ndc(height, width, device=scene.device)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    ray = ray_to - ray_from
    tb = torch.clamp(sampling.intersect_cube(ray_from, ray), min=0.0)
    miss = tb[..., 0] >= tb[..., 1]
    unit = ray / torch.sqrt(torch.clamp(_march.dot3(ray, ray),
                                        min=1e-20))[..., None]
    return int(env_texels(unit[miss], scene.environment).unique().numel()) \
        + 4


def phase_env_path(dev, counters, headline):
    """Environment maps larger than 1×1 in K5 and K8: each kernel against
    its plain version on the float32 twin of the headline (512²; K5 3
    frames of steps 8, K8 4 frames) with ``gradient_sky(64, 128)`` and a
    random 1024×2048 map; K5's and K8's device ms a frame on the headline
    with each map against the 1×1 map, in turns, with bounds that add the
    texels the frame reads; then the MCM and MCS paths with the sky
    (``make_renderer``, 10 frames, ``display``, ``reinhard``), each with
    every launch counter at 0 just before it and read just after.
    Returns the K5 and K8 rows' map fields and the paths' launches."""
    import dataclasses

    import torch

    from vpt_tpu_torch import tonemap, transfer, volume
    from vpt_tpu_torch.kernels import mcm_event, mcs_frame
    from vpt_tpu_torch.renderers import make_renderer, make_scene, mcm, mcs

    maps = _maps(dev)
    params8 = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    k5, k8 = {}, {}
    worst5 = worst8 = 0.0
    twin = make_scene(volume.sphere_volume(128),
                      transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                      tracking="auto")
    for name, env in maps.items():
        scene = dataclasses.replace(twin, environment=env)
        worst5 = max(worst5, _frames_agree(
            scene, params8, 512, 512, 3, f"env {name} f32 twin 512^2 "
            "3 frames")[1])
        state, plain = kernel_and_plain_frames("mcs", scene, mcs.Params(),
                                               512, 512, 4)
        worst8 = max(worst8, compare_states(f"env {name} f32 twin 4 frames",
                                            "mcs", state, plain, False))
    del twin, scene, state, plain
    # device ms on the headline, medians in turns (1x1, maps, maps, 1x1)
    scenes = {"1x1": headline, **{name: dataclasses.replace(
        headline, environment=env) for name, env in maps.items()}}
    frames5, frames8 = {}, {}
    for name, scene in scenes.items():
        state = mcm.reset(params8, 512, 512, scene)
        frames5[name] = (lambda state=state, scene=scene:
                         mcm_event.event_frame(state, scene, params8, 0.4))
        acc = mcs.reset(mcs.Params(), 512, 512, scene)
        frames8[name] = (lambda acc=acc, scene=scene: mcs_frame.mcs_frame(
            acc, scene, mcs.Params(), 0.4, 1))
    times5 = device_turns(frames5, "mcm_event_kernel")
    times8 = device_turns(frames8, "mcs_frame_kernel")
    del frames5, frames8
    ref5, ref8 = times5["1x1"], times8["1x1"]
    tw = headline.transfer_1d.shape[0]
    for name, scene in scenes.items():
        ms5, ms8 = times5[name], times8[name]
        _, bound5, work = print_kernel_device_ms(scene, 8, timed=False,
                                                 label=f"env {name}")
        bound8, by8 = mcs_bound(scene)
        reference = dataclasses.replace(scene, kernels=False)
        state = mcm.reset(params8, 512, 512, scene)
        plain5 = cuda_ms(lambda: mcm_event.event_frame_plain(
            state, reference, params8, 0.4), 2)
        acc = mcs.reset(mcs.Params(), 512, 512, scene)
        plain8 = cuda_ms(lambda: mcs_frame.mcs_frame_plain(
            acc, reference, mcs.Params(), 0.4, 1), 2)
        occ5 = mcm_event.occupancy(torch.bfloat16, tw,
                                   env_map=name != "1x1")
        occ8 = mcs_frame.occupancy(torch.bfloat16, tw, env_map=name != "1x1")
        print(f"path env {name}: K5 {fmt_ms(ms5)} a frame on the card at "
              f"steps 8, median in turns" + (f" ({ms5 / ref5:.4f}x the 1x1 "
                                             "map's)"
                            if ms5 and ref5 else "")
              + f", bound {bound5:.4f} ms ({work['texels']} texels); K8 "
              f"{fmt_ms(ms8)} a frame"
              + (f" ({ms8 / ref8:.4f}x)" if ms8 and ref8 else "")
              + f", bound {bound8:.4f} ms ({by8}); plain frames K5 "
              f"{plain5:.4f} ms, K8 {plain8:.4f} ms; registers K5 "
              f"{occ5['registers']}, K8 "
              f"{occ8['registers']}", flush=True)
        if name != "1x1":
            k5.update({f"env_{name}_device_ms": ms5,
                       f"env_{name}_bound_ms": bound5,
                       f"env_{name}_plain_ms": plain5,
                       f"env_{name}_registers": occ5["registers"]})
            k8.update({f"env_{name}_device_ms": ms8,
                       f"env_{name}_bound_ms": bound8,
                       f"env_{name}_plain_ms": plain8,
                       f"env_{name}_registers": occ8["registers"]})
    k5.update(env_1x1_device_ms=ref5, env_max_abs_err=worst5)
    k8.update(env_1x1_device_ms=ref8, env_max_abs_err=worst8)
    sky = scenes["sky"]
    launches = {}
    for key, kernel in (("mcm", "mcm_event"), ("mcs", "mcs_frame")):
        renderer = make_renderer(key, height=512, width=512)
        for module in counters.values():
            module.LAUNCHES = 0
        renderer.reset(sky)
        for i in range(10):
            renderer.render(sky, 0.2 + 0.001 * i)
        hdr = renderer.display(sky)
        image = tonemap.ToneMapper("reinhard")(hdr)
        torch.cuda.synchronize()
        launches[key] = _path_launches(counters, f"path env {key}",
                                       {kernel: 10, "tonemap": 1})
        _check_display(f"path env {key}", hdr, image)
        print(f"path env {key} sky 512^2: 10 frames, HDR mean "
              f"{float(hdr[..., :3].mean()):.6f}; launches: "
              + ", ".join(f"{k} {v}" for k, v in launches[key].items()),
              flush=True)
    k5["launches_env"] = launches["mcm"]["mcm_event"]
    k8["launches_env"] = launches["mcs"]["mcs_frame"]

    # cli render --envmap on a PNG of write_png, read back by read_image
    import numpy as np

    from vpt_tpu_torch import environment
    from vpt_tpu_torch.io import read_image, write_png

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke")
    os.makedirs(out, exist_ok=True)
    sky_png = os.path.join(out, "sky.png")
    write_png(sky_png, maps["sky"])
    want = environment.from_image(read_image(sky_png), device=dev)
    lines, cli_launches, built = run_cli(
        ["render", "--volume", "sphere:128", "--renderer", "mcm",
         "--resolution", "512", "--spp", "8", "--tf-alpha", "0.8",
         "--tf-srgb", "--envmap", sky_png, "-o",
         os.path.join(out, "sky_mcm.png")], counters)
    check_cli_launches("path env cli", cli_launches, {"mcm_event": 8,
                                                      "tonemap": 1})
    check(len(built) == 1 and torch.equal(built[0].environment, want)
          and tuple(want.shape) == (64, 128, 4),
          "path env cli: the scene's map is not the PNG's pixels")
    pixels = png_pixels(os.path.join(out, "sky_mcm.png"))
    check(pixels.max() > 0
          and len(np.unique(pixels.reshape(-1, 3), axis=0)) > 8,
          "path env cli: the image is black or flat")
    sec = cli_seconds(lines)
    print(f"path env cli: cli render --envmap {sky_png} (64x128 PNG): the "
          f"scene's map equals the decoded PNG; MCM "
          f"512^2 8 spp {sec['frame_ms']:.4f} ms a frame (host clock); "
          f"launches mcm_event {cli_launches['mcm_event']}, tonemap "
          f"{cli_launches['tonemap']}", flush=True)
    launches["cli"] = cli_launches
    return k5, k8, launches


def mcs_bound(scene):
    """(ms, by) of one K8 frame at 512² with default Params, as
    :func:`time_frame_kernels` bounds it (the kernel's own count of its
    fetches, the distinct rows of the plain frame), plus, with a map
    larger than 1×1, one lookup a pixel and the texels
    :func:`mcs_env_texels` counts."""
    import torch

    from vpt_tpu_torch.kernels import mcs_frame
    from vpt_tpu_torch.renderers import mcs

    n = 512 * 512
    counts = torch.zeros(2, dtype=torch.int64, device=scene.device)
    state = mcs.reset(mcs.Params(), 512, 512, scene)
    mcs_frame.mcs_frame(state, scene, mcs.Params(), 0.4, 1, counts=counts)
    _, fetches = (int(v) for v in counts.tolist())
    _, rows = mcs_work(scene, mcs.Params(), 0.4, 512, 512)
    ops = fetches * (MCS_OPS_STEP + ext_ops(scene)) + n * MCS_OPS_PIXEL
    texels = 0
    if tuple(scene.environment.shape[:2]) != (1, 1):
        texels = mcs_env_texels(scene, 512, 512)
        ops += n * ENV_OPS_LOOKUP
    table = scene.tracking_packed if scene.tracking_packed is not None \
        else scene.volume_packed
    nbytes = rows * table.shape[1] * table.element_size() + 2 * n * 16 \
        + tf_row_bytes(scene) + texels * 16
    return roofline(nbytes, ops)


def phase_clamp_path(dev, counters, headline):
    """K6's clamp boxes: EAM, MIP, Depth and ISO with ``march_clamp=True``,
    and ISO with ``iso_clamp_min=0.1`` at isovalues 0.05 (the box does not
    hold) and 0.5 (it does), against the plain clamped frames on the
    float32 twin of the headline at 512², 4 frames (Depth and ISO equal,
    EAM and MIP 99.99% of the pixels within 1e-6); K6's device ms a frame
    on the headline with and without the boxes, in turns, with the clamped
    frame's bound from its samples and distinct rows and the instances'
    registers; then each clamped renderer's path (``make_renderer``, 10
    frames, ``display``, ``reinhard``) with every launch counter at 0 just
    before it and read just after.  Returns the K6 row's clamp fields and
    the paths' launches."""
    import dataclasses

    import torch

    from vpt_tpu_torch import tonemap, transfer, volume
    from vpt_tpu_torch.kernels import march, tf1d
    from vpt_tpu_torch.renderers import iso, make_renderer, make_scene

    def built(headline=False, **kw):
        """The headline's scene (bf16, ``tf_mxu``, cheb-skip) or its
        float32 twin, with the clamp options ``kw``."""
        extra = dict(tracking="auto", pack_dtype=torch.bfloat16,
                     tf_mxu=True) if headline else {}
        return make_scene(volume.sphere_volume(128),
                          transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                          **extra, **kw)

    cases = [(key, {"march_clamp": True}, renderer_module(key).Params())
             for key in ("eam", "mip", "depth", "iso")]
    cases += [("iso", {"iso_clamp_min": 0.1}, iso.Params(isovalue=v))
              for v in (0.05, 0.5)]
    fields, worst = {}, 0.0
    for key, kw, params in cases:
        twin = built(**kw)
        label = f"clamp {kw} f32 twin 512^2 4 frames"
        if key == "iso":
            label += f" isovalue {params.isovalue}"
        state, plain = kernel_and_plain_frames(key, twin, params, 512, 512,
                                               4)
        worst = max(worst, compare_states(label, key, state, plain,
                                          key in ("depth", "iso")))
    del twin, state, plain
    tw, tf_mode = headline.transfer_1d.shape[0], tf1d.mode_code(
        headline.tf_mxu)
    clamped = {"march_clamp": built(True, march_clamp=True),
               "iso_clamp_min": built(True, iso_clamp_min=0.1)}
    check(clamped["march_clamp"].occupied_aabb is not None
          and clamped["iso_clamp_min"].iso_aabb is not None,
          "path clamp: the headline has no box")
    print(f"path clamp: occupied box "
          f"{clamped['march_clamp'].occupied_aabb.tolist()}, iso box (0.1) "
          f"{clamped['iso_clamp_min'].iso_aabb.tolist()}", flush=True)
    for key, kw, params in cases:
        scene = clamped[next(iter(kw))]
        name = key if key != "iso" or "march_clamp" in kw \
            else f"iso{params.isovalue}"
        boxes = len(march.clamp_boxes(key, scene, params))
        runs = {}
        for label, s in (("bare", headline), ("clamp", scene)):
            state = renderer_module(key).reset(params, 512, 512, s)
            runs[label] = (state, s)
        times = device_turns({
            label: (lambda state=state, s=s, key=key, params=params:
                    march.march_frame(key, state, s, params, 0.5, 2))
            for label, (state, s) in runs.items()}, "march_kernel")
        ms, bare_ms = times["clamp"], times["bare"]
        plain = renderer_module(key).reset(params, 512, 512, scene)
        reference = dataclasses.replace(scene, kernels=False)
        plain_ms = cuda_ms(lambda: march.march_frame_plain(
            key, plain, reference, params, 0.5, 2), 2)
        samples, rows, _, _ = march_work(key, scene, params, 0.5, 512, 512)
        bare_samples = march_work(key, headline, params, 0.5, 512, 512)[0]
        bound, by, nbytes = frame_bound(
            scene, scene.volume_packed, 512 * 512, 4 if key == "mip" else 16,
            samples * MARCH_OPS_SAMPLE + 512 * 512 * MARCH_OPS_PIXEL, rows)
        occ = march.occupancy(key, scene.volume_packed.dtype, tw, tf_mode,
                              clamp=True)
        bare_occ = march.occupancy(key, scene.volume_packed.dtype, tw,
                                   tf_mode)
        print(f"path clamp {name} 512^2 headline ({boxes} boxes): K6 "
              f"{fmt_ms(ms)} a frame on the card against {fmt_ms(bare_ms)} "
              "unclamped (medians in turns)"
              + (f" ({ms / bare_ms:.4f}x)" if ms and bare_ms else "")
              + f"; {samples} samples ({bare_samples} unclamped), {rows} "
              f"distinct corner rows; bound {bound:.4f} ms ({by}, {nbytes} "
              f"bytes); plain {plain_ms:.4f} ms; registers "
              f"{occ['registers']} clamped, "
              f"{bare_occ['registers']} unclamped, {occ['blocks_per_sm']} / "
              f"{bare_occ['blocks_per_sm']} blocks of 128 an SM", flush=True)
        fields.update({f"clamp_{name}_device_ms": ms,
                       f"clamp_{name}_unclamped_device_ms": bare_ms,
                       f"clamp_{name}_bound_ms": bound,
                       f"clamp_{name}_plain_ms": plain_ms,
                       f"clamp_{name}_registers": occ["registers"]})
    fields["clamp_max_abs_err"] = worst
    launches, total = {}, 0
    for key in ("eam", "mip", "depth", "iso"):
        scene = clamped["march_clamp"]
        renderer = make_renderer(key, height=512, width=512)
        for module in counters.values():
            module.LAUNCHES = 0
        renderer.reset(scene)
        for i in range(10):
            renderer.render(scene, 0.2 + 0.001 * i)
        hdr = renderer.display(scene)
        image = tonemap.ToneMapper("reinhard")(hdr)
        torch.cuda.synchronize()
        expected = {"march_frame": 10, "tonemap": 1}
        if key == "iso":
            expected["iso_shade"] = 1
        launches[key] = _path_launches(counters, f"path clamp {key}",
                                       expected)
        _check_display(f"path clamp {key}", hdr, image)
        total += launches[key]["march_frame"]
        print(f"path clamp {key} 512^2: 10 frames, HDR mean "
              f"{float(hdr[..., :3].mean()):.6f}; launches: "
              + ", ".join(f"{k} {v}" for k, v in launches[key].items()),
              flush=True)
    fields["launches_clamp"] = total
    return fields, launches


# -- two-channel and filtered volumes: the ext instances of K5-K8 ---------

#: the 2D TF of the float32 twins that hold the two-channel instances:
#: three bumps over (value, gradient magnitude)
BUMPS = [
    {"position": {"x": 0.3, "y": 0.05}, "size": {"x": 0.25, "y": 0.1},
     "color": {"r": 0.9, "g": 0.6, "b": 0.2, "a": 0.8}},
    {"position": {"x": 0.6, "y": 0.1}, "size": {"x": 0.3, "y": 0.1},
     "color": {"r": 0.2, "g": 0.7, "b": 0.9, "a": 1.0}},
    {"position": {"x": 0.85, "y": 0.02}, "size": {"x": 0.2, "y": 0.05},
     "color": {"r": 1.0, "g": 1.0, "b": 1.0, "a": 0.6}},
]
EXT_NAMES = ("mcm_event", "march_frame", "iso_shade", "mcs_frame",
             "dos_sweep", "lao_march")
#: rounds of :func:`device_turns` for an ext instance: 4 readings each
EXT_ROUNDS = 2


def hold_ext(label, scene, params8, hits=True):
    """Each kernel's ext instance on ``scene`` against its plain version
    on the same scene at 512²: K5 3 frames of steps 8 (K5's bounds; none
    when ``params8`` is None), K6 in each mode and K8 4 frames (99.99% of
    the pixels within 1e-6, Depth and ISO equal), K7 on the ISO state
    (equal), which must hold hits where ``hits``, K9 over a DOS sweep and
    K10 over a LAO frame, baked too on two channels (:func:`dos_lao_agree`).
    Returns each kernel's worst error."""
    from vpt_tpu_torch.kernels import iso_shade

    worst = dict.fromkeys(EXT_NAMES, 0.0)
    worst.update(dos_lao_agree(f"{label} 512^2", scene,
                               baked=scene.channels == 2))
    if params8 is not None:
        worst["mcm_event"] = _frames_agree(scene, params8, 512, 512, 3,
                                           f"{label} 512^2 3 frames")[1]
    for key in FRAME_KERNEL:
        module = renderer_module(key)
        state, plain = kernel_and_plain_frames(key, scene, module.Params(),
                                               512, 512, 4)
        name = FRAME_KERNEL[key]
        worst[name] = max(worst[name], compare_states(
            f"{label} 512^2 4 frames", key, state, plain,
            key in ("depth", "iso")))
        if key == "iso":
            check(not hits or bool((state[..., 3] > 0).any()),
                  f"{label}: no ISO hit")
            shaded = module.display(state, scene, module.Params())
            want = iso_shade.iso_shade_plain(state, scene, module.Params())
            worst["iso_shade"] = compare_states(label, "iso_shade", shaded,
                                                want, True)
    return worst


def time_ext(label, prefix, scene, base, event=True, frames=True):
    """The ext instances on ``scene`` timed against the headline's
    instances on ``base`` (the same scene read as one linear channel) at
    512², default Params (K5: extinction 40, steps 8): device medians of
    :func:`device_turns`, the loop ms, the plain version's ms, the bound
    from this run's work (the distinct corner rows, and a two-channel
    scene's 2D TF rows, read once; the operations with :func:`ext_ops`)
    and the registers.  ``event`` times K5, ``frames`` K6 in each mode, K7
    and K8.  Returns each kernel's fields, keyed ``{prefix}_...``."""
    import dataclasses

    import torch

    from vpt_tpu_torch.kernels import iso_shade, march, mcm_event, mcs_frame
    from vpt_tpu_torch.kernels import tf1d
    from vpt_tpu_torch.renderers import iso, mcm, mcs

    fields = {name: {} for name in EXT_NAMES}
    ref = dataclasses.replace(scene, kernels=False)
    dtype, tw = scene.volume_packed.dtype, scene.transfer_1d.shape[0]
    ext = dict(channels=scene.channels, filtered=scene.filter != "linear")
    n = 512 * 512
    if event:
        params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
        seeds = itertools.count()
        turns = {}
        for name, s in (("ext", scene), ("linear", base)):
            state = mcm.reset(params, 512, 512, s)
            turns[name] = (lambda state=state, s=s: mcm_event.event_frame(
                state, s, params, 0.2 + 0.001 * next(seeds)))
        t = device_turns(turns, "mcm_event", rounds=EXT_ROUNDS)
        _, bound, work = print_kernel_device_ms(scene, 8, timed=False,
                                                label=label)
        state = mcm.reset(params, 512, 512, scene)
        ms = cuda_ms(lambda: mcm_event.event_frame(state, scene, params,
                                                   0.5), 10)
        plain = mcm.reset(params, 512, 512, scene)
        plain_ms = cuda_ms(lambda: mcm_event.event_frame_plain(
            plain, ref, params, 0.5), 1)
        occ = mcm_event.occupancy(dtype, tw, scene.majorant is not None,
                                  **ext)
        print(f"{label} K5 steps 8: {fmt_ms(t['ext'])} a frame on the card "
              f"against {fmt_ms(t['linear'])} linear single-channel "
              "(medians in turns)"
              + (f" ({t['ext'] / t['linear']:.4f}x)"
                 if t["ext"] and t["linear"] else "")
              + f"; loop {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{bound:.4f} ms ({work['bound_by']}, {work['bound_bytes']} "
              f"bytes, {work['rows']} distinct rows); {occ['registers']} "
              f"registers, {occ['local_bytes']} local bytes, "
              f"{occ['blocks_per_sm']} blocks an SM", flush=True)
        fields["mcm_event"] = {
            f"{prefix}_device_ms": t["ext"],
            f"{prefix}_linear_device_ms": t["linear"],
            f"{prefix}_ms": ms, f"{prefix}_plain_ms": plain_ms,
            f"{prefix}_bound_ms": bound,
            f"{prefix}_registers": occ["registers"]}
    if not frames:
        return fields
    tf_mode = tf1d.mode_code(scene.tf_mxu)
    for key in ("eam", "mip", "depth", "iso"):
        module = renderer_module(key)
        params = module.Params()
        states = {name: module.reset(params, 512, 512, s)
                  for name, s in (("ext", scene), ("linear", base))}
        t = device_turns({
            name: (lambda st=st, s=s: march.march_frame(key, st, s, params,
                                                        0.5, 2))
            for (name, st), s in zip(states.items(), (scene, base))},
            "march", rounds=EXT_ROUNDS)
        st = states["ext"]
        ms = cuda_ms(lambda: march.march_frame(key, st, scene, params, 0.5,
                                               2), 10)
        plain = module.reset(params, 512, 512, scene)
        plain_ms = cuda_ms(lambda: march.march_frame_plain(
            key, plain, ref, params, 0.5, 2), 1)
        samples, rows, _, _ = march_work(key, scene, params, 0.5, 512, 512)
        bound, by, nbytes = frame_bound(
            scene, scene.volume_packed, n, 4 if key == "mip" else 16,
            samples * (MARCH_OPS_SAMPLE + ext_ops(scene))
            + n * MARCH_OPS_PIXEL, rows)
        occ = march.occupancy(key, dtype, tw, tf_mode, **ext)
        print(f"{label} K6 {key}: {fmt_ms(t['ext'])} a frame on the card "
              f"against {fmt_ms(t['linear'])} linear single-channel"
              + (f" ({t['ext'] / t['linear']:.4f}x)"
                 if t["ext"] and t["linear"] else "")
              + f"; loop {ms:.4f} ms; plain {plain_ms:.4f} ms; {samples} "
              f"samples, {rows} distinct rows; bound {bound:.4f} ms ({by}, "
              f"{nbytes} bytes); {occ['registers']} registers, "
              f"{occ['local_bytes']} local bytes, {occ['blocks_per_sm']} "
              f"blocks an SM, {occ['chunk']} rows read ahead", flush=True)
        fields["march_frame"].update({
            f"{prefix}_{key}_device_ms": t["ext"],
            f"{prefix}_{key}_linear_device_ms": t["linear"],
            f"{prefix}_{key}_ms": ms, f"{prefix}_{key}_plain_ms": plain_ms,
            f"{prefix}_{key}_bound_ms": bound,
            f"{prefix}_{key}_registers": occ["registers"]})
        if key == "iso":
            hits = states
    params = iso.Params()
    t = device_turns({name: (lambda st=st, s=s: iso.display(st, s, params))
                      for (name, st), s in zip(hits.items(),
                                               (scene, base))}, "iso_shade",
                     rounds=EXT_ROUNDS)
    ms = cuda_ms(lambda: iso.display(hits["ext"], scene, params), 10)
    plain_ms = cuda_ms(lambda: iso_shade.iso_shade_plain(hits["ext"], scene,
                                                         params), 1)
    count, rows = shade_work(scene, hits["ext"], float(params.gradient_step))
    bound, by, nbytes = frame_bound(
        scene, scene.volume_packed, n, 16,
        count * (7 * (SHADE_OPS_TAP + ext_ops(scene)) + SHADE_OPS_PIXEL),
        rows)
    occ = iso_shade.occupancy(dtype, tf_mode, **ext)
    print(f"{label} K7: {fmt_ms(t['ext'])} a display on the card against "
          f"{fmt_ms(t['linear'])} linear single-channel"
          + (f" ({t['ext'] / t['linear']:.4f}x)" if t["ext"] and t["linear"]
             else "")
          + f"; loop {ms:.4f} ms; plain {plain_ms:.4f} ms; {count} hits, "
          f"{rows} distinct rows; bound {bound:.4f} ms ({by}); "
          f"{occ['registers']} registers, {occ['blocks_per_sm']} blocks an "
          "SM", flush=True)
    fields["iso_shade"] = {
        f"{prefix}_device_ms": t["ext"],
        f"{prefix}_linear_device_ms": t["linear"], f"{prefix}_ms": ms,
        f"{prefix}_plain_ms": plain_ms, f"{prefix}_bound_ms": bound,
        f"{prefix}_registers": occ["registers"]}
    params = mcs.Params()
    states = {name: mcs.reset(params, 512, 512, s)
              for name, s in (("ext", scene), ("linear", base))}
    t = device_turns({name: (lambda st=st, s=s: mcs_frame.mcs_frame(
        st, s, params, 0.4, 2)) for (name, st), s in zip(states.items(),
                                                          (scene, base))},
        "mcs_frame", rounds=EXT_ROUNDS)
    ms = cuda_ms(lambda: mcs_frame.mcs_frame(states["ext"], scene, params,
                                             0.4, 2), 10)
    plain = mcs.reset(params, 512, 512, scene)
    plain_ms = cuda_ms(lambda: mcs_frame.mcs_frame_plain(plain, ref, params,
                                                         0.4, 2), 1)
    bound, by = mcs_bound(scene)
    occ = mcs_frame.occupancy(dtype, tw, **ext)
    print(f"{label} K8: {fmt_ms(t['ext'])} a frame on the card against "
          f"{fmt_ms(t['linear'])} linear single-channel"
          + (f" ({t['ext'] / t['linear']:.4f}x)" if t["ext"] and t["linear"]
             else "")
          + f"; loop {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({by}); {occ['registers']} registers, "
          f"{occ['blocks_per_sm']} blocks an SM", flush=True)
    fields["mcs_frame"] = {
        f"{prefix}_device_ms": t["ext"],
        f"{prefix}_linear_device_ms": t["linear"], f"{prefix}_ms": ms,
        f"{prefix}_plain_ms": plain_ms, f"{prefix}_bound_ms": bound,
        f"{prefix}_registers": occ["registers"]}
    fields["dos_sweep"] = time_dos(label, prefix, scene, base)
    fields["lao_march"] = time_lao(label, prefix, scene, base)
    torch.cuda.synchronize()
    return fields


def lao_ops(scene, params, samples, fetches, hits):
    """K10's float32 operations on ``scene``: the headline's count
    (LAO_OPS_*) plus what an ext fetch adds: a cubic scene's warps (9 axis
    coordinates a slice for the seven gradient cells, 3 a fetch for the
    others; :data:`EXT_OPS_CUBIC` is three of them), a baked slice's
    second channel."""
    from vpt_tpu_torch.renderers import lao

    taps = len(lao.lao_taps(params))
    ops = fetches * LAO_OPS_FETCH + samples * (taps * LAO_OPS_TAP
                                               + LAO_OPS_SLICE) \
        + hits * LAO_OPS_PIXEL
    if scene.filter == "cubic":
        gradient = 0 if params.baked_gradient else 6
        ops += (fetches - samples * gradient) * EXT_OPS_CUBIC \
            + samples * 2 * EXT_OPS_CUBIC * gradient // 6
    if params.baked_gradient:
        ops += samples * EXT_OPS_CHANNEL
    return ops


def time_dos(label, prefix, scene, base):
    """K9 on ``scene`` (one DOS frame of 50 slices from ``dos.reset``)
    timed against the same frame on ``base`` at 512², default Params
    (device medians of :func:`device_turns`), with the loop ms, the plain
    version's ms, the bound from this run's work (:func:`dos_work`) and
    the registers and residency.  Returns K9's fields, keyed
    ``{prefix}_...``."""
    import dataclasses

    from vpt_tpu_torch.kernels import dos_sweep, tf1d
    from vpt_tpu_torch.renderers import dos

    ref = dataclasses.replace(scene, kernels=False)
    ext = dict(channels=scene.channels, filtered=scene.filter != "linear")
    dparams = dos.Params()

    def dos_frame(s):
        return lambda: dos.render_frame(dos.reset(dparams, 512, 512, s), s,
                                        dparams, 0.1, 1)

    t = device_turns({"ext": dos_frame(scene), "linear": dos_frame(base)},
                     "dos_sweep", rounds=EXT_ROUNDS)
    ms = cuda_ms(dos_frame(scene), 10)
    plain_ms = cuda_ms(lambda: dos_sweep.sweep_frame_plain(
        dos.reset(dparams, 512, 512, scene), ref, dparams), 1)
    nbytes, ops, written, active = dos_work(scene, dparams, 512, 512, 1)
    bound, by = roofline(nbytes, ops)
    occ = dos_sweep.occupancy(scene.volume_packed.dtype,
                              tf1d.mode_code(scene.tf_mxu), dparams.samples,
                              dparams.steps, **ext)
    print(f"{label} K9 first frame ({active} active slices, {written} "
          f"written pixels): {fmt_ms(t['ext'])} on the card against "
          f"{fmt_ms(t['linear'])} linear single-channel"
          + (f" ({t['ext'] / t['linear']:.4f}x)" if t["ext"] and t["linear"]
             else "")
          + f"; loop {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({by}, {nbytes} bytes, {ops} operations); "
          f"{occ['registers']} registers, {occ['local_bytes']} spill bytes,"
          f" {occ['blocks_per_sm']} blocks of 512 an SM "
          f"({occ['blocks_per_sm'] * occ['sms']} cooperative blocks)",
          flush=True)
    return {f"{prefix}_device_ms": t["ext"],
            f"{prefix}_linear_device_ms": t["linear"], f"{prefix}_ms": ms,
            f"{prefix}_plain_ms": plain_ms, f"{prefix}_bound_ms": bound,
            f"{prefix}_registers": occ["registers"],
            f"{prefix}_local_bytes": occ["local_bytes"],
            f"{prefix}_blocks_per_sm": occ["blocks_per_sm"]}


def time_lao(label, prefix, scene, base, baked=False):
    """K10 on ``scene`` (one LAO frame, or with ``baked`` the
    baked-gradient frame) timed against the same frame on ``base`` (with
    ``baked``: the seven-tap frame) at 512², default Params, as
    :func:`time_dos`, the bound from :func:`lao_work`.  Returns K10's
    fields, keyed ``{prefix}_...``."""
    import dataclasses

    from vpt_tpu_torch.kernels import lao_march
    from vpt_tpu_torch.renderers import lao

    ref = dataclasses.replace(scene, kernels=False)
    ext = dict(channels=scene.channels, filtered=scene.filter != "linear")
    params = lao.Params(baked_gradient=baked)
    base_params = lao.Params() if baked else params
    states = {name: lao.reset(params, 512, 512, s)
              for name, s in (("ext", scene), ("linear", base))}
    frames = {"ext": lambda: lao.render_frame(states["ext"], scene, params,
                                              0.5, 1),
              "linear": lambda: lao.render_frame(states["linear"], base,
                                                 base_params, 0.5, 1)}
    t = device_turns(frames, "lao_", rounds=EXT_ROUNDS)
    ms = cuda_ms(frames["ext"], 10)
    plain_ms = cuda_ms(lambda: lao_march.lao_frame_plain(
        states["ext"].clone(), ref, params), 1)
    samples, fetches, rows, hits, _ = lao_work(scene, params, 512, 512)
    nbytes = rows * scene.volume_packed.shape[1] \
        * scene.volume_packed.element_size() + 20 * 512 * 512 \
        + scene.transfer_packed.numel() * scene.transfer_packed.element_size()
    ops = lao_ops(scene, params, samples, fetches, hits)
    bound, by = roofline(nbytes, ops)
    occ = lao_march.occupancy(scene.volume_packed.dtype,
                              scene.transfer_packed.dtype, **ext,
                              baked=baked)
    print(f"{label} K10{' baked' if baked else ''}: {fmt_ms(t['ext'])} a "
          f"frame on the card against {fmt_ms(t['linear'])} "
          + ("seven-tap" if baked else "linear single-channel")
          + (f" ({t['ext'] / t['linear']:.4f}x)" if t["ext"] and t["linear"]
             else "")
          + f"; loop {ms:.4f} ms; plain {plain_ms:.4f} ms; {samples} active "
          f"pixel-slices, {fetches} fetches of {rows} distinct rows; bound "
          f"{bound:.4f} ms ({by}, {nbytes} bytes, {ops} operations); "
          f"{occ['registers']} registers, {occ['local_bytes']} spill bytes,"
          f" {occ['blocks_per_sm']} blocks an SM", flush=True)
    return {f"{prefix}_device_ms": t["ext"],
            f"{prefix}_{'seven_tap' if baked else 'linear'}_device_ms":
                t["linear"], f"{prefix}_ms": ms,
            f"{prefix}_plain_ms": plain_ms, f"{prefix}_bound_ms": bound,
            f"{prefix}_registers": occ["registers"],
            f"{prefix}_local_bytes": occ["local_bytes"]}


def merge_ext(rows, worst, fields, key):
    """Fold a phase's worst errors (under ``{key}_max_abs_err``) and
    fields into each kernel's row of the JSON line."""
    for name in EXT_NAMES:
        row = rows.setdefault(name, {})
        row.update(fields.get(name, {}))
        err = worst.get(name, 0.0)
        row[f"{key}_max_abs_err"] = max(row.get(f"{key}_max_abs_err", 0.0),
                                        err)


def phase_channels_path(dev, counters):
    """``path channels``: a two-channel volume through ``cli render``.

    ``volume.with_gradient_magnitude(blobs_volume(256))`` is written as a
    256³ RG uint8 BVP by the port's ``write_bvp``, and
    ``TransferFunctionBumps.default()`` as the widget JSON that ``--tf``
    takes (rasterized to 256×256); MCM renders it at 512², 32 spp
    (``--precision fast``: bf16 tables and 2D TF), then EAM, MIP, Depth,
    ISO and MCS at 10 spp, each ``cli.main`` with every launch counter at
    0 just before it and read just after.  The ext instances are held to
    their plain versions on the path's bf16 scene and on a float32 twin of
    it with a three-bump 2D TF (:data:`BUMPS`), and timed on the volume
    the path wrote (bf16 tables) with :data:`BUMPS` against the
    single-channel instances on its channel 0 with the same TF.  Returns
    each kernel's row fields, worst errors and the path's launches."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.io import readers
    from vpt_tpu_torch.renderers import make_scene, mcm

    t0 = time.perf_counter()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke")
    os.makedirs(out, exist_ok=True)
    bvp = os.path.join(out, "rg256.bvp")
    vol = volume.with_gradient_magnitude(volume.blobs_volume(256))
    readers.write_bvp(bvp, vol)
    tf_json = os.path.join(out, "tf_default.json")
    with open(tf_json, "w") as f:
        f.write(transfer.TransferFunctionBumps.default().to_json())
    print(f"path channels: wrote {bvp}, {os.path.getsize(bvp)} bytes, and "
          f"the default bump as {tf_json}, in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches, scene = {}, None
    for key, spp in (("mcm", 32), ("eam", 10), ("mip", 10), ("depth", 10),
                     ("iso", 10), ("mcs", 10), ("dos", 10), ("lao", 10)):
        png = os.path.join(out, f"rg_{key}.png")
        argv = ["render", "--volume", bvp, "--tf", tf_json, "--renderer",
                key, "--resolution", "512", "--spp", str(spp),
                "--precision", "fast", "--tonemap", "reinhard", "-o", png]
        lines, got, scenes = run_cli(argv, counters)
        sec = cli_seconds(lines)
        s = scenes[0]
        check(len(scenes) == 1 and s.channels == 2
              and tuple(s.volume_packed.shape) == (256 ** 3, 16)
              and s.volume_packed.dtype == torch.bfloat16
              and s.transfer_packed.dtype == torch.bfloat16
              and tuple(s.transfer.shape) == (256, 256, 4)
              and s.tf_mxu is None and s.tracking_packed is None,
              f"path channels {key}: not one bf16 two-channel scene with "
              "a 256x256 TF")
        kernel = "mcm_event" if key == "mcm" else PATH_KERNEL[key]
        expected = {kernel: spp, "tonemap": 1}
        if key == "iso":
            expected["iso_shade"] = 1
        check_cli_launches(f"path channels {key}", got, expected)
        pixels = png_pixels(png)
        check(pixels.shape == (512, 512, 3),
              f"path channels {key}: PNG {pixels.shape}")
        launches[key] = got
        print(f"path channels {key} 256^3 RG BVP 512^2 {spp} spp: load "
              f"{sec['load']:.4f} s, scene build {sec['scene']:.4f} s, "
              f"{sec['frame_ms']:.4f} ms a frame (host clock), display "
              f"{sec['display']:.4f} s, PNG {sec['png']:.4f} s, mean pixel "
              f"{float(pixels.mean()):.4f}; launches: "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v),
              flush=True)
        scene = s
    params8 = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    # the default bump lies at gradient magnitude 0.5, which few voxels
    # reach: the path's ISO frames may hit nothing, the twin's must hit
    worst = hold_ext("path channels bf16", scene, params8, hits=False)
    bumps = transfer.rasterize(transfer.TransferFunctionBumps.from_list(
        BUMPS))
    twin = make_scene(volume.Volume(scene.volume), bumps)
    check(twin.volume_packed.dtype == torch.float32 and twin.channels == 2,
          "path channels: the twin is not a float32 two-channel scene")
    for name, err in hold_ext("path channels f32 twin", twin,
                              params8).items():
        worst[name] = max(worst[name], err)
    del twin, scene
    torch.cuda.empty_cache()
    # timed on the path's volume and tables with the bumps' TF, where ISO
    # hits, against its channel 0 with the same TF
    timed = make_scene(volume.Volume(vol.data), bumps,
                       pack_dtype=torch.bfloat16)
    base = make_scene(volume.Volume(vol.data[..., :1]), bumps,
                      pack_dtype=torch.bfloat16)
    fields = time_ext("path channels bumps", "channels", timed, base)
    del base, timed
    torch.cuda.empty_cache()
    return fields, worst, launches


def phase_filters_path(dev, counters):
    """``path filters``: the render headline's ``sphere_volume(128)``
    (sRGB gray ramp, alpha 0.8) through ``RenderingContext`` at 512²,
    ``precision="fast"``, with ``set_filter("nearest")`` and then
    ``"cubic"``: MCM steps 8 × 30 frames (``tracking="auto"``, which a
    filtered volume takes as the global majorant) and with
    ``tracking="grid"``, then EAM, MIP, Depth, ISO and MCS, 10 frames
    each, a ``reinhard`` display each, every launch counter at 0 just
    before each and read just after.  The ext instances are held to their
    plain versions on each filter's float32 twin and on the context's
    scene (float32 tables, bf16 TF weights), and timed on the context's
    scene against the linear instances on the same tables.  Returns each
    kernel's row fields, worst errors and the path's launches."""
    import dataclasses

    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene, mcm
    from vpt_tpu_torch.runtime import RenderingContext

    params8 = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    fields = {name: {} for name in EXT_NAMES}
    worst = dict.fromkeys(EXT_NAMES, 0.0)
    launches = {}
    for filt in ("nearest", "cubic"):
        for tracking in ("auto", "grid"):
            ctx = RenderingContext(resolution=512, precision="fast",
                                   tracking=tracking, tf_srgb=True,
                                   device=dev)
            ctx.set_volume(volume.sphere_volume(128))
            ctx.set_transfer_function(transfer.gray_ramp(alpha_scale=0.8))
            ctx.choose_tone_mapper("reinhard")
            ctx.set_filter(filt)
            keys = ("mcm",) if tracking == "grid" else \
                ("mcm", "eam", "mip", "depth", "iso", "mcs", "dos", "lao")
            for key in keys:
                frames = 30 if key == "mcm" else 10
                ctx.choose_renderer(key, params=params8 if key == "mcm"
                                    else None)
                for module in counters.values():
                    module.LAUNCHES = 0
                t0 = time.perf_counter()
                ctx.render(frames)
                image = ctx.get_display_image()
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                kernel = "mcm_event" if key == "mcm" else PATH_KERNEL[key]
                expected = {kernel: frames, "tonemap": 1}
                if key == "iso":
                    expected["iso_shade"] = 1
                name = f"path filters {filt} {key}" \
                    + (" grid" if tracking == "grid" else "")
                got = _path_launches(counters, name, expected)
                _check_display(name, ctx.get_hdr_image(), image)
                launches[name] = got
                print(f"{name} 512^2: {frames} frames and the display in "
                      f"{dt:.3f} ms (host clock); launches: "
                      + ", ".join(f"{k} {v}" for k, v in got.items() if v),
                      flush=True)
            scene = ctx.get_scene()
            check(scene.filter == filt
                  and scene.volume_packed.dtype == torch.float32
                  and scene.tf_mxu == torch.bfloat16
                  and scene.tracking_packed is None
                  and (scene.majorant is not None) == (tracking == "grid"),
                  f"path filters {filt} {tracking}: not a float32 filtered "
                  "scene with bf16 TF weights")
            label = f"path filters {filt}" + (" grid" if tracking == "grid"
                                              else "")
            twin = make_scene(volume.Volume(volume.sphere_volume(128).data,
                                            filt),
                              transfer.gray_ramp(alpha_scale=0.8),
                              tf_srgb=True, tracking=tracking)
            grid = tracking == "grid"
            # K5 on the context's scene (bf16 TF weights) and the twin;
            # the frame kernels on the twin
            err = {"mcm_event": _frames_agree(
                scene, params8, 512, 512, 3,
                f"{label} headline 512^2 3 frames")[1]}
            if grid:
                err["mcm_event"] = max(err["mcm_event"], _frames_agree(
                    twin, params8, 512, 512, 3,
                    f"{label} f32 twin 512^2 3 frames")[1])
            else:
                twin_err = hold_ext(f"{label} f32 twin", twin, params8)
                err = {k: max(v, err.get(k, 0.0))
                       for k, v in twin_err.items()}
            for name, e in err.items():
                worst[name] = max(worst[name], e)
            prefix = f"{filt}_grid" if grid else filt
            got = time_ext(label, prefix, scene,
                           dataclasses.replace(scene, filter="linear"),
                           frames=not grid)
            for name in EXT_NAMES:
                fields[name].update(got[name])
            del ctx, scene, twin
            torch.cuda.empty_cache()
    return fields, worst, launches


def phase_baked_path(dev, counters):
    """``path baked``: LAO's baked gradient on
    ``volume.with_lao_gradient(blobs_volume(256))`` (the bake's seconds on
    the card) with the three-bump 2D TF (:data:`BUMPS`, so that |∇|
    selects colours) through ``RenderingContext`` at 512²,
    ``precision="fast"`` (bf16 tables), ``lao.Params(baked_gradient=True)``,
    2 frames and a ``reinhard`` display, every launch counter at 0 just
    before and read just after.  K10's baked instance is held to its plain
    frame on the context's scene and on a float32 twin (99.99% of the
    values within 1e-6), the baked image to the exact seven-tap one within
    ``tests/test_lao_baked.py``'s bounds (max |Δ| 0.03, mean 0.004), and
    its device time taken in turns against the seven-tap instance on the
    same scene.  Returns K10's row fields, worst error and the path's
    launches."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import lao, make_scene
    from vpt_tpu_torch.runtime import RenderingContext

    vol = volume.blobs_volume(256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baked = volume.with_lao_gradient(vol)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    check(tuple(baked.data.shape) == (256, 256, 256, 2)
          and bool(torch.isfinite(baked.data).all())
          and float(baked.data[..., 1].max()) > 0.0,
          "path baked: the baked volume is not finite (256^3, 2)")
    print(f"path baked: with_lao_gradient(blobs_volume(256)) in "
          f"{bake_s:.4f} s on the card, |grad| up to "
          f"{float(baked.data[..., 1].max()):.6f}", flush=True)
    bumps = transfer.rasterize(transfer.TransferFunctionBumps.from_list(
        BUMPS))
    params = lao.Params(baked_gradient=True)
    ctx = RenderingContext(resolution=512, precision="fast", device=dev)
    ctx.set_volume(baked)
    ctx.set_transfer_function(bumps)
    ctx.choose_tone_mapper("reinhard")
    ctx.choose_renderer("lao", params=params)
    for module in counters.values():
        module.LAUNCHES = 0
    t0 = time.perf_counter()
    ctx.render(2)
    image = ctx.get_display_image()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    launches = _path_launches(counters, "path baked lao",
                              {"lao_march": 2, "tonemap": 1})
    hdr = ctx.get_hdr_image()
    _check_display("path baked lao", hdr, image)
    scene = ctx.get_scene()
    check(scene.channels == 2 and scene.volume_packed.dtype == torch.bfloat16
          and scene.transfer_packed.dtype == torch.bfloat16,
          "path baked: not a bf16 two-channel scene")
    print(f"path baked lao 256^3 512^2: 2 frames and the display in "
          f"{dt:.3f} ms (host clock); launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v),
          flush=True)
    twin = make_scene(volume.Volume(baked.data), bumps)
    check(twin.volume_packed.dtype == torch.float32,
          "path baked: the twin is not a float32 scene")
    worst = 0.0
    for label, s in (("path baked bf16", scene), ("path baked f32 twin",
                                                   twin)):
        worst = max(worst, dos_lao_agree(label, s, baked=True)["lao_march"])
    # the baked image against the exact seven-tap one, both on the card
    exact = lao.reset(lao.Params(), 512, 512, scene)
    lao.render_frame(exact, scene, lao.Params(), 0.5, 1)
    diff = (hdr - exact).abs()
    err_max, err_mean = float(diff.max()), float(diff.mean())
    check(err_max < 0.03 and err_mean < 0.004,
          f"path baked: the baked image is {err_max} (max) / {err_mean} "
          "(mean) from the seven-tap one (bounds 0.03 / 0.004)")
    print(f"path baked: baked image against the seven-tap image: max |d| "
          f"{err_max}, mean {err_mean} (bounds 0.03, 0.004)", flush=True)
    del twin, exact
    fields = time_lao("path baked", "baked", scene, scene, baked=True)
    fields.update({"baked_bake_s": bake_s, "baked_vs_seven_tap_max":
                   err_max, "baked_vs_seven_tap_mean": err_mean})
    del ctx, scene, baked, vol
    torch.cuda.empty_cache()
    return fields, worst, launches


#: ``path fit mcs``: BASELINE.json's MCS configuration (a 256³ volume,
#: differentiable TF parameters) at a 256² target; frames cut from
#: fit_mc's default 64 to 16 for this script's time limit (at 64 an Adam
#: step took 28.3 s on an H100 80GB HBM3 at 700 W, with a peak memory of
#: 6.7 GiB, under half the card's, so memory forces no cut)
FIT_MCS_VOLUME, FIT_MCS_RES, FIT_MCS_FRAMES = 256, 256, 16


def phase_fit_mcs_path(dev, counters):
    """``path fit mcs``: ``train.fit_mc(renderer="mcs")``, every launch
    counter at 0 first.  At 64² (blobs 32³), the value and the volume
    gradient of ``mcs_expected_image`` with the kernels against
    ``kernels=False`` (loss equal, gradient within 1e-4 relative L2: K3
    forward, K4 backward).  Then BASELINE's size: ``blobs_volume(256)``
    with ``gray_ramp(alpha_scale=0.8)`` as truth, a 256² target rendered
    by the port under ``no_grad``, and a TF fit from a flat 0.2 init, 3
    Adam steps at lr 0.02, the frames cut as :data:`FIT_MCS_FRAMES` says;
    the peak memory must stay under half of the card's.  Prints the
    seconds an Adam step, the peak memory and the K3/K4 launches a
    step, then :func:`fit_mcs_profile` and :func:`fit_mcs_exit`.  Returns
    the path's launches and K3's and K4's fields."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch import train, transfer, volume
    from vpt_tpu_torch.renderers import diff_mc, make_scene, mcs

    for module in counters.values():
        module.LAUNCHES = 0
    params = mcs.Params(extinction=train.MC_FIT_EXTINCTION["mcs"])
    small = make_scene(volume.blobs_volume(32, seed=1),
                       transfer.gray_ramp(alpha_scale=0.8), device=dev)
    target = torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(
        4)).to(dev)
    out = []
    for kernels in (True, False):
        vol = torch.full((32, 32, 32, 1), 0.2, device=dev,
                         requires_grad=True)
        loss = train.mc_loss({"volume": vol},
                             dataclasses.replace(small, kernels=kernels),
                             target, params, 2, np.float32(0.1))
        loss.backward()
        out.append((loss.item(), vol.grad))
    torch.cuda.synchronize()
    (loss, grad), (plain_loss, plain_grad) = out
    check(bool(torch.isfinite(grad).all())
          and float(grad.abs().max()) > 0.0,
          "fit mcs: the volume gradient is not finite or all zero")
    rel = float((grad - plain_grad).norm() / plain_grad.norm())
    check(loss == plain_loss, f"fit mcs loss {loss} != plain {plain_loss}")
    check(rel <= 1e-4, f"fit mcs gradient: relative L2 error {rel}")
    print(f"fit mcs value-and-grad 64^2 blobs32 2 frames: loss {loss!r} "
          "equal to the plain version's; volume gradient relative L2 error "
          f"{rel:.3g} (bound 1e-4)", flush=True)
    held = {name: m.LAUNCHES for name, m in counters.items()}

    n, res, frames = FIT_MCS_VOLUME, FIT_MCS_RES, FIT_MCS_FRAMES
    truth = make_scene(volume.blobs_volume(n),
                       transfer.gray_ramp(alpha_scale=0.8))
    init = torch.full(tuple(truth.transfer.shape), 0.2, device=dev)
    half = torch.cuda.get_device_properties(0).total_memory / 2 ** 31
    t0 = time.perf_counter()
    with torch.no_grad():
        target = diff_mc.mcs_expected_image(truth, params, res, res, frames)
    torch.cuda.synchronize()
    check(tuple(target.shape) == (res, res, 4)
          and bool(torch.isfinite(target).all()), "fit mcs: target not finite")
    print(f"fit mcs target: {n}^3 blobs truth, {res}^2, {frames} frames "
          f"under no_grad in {time.perf_counter() - t0:.3f} s, mean "
          f"{float(target.mean()):.6f}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = {name: m.LAUNCHES for name, m in counters.items()}
    steps = 3
    t0 = time.perf_counter()
    _, fitted, losses = train.fit_mc(target, truth, init_tf=init,
                                     renderer="mcs", frames=frames,
                                     steps=steps, learning_rate=0.02)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {name: (m.LAUNCHES - before[name]) / steps
                for name, m in counters.items()}
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"fit mcs losses {losses}")
    check(bool(torch.isfinite(fitted).all()) and float(fitted.min()) >= 0.0
          and float(fitted.max()) <= 1.0, "fit mcs: TF outside [0, 1]")
    check(not torch.equal(fitted, init), "fit mcs did not move the TF")
    check(peak < half, f"fit mcs: peak memory {peak:.3f} GiB is not under "
          f"half the card's ({half:.3f} GiB)")
    print(f"fit_mc mcs {n}^3 / {res}^2, {frames} frames, {steps} Adam steps "
          f"at lr 0.02 from a flat TF: losses {losses}; {step_s:.4f} s per "
          f"step (host clock), peak memory {peak:.3f} GiB; launches a step: "
          f"corner_gather {per_step['corner_gather']:.1f}, corner_scatter "
          f"{per_step['corner_scatter']:.1f}, tf1d_lookup "
          f"{per_step['tf1d_lookup']:.1f}", flush=True)
    launches = {name: m.LAUNCHES for name, m in counters.items()}
    busy = fit_mcs_profile(truth, init, target, params)
    exit_s, full_s, exit_err = fit_mcs_exit(truth, init, target, params)
    rows = {name: {"launches_fit_mcs": launches[name],
                   "launches_fit_mcs_step": per_step[name],
                   "launches_fit_mcs_grad_check": held[name]}
            for name in ("corner_gather", "corner_scatter")}
    rows["corner_gather"].update({
        "fit_mcs_frames": frames, "fit_mcs_step_s": step_s,
        "fit_mcs_peak_gib": peak, "fit_mcs_losses": losses,
        "fit_mcs_grad_rel_l2": rel, "fit_mcs_device_busy": busy,
        "fit_mcs_exit_early_s": exit_s, "fit_mcs_full_budget_s": full_s,
        "fit_mcs_full_budget_grad_rel_l2": exit_err})
    del truth, target, fitted
    torch.cuda.empty_cache()
    return launches, rows


def fit_mcs_profile(truth, init, target, params, frames=2):
    """Where an MCS TF fit's value-and-grad spends its time: one at
    ``frames`` frames under :func:`profile_busy`.  Returns the card's busy
    share of the wall time."""
    import numpy as np

    from vpt_tpu_torch import train

    def step():
        leaf = init.clone().requires_grad_(True)
        train.mc_loss({"tf": leaf}, truth, target, params, frames,
                      np.float32(0.1)).backward()

    return profile_busy(f"fit mcs profile, one value-and-grad of {frames} "
                        "frames", step)


def profile_busy(label, step):
    """One call of ``step`` (after a warm-up call) under torch.profiler:
    its wall time, the card's busy time (the kernels' device time summed)
    and the five operators with the most device time and with the most
    host time.  Returns the card's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        step()
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    top_device = sorted((e for e in events
                         if e.device_type == DeviceType.CPU),
                        key=lambda e: -e.device_time_total)[:5]
    top_host = sorted((e for e in events
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:5]
    print(f"{label}: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of kernels on "
          f"the card ({busy_ms / wall_ms:.4f} busy); most device time: "
          + ", ".join(f"{e.key} {e.device_time_total / 1e3:.3f} ms "
                      f"({e.count} calls)" for e in top_device)
          + "; most host time: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms "
                      f"({e.count} calls)" for e in top_host), flush=True)
    return busy_ms / wall_ms


def fit_mcs_exit(truth, init, target, params, frames=2):
    """One value-and-grad of an MCS TF fit at ``frames`` frames with the
    tracking scans left once every pixel is done, as ``diff_mc`` runs
    them, then with the full ``track_steps`` budget, as JAX runs them
    (``diff_mc._EXIT_EARLY`` off): the losses must be equal and the TF
    gradients within 1e-4 relative L2.  Returns the two wall times in
    seconds (host clock) and the gradients' relative L2 difference."""
    import numpy as np
    import torch

    from vpt_tpu_torch import train
    from vpt_tpu_torch.renderers import diff_mc

    out = []
    try:
        for exit_early in (True, False):
            diff_mc._EXIT_EARLY = exit_early
            leaf = init.clone().requires_grad_(True)
            t0 = time.perf_counter()
            loss = train.mc_loss({"tf": leaf}, truth, target, params, frames,
                                 np.float32(0.1))
            loss.backward()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0, loss.item(), leaf.grad))
    finally:
        diff_mc._EXIT_EARLY = True
    (exit_s, exit_loss, exit_grad), (full_s, full_loss, full_grad) = out
    rel = float((exit_grad - full_grad).norm() / full_grad.norm())
    check(exit_loss == full_loss, f"fit mcs: the early exit's loss "
          f"{exit_loss} != the full budget's {full_loss}")
    check(rel <= 1e-4, f"fit mcs: the early exit's TF gradient is {rel} "
          "relative L2 from the full budget's")
    print(f"fit mcs early exit, one value-and-grad of {frames} frames: "
          f"{exit_s:.4f} s with the exit, {full_s:.4f} s with the full "
          f"budget (host clock, {full_s / exit_s:.2f}x); loss equal, TF "
          f"gradient relative L2 difference {rel:.3g}, "
          f"{'equal' if torch.equal(exit_grad, full_grad) else 'not equal'}"
          " bit for bit", flush=True)
    return exit_s, full_s, rel


# -- the inverse-rendering entry point: cli fit (eam, iso-depth, --inpaint) --

#: ``path fit eam``: BASELINE config 1's EAM fit (a 64³ volume, 256²
#: images); Adam steps cut from cli fit's default 200 to 5
FIT_EAM_VOLUME, FIT_EAM_RES, FIT_EAM_STEPS = 64, 256, 5
#: ``path fit iso``: BASELINE config 2's ISO depth fit (128³, a 256² depth
#: map); Adam steps cut from 200 to 5
FIT_ISO_VOLUME, FIT_ISO_RES, FIT_ISO_STEPS = 128, 256, 5
#: ``--inpaint``: config 3's MCM fit and completion (256³, 256²); Adam
#: steps cut from 200 to 3, MC frames from cli fit's default 32 to 16
INPAINT_VOLUME, INPAINT_RES, INPAINT_STEPS, INPAINT_FRAMES = 256, 256, 3, 16


class StepWatch:
    """Wrap ``module.<name>`` (a fit's loss, called once an Adam step) for
    a ``with`` block: at each call, after a synchronize, record the host
    clock and every launch counter.  The intervals between calls are whole
    steps (the loss, its backward and the Adam update)."""

    def __init__(self, module, name, counters):
        self.module, self.name, self.counters = module, name, counters
        self.marks = []

    def __enter__(self):
        import torch

        self.orig = getattr(self.module, self.name)

        def watched(*args, **kwargs):
            torch.cuda.synchronize()
            self.marks.append((time.perf_counter(),
                               {k: m.LAUNCHES
                                for k, m in self.counters.items()}))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, watched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def per_step(self):
        """(seconds a step, {kernel: launches a step}) over the intervals
        between the recorded calls."""
        check(len(self.marks) >= 2, f"{self.name} ran fewer than 2 steps")
        (t0, c0), (t1, c1) = self.marks[0], self.marks[-1]
        n = len(self.marks) - 1
        return (t1 - t0) / n, {k: (c1[k] - c0[k]) / n for k in c0}


def fit_grad_check(label, loss_fn, leaves, counters):
    """One value-and-grad of ``loss_fn(leaves, kernels)`` with the kernels
    and with ``kernels=False`` on the card: the loss within 1e-6 relative,
    each leaf's gradient finite, not all zero and within 1e-4 relative L2;
    K3 and K4 launched, K1 (no gradient) not.  Returns the largest
    gradient error and the kernels' launches."""
    import torch

    out = []
    for kernels in (True, False):
        grads = {k: v.detach().clone().requires_grad_(True)
                 for k, v in leaves.items()}
        before = {k: m.LAUNCHES for k, m in counters.items()}
        loss = loss_fn(grads, kernels)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: m.LAUNCHES - before[k] for k, m in counters.items()}
        out.append((loss.item(), {k: g.grad for k, g in grads.items()},
                    launched))
    (loss, grads, launched), (plain_loss, plain_grads, plain_launched) = out
    check(abs(loss - plain_loss) <= 1e-6 * abs(plain_loss),
          f"{label}: loss {loss} against {plain_loss} with kernels=False")
    check(launched["corner_gather"] > 0 and launched["corner_scatter"] > 0,
          f"{label}: K3/K4 not launched: {launched}")
    check(launched["tf1d_lookup"] == 0,
          f"{label}: the TF-lookup kernel (no gradient) was launched")
    check(not any(plain_launched.values()),
          f"{label}: kernels=False launched {plain_launched}")
    errs = {}
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"{label}: the {k} gradient is not finite or all zero")
        want = plain_grads[k]
        errs[k] = float((g - want).norm() / want.norm())
        check(errs[k] <= 1e-4, f"{label}: {k} gradient relative L2 error "
              f"{errs[k]}")
    print(f"{label}: loss {loss!r}, kernels=False {plain_loss!r} (relative "
          f"{abs(loss - plain_loss) / abs(plain_loss):.3g}, bound 1e-6); "
          "gradients relative L2 "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + " (bound 1e-4); launches corner_gather "
          f"{launched['corner_gather']}, corner_scatter "
          f"{launched['corner_scatter']}, tf1d_lookup 0", flush=True)
    return max(errs.values()), launched


def _fit_out():
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke", "fit")
    os.makedirs(out, exist_ok=True)
    return out


def _fitted(path, shape, label):
    import numpy as np

    vol = np.load(path)
    check(vol.shape == shape and bool(np.isfinite(vol).all())
          and float(vol.min()) >= 0.0 and float(vol.max()) <= 1.0,
          f"{label}: {path} is not a finite {shape} volume in [0, 1]")
    return vol


def phase_fit_eam_path(dev, counters):
    """``path fit eam`` (BASELINE config 1), every launch counter at 0
    first: ``blobs_volume(64)`` with ``gray_ramp(alpha_scale=1.0)`` as
    truth, 256² targets from 4 orbit views (yaw 0/90/180/270, cli fit's
    camera) rendered by ``train.render_eam`` under ``no_grad`` (64
    slices) and written as PNGs; one value-and-grad of the 4-view loss
    from cli fit's flat 0.1 init with the kernels against
    ``kernels=False``; then ``cli fit --grid 64 --eam-slices 64 --steps 5
    --inpaint-blind`` on the PNGs in-process (3 fit views, the last held
    out): seconds an Adam step, peak memory, K3/K4 launches a step and the
    blind tau table.  Returns the path's launches and K3's and K4's
    fields."""
    import math

    import numpy as np
    import torch

    from vpt_tpu_torch import train, transfer, volume
    from vpt_tpu_torch.io.image import write_png
    from vpt_tpu_torch.renderers import eam
    from vpt_tpu_torch.runtime.animators import OrbitCameraAnimator
    from vpt_tpu_torch.scene import CameraState, default_camera

    for module in counters.values():
        module.LAUNCHES = 0
    n, res, steps = FIT_EAM_VOLUME, FIT_EAM_RES, FIT_EAM_STEPS
    out = _fit_out()
    truth = volume.blobs_volume(n).data
    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(slices=64, random=False)
    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    views, targets, pngs = [], [], []
    t0 = time.perf_counter()
    for i, yaw in enumerate((0.0, 90.0, 180.0, 270.0)):
        orbit.yaw = math.radians(yaw)
        orbit.pitch = 0.0
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        views.append((cs.mvp_inverse, cs.model_view, cs.projection))
        with torch.no_grad():
            targets.append(train.render_eam(truth, tf, views[-1], params,
                                            np.float32(0.0), res, res))
        pngs.append(os.path.join(out, f"eam_view{i}.png"))
        write_png(pngs[-1], targets[-1])
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) and float(t[..., :3].max()) > 0
              for t in targets), "fit eam: a target is not finite or black")
    print(f"fit eam targets: {n}^3 blobs, 4 views {res}^2, 64 slices, under "
          f"no_grad in {time.perf_counter() - t0:.3f} s", flush=True)

    init = torch.full((n, n, n, 1), 0.1, device=dev)
    err, _ = fit_grad_check(
        f"fit eam value-and-grad 4 views {res}^2 {n}^3",
        lambda leaves, kernels: train.multiview_loss(
            leaves["volume"], tf, views, targets, params, np.float32(0.0),
            kernels=kernels),
        {"volume": init}, counters)

    def value_and_grad():
        leaf = init.clone().requires_grad_(True)
        train.multiview_loss(leaf, tf, views[:3], targets[:3], params,
                             np.float32(0.0)).backward()

    busy = profile_busy(f"fit eam profile, one value-and-grad of 3 views "
                        f"{res}^2 {n}^3", value_and_grad)
    held = {name: m.LAUNCHES for name, m in counters.items()}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["fit", "--target", *pngs, "--grid", str(n), "--eam-slices", "64",
            "--steps", str(steps), "--inpaint-blind", "-o",
            os.path.join(out, "eam")]
    t0 = time.perf_counter()
    with StepWatch(train, "multiview_loss", counters) as watch:
        lines, launches, _ = run_cli(argv, counters)
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s, per_step = watch.per_step()
    check(per_step["tf1d_lookup"] == 0 and per_step["corner_gather"] > 0
          and per_step["corner_scatter"] > 0,
          f"fit eam: launches a step {per_step}")
    _fitted(os.path.join(out, "eam.npy"), (n, n, n, 1), "fit eam")
    check(os.path.getsize(os.path.join(out, "eam.png")) > 0,
          "fit eam: no PNG")
    table = next((ln for ln in lines if ln.startswith("blind tau")), None)
    chosen = next((ln for ln in lines if ln.startswith("chosen tau")), None)
    final = next((ln for ln in lines if ln.startswith("final loss")), None)
    check(table is not None and chosen is not None and final is not None,
          f"fit eam: cli fit printed {lines}")
    print(f"path fit eam: cli fit {n}^3, 3 fit views + 1 held out at "
          f"{res}^2, 64 slices, {steps} Adam steps, --inpaint-blind: "
          f"{call_s:.3f} s the call, {step_s:.4f} s an Adam step (host "
          f"clock), peak memory {peak:.3f} GiB; launches a step: "
          f"corner_gather {per_step['corner_gather']:.1f}, corner_scatter "
          f"{per_step['corner_scatter']:.1f}, tf1d_lookup 0; {final}; "
          f"{table}; {chosen}", flush=True)
    launches = {k: launches[k] + held[k] for k in launches}
    rows = {name: {"launches_fit_eam": launches[name],
                   "launches_fit_eam_step": per_step[name],
                   "launches_fit_eam_checks": held[name]}
            for name in ("corner_gather", "corner_scatter")}
    rows["corner_gather"].update({
        "fit_eam_step_s": step_s, "fit_eam_peak_gib": peak,
        "fit_eam_call_s": call_s, "fit_eam_grad_rel_l2": err,
        "fit_eam_device_busy": busy, "fit_eam_blind": chosen})
    return launches, rows


def phase_fit_iso_path(dev, counters):
    """``path fit iso`` (BASELINE config 2), every launch counter at 0
    first: ``sphere_volume(128)`` truth with ``gray_ramp(alpha_scale=1.0)``,
    a 256² depth map from ``diff_iso.render`` under ``no_grad`` saved as
    ``.npy``; one value-and-grad of ``diff_iso.depth_loss`` at 64² and one
    at 256² (the fit's own shape) with the volume and a tensor isovalue as
    leaves, the kernels against ``kernels=False``; then ``cli fit --method iso-depth --grid 128
    --steps 5``: seconds an Adam step, peak memory, K3/K4 launches a step.
    Returns the path's launches and K3's and K4's fields."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import diff_iso, make_scene

    for module in counters.values():
        module.LAUNCHES = 0
    n, res, steps = FIT_ISO_VOLUME, FIT_ISO_RES, FIT_ISO_STEPS
    out = _fit_out()
    tf = transfer.gray_ramp(alpha_scale=1.0)
    truth = make_scene(volume.sphere_volume(n), tf, pack=False)
    t0 = time.perf_counter()
    with torch.no_grad():
        depth = diff_iso.render(truth, diff_iso.Params(), res, res)["depth"]
        small = diff_iso.render(truth, diff_iso.Params(), 64, 64)["depth"]
    torch.cuda.synchronize()
    hits = float((depth >= 0).float().mean())
    check(bool(torch.isfinite(depth).all()) and 0.0 < hits < 1.0,
          "fit iso: the depth map is not finite or has no hit")
    npy = os.path.join(out, "depth.npy")
    np.save(npy, depth.cpu().numpy())
    print(f"fit iso target: {n}^3 sphere, {res}^2 depth map under no_grad "
          f"in {time.perf_counter() - t0:.3f} s, {hits:.4f} of the pixels "
          "in the cube", flush=True)

    template = make_scene(torch.full((n, n, n, 1), 0.1, device=dev), tf,
                          pack=False)
    init = 0.1 + 0.8 * volume.blobs_volume(n, seed=5).data
    isovalue = torch.tensor(0.45, device=dev)

    def loss_fn(target):
        def fn(leaves, kernels):
            params = diff_iso.Params(isovalue=leaves["isovalue"])
            sc = dataclasses.replace(template, kernels=kernels)
            return diff_iso.depth_loss(leaves["volume"], sc, params, target,
                                       *target.shape)
        return fn

    # at 64² and at the fit's own 256², the shapes cli fit's steps give K3
    # and K4
    err = max(fit_grad_check(
        f"fit iso value-and-grad {t.shape[0]}^2 {n}^3", loss_fn(t),
        {"volume": init, "isovalue": isovalue}, counters)[0]
        for t in (small, depth))
    held = {name: m.LAUNCHES for name, m in counters.items()}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["fit", "--target", npy, "--method", "iso-depth", "--grid",
            str(n), "--steps", str(steps), "-o", os.path.join(out, "iso")]
    t0 = time.perf_counter()
    with StepWatch(diff_iso, "depth_loss", counters) as watch:
        lines, launches, _ = run_cli(argv, counters)
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s, per_step = watch.per_step()
    check(per_step["tf1d_lookup"] == 0 and per_step["corner_gather"] > 0
          and per_step["corner_scatter"] > 0,
          f"fit iso: launches a step {per_step}")
    _fitted(os.path.join(out, "iso.npy"), (n, n, n, 1), "fit iso")
    final = next((ln for ln in lines if ln.startswith("final depth")), None)
    check(final is not None, f"fit iso: cli fit printed {lines}")
    print(f"path fit iso: cli fit --method iso-depth {n}^3, {res}^2, "
          f"{steps} Adam steps: {call_s:.3f} s the call, {step_s:.4f} s an "
          f"Adam step (host clock), peak memory {peak:.3f} GiB; launches a "
          f"step: corner_gather {per_step['corner_gather']:.1f}, "
          f"corner_scatter {per_step['corner_scatter']:.1f}, tf1d_lookup 0; "
          f"{final}", flush=True)
    launches = {k: launches[k] + held[k] for k in launches}
    rows = {name: {"launches_fit_iso": launches[name],
                   "launches_fit_iso_step": per_step[name],
                   "launches_fit_iso_checks": held[name]}
            for name in ("corner_gather", "corner_scatter")}
    rows["corner_gather"].update({
        "fit_iso_step_s": step_s, "fit_iso_peak_gib": peak,
        "fit_iso_call_s": call_s, "fit_iso_grad_rel_l2": err})
    return launches, rows


def phase_inpaint_path(dev, counters):
    """``--inpaint`` (config 3's completion), every launch counter at 0
    first: a 256² PNG of ``blobs_volume(256)`` under
    ``gray_ramp(alpha_scale=1.0)`` (``mcm_expected_image`` at fit_mc's
    default Params, 16 frames, under ``no_grad``), then ``cli fit --method
    mcm --grid 256 --mc-frames 16 --steps 3 --inpaint``: seconds an Adam
    step, peak memory, the seconds of ``inpaint.complete_occluded`` on the
    256³ fitted volume and the filled share.  Returns the path's launches
    and K3's and K4's fields."""
    import torch

    from vpt_tpu_torch import inpaint, train, transfer, volume
    from vpt_tpu_torch.io.image import write_png
    from vpt_tpu_torch.renderers import diff_mc, make_scene, mcm

    for module in counters.values():
        module.LAUNCHES = 0
    n, res, steps, frames = (INPAINT_VOLUME, INPAINT_RES, INPAINT_STEPS,
                             INPAINT_FRAMES)
    out = _fit_out()
    truth = make_scene(volume.blobs_volume(n),
                       transfer.gray_ramp(alpha_scale=1.0))
    params = mcm.Params(extinction=train.MC_FIT_EXTINCTION["mcm"], steps=16)
    t0 = time.perf_counter()
    with torch.no_grad():
        target = diff_mc.mcm_expected_image(truth, params, res, res, frames)
    png = os.path.join(out, "mcm_target.png")
    write_png(png, target)
    print(f"inpaint target: {n}^3 blobs, {res}^2, steps 16 x {frames} "
          f"frames under no_grad and a PNG in {time.perf_counter() - t0:.3f} "
          f"s", flush=True)
    del truth, target
    torch.cuda.empty_cache()

    fill = {}
    complete = inpaint.complete_occluded

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = complete(*args, **kwargs)
        torch.cuda.synchronize()
        fill["s"] = time.perf_counter() - t
        fill["share"] = float(result[1].float().mean())
        return result

    torch.cuda.reset_peak_memory_stats()
    argv = ["fit", "--target", png, "--method", "mcm", "--grid", str(n),
            "--mc-frames", str(frames), "--steps", str(steps), "--inpaint",
            "-o", os.path.join(out, "mcm")]
    inpaint.complete_occluded = timed
    t0 = time.perf_counter()
    try:
        with StepWatch(train, "mc_loss", counters) as watch:
            lines, launches, _ = run_cli(argv, counters)
    finally:
        inpaint.complete_occluded = complete
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s, per_step = watch.per_step()
    check("s" in fill, "inpaint: cli fit did not complete the volume")
    check(per_step["corner_gather"] > 0 and per_step["corner_scatter"] > 0,
          f"inpaint: launches a step {per_step}")
    _fitted(os.path.join(out, "mcm.npy"), (n, n, n, 1), "inpaint")
    said = next((ln for ln in lines if ln.startswith("inpainted")), None)
    check(said is not None, f"inpaint: cli fit printed {lines}")
    print(f"path inpaint: cli fit --method mcm {n}^3, {res}^2, {frames} "
          f"frames, {steps} Adam steps, --inpaint: {call_s:.3f} s the call, "
          f"{step_s:.4f} s an Adam step (host clock), peak memory "
          f"{peak:.3f} GiB; complete_occluded on the {n}^3 fitted volume "
          f"{fill['s']:.4f} s, {fill['share']:.6f} of the voxels filled "
          f"({said}); launches a step: corner_gather "
          f"{per_step['corner_gather']:.1f}, corner_scatter "
          f"{per_step['corner_scatter']:.1f}", flush=True)
    rows = {name: {"launches_inpaint": launches[name],
                   "launches_inpaint_step": per_step[name]}
            for name in ("corner_gather", "corner_scatter")}
    rows["corner_gather"].update({
        "inpaint_step_s": step_s, "inpaint_peak_gib": peak,
        "inpaint_call_s": call_s, "inpaint_fill_s": fill["s"],
        "inpaint_filled_share": fill["share"]})
    torch.cuda.empty_cache()
    return launches, rows


# -- the serving entry point: cli render (the slice's main path) -----------

def png_decode(data, channels=3, what="PNG"):
    """The (H, W, channels) uint8 pixels of 8-bit RGB (3) or RGBA (4) PNG
    bytes whose rows all use filter 0 (what ``io.image.png_bytes``
    writes), decoded with zlib; ``what`` names them in a failure."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{what}: not a PNG")
    pos, idat, size = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    color_type = {3: 2, 4: 6}[channels]
    check(size is not None and size[2:] == (8, color_type),
          f"{what}: not 8-bit of {channels} channels: {size}")
    w, h = size[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + channels * w)
    check(bool((rows[:, 0] == 0).all()), f"{what}: a row not in filter 0")
    return rows[:, 1:].reshape(h, w, channels)


def png_pixels(path):
    """The (H, W, 3) uint8 pixels of the 8-bit RGB PNG file at ``path``."""
    with open(path, "rb") as f:
        return png_decode(f.read(), what=path)


def run_cli(argv, counters):
    """``vpt_tpu_torch.cli.main(argv)`` in-process with every launch
    counter at 0 just before and read just after, and the scenes it built
    (``make_scene`` watched for the call).  Returns (its output lines, the
    launches, the scenes)."""
    import contextlib
    import io

    import torch

    from vpt_tpu_torch import cli
    from vpt_tpu_torch.renderers import base

    built = []
    make_scene = base.make_scene

    def watched(*args, **kwargs):
        built.append(make_scene(*args, **kwargs))
        return built[-1]

    text = io.StringIO()
    base.make_scene = watched
    try:
        for module in counters.values():
            module.LAUNCHES = 0
        with contextlib.redirect_stdout(text):
            cli.main(argv)
        torch.cuda.synchronize()
        launches = {name: m.LAUNCHES for name, m in counters.items()}
    finally:
        base.make_scene = make_scene
    return text.getvalue().splitlines(), launches, built


def cli_seconds(lines):
    """The stage seconds that ``cli render`` prints."""
    import re

    for line in lines:
        m = re.match(r"seconds \(cuda\): load (\S+), scene (\S+), frames "
                     r"(\S+) \((\S+) ms a frame, (\S+) events/s\), display "
                     r"(\S+), png (\S+)$", line)
        if m:
            return dict(zip(("load", "scene", "frames", "frame_ms",
                             "events_per_s", "display", "png"),
                            map(float, m.groups())))
    raise SmokeFailure(f"cli render printed no stage seconds: {lines}")


def check_cli_launches(name, launches, expected):
    for kernel, count in launches.items():
        check(count == expected.get(kernel, 0),
              f"{name}: {kernel} launched {count} times, not "
              f"{expected.get(kernel, 0)}")


def cli_grid_path(dev, counters, bvp, out):
    """``cli render --tracking grid`` on the BVP ``bvp`` (MCM 512², 16 spp,
    bf16, the sRGB TF, a PNG and a checkpoint in ``out``), with the launch
    counters at 0 just before it and read just after: its scene holds a
    16³ grid and no tracking table, and its state agrees with the plain
    grid loop replayed from the same reset with the context's seeds, to
    K5's bounds.  Returns the call's launches."""
    import dataclasses

    import torch

    from vpt_tpu_torch import cli
    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm
    from vpt_tpu_torch.runtime import checkpoint

    # 256 divides by 16, so the scene has a 16^3 grid
    png, npz = (os.path.join(out, f"grid.{ext}") for ext in ("png", "npz"))
    argv = ["render", "--volume", bvp, "--renderer", "mcm", "--resolution",
            "512", "--spp", "16", "--tf-alpha", "0.8", "--tf-srgb",
            "--precision", "fast", "--tracking", "grid", "--tonemap",
            "reinhard", "-o", png, "--checkpoint", npz]
    lines, launches, scenes = run_cli(argv, counters)
    sec = cli_seconds(lines)
    check(len(scenes) == 1 and scenes[0].majorant is not None
          and tuple(scenes[0].majorant.shape) == (16, 16, 16, 2)
          and scenes[0].tracking_packed is None,
          "path cli grid: not one scene with a 16^3 grid and no table")
    check_cli_launches("path cli grid", launches, {"mcm_event": 16,
                                                   "tonemap": 1})
    ctx = cli._build_context(cli.build_parser().parse_args(argv), dev)
    scene = dataclasses.replace(ctx.get_scene(), kernels=False)
    params = ctx.renderer.params
    plain = mcm.reset(params, 512, 512, scene)
    for n in range(1, 17):
        mcm_event.event_frame_plain(plain, scene, params,
                                    ctx._frame_seed(n))
    _, saved, frame, _ = checkpoint.load(npz, device=dev)
    got = dict(zip(sorted(plain), saved))
    check(frame == 16 and len(saved) == len(plain),
          "path cli grid: the checkpoint is not the 16 frames' state")
    match = got["samples"] == plain["samples"]
    agree = float(match.float().mean())
    err = float((got["radiance"] - plain["radiance"])[match].abs().max())
    gap = abs(float(got["radiance"].mean())
              - float(plain["radiance"].mean()))
    check(agree >= 0.9999 and err <= 1e-6 and gap <= 1e-4,
          f"path cli grid: samples agree {agree}, radiance err {err}, "
          f"means {gap} apart (bounds 0.9999, 1e-6, 1e-4)")
    print(f"path cli grid 256^3 BVP 512^2 16 spp: {sec['frame_ms']:.4f} ms "
          f"a frame ({sec['events_per_s']:.6g} events/s, host clock), "
          f"scene build {sec['scene']:.4f} s; against the plain grid loop "
          f"from the same reset: samples agree {agree:.6f} (bound 0.9999), "
          f"radiance max abs err {err} (bound 1e-6), means {gap:.3g} apart "
          f"(bound 1e-4); launches mcm_event {launches['mcm_event']}, "
          f"tonemap {launches['tonemap']}", flush=True)
    del ctx, scene, plain, saved, got, scenes
    torch.cuda.empty_cache()
    return launches


def phase_cli_path(dev, counters):
    """The serving entry point, ``cli render``, in-process on the card:

    1. ``build/smoke/blobs256.bvp``: the port's ``blobs_volume(256)``
       through its ``write_bvp`` (256³ uint8, stored);
    2. MCM at 512², 32 spp, bf16 tables and TF weights, cheb-skip, the sRGB
       TF, reinhard, a PNG and a checkpoint; the stage seconds on the host
       clock after a synchronize each, ms a frame and events/s;
    3. checked bit for bit: (a) a context built from the same arguments
       renders the CLI's state, and its HDR image is
       ``make_renderer("mcm")``'s on ``ctx.get_scene()`` with
       ``ctx._frame_seed(1..32)``; (b) 16 frames, a checkpoint, a fresh
       context's load and 16 more give the 32 frames' image; (c) the PNG's
       pixels are ``to_uint8`` of the display;
    4. each of the eight renderers through ``cli render`` on the BVP at
       512², default Params, 10 spp (DOS: one sweep), and MCM with
       ``--tracking grid`` (16 spp), held to the plain grid loop replayed
       from the same reset with the context's seeds;
    5. ``blobs:320`` through MCM, 4 spp: a volume above the 256³ packing
       rule, on float32 corner tables.

    Every ``cli.main`` call runs with the launch counters at 0 just before
    it and read just after.  Returns the launches of each kernel over the
    calls of 2 and 4."""
    import numpy as np
    import torch

    from vpt_tpu_torch import cli, volume
    from vpt_tpu_torch.io import readers, to_uint8
    from vpt_tpu_torch.renderers import dos, make_renderer
    from vpt_tpu_torch.runtime import checkpoint

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke")
    os.makedirs(out, exist_ok=True)
    bvp = os.path.join(out, "blobs256.bvp")
    t0 = time.perf_counter()
    readers.write_bvp(bvp, volume.blobs_volume(256))
    print(f"path cli: wrote {bvp}, {os.path.getsize(bvp)} bytes, in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    png, npz = os.path.join(out, "mcm.png"), os.path.join(out, "mcm.npz")
    argv = ["render", "--volume", bvp, "--renderer", "mcm", "--resolution",
            "512", "--spp", "32", "--tf-alpha", "0.8", "--tf-srgb",
            "--precision", "fast", "--tracking", "auto", "--tonemap",
            "reinhard", "-o", png, "--checkpoint", npz]
    lines, launches, scenes = run_cli(argv, counters)
    sec = cli_seconds(lines)
    check(len(scenes) == 1 and scenes[0].volume_packed.dtype
          == torch.bfloat16 and scenes[0].tracking_packed is not None,
          "path cli: not one bf16 scene with a tracking table")
    check_cli_launches("path cli mcm", launches, {"mcm_event": 32,
                                                  "tonemap": 1})
    print(f"path cli mcm 256^3 BVP 512^2 32 spp: load {sec['load']:.4f} s, "
          f"scene build {sec['scene']:.4f} s, frames {sec['frames']:.4f} s "
          f"({sec['frame_ms']:.4f} ms a frame, {sec['events_per_s']:.6g} "
          f"events/s), display {sec['display']:.4f} s, PNG write "
          f"{sec['png']:.4f} s (host clock, each after "
          "torch.cuda.synchronize()); launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    totals = dict(launches)

    args = cli.build_parser().parse_args(argv)
    ctx = cli._build_context(args, dev)
    ctx.render(frames=32)
    _, saved, frame, _ = checkpoint.load(npz, device=dev)
    check(frame == 32 and len(saved) == len(ctx.renderer.state)
          and all(torch.equal(a, ctx.renderer.state[k]) for a, k in
                  zip(saved, sorted(ctx.renderer.state))),
          "path cli: the CLI's state is not a context's of its arguments")
    scene = ctx.get_scene()
    direct = make_renderer("mcm", params=ctx.renderer.params, height=512,
                           width=512)
    direct.reset(scene)
    for n in range(1, 33):
        direct.render(scene, ctx._frame_seed(n))
    hdr = ctx.get_hdr_image()
    check(torch.equal(hdr, direct.display(scene)),
          "path cli (a): the context's HDR image is not the renderer's")
    part = cli._build_context(args, dev)
    part.render(frames=16)
    part.save_checkpoint(os.path.join(out, "half.npz"))
    resumed = cli._build_context(args, dev)
    resumed.load_checkpoint(os.path.join(out, "half.npz"))
    resumed.render(frames=16)
    check(resumed.renderer.frame_number == 32
          and torch.equal(resumed.get_hdr_image(), hdr),
          "path cli (b): 16 + 16 resumed frames are not 32 frames")
    pixels = png_pixels(png)
    check(np.array_equal(pixels, to_uint8(ctx.get_display_image())),
          "path cli (c): the PNG is not to_uint8 of the display")
    check(bool(torch.isfinite(hdr).all()) and pixels.max() > 0,
          "path cli: image not finite or black")
    print(f"path cli checks: (a) HDR equals make_renderer('mcm') on "
          f"ctx.get_scene() with ctx._frame_seed(1..32), bit for bit; (b) "
          f"16 + checkpoint + 16 frames equal 32, bit for bit; (c) PNG "
          f"{pixels.shape} equals to_uint8(display); HDR mean "
          f"{float(hdr[..., :3].mean()):.6f}", flush=True)
    # where a cli render's frames go on this scene: the same call again in
    # a warm process, then MCM's reset, frames from a warm state and K5's
    # own time, each on the context's renderer
    lines, _, _ = run_cli(argv[:-4] + ["-o", os.path.join(out, "again.png")],
                          counters)
    again = cli_seconds(lines)
    renderer = ctx.renderer
    seeds = itertools.count(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.reset(scene)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    renderer.render(scene, ctx._frame_seed(next(seeds)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(32):
        renderer.render(scene, ctx._frame_seed(next(seeds)))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / 32
    device_ms = profiler_device_ms(
        lambda: renderer.render(scene, ctx._frame_seed(next(seeds))),
        "mcm_event_kernel", 20)
    steps = renderer.params.steps
    print(f"path cli mcm, where the frames go: the same cli render again "
          f"{again['frame_ms']:.4f} ms a frame (load {again['load']:.4f} s, "
          f"scene build {again['scene']:.4f} s); mcm.reset "
          f"{reset_ms:.4f} ms; frames from a warm state {warm_ms:.4f} ms "
          f"a frame ({512 * 512 * steps / warm_ms * 1e3:.6g} events/s, "
          f"host clock); K5 {fmt_ms(device_ms)} a frame on the card",
          flush=True)
    sweep = dos_sweep_frames(scene, dos.Params(), 512, 512)
    del ctx, part, resumed, direct, renderer, scene, hdr, scenes
    torch.cuda.empty_cache()

    for name, count in cli_grid_path(dev, counters, bvp, out).items():
        totals[name] += count

    for key, kernel in sorted({**PATH_KERNEL, "mcm": "mcm_event"}.items()):
        spp = sweep if key == "dos" else 10
        png, npz = (os.path.join(out, f"{key}.{ext}") for ext in ("png",
                                                                  "npz"))
        lines, launches, _ = run_cli(
            ["render", "--volume", bvp, "--renderer", key, "--resolution",
             "512", "--spp", str(spp), "--tf-alpha", "0.8", "--tf-srgb",
             "-o", png, "--checkpoint", npz], counters)
        sec = cli_seconds(lines)
        expected = {kernel: spp, "tonemap": 1}
        if key == "iso":
            expected["iso_shade"] = 1
        check_cli_launches(f"path cli {key}", launches, expected)
        _, state, _, _ = checkpoint.load(npz, device="cpu")
        check(all(bool(torch.isfinite(t).all()) for t in state)
              and png_pixels(png).max() > 0,
              f"path cli {key}: state not finite or image black")
        for name, count in launches.items():
            totals[name] += count
        print(f"path cli {key} 512^2 {spp} spp: {sec['frame_ms']:.4f} ms a "
              f"frame (host clock), frames {sec['frames']:.4f} s, scene "
              f"build {sec['scene']:.4f} s; launches {kernel} "
              f"{launches[kernel]}, tonemap {launches['tonemap']}",
              flush=True)
    torch.cuda.empty_cache()

    lines, launches, scenes = run_cli(
        ["render", "--volume", "blobs:320", "--renderer", "mcm", "--spp",
         "4", "--tf-alpha", "0.8", "--tf-srgb", "-o",
         os.path.join(out, "mcm320.png")], counters)
    sec = cli_seconds(lines)
    check(len(scenes) == 1 and scenes[0].volume_packed.dtype
          == torch.float32 and scenes[0].transfer_packed.dtype
          == torch.float32 and scenes[0].tf_mxu == torch.bfloat16,
          "path cli 320^3: not float32 tables with bf16 TF weights")
    check_cli_launches("path cli 320^3", launches, {"mcm_event": 4,
                                                    "tonemap": 1})
    table = scenes[0].volume_packed
    print(f"path cli mcm blobs:320 512^2 4 spp: float32 corner tables "
          f"({table.numel() * 4} bytes), tracking table "
          f"{scenes[0].tracking_packed.dtype}; scene build "
          f"{sec['scene']:.4f} s, {sec['frame_ms']:.4f} ms a frame",
          flush=True)
    del scenes, table
    torch.cuda.empty_cache()
    return totals


# -- the last entry points: cli view, cli animate, the config-3 recipe ------

#: the viewer's request size and its samples a /frame
VIEW_RES, VIEW_SPP = 512, 4
#: the seven renderers a viewer path switches to after MCM
VIEW_SWITCHES = ("eam", "mip", "depth", "iso", "mcs", "dos", "lao")
VIEW_BUMPS = [{"position": {"x": 0.45, "y": 0.5},
               "size": {"x": 0.3, "y": 0.4},
               "color": {"r": 0.9, "g": 0.6, "b": 0.3, "a": 0.8}}]


def http_request(url, data=None):
    """(the body, seconds on the host clock) of one request; any status
    but 200 fails the smoke (the viewer turns exceptions into 500s)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        raise SmokeFailure(f"{url}: HTTP {exc.code} {exc.reason}") from exc
    check(status == 200, f"{url}: HTTP {status}")
    return body, time.perf_counter() - t0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_viewer(argv):
    """Start ``python -m vpt_tpu_torch.cli`` + argv from the checkout's
    root and wait (120 s at most) for its "viewer on http://" line.
    Returns (the process, its base URL)."""
    import queue
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "vpt_tpu_torch.cli", *argv], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": root + os.pathsep
             + os.environ.get("PYTHONPATH", "")})
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.perf_counter() + 120
    said = []
    while time.perf_counter() < deadline:
        try:
            line = lines.get(timeout=1)
        except queue.Empty:
            check(proc.poll() is None, f"cli view exited {proc.returncode}: "
                  + "".join(said)[-2000:])
            continue
        said.append(line)
        if "viewer on http://" in line:
            return proc, line.split("viewer on ")[1].strip()
    proc.kill()
    raise SmokeFailure("cli view printed no 'viewer on http://' line in "
                       "120 s: " + "".join(said)[-2000:])


def view_requests():
    """The path's requests, in order: (kind, path, POST body or None)."""
    import urllib.parse

    pose = "yaw=0.3&pitch=0.2&distance=2"
    frame = f"/frame?{pose}&spp={VIEW_SPP}&tonemap=reinhard&renderer="
    out = [("page", "/", None), ("info", "/info", None),
           ("histogram", "/histogram", None)]
    out += [("first" if i == 0 else "warm", frame + "mcm", None)
            for i in range(8)]
    moved = f"/frame?yaw=0.9&pitch=-0.3&distance=2&spp={VIEW_SPP}"
    out.append(("pose", moved + "&renderer=mcm", None))
    for rp, kind in (({"extinction": 30}, "params"),
                     ({"extinction": 30, "steps": 16}, "static")):
        out.append((kind, moved + "&renderer=mcm&rp="
                    + urllib.parse.quote(json.dumps(rp)), None))
    # each renderer twice: its first use in the server's process, then a
    # switch back to it
    out += [(f"{turn} {key}", moved + f"&renderer={key}", None)
            for turn in ("switch", "again") for key in VIEW_SWITCHES]
    out += [("tf", "/tf", json.dumps(VIEW_BUMPS).encode()),
            ("tf frame", moved + "&renderer=mcm", None),
            ("tf.png", "/tf.png", None),
            ("resolution", moved + "&renderer=mcm&resolution=256", None),
            ("filter", moved + "&renderer=mcm&resolution=256"
             "&filter=nearest", None)]
    return out


def view_expected(kind, path):
    """The launches one request makes: its renderer's kernel once a
    sample and K2 once a /frame (and K7 once an ISO /frame), no other."""
    if not path.startswith("/frame"):
        return {}
    key = path.split("renderer=")[1].split("&")[0]
    expected = {PATH_KERNEL.get(key, "mcm_event"): VIEW_SPP, "tonemap": 1}
    if key == "iso":
        expected["iso_shade"] = 1
    return expected


def phase_view_path(dev, counters, bvp, card):
    """``cli view`` on the card, the user's entry point, as a subprocess
    (``python -m vpt_tpu_torch.cli view --volume <bvp> --renderer mcm
    --resolution 512 --port <free>``), stopped by its PID at the end, and
    the same ``ViewerServer`` in this process on a context built from the
    same arguments (``cli._build_context``), serving the same requests in
    the same order (:func:`view_requests`) with every launch counter at 0
    just before each and read just after.  Every response of either is
    200, and the subprocess's bodies equal this process's bit for bit, so
    the counted launches are the subprocess's: each /frame launches its
    renderer's kernel once a sample and K2 once, and nothing else does.
    Each /frame PNG decodes to the requested size; the 8th MCM /frame
    equals, in every pixel, a third context driven directly (the pose set
    on its orbit animator, ``render(4)`` eight times, ``to_uint8`` of the
    display).  Prints the host-clock latency of the subprocess's first,
    warm (the median of requests 2-8), pose-change and renderer-switch
    requests, and of a second switch to each renderer.  Returns the
    launches over the path."""
    import numpy as np
    import torch

    from vpt_tpu_torch import cli
    from vpt_tpu_torch.io import to_uint8
    from vpt_tpu_torch.renderers import mcm
    from vpt_tpu_torch.runtime.viewer import ViewerServer

    argv = ["view", "--volume", bvp, "--renderer", "mcm", "--resolution",
            str(VIEW_RES)]
    t0 = time.perf_counter()
    proc, base = start_viewer(argv + ["--port", str(free_port())])
    started = time.perf_counter() - t0
    server = None
    try:
        ctx = cli._build_context(cli.build_parser().parse_args(
            argv + ["--port", "0"]), dev)
        server = ViewerServer(ctx, port=0)
        local = f"http://127.0.0.1:{server.serve_background()}"
        totals = {name: 0 for name in counters}
        seconds, frames = {}, []
        for kind, path, body in view_requests():
            got, sec = http_request(base + path, body)
            seconds.setdefault(kind, []).append(sec)
            for module in counters.values():
                module.LAUNCHES = 0
            want, _ = http_request(local + path, body)
            torch.cuda.synchronize()
            launches = {name: m.LAUNCHES for name, m in counters.items()}
            check(got == want, f"path view {kind} {path}: the subprocess's "
                  "body differs from this process's server's")
            check_cli_launches(f"path view {kind}", launches,
                               view_expected(kind, path))
            for name, count in launches.items():
                totals[name] += count
            if path.startswith("/frame"):
                res = 256 if "resolution=256" in path else VIEW_RES
                pixels = png_decode(got)
                check(pixels.shape == (res, res, 3) and pixels.max() > 0,
                      f"path view {kind}: a {pixels.shape} PNG")
                frames.append(pixels)
            elif path == "/tf.png":
                check(png_decode(got, 4).shape[2] == 4, "tf.png not RGBA")
            elif path == "/":
                check(b"vpt_tpu_torch viewer" in got, "the page's title")
            elif path == "/info":
                info = json.loads(got)
                check(len(info["renderers"]) == 8
                      and "frame_cost_ms_512" not in info,
                      f"/info: {sorted(info)}")
            elif path == "/histogram":
                check(len(json.loads(got)) == 96, "/histogram not 96 bins")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        if server is not None:
            server.shutdown()

    direct = cli._build_context(cli.build_parser().parse_args(
        argv + ["--port", "0"]), dev)
    direct.choose_renderer("mcm", params=mcm.Params())
    orbit = direct.camera_animator
    orbit.yaw, orbit.pitch, orbit.roll, orbit.distance = 0.3, 0.2, 0.0, 2.0
    orbit.focus = np.zeros(3, np.float32)
    orbit._update_camera()
    for _ in range(8):
        direct.render(frames=VIEW_SPP)
    want = to_uint8(direct.get_display_image())
    check(np.array_equal(frames[7], want),
          "path view: 8 /frame requests differ from 8 direct renders, in "
          f"{int((frames[7] != want).any(-1).sum())} pixels")
    median = sorted(seconds["warm"])[len(seconds["warm"]) // 2]
    switches = {k.split()[1]: v[0] for k, v in seconds.items()
                if k.startswith("switch")}
    again = {k.split()[1]: v[0] for k, v in seconds.items()
             if k.startswith("again")}
    print(f"path view ({card}): cli view 256^3 BVP MCM {VIEW_RES}^2, "
          f"{VIEW_SPP} spp a /frame, {len(seconds)} request kinds, every "
          f"response 200; up in {started:.3f} s; host-clock latency: first "
          f"/frame {seconds['first'][0] * 1e3:.3f} ms, warm "
          f"{median * 1e3:.3f} ms (median of 7), pose change "
          f"{seconds['pose'][0] * 1e3:.3f} ms, Params "
          f"{seconds['params'][0] * 1e3:.3f} ms, static rebuild "
          f"{seconds['static'][0] * 1e3:.3f} ms, renderer switch (first "
          "use in the process) "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in switches.items())
          + ", switch back "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in again.items())
          + f", resolution 256 {seconds['resolution'][0] * 1e3:.3f} ms, "
          f"filter {seconds['filter'][0] * 1e3:.3f} ms; the 8th /frame "
          "equals 8 direct renders in every pixel; launches: "
          + ", ".join(f"{k} {v}" for k, v in totals.items()), flush=True)
    del ctx, direct
    torch.cuda.empty_cache()
    return totals


ANIMATE_FRAMES, ANIMATE_SPP = 8, 16


def phase_animate_path(dev, counters, bvp):
    """``cli animate`` in-process (``run_cli``: every launch counter at 0
    just before, read just after) on the BVP: MCM at 512², 16 spp, 8
    orbit frames, ``--video anim.gif``, then the same with ``--video
    anim.mp4`` (OpenCV's ``mp4v``; without OpenCV, or without the codec,
    it falls back to a GIF and says so).  Checks 8 PNGs, the GIF's 8
    frames equal to the PNGs, consecutive frames that differ, and K5 =
    frames × spp, K2 = frames launches a call.  Returns the launches."""
    import importlib.util

    import numpy as np
    from PIL import Image

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke", "animate")
    os.makedirs(out, exist_ok=True)
    totals, said = {name: 0 for name in counters}, {}
    for ext in ("gif", "mp4"):
        folder, video = (os.path.join(out, ext),
                         os.path.join(out, f"anim.{ext}"))
        t0 = time.perf_counter()
        lines, launches, _ = run_cli(
            ["animate", "--volume", bvp, "--renderer", "mcm",
             "--resolution", "512", "--spp", str(ANIMATE_SPP), "--frames",
             str(ANIMATE_FRAMES), "-o", folder, "--video", video], counters)
        call_s = time.perf_counter() - t0
        check_cli_launches(f"path animate {ext}", launches, {
            "mcm_event": ANIMATE_FRAMES * ANIMATE_SPP,
            "tonemap": ANIMATE_FRAMES})
        for name, count in launches.items():
            totals[name] += count
        pngs = sorted(p for p in os.listdir(folder) if p.endswith(".png"))
        check(len(pngs) == ANIMATE_FRAMES, f"path animate: {len(pngs)} PNGs")
        frames = [png_pixels(os.path.join(folder, p)) for p in pngs]
        check(all(not np.array_equal(a, b)
                  for a, b in zip(frames, frames[1:])),
              "path animate: two consecutive frames are equal")
        wrote = [ln for ln in lines if "wrote video" in ln]
        check(len(wrote) == 1, f"path animate: {lines}")
        written = wrote[0].split("wrote video ")[1].strip()
        said[ext] = (written, call_s, [ln for ln in lines
                                       if ln.startswith("write_video")])
        if written.endswith(".gif"):
            gif = Image.open(written)
            check(gif.n_frames == ANIMATE_FRAMES,
                  f"path animate: the GIF has {gif.n_frames} frames")
            for i, pixels in enumerate(frames):
                gif.seek(i)
                check(np.array_equal(np.asarray(gif.convert("RGB")),
                                     pixels),
                      f"path animate: GIF frame {i} is not its PNG")
    cv2 = importlib.util.find_spec("cv2") is not None
    check(cv2 or said["mp4"][0].endswith(".gif"),
          "path animate: no OpenCV, yet the .mp4 request wrote no GIF")
    print(f"path animate: cli animate 256^3 BVP MCM 512^2, "
          f"{ANIMATE_FRAMES} orbit frames x {ANIMATE_SPP} spp: --video "
          f"anim.gif {said['gif'][1]:.3f} s -> {said['gif'][0]}; --video "
          f"anim.mp4 {said['mp4'][1]:.3f} s -> {said['mp4'][0]} (cv2 "
          f"{'present' if cv2 else 'absent'}"
          + (f"; {said['mp4'][2][0]}" if said["mp4"][2] else "")
          + f"); launches a call: mcm_event {ANIMATE_FRAMES * ANIMATE_SPP}, "
          f"tonemap {ANIMATE_FRAMES}", flush=True)
    return totals


#: the recipe's cuts for this script's time limit: the Adam steps of each
#: stage (300/200/150/160 in the recipe) and the targets' samples a pixel
#: (2048; 64 is the recipe's own --quick value); of 3 steps, the first
#: carries the stage's logging and first use, the second is steady
CONFIG3_STEPS = 3


def phase_config3_path(dev, counters):
    """The port's config-3 recipe (``vpt_tpu_torch.examples.config3_mcm256``)
    at its full size through its own ``run`` with every launch counter at
    0 first: ``blobs_volume(256)`` truth, 256² images, 10 views,
    extinctions 25 and 5, the four stages, ``--inpaint-blind`` (views 3
    and 7 held out), the cache off; cut: :data:`CONFIG3_STEPS` Adam steps a
    stage and 64-spp targets.  Prints the seconds a stage and an Adam step
    (the host clock between the loss's calls, each after a synchronize:
    the second step, and the first, which carries the stage's logging),
    the peak memory, K3/K4 launches a step, the voxel MSE before and after
    and the blind tau table; checks the JSON summary line and the
    gallery.  Returns the path's launches and K3's and K4's fields."""
    import contextlib
    import io

    import torch

    from vpt_tpu_torch.examples import config3_mcm256 as c3

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke", "config3")
    os.makedirs(out, exist_ok=True)
    gallery = os.path.join(out, "gallery.png")
    args = c3.build_parser().parse_args(
        ["--inpaint-blind", "--out", gallery, "--cache", ""])
    n, res, full_spp, n_views = c3.sizes(False)
    min_spp = c3.sizes(True)[2]
    full = c3.stage_table(args, n)
    stages = [(g, CONFIG3_STEPS, f, lr, d) for g, _, f, lr, d in full]
    print(f"path config3: cut the Adam steps {[s[1] for s in full]} -> "
          f"{[s[1] for s in stages]} and the targets' spp {full_spp} -> "
          f"{min_spp} (the recipe's --quick value); {n}^3, {res}^2, "
          f"{n_views} views, extinctions {args.exts}, --inpaint-blind",
          flush=True)

    marks = []
    loss_fn = c3.loss_fn

    def watched(voxels, *rest, **kwargs):
        torch.cuda.synchronize()
        marks.append((voxels.shape[0], time.perf_counter(),
                      {k: m.LAUNCHES for k, m in counters.items()}))
        return loss_fn(voxels, *rest, **kwargs)

    for module in counters.values():
        module.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    c3.loss_fn = watched
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            summary = c3.run(args, stages, n, res, min_spp, n_views)
        torch.cuda.synchronize()
    finally:
        c3.loss_fn = loss_fn
    call_s = time.perf_counter() - t0
    launches = {name: m.LAUNCHES for name, m in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lines = text.getvalue().splitlines()
    check(json.loads(lines[-1]) == summary,
          "path config3: the last line is not the JSON summary")
    check(summary["inpaint_tau_blind"] is None
          or summary["inpaint_tau_blind"] in
          [float(t) for t in args.blind_taus.split(",")],
          f"path config3: tau {summary['inpaint_tau_blind']}")
    for key in ("image_mse_first", "image_mse_last", "voxel_mse_init",
                "voxel_mse_fitted", "voxel_mse_inpaint_blind"):
        check(summary[key] == summary[key] and abs(summary[key]) < 1e3,
              f"path config3: {key} {summary[key]}")
    pixels = png_pixels(gallery)
    check(pixels.shape == (3 * res, 3 * res, 3) and pixels.max() > 0,
          f"path config3: a {pixels.shape} gallery")
    check(launches["mcm_event"] > 0 and launches["corner_gather"] > 0
          and launches["corner_scatter"] > 0 and launches["tonemap"] == 9,
          f"path config3: launches {launches}")
    stage_s = [ln.strip() for ln in lines if "stage done in" in ln]
    per_stage = []
    for g, *_ in stages:
        got = [(t, c) for grid, t, c in marks if grid == g]
        check(len(got) == CONFIG3_STEPS, f"path config3: {len(got)} loss "
              f"calls at {g}^3")
        (t_0, _), (t_1, c_1), (t_2, c_2) = got
        per_stage.append((g, t_2 - t_1, t_1 - t_0,
                          {k: c_2[k] - c_1[k]
                           for k in ("corner_gather", "corner_scatter")}))
    for ln in lines:
        if ln.startswith("config 3:") or "voxel MSE by truth" in ln \
                or "chosen tau" in ln or "stage done" in ln:
            print(f"path config3 | {ln.strip()}", flush=True)
    print("path config3: " + "; ".join(
        f"{g}^3 {s:.4f} s an Adam step (the stage's first {s0:.4f} s), "
        f"corner_gather {c['corner_gather']} / corner_scatter "
        f"{c['corner_scatter']} a step" for g, s, s0, c in per_stage)
        + f"; peak memory {peak:.3f} GiB; voxel MSE "
        f"{summary['voxel_mse_init']:.6f} init -> "
        f"{summary['voxel_mse_fitted']:.6f} fitted -> "
        f"{summary['voxel_mse_inpaint_blind']:.6f} blind-inpainted (tau "
        f"{summary['inpaint_tau_blind']}); blind table "
        + json.dumps(summary["inpaint_blind_table"])
        + f"; the blind completion {summary['inpaint_seconds']} s; fit "
        f"{summary['fit_seconds']} s, the run {call_s:.3f} s; "
        "launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()),
        flush=True)
    check(len(stage_s) == len(stages), f"path config3: {stage_s}")
    rows = {name: {"launches_config3": launches[name],
                   "launches_config3_step": {
                       str(g): c[name] for g, _, _, c in per_stage}}
            for name in ("corner_gather", "corner_scatter")}
    rows["corner_gather"].update({
        "config3_step_s": {str(g): s for g, s, _, _ in per_stage},
        "config3_peak_gib": peak, "config3_call_s": call_s})
    torch.cuda.empty_cache()
    return launches, rows


# -- this slice: unpacked scenes, the row window, parallel/, the demos -----

UNPACKED_KEYS = ("mcm", "eam", "mip", "depth", "iso", "mcs", "dos", "lao")


def plain_frame(key, plain, scene, params, seed, n):
    """Renderer ``key``'s plain frame in place on ``plain``, on the scene
    with ``kernels=False``; checks that it launched nothing."""
    import dataclasses

    from vpt_tpu_torch.kernels import dos_sweep, lao_march, march
    from vpt_tpu_torch.kernels import mcm_event, mcs_frame

    reference = dataclasses.replace(scene, kernels=False)
    before = launch_counts()
    if key == "mcm":
        mcm_event.event_frame_plain(plain, reference, params, seed)
    elif key == "mcs":
        mcs_frame.mcs_frame_plain(plain, reference, params, seed, n)
    elif key == "dos":
        dos_sweep.sweep_frame_plain(plain, reference, params)
    elif key == "lao":
        lao_march.lao_frame_plain(plain, reference, params)
    else:
        march.march_frame_plain(key, plain, reference, params, seed, n)
    check(launch_counts() == before, f"{key}: the plain frame launched a "
          "kernel")


def _clone(state):
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    return state.clone()


def states_agree(label, key, got, want):
    """Kernel against plain frame within the packed rows' bounds (MCM:
    ``_frames_agree``'s; Depth and ISO equal; DOS its colour and
    occlusion, the others their state, 99.99% of the pixels within
    1e-6); returns the max abs error."""
    import torch

    if key == "mcm":
        match = got["samples"] == want["samples"]
        agree = float(match.float().mean())
        err = float((got["radiance"] - want["radiance"])[match].abs().max())
        check(agree >= 0.9999 and err <= 1e-6, f"{label} mcm: samples "
              f"agree {agree}, radiance err {err}")
        print(f"mcm {label}: samples agree {agree:.6f} (bound 0.9999), "
              f"radiance max abs err {err} (bound 1e-6)", flush=True)
        return err
    if key == "dos":
        check(torch.equal(got["depth"], want["depth"]),
              f"{label} dos: depth differs")
        return max(compare_states(label, "dos " + k, got[k], want[k], False)
                   for k in ("color", "occlusion"))
    return compare_states(label, key, got, want, key in ("depth", "iso"))


def phase_unpacked_path(dev, counters):
    """``path unpacked``: a ``pack=False`` 64³ blobs scene on the card
    (the samplers unpacked, float32 corner tables for the kernels), one
    frame of each renderer at 256² through its kernel, every launch
    counter at 0 first, against its plain frame; ISO's display through
    K7 against its plain shade.  Returns (launches, {kernel: max abs
    err})."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import iso_shade
    from vpt_tpu_torch.renderers import factory, iso, make_scene, mcm

    t0 = time.perf_counter()
    scene = make_scene(volume.blobs_volume(64, seed=1),
                       transfer.gray_ramp(alpha_scale=0.8), pack=False)
    check(scene.kernel_tables and not scene._packed_samples()
          and scene.volume_packed.dtype == torch.float32
          and scene.transfer_packed.dtype == torch.float32,
          "path unpacked: the scene lacks its float32 kernel tables")
    for module in counters.values():
        module.LAUNCHES = 0
    errors = {}
    for key in UNPACKED_KEYS:
        module = factory.get_module(key)
        params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8) \
            if key == "mcm" else module.Params()
        state = module.reset(params, 256, 256, scene)
        plain = _clone(state)
        module.render_frame(state, scene, params, 0.37, 1)
        plain_frame(key, plain, scene, params, 0.37, 1)
        torch.cuda.synchronize()
        name = PATH_KERNEL.get(key, "mcm_event")
        errors[name] = max(errors.get(name, 0.0), states_agree(
            "unpacked 64^3 256^2", key, state, plain))
        if key == "iso":
            shown = iso.display(state, scene, params)
            check(torch.equal(shown, iso_shade.iso_shade_plain(
                state, scene, params)), "path unpacked: K7 differs")
            errors["iso_shade"] = 0.0
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    check_cli_launches("path unpacked", launches, {
        "mcm_event": 1, "march_frame": 4, "iso_shade": 1, "mcs_frame": 1,
        "dos_sweep": 1, "lao_march": 1})
    print(f"path unpacked: pack=False blobs 64^3 (float32 kernel tables, "
          f"{scene.volume_packed.numel() * 4} bytes), each renderer one "
          f"frame at 256^2 through its kernel; launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, errors


#: the row-window checks' bands of a 512-row frame: two equal ones, and
#: three uneven ones that are no multiple of a block's rows
WINDOW_BANDS = {"two bands": [(0, 256), (256, 512)],
                "three uneven bands": [(0, 137), (137, 339), (339, 512)]}


def phase_window_checks(headline):
    """The row window of K5, K6 (four modes), K8 and K10 at 512² on the
    headline: the whole frame rendered as two equal bands and as three
    uneven ones, each band with its window, stacked and held against the
    unwindowed frame: bit for bit (K5, K6, K8; every state field), K10
    within its bound (99.99% of the values within 1e-6).  Returns
    {kernel: max abs err}."""
    import numpy as np
    import torch

    from vpt_tpu_torch.renderers import factory, mcm

    errors = {}
    for key in ("mcm", "eam", "mip", "depth", "iso", "mcs", "lao"):
        module = factory.get_module(key)
        params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8) \
            if key == "mcm" else module.Params()
        frames = 1 if key == "lao" else 2
        name = PATH_KERNEL.get(key, "mcm_event")
        whole = module.reset(params, 512, 512, headline)
        for n in range(1, frames + 1):
            module.render_frame(whole, headline, params,
                                np.float32(0.3 + 0.01 * n), n)
        for label, bands in WINDOW_BANDS.items():
            parts = []
            for r0, r1 in bands:
                kw = {"window": (r0, 512)} if key == "mcm" else {}
                part = module.reset(params, r1 - r0, 512, headline, **kw)
                for n in range(1, frames + 1):
                    module.render_frame(part, headline, params,
                                        np.float32(0.3 + 0.01 * n), n,
                                        window=(r0, 512))
                parts.append(part)
            torch.cuda.synchronize()
            if isinstance(whole, dict):
                for k in whole:
                    check(torch.equal(torch.cat([p[k] for p in parts]),
                                      whole[k]),
                          f"window {key} {label}: {k} differs")
                err = 0.0
            elif key == "lao":
                err = compare_states(f"window {label}", key,
                                     torch.cat(parts), whole, False)
            else:
                check(torch.equal(torch.cat(parts), whole),
                      f"window {key} {label}: the bands differ")
                err = 0.0
            errors[name] = max(errors.get(name, 0.0), err)
            print(f"window {name} {key} 512^2 {label} "
                  f"{[r1 - r0 for r0, r1 in bands]}: "
                  + ("max abs err " + str(err) if key == "lao"
                     else "equal bit for bit") + " to the whole frame",
                  flush=True)
    return errors


#: config 4 (``examples/config4_pod512.py:86-96``, ``--full``): the volume,
#: the image and the frames of ``path parallel``
PARALLEL_VOLUME, PARALLEL_RES, PARALLEL_SPP = 512, 1024, 32


def eam_fit_views(truth, count=4, res=256):
    """``path fit eam``'s inputs: 256² targets of ``truth`` from ``count``
    orbit views, rendered by ``train.render_eam`` under no_grad, the
    views' matrices, the TF and Params (64 slices, no jitter)."""
    import numpy as np
    import torch

    from vpt_tpu_torch import transfer, train
    from vpt_tpu_torch.examples.inverse_demo import orbit_views
    from vpt_tpu_torch.renderers import eam

    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(slices=64, random=False)
    views = [tuple(m.to(truth.device) for m in v) for v in orbit_views(count)]
    with torch.no_grad():
        targets = [train.render_eam(truth, tf, v, params, np.float32(0.0),
                                    res, res) for v in views]
    return tf, params, views, targets


def bucketed_eam_step(mesh, n):
    """``path parallel``'s bucketed EAM step (``path fit eam``'s 4 views of
    256², 64 slices; 4 buckets, Adam) on ``blobs_volume(n)`` from a flat
    0.2, rows over ``mesh``'s ``data`` axis, as every tree since PR 16
    takes it: ``step()`` runs one, chaining the volume and the optimizer
    state, and returns the loss."""
    import numpy as np
    import torch

    from vpt_tpu_torch import volume
    from vpt_tpu_torch.parallel import overlap, shard
    from vpt_tpu_torch.parallel.mesh import axis_group

    truth = volume.blobs_volume(n, seed=1).data
    tf, eparams, views, targets = eam_fit_views(truth)

    def loss_of_volume(v):
        return sum(shard.eam_loss_rows(v, tf, cams, target, eparams,
                                       np.float32(0.0), mesh)
                   for cams, target in zip(views, targets)) / len(views)

    train_step = overlap.bucketed_train_step(
        lambda p: torch.optim.Adam(p, lr=0.05), loss_of_volume, 4,
        group=axis_group(mesh, "data"))
    carry = [torch.full_like(truth, 0.2), None]

    def step():
        loss, carry[0], carry[1] = train_step(*carry)
        return loss

    return step


class BucketTimeline:
    """The bucketed backward's K4 bucket launches and gradient reductions
    in the order issued, ``order``: ("scatter", i) after the i-th launch
    returns, ("reduce", i) as the i-th reduction is issued; and, from
    :meth:`times` after the step and a synchronisation, each reduction's
    issue on the host clock, its completion on the host clock (its work's
    future, where the backend completes one: gloo's), and each launch's
    end on the card (a CUDA event after it), all in ms from the
    timeline's start (the card idle, an event recorded at once)."""

    def __init__(self):
        import torch

        from vpt_tpu_torch.kernels import corner_scatter
        from vpt_tpu_torch.parallel import overlap

        self.order, self.issued, self.finished, self.ends = [], [], {}, []
        self._modules = (corner_scatter, overlap)
        self._real = (corner_scatter.corner_grad_bucket,
                      overlap._all_reduce_async)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record()

    def __enter__(self):
        import torch

        scatter, reduce = self._real

        def timed_scatter(*args):
            out = scatter(*args)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.ends.append(end)
            self.order.append(("scatter", len(self.ends) - 1))
            return out

        def timed_reduce(grad, group):
            i = len(self.issued)
            self.issued.append(time.perf_counter())
            self.order.append(("reduce", i))
            work = reduce(grad, group)

            def done(_, i=i):
                self.finished[i] = time.perf_counter()

            work.get_future().then(done)
            return work

        self._modules[0].corner_grad_bucket = timed_scatter
        self._modules[1]._all_reduce_async = timed_reduce
        return self

    def __exit__(self, *exc):
        self._modules[0].corner_grad_bucket = self._real[0]
        self._modules[1]._all_reduce_async = self._real[1]

    def times(self):
        return {"issued_ms": [(t - self.t0) * 1e3 for t in self.issued],
                "finished_ms": [(self.finished[i] - self.t0) * 1e3
                                if i in self.finished else None
                                for i in range(len(self.issued))],
                "scatter_end_ms": [self.e0.elapsed_time(e)
                                   for e in self.ends]}


def phase_parallel_path(dev, counters):
    """``path parallel``: config 4's full shapes on one card, in a world
    of one over ``nccl``: ``distributed.initialize``, ``make_mesh``,
    ``place_state``, 32 frames of ``halo.sharded_render_frame`` on one
    slab (K5's halo instance), ``shard_display`` and ``reinhard`` (K2);
    one frame on the volume z-sharded between frames
    (``sharded_scene(shard_volume=True)``) against the replicated frame;
    one ``bucketed_train_step`` of the data-parallel EAM fit at ``path fit
    eam``'s size (K3, K4); ``save_sharded`` / ``load_sharded`` of the
    state; a DOS frame of the 512³ scene at 1024² through
    ``dos_halo.sharded_render_frame`` on one band (K9's band instance);
    and phase 2 of the config-4 recipe (``config4_pod512.fit_phase``: the
    sharded MCM gradient of the 512³ volume at 1024², K3's slab instance
    and K4, 3 SGD steps with ``rehalo``: finite losses and a slab that
    moved; whether the loss descends is printed, not required, since
    vpt_tpu's recipe fails that check at its own default size).  Every
    launch counter at 0 first.  Prints the frame time, events/s, the
    step times and the peak memory.  After the counts are read: a halo
    frame against ``shard_render_frame``'s replicated K5 frame (bit for
    bit) and both timed in turns at 1024²; one halo frame from the reset
    state against the plain loop; the DOS band frame against the plain
    band (``band_slice_plain``, bit for bit) and the cooperative K9 frame;
    K3's slab instance and K4 at the fit's shapes
    (:func:`slab_kernels_agree`); the display's K2 against
    ``tonemap_plain``.
    Returns the launches and those comparisons' max abs errors by
    kernel."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vpt_tpu_torch import tonemap, transfer, volume
    from vpt_tpu_torch.examples import config4_pod512
    from vpt_tpu_torch.kernels import tonemap_kernel
    from vpt_tpu_torch.parallel import (distributed, gather_state,
                                        make_mesh, place_state,
                                        shard_display, shard_render_frame,
                                        sharded_scene)
    from vpt_tpu_torch.parallel import dos_halo, halo
    from vpt_tpu_torch.renderers import dos, make_scene, mcm
    from vpt_tpu_torch.runtime import checkpoint

    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    check(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                 retries=2, retry_delay=1.0),
          "path parallel: no process group")
    try:
        check("nccl" in dist.get_backend(), "path parallel: not nccl")
        print(f"path parallel: {distributed.topology_summary()}",
              flush=True)
        grid = make_mesh(1)
        t0 = time.perf_counter()
        scene = make_scene(volume.blobs_volume(PARALLEL_VOLUME, seed=3),
                           transfer.gray_ramp(alpha_scale=0.9))
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        table_bytes = scene.volume_packed.numel() * 4
        params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
        for module in counters.values():
            module.LAUNCHES = 0
        halo.COLLECTIVES.clear()
        whole = mcm.reset(params, PARALLEL_RES, PARALLEL_RES, scene)
        state = place_state(whole, grid)
        frame_fn, slabs = halo.sharded_render_frame(mcm, grid, scene, 1,
                                                    whole)
        rs = np.random.default_rng(4)
        seeds = [np.float32(rs.random(dtype=np.float32))
                 for _ in range(PARALLEL_SPP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for n, seed in enumerate(seeds, 1):
            frame_fn(state, slabs, params, seed, n)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        shown = shard_display(mcm, grid, whole)(state, scene, params)
        image = tonemap.ToneMapper("reinhard")(shown)
        torch.cuda.synchronize()
        _check_display("path parallel", shown, image, PARALLEL_RES)
        events = PARALLEL_RES * PARALLEL_RES * params.steps * PARALLEL_SPP
        samples = float(state["samples"].mean())
        check(samples > 1.0, f"path parallel: {samples} samples a pixel")
        target = gather_state(state["radiance"], grid, PARALLEL_RES)

        # the volume z-sharded between frames: the replicated frame
        frame = shard_render_frame(mcm, grid, whole)
        zslabs = sharded_scene(scene, grid, shard_volume=True)
        a, b = _clone(state), _clone(state)
        frame(a, scene, params, np.float32(0.77), PARALLEL_SPP + 1)
        frame(b, zslabs, params, np.float32(0.77), PARALLEL_SPP + 1)
        torch.cuda.synchronize()
        for k in a:
            check(torch.equal(a[k], b[k]), f"path parallel: the z-sharded "
                  f"frame's {k} differs from the replicated one")
        del zslabs, a, b

        # DOS at 1024² on one band, through the halo exchange
        dparams = dos.Params()
        dwhole = dos.reset(dparams, PARALLEL_RES, PARALLEL_RES, scene)
        dframe, dhalo = dos_halo.sharded_render_frame(
            grid, scene, dparams, PARALLEL_RES, PARALLEL_RES, donate=False)
        band = dframe(place_state(dwhole, grid), scene, dparams, 0.0, 1)
        torch.cuda.synchronize()

        # the data-parallel EAM step, its gradient bucketed over data
        step = bucketed_eam_step(grid, 64)
        before = (counters["corner_gather"].LAUNCHES,
                  counters["corner_scatter"].LAUNCHES,
                  counters["corner_scatter_bucket"].LAUNCHES)
        step_s = []
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with BucketTimeline() if i else contextlib.nullcontext() \
                    as order:
                loss = step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(loss)), "path parallel: loss")
        eam_peak = torch.cuda.max_memory_allocated()
        k3, k4_whole, k4 = ((counters[k].LAUNCHES - b) // 2 for k, b in zip(
            ("corner_gather", "corner_scatter", "corner_scatter_bucket"),
            before))
        check(k4 == 4 and k4_whole == 0, f"path parallel: the bucketed EAM "
              f"step launched K4's bucket instance {k4} times and the whole "
              f"table's {k4_whole} times a step")
        check(order.order == [x for b in range(4)
                              for x in (("scatter", b), ("reduce", b))],
              f"path parallel: the bucketed EAM step's order {order.order}")

        # a sharded checkpoint of the state, written in the background
        ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "smoke", "parallel_ckpt")
        t0 = time.perf_counter()
        pending = checkpoint.save_sharded(ckpt, "mcm", state, PARALLEL_SPP,
                                          params, extra={"seed0": 4},
                                          wait=False, mesh=grid,
                                          height=PARALLEL_RES)
        issued_s = time.perf_counter() - t0
        pending.wait_until_finished()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        key, loaded, frame_number, _ = checkpoint.load_sharded(ckpt,
                                                               mesh=grid)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(key == "mcm" and frame_number == PARALLEL_SPP,
              "path parallel: checkpoint metadata")
        for k in state:
            check(torch.equal(loaded[k], state[k]),
                  f"path parallel: checkpoint leaf {k} differs")
        state_bytes = sum(v.numel() * 4 for v in state.values())
        forward_peak = max(peak_before, torch.cuda.max_memory_allocated()) \
            / 2 ** 30

        # phase 2 of the config-4 recipe: the sharded gradient of the 512³
        # volume on one slab, 3 SGD steps
        del slabs, loaded
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        halo.COLLECTIVES.clear()
        fit_before = counters["corner_scatter_bucket"].LAUNCHES
        losses, fit_s, fit_coll, fitted = config4_pod512.fit_phase(
            grid, scene, params, target, 3, 4, 1, "cuda",
            say=lambda *a: print("path parallel config 4 fit:", *a,
                                 flush=True))
        fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fit_k4 = (counters["corner_scatter_bucket"].LAUNCHES - fit_before) \
            / len(fit_s)
        check(all(np.isfinite(losses)), f"path parallel: fit losses "
              f"{losses}")
        moved = float((fitted[0, :-1] - torch.clamp(
            scene.volume * 0.6, 0.0, 1.0)).abs().max())
        check(bool(torch.isfinite(fitted).all()) and moved > 0.0,
              "path parallel: the fit's SGD steps left the slab as it was")
        # the recipe's closing check (losses[-1] < losses[0]) is read, not
        # required: vpt_tpu's recipe fails it at its own default size (a
        # fixed seed's MC value is stepwise constant in the voxels;
        # ROADMAP queue 3)
        descended = losses[-1] < losses[0]
        del fitted
        launches = {k: m.LAUNCHES for k, m in counters.items()}
        check(launches["mcm_event"] == 2,
              f"path parallel: {launches['mcm_event']} K5 launches")
        check(launches["mcm_event_halo"]
              == (params.steps + 1) * PARALLEL_SPP,
              f"path parallel: {launches['mcm_event_halo']} K5 halo "
              "launches")
        check(launches["tonemap"] == 1, "path parallel: K2 launches")

        # the halo frame against shard_render_frame's replicated K5 frame,
        # and both timed in turns; against the plain loop from the reset
        # state; DOS's band against the cooperative frame; K2's display
        # against its plain tone map (comparison launches: not the path's)
        slabs = halo.place_scene_slabs(scene, 1, 0)
        a, b = _clone(state), _clone(state)
        frame_fn(a, slabs, params, np.float32(0.91), PARALLEL_SPP + 1)
        frame(b, scene, params, np.float32(0.91), PARALLEL_SPP + 1)
        torch.cuda.synchronize()
        for k in a:
            check(torch.equal(a[k], b[k]), f"path parallel: the halo "
                  f"frame's {k} differs from shard_render_frame's K5 frame")
        turns = in_turns({
            "halo": lambda: frame_fn(a, slabs, params, np.float32(0.5), 2),
            "whole": lambda: frame(b, scene, params, np.float32(0.5), 2)},
            10)

        def sharded(st, seed):
            frame_fn(st, slabs, params, seed, 1)

        agree, k5_err = _frames_agree(scene, params, PARALLEL_RES,
                                      PARALLEL_RES, 1,
                                      "path parallel config 4 halo",
                                      render=sharded)
        plain_band = band_frame_plain(
            place_state(dwhole, grid), scene, dparams, (0, PARALLEL_RES),
            dos_halo._exchange(grid, "data", dhalo, 0))
        torch.cuda.synchronize()
        for k in band:
            check(torch.equal(band[k], plain_band[k]), f"path parallel: the "
                  f"1024^2 DOS band's {k} differs from band_slice_plain's")
        del plain_band
        coop = dos.reset(dparams, PARALLEL_RES, PARALLEL_RES, scene)
        dos.render_frame(coop, scene, dparams, 0.0, 1)
        torch.cuda.synchronize()
        k9_err, k9_share = dos_bands_agree("path parallel", band, coop,
                                           3e-5, 0.9)
        slab_check = slab_kernels_agree(
            scene, event_positions(state, scene, params, np.float32(0.3)))
        plain_image = tonemap_kernel.tonemap_plain(shown, "reinhard")
        torch.cuda.synchronize()
        k2_err = float((image - plain_image).abs().max())
        # powf differs from PyTorch's by a few ulps on O(1) values, as in
        # phase_tonemap
        check(torch.allclose(image, plain_image, rtol=1e-6, atol=1e-6),
              f"path parallel: K2's {PARALLEL_RES}^2 display max abs err "
              f"{k2_err} against tonemap_plain")
        print(f"path parallel: config 4 full ({PARALLEL_VOLUME}^3 blobs, "
              f"float32 tables {table_bytes} bytes, a slab's {table_bytes} "
              f"on one slab, built in {scene_s:.3f} s), MCM "
              f"{PARALLEL_RES}^2 steps 8 x {PARALLEL_SPP} frames through "
              f"halo.sharded_render_frame: {run_s * 1e3 / PARALLEL_SPP:.4f} "
              f"ms a frame (host clock), {events / run_s:.6g} events/s, "
              f"mean samples {samples:.4f}; in turns a halo frame "
              f"{turns['halo']:.4f} ms ({params.steps + 1} launches, "
              f"{halo.COLLECTIVES.get('all_reduce', 0)} all-reduces on one "
              f"slab) against shard_render_frame's K5 frame "
              f"{turns['whole']:.4f} ms, equal bit for bit; the z-sharded "
              f"frame equal to the replicated one; from the reset state "
              f"against the plain loop: samples agree {agree}, radiance max "
              f"abs err {k5_err}; DOS 1024^2 through dos_halo (halo "
              f"{dhalo} rows, one band) equal to band_slice_plain's bit for "
              f"bit, against the cooperative K9 frame max abs err {k9_err} "
              f"(bound 3e-5), {k9_share:.6f} of the values within 1e-6 "
              f"(bound 0.9); {slab_check['text']}; K2's display against "
              f"tonemap_plain max abs err {k2_err} (atol 1e-6, rtol 1e-6); "
              f"bucketed EAM step (64^3, 4 views 256^2, 64 slices, 4 "
              f"buckets) {step_s[0]:.4f} s first, {step_s[1]:.4f} s second, "
              f"{k3} K3, {k4} K4 bucket and {k4_whole} whole-table K4 "
              f"launches a step, peak memory {eam_peak / 2 ** 30:.3f} GiB "
              f"({(eam_peak - held) / 2 ** 30:.3f} above the "
              f"{held / 2 ** 30:.3f} held before it), the second step's "
              f"scatters and reductions issued "
              + ", ".join(f"{k} {b}" for k, b in order.order)
              + f", loss {float(loss):.6g}; save_sharded "
              f"{state_bytes} bytes {save_s:.3f} s ({issued_s:.3f} s to "
              f"return), load_sharded {load_s:.3f} s; peak memory "
              f"{forward_peak:.3f} GiB; config 4 fit ({PARALLEL_VOLUME}^3, "
              f"{PARALLEL_RES}^2, 2 frames, 4 buckets, one slab): losses "
              f"{', '.join(f'{x:.9g}' for x in losses)}, "
              f"{', '.join(f'{x:.3f}' for x in fit_s)} s a step, "
              f"{fit_k4:g} K4 bucket launches a step, "
              f"descending {descended} (read, not required: ROADMAP queue "
              f"3), the slab moved up to {moved:.3g}, "
              f"collectives a step {fit_coll}, peak memory {fit_peak:.3f} "
              f"GiB; launches: "
              + ", ".join(f"{k} {v}" for k, v in launches.items())
              + f"; {time.perf_counter() - t_all:.1f} s", flush=True)
        del slabs, a, b
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        frames_launches, frames_errors, frames_turns = halo_frames_path(
            grid, scene, counters, PARALLEL_RES)
        print(f"path halo frames: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        resident_launches, resident_rows = phase_resident_path(grid, scene,
                                                               counters)
        print(f"path resident: {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        dist.destroy_process_group()
    del scene, state
    torch.cuda.empty_cache()
    return launches, {"mcm_event": k5_err, "tonemap": k2_err,
                      "mcm_event_halo": k5_err, "dos_band": k9_err,
                      "corner_gather_slab": slab_check["k3_err"],
                      "corner_scatter": slab_check["k4_err"]}, {
        "halo_ms_1024": turns["halo"], "whole_ms_1024": turns["whole"],
        "slab_fit_device_ms": slab_check["k3_device_ms"],
        "slab_fit_bound_ms": slab_check["k3_bound_ms"],
        "fit_losses": losses, "fit_step_s": fit_s,
        "fit_peak_gib": fit_peak, "forward_peak_gib": forward_peak,
        "fit_k4_bucket_per_step": fit_k4, "eam_step_s": step_s,
        "eam_peak_gib": eam_peak / 2 ** 30,
        "eam_peak_above_gib": (eam_peak - held) / 2 ** 30,
        "eam_k4_bucket_per_step": k4, "eam_k3_per_step": k3,
        "resident_launches": resident_launches,
        "resident_rows": resident_rows, "frames_launches": frames_launches,
        "frames_errors": frames_errors, "frames_turns": frames_turns}


#: the two-rank check's image and frames, on the one card over gloo
GLOO_RES, GLOO_FRAMES = 512, 4


def gloo_scene():
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    return make_scene(volume.blobs_volume(128, seed=3),
                      transfer.gray_ramp(alpha_scale=0.9))


def gloo_frames(mesh, scene, shard_volume):
    """The MCM frames (config 4's Params; rows over ``data``) and one EAM
    frame (the volume z-sharded over ``space`` when ``shard_volume``) of
    the two-rank check, gathered: ``(mcm state, eam image)``; with
    ``mesh`` None, the renderers' own frames in one process."""
    import numpy as np

    from vpt_tpu_torch.parallel import (gather_state, place_state,
                                        shard_render_frame, sharded_scene)
    from vpt_tpu_torch.renderers import eam, mcm

    params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
    state = mcm.reset(params, GLOO_RES, GLOO_RES, scene)
    image = eam.reset(eam.Params(), GLOO_RES, GLOO_RES, scene)
    if mesh is None:
        for n in range(1, GLOO_FRAMES + 1):
            mcm.render_frame(state, scene, params, np.float32(0.1 * n), n)
        return state, eam.render_frame(image, scene, eam.Params(),
                                       np.float32(0.5), 1)
    frame = shard_render_frame(mcm, mesh, state)
    rows = place_state(state, mesh)
    for n in range(1, GLOO_FRAMES + 1):
        frame(rows, scene, params, np.float32(0.1 * n), n)
    sc = sharded_scene(scene, mesh, shard_volume=shard_volume)
    band = shard_render_frame(eam, mesh, image)(
        place_state(image, mesh), sc, eam.Params(), np.float32(0.5), 1)
    return (gather_state(rows, mesh, GLOO_RES),
            gather_state(band, mesh, GLOO_RES))


#: the two-rank check's EAM fit: one 128² view of a 64³ volume, and its
#: SGD rate (the gradient's largest entry is ~3e-6: a step of up to ~0.03)
GLOO_FIT_RES, GLOO_FIT_LR = 128, 1e4


def gloo_fit(mesh, shard_volume):
    """The EAM fit's loss, whole volume gradient and the whole volume after
    one step of ``torch.optim.SGD(lr=GLOO_FIT_LR)`` (clipped to [0, 1]):
    through ``shard.eam_value_and_grad``
    and ``shard.data_parallel_train_step`` on ``mesh`` (the volume this
    rank's z slab when ``shard_volume``; then also the step's loss), or
    with ``mesh`` None in one process through ``train.render_eam``'s
    autograd.  Every input is made from seeds on the card, alike in every
    process."""
    import numpy as np
    import torch

    from vpt_tpu_torch import train, volume
    from vpt_tpu_torch.parallel import mesh as meshmod
    from vpt_tpu_torch.parallel import shard

    truth = volume.blobs_volume(64, seed=1).data
    tf, params, views, targets = eam_fit_views(truth, count=1,
                                               res=GLOO_FIT_RES)
    cams, target = views[0], targets[0]
    vol = volume.blobs_volume(64, seed=2).data
    seed = np.float32(0.0)
    if mesh is None:
        leaf = vol.clone().requires_grad_(True)
        loss = train.mse_rgb(train.render_eam(
            leaf, tf, cams, params, seed, GLOO_FIT_RES, GLOO_FIT_RES),
            target)
        grad, = torch.autograd.grad(loss, leaf)
        stepped = torch.add(vol, grad, alpha=-GLOO_FIT_LR)
        return float(loss.detach()), grad, torch.clamp(stepped, 0.0, 1.0)
    depth = vol.shape[0]
    z0, z1 = meshmod.block_of(depth, mesh, ("space",))
    mine = vol[z0:z1] if shard_volume else vol
    loss, grads = shard.eam_value_and_grad(
        mine, tf, cams, target, params, seed, mesh,
        shard_volume=shard_volume)
    step = shard.data_parallel_train_step(
        lambda p: torch.optim.SGD(p, lr=GLOO_FIT_LR), mesh, params=params,
        shard_volume=shard_volume)
    step_loss, stepped, _, _ = step(mine, tf, None, cams, target, seed)
    grad = grads["volume"]
    if shard_volume:
        grad = shard.gather_blocks(grad, depth, mesh, ("space",))
        stepped = shard.gather_blocks(stepped, depth, mesh, ("space",))
    return float(loss), grad, stepped, float(step_loss)


#: the two-rank halo check: the volume, the image and the frames
GLOO_HALO_VOLUME, GLOO_HALO_RES, GLOO_HALO_FRAMES = 256, 512, 2


def gloo_halo(mesh, scene):
    """The two-rank check's halo frames (config 4's Params) on ``mesh``'s
    ``space`` slabs, gathered over ``data``; with ``mesh`` None one
    process's K5 frames on the whole scene."""
    import numpy as np

    from vpt_tpu_torch.parallel import gather_state, place_state
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.parallel.mesh import axis_size
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
    state = mcm.reset(params, GLOO_HALO_RES, GLOO_HALO_RES, scene)
    if mesh is None:
        for n in range(1, GLOO_HALO_FRAMES + 1):
            mcm.render_frame(state, scene, params, np.float32(0.1 * n), n)
        return state
    frame_fn, slabs = halo.sharded_render_frame(
        mcm, mesh, scene, axis_size(mesh, "space"), state)
    rows = place_state(state, mesh)
    for n in range(1, GLOO_HALO_FRAMES + 1):
        frame_fn(rows, slabs, params, np.float32(0.1 * n), n)
    return gather_state(rows, mesh, GLOO_HALO_RES)


def gloo_eam_scene(truth_seed=2):
    """The two-rank gradient check's scene: ``gloo_fit``'s 64³ volume,
    TF and view as a Scene (``halo_grad`` reads the camera from it), its
    target and Params."""
    import dataclasses

    from vpt_tpu_torch import volume
    from vpt_tpu_torch.renderers import make_scene

    truth = volume.blobs_volume(64, seed=1).data
    tf, params, views, targets = eam_fit_views(truth, count=1,
                                               res=GLOO_FIT_RES)
    vol = volume.blobs_volume(64, seed=truth_seed).data
    mvp_inverse, model_view, projection = views[0]
    scene = dataclasses.replace(make_scene(vol, tf, pack=False),
                                mvp_inverse=mvp_inverse,
                                model_view=model_view, projection=projection)
    return scene, targets[0], params


def gloo_halo_grad(mesh):
    """The sharded EAM gradient (``halo_grad.make_sharded_grad`` with
    ``eam.generate`` as the estimator) of ``gloo_eam_scene`` on ``mesh``'s
    ``space`` slabs: the loss and the whole gradient, joined."""
    import numpy as np

    from vpt_tpu_torch.parallel import shard
    from vpt_tpu_torch.parallel.halo_grad import (make_sharded_grad,
                                                  place_slabs)
    from vpt_tpu_torch.parallel.mesh import axis_size
    from vpt_tpu_torch.renderers import eam

    scene, target, params = gloo_eam_scene()
    slabs = axis_size(mesh, "space")

    def expected(sc, p, h, w, frames, seed0=0.0, score_floor=None):
        return eam.generate(sc, p, np.float32(seed0), h, w)

    grad_fn = make_sharded_grad(mesh, scene, params, GLOO_FIT_RES,
                                GLOO_FIT_RES, 1, slabs, expected=expected,
                                num_buckets=2)
    loss, body = grad_fn(place_slabs(scene.volume, mesh, slabs), target,
                         0.0)
    return float(loss), shard.gather_blocks(body, slabs, mesh, ("space",)
                                            ).reshape(scene.volume.shape)


#: the two-rank bucketed EAM step: its volume (``path parallel``'s views,
#: Params and buckets)
GLOO_BUCKET_VOLUME, GLOO_BUCKETS = 256, 4


def gloo_bucketed(mesh):
    """Two steps of :func:`bucketed_eam_step` on a GLOO_BUCKET_VOLUME³
    volume, rows over ``mesh``'s ``data`` (one gradient reduction a bucket
    over gloo), the second recorded by a :class:`BucketTimeline`: its
    seconds, the losses, the K4 bucket launches a step, the order and the
    times."""
    import numpy as np
    import torch

    from vpt_tpu_torch.kernels import corner_scatter

    step = bucketed_eam_step(mesh, GLOO_BUCKET_VOLUME)
    before = corner_scatter.BUCKET_LAUNCHES
    losses = [float(step())]
    with BucketTimeline() as timeline:
        losses.append(float(step()))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - timeline.t0
    return {"losses": losses, "step_s": seconds,
            "k4_bucket": (corner_scatter.BUCKET_LAUNCHES - before) // 2,
            "order": timeline.order, **timeline.times(),
            "finite": bool(np.isfinite(losses).all())}


def gloo_dos(mesh, scene):
    """One DOS frame (default Params, 512²) through
    ``dos_halo.sharded_render_frame`` on ``mesh``'s ``data`` bands,
    gathered, and the halo width; with ``mesh`` None one process's
    cooperative K9 frame."""
    from vpt_tpu_torch.parallel import dos_halo, gather_state, place_state
    from vpt_tpu_torch.renderers import dos

    params = dos.Params()
    state = dos.reset(params, GLOO_RES, GLOO_RES, scene)
    if mesh is None:
        return dos.render_frame(state, scene, params, 0.0, 1), 0
    frame_fn, width = dos_halo.sharded_render_frame(mesh, scene, params,
                                                    GLOO_RES, GLOO_RES)
    rows = frame_fn(place_state(state, mesh), scene, params, 0.0, 1)
    return gather_state(rows, mesh, GLOO_RES), width


def gloo_rank(rank, world, store, out):
    """One rank of the two-rank check: a ``gloo`` group whose collectives
    take the card's tensors; rank 0 writes the gathered frames to
    ``out``."""
    import torch
    import torch.distributed as dist

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        scene = gloo_scene()
        rows = make_mesh(world, axes=("data",))
        mcm_event.LAUNCHES = 0
        state, _ = gloo_frames(rows, scene, False)
        k5 = mcm_event.LAUNCHES
        slabs = make_mesh(world, space=world)
        _, image = gloo_frames(slabs, scene, True)
        # the data-parallel EAM step: all-reduced over data, and
        # reduce-scattered into z slabs over space
        fits = {"rows": gloo_fit(rows, False), "slabs": gloo_fit(slabs, True)}
        # the spatially sharded half: halo frames on 2 slabs of a 256³
        # scene, the sharded EAM gradient on 2 slabs, DOS on 2 bands
        from vpt_tpu_torch import transfer, volume
        from vpt_tpu_torch.kernels import dos_sweep
        from vpt_tpu_torch.parallel import halo
        from vpt_tpu_torch.renderers import make_scene

        mcm_event.HALO_LAUNCHES = dos_sweep.BAND_LAUNCHES = 0
        halo.COLLECTIVES.clear()
        big = make_scene(volume.blobs_volume(GLOO_HALO_VOLUME, seed=3),
                         transfer.gray_ramp(alpha_scale=0.9))
        halo_state = gloo_halo(slabs, big)
        # path resident's two-rank cases, outside the halo's counts
        counted = (dict(halo.COLLECTIVES), mcm_event.HALO_LAUNCHES)
        resident_out = gloo_resident(slabs, big, rg_scene(128))
        frames_out = _cpu(gloo_halo_frames(slabs, big))
        # each rank's halo frame counts, which must equal the other's
        torch.save(halo_frame_counts(frames_out), f"{out}.counts{rank}")
        halo.COLLECTIVES.clear()
        halo.COLLECTIVES.update(counted[0])
        mcm_event.HALO_LAUNCHES = counted[1]
        del big
        halo_launches = mcm_event.HALO_LAUNCHES
        grad = gloo_halo_grad(slabs)
        dos_state, dos_halo_rows = gloo_dos(rows, scene)
        collectives = dict(halo.COLLECTIVES)
        t0 = time.perf_counter()
        bucketed = gloo_bucketed(rows)
        bucketed["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"state": {k: v.cpu() for k, v in state.items()},
                        "image": image.cpu(), "k5": k5,
                        "fits": {k: tuple(x.cpu() if torch.is_tensor(x)
                                          else x for x in v)
                                 for k, v in fits.items()},
                        "halo": {k: v.cpu() for k, v in halo_state.items()},
                        "halo_launches": halo_launches,
                        "halo_grad": (grad[0], grad[1].cpu()),
                        "dos": {k: v.cpu() for k, v in dos_state.items()},
                        "dos_halo_rows": dos_halo_rows,
                        "band_launches": dos_sweep.BAND_LAUNCHES,
                        "collectives": collectives,
                        "bucketed": bucketed,
                        "resident": resident_out,
                        "halo_frames": frames_out}, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gloo_bucketed_line(got):
    """``path parallel gloo``'s bucketed EAM step (:func:`gloo_bucketed`),
    checked (finite, 4 K4 bucket launches, a reduction issued after each
    launch and before the next) and put in words: each bucket's reduction
    issued and finished, the last launch's end, and the overlap window
    from bucket 0's issue to that end, in ms from the recorded step's
    start."""
    import numpy as np

    k = GLOO_BUCKETS
    check(got["finite"] and all(np.isfinite(got["losses"])),
          f"path parallel gloo: the bucketed step's losses {got['losses']}")
    check(got["k4_bucket"] == k, f"path parallel gloo: {got['k4_bucket']} "
          "K4 bucket launches a step")
    check(got["order"] == [x for b in range(k)
                           for x in (("scatter", b), ("reduce", b))],
          f"path parallel gloo: the bucketed step's order {got['order']}")
    last = got["scatter_end_ms"][-1]
    window = last - got["issued_ms"][0]
    return (f"bucketed EAM step ({GLOO_BUCKET_VOLUME}^3, 4 views 256^2, 64 "
            f"slices, {k} buckets, rows over data = 2): losses "
            f"{', '.join(f'{x:.6g}' for x in got['losses'])}, the second "
            f"step {got['step_s']:.4f} s on rank 0, {got['k4_bucket']} K4 "
            "bucket launches a step; from the step's start, bucket b's "
            "reduction issued / finished (host clock, the work's future) "
            "and its K4 launch's end (CUDA event): " + "; ".join(
                f"{b}: {i:.3f} / "
                + ("not measured" if f is None else f"{f:.3f}")
                + f" ms, K4 end {e:.3f} ms"
                for b, (i, f, e) in enumerate(zip(
                    got["issued_ms"], got["finished_ms"],
                    got["scatter_end_ms"])))
            + f"; the last K4 ended at {last:.3f} ms: overlap window "
            f"{window:.3f} ms from bucket 0's issue; {got['seconds']:.1f} s "
            "for both steps and their set-up")


def phase_parallel_gloo(dev):
    """Two ranks on the one card over ``gloo`` (whose collectives take
    CUDA tensors): the MCM frames with their rows split in two and an EAM
    frame on the volume z-sharded over ``space``, assembled, against the
    world-one frames of this process, bit for bit; the data-parallel EAM
    gradient and step (:func:`gloo_fit`) against this process's; the
    spatially sharded half with ``space`` = 2 (every collective runs): the
    halo MCM frames (:func:`gloo_halo`, 256³ at 512²) against one
    process's K5 frames bit for bit, the sharded EAM gradient
    (:func:`gloo_halo_grad`) against ``train.render_eam``'s within 1e-5 of
    its largest entry, and a DOS frame through ``dos_halo`` on ``data`` =
    2 (:func:`gloo_dos`) against the cooperative K9 frame within 1e-6
    (:func:`dos_bands_agree`)."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from vpt_tpu_torch import train, transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    t0 = time.perf_counter()
    scene = gloo_scene()
    want_state, want_image = gloo_frames(None, scene, False)
    want_loss, want_grad, want_step = (
        x.cpu() if torch.is_tensor(x) else x for x in gloo_fit(None, False))
    want_dos, _ = gloo_dos(None, scene)
    big = make_scene(volume.blobs_volume(GLOO_HALO_VOLUME, seed=3),
                     transfer.gray_ramp(alpha_scale=0.9))
    want_halo = gloo_halo(None, big)
    want_rg = gloo_halo(None, rg_scene(128))
    want_frames = _cpu(gloo_halo_frames(None, big))
    del big
    escene, etarget, eparams = gloo_eam_scene()
    leaf = escene.volume.clone().requires_grad_(True)
    cams = (escene.mvp_inverse, escene.model_view, escene.projection)
    eloss = train.mse_rgb(train.render_eam(
        leaf, escene.transfer, cams, eparams, np.float32(0.0), GLOO_FIT_RES,
        GLOO_FIT_RES), etarget)
    egrad, = torch.autograd.grad(eloss, leaf)
    eloss, egrad = float(eloss.detach()), egrad.cpu()
    torch.cuda.synchronize()
    del scene, escene, leaf
    torch.cuda.empty_cache()
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke")
    os.makedirs(folder, exist_ok=True)
    store = tempfile.mktemp(dir=folder, prefix="gloo_store_")
    out = os.path.join(folder, "gloo_frames.pt")
    mp.start_processes(gloo_rank, args=(2, store, out), nprocs=2,
                       start_method="spawn")
    got = torch.load(out, weights_only=False)
    for k, v in want_state.items():
        check(torch.equal(got["state"][k], v.cpu()),
              f"path parallel gloo: MCM {k} differs from the world-one "
              "frame")
    check(torch.equal(got["image"], want_image.cpu()),
          "path parallel gloo: the z-sharded EAM frame differs")
    # the loss within 1e-6 (tests/test_parallel.py's bound); the gradient
    # within 1e-5 of its largest entry (each rank's K4 scatters its rows'
    # share, summed over the group, in another order than one process's),
    # so the stepped volume within GLOO_FIT_LR times that, plus 1e-6 for
    # its own rounding
    gmax = float(want_grad.abs().max())
    check(gmax > 0.0, "path parallel gloo: the fit's gradient is 0")
    grad_bound = 1e-5 * gmax
    step_bound = GLOO_FIT_LR * grad_bound + 1e-6
    fit_errs = {}
    for name, (loss, grad, stepped, step_loss) in got["fits"].items():
        errs = (abs(loss - want_loss), float((grad - want_grad).abs().max()),
                float((stepped - want_step).abs().max()),
                abs(step_loss - want_loss))
        fit_errs[name] = errs
        check(errs[0] <= 1e-6 and errs[3] <= 1e-6,
              f"path parallel gloo: the {name} EAM loss {loss} / "
              f"{step_loss} against {want_loss}")
        check(errs[1] <= grad_bound, f"path parallel gloo: the {name} "
              f"gradient max abs err {errs[1]} (bound {grad_bound})")
        check(errs[2] <= step_bound, f"path parallel gloo: the {name} SGD "
              f"step's volume max abs err {errs[2]} (bound {step_bound})")
    for k, v in want_halo.items():
        check(torch.equal(got["halo"][k], v.cpu()),
              f"path parallel gloo: the halo frame's {k} (2 slabs) differs "
              "from one process's K5 frame")
    check(got["halo_launches"] == (8 + 1) * GLOO_HALO_FRAMES,
          f"path parallel gloo: {got['halo_launches']} K5 halo launches")
    hloss, hgrad = got["halo_grad"]
    hscale = float(egrad.abs().max())
    herr = float((hgrad - egrad).abs().max())
    check(hscale > 0.0 and herr <= 1e-5 * hscale,
          f"path parallel gloo: the sharded EAM gradient max abs err {herr} "
          f"(bound {1e-5 * hscale})")
    check(abs(hloss - eloss) <= 1e-6 * max(abs(eloss), 1e-30) + 1e-9,
          f"path parallel gloo: the sharded EAM loss {hloss} against "
          f"{eloss}")
    check_gloo_resident(got["resident"], want_halo, want_rg)
    print("path parallel gloo: "
          + check_gloo_halo_frames(got["halo_frames"], want_frames,
                                   torch.load(f"{out}.counts1")),
          flush=True)
    derr, dshare = dos_bands_agree("path parallel gloo", got["dos"],
                                   want_dos, 1e-6, 1.0)
    check(got["band_launches"] > 0, "path parallel gloo: no K9 band launch")
    print("path parallel gloo: " + gloo_bucketed_line(got["bucketed"]),
          flush=True)
    print(f"path parallel gloo: halo MCM {GLOO_HALO_VOLUME}^3 at "
          f"{GLOO_HALO_RES}^2 x {GLOO_HALO_FRAMES} frames on 2 slabs "
          f"({got['halo_launches']} K5 halo launches on rank 0) equal bit "
          f"for bit to one process's K5 frames; the sharded EAM gradient "
          f"(64^3 on 2 slabs, 2 buckets, one {GLOO_FIT_RES}^2 view) against "
          f"train.render_eam's: loss err {abs(hloss - eloss):.3g}, gradient "
          f"max abs err {herr:.3g} (bound {1e-5 * hscale:.3g}); DOS "
          f"{GLOO_RES}^2 through dos_halo on 2 bands (halo "
          f"{got['dos_halo_rows']} rows, {got['band_launches']} K9 band "
          f"launches on rank 0) against the cooperative K9 frame max abs "
          f"err {derr:.3g} (bound 1e-6), {dshare:.6f} within 1e-6; "
          f"collectives on rank 0 "
          f"{got['collectives']}", flush=True)
    print(f"path parallel gloo: 2 ranks on one card over gloo (CUDA "
          f"tensors): MCM {GLOO_RES}^2 x {GLOO_FRAMES} frames, rows split "
          f"in two ({got['k5']} K5 launches on rank 0), and an EAM frame on "
          f"the 128^3 volume z-sharded over space: equal bit for bit to the "
          f"world-one frames; data_parallel_train_step (64^3, one "
          f"{GLOO_FIT_RES}^2 view, SGD lr {GLOO_FIT_LR:g}) against one "
          f"process's "
          f"train.render_eam gradient (max |grad| {gmax:.6g}), rows over "
          f"data (all-reduce) / z slabs over space (reduce-scatter): loss "
          f"err {fit_errs['rows'][0]:.3g} / {fit_errs['slabs'][0]:.3g}, "
          f"gradient max abs err {fit_errs['rows'][1]:.3g} / "
          f"{fit_errs['slabs'][1]:.3g}, stepped volume "
          f"{fit_errs['rows'][2]:.3g} / {fit_errs['slabs'][2]:.3g} (bounds "
          f"1e-6, {grad_bound:.3g}, {step_bound:.3g}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


#: the four-rank check: rows over data = 2 and slabs over space = 2 on the
#: one card over gloo, a 128³ volume at 256²
GLOO4_VOLUME, GLOO4_RES = 128, 256


def gloo4_cases():
    """The four-rank check's frames: (renderer key, Params), default
    Params."""
    from vpt_tpu_torch.renderers import dos, lao

    return (("lao", lao.Params()), ("dos", dos.Params()))


def gloo4_rank(rank, world, store, out):
    """One rank of the four-rank check: a ``gloo`` group whose collectives
    take the card's tensors, a (2, 2) mesh.  The launch counts of K10 and
    K9 are set to 0, then one LAO frame and one DOS frame (a sweep's
    first) of :func:`gloo_scene` through ``halo.sharded_render_frame`` on
    this rank's rows and slab (K10's halo instance; DOS's band of rows
    through K9's halo band instance), and the counts and collectives read;
    then the same rows through ``shard.shard_render_frame`` on the whole
    scene (K10 with a row window, K9's band instance).  Rank 0 writes the
    gathered frames, the counts and its collectives to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vpt_tpu_torch.kernels import dos_sweep, lao_march
    from vpt_tpu_torch.parallel import (gather_state, halo, make_mesh,
                                        place_state, shard_render_frame)

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        scene = gloo_scene()
        mesh = make_mesh(world, space=2)
        cases = gloo4_cases()
        wholes = {key: renderer_module(key).reset(params, GLOO4_RES,
                                                  GLOO4_RES, scene)
                  for key, params in cases}
        torch.cuda.synchronize()
        for name in ("LAUNCHES", "HALO_LAUNCHES"):
            setattr(lao_march, name, 0)
        for name in ("LAUNCHES", "BAND_LAUNCHES", "HALO_LAUNCHES",
                     "HALO_BAND_LAUNCHES"):
            setattr(dos_sweep, name, 0)
        halo.COLLECTIVES.clear()
        t0 = time.perf_counter()
        halo_frames = {}
        for key, params in cases:
            frame_fn, slabs = halo.sharded_render_frame(
                renderer_module(key), mesh, scene, 2, wholes[key])
            halo_frames[key] = frame_fn(place_state(_clone(wholes[key]),
                                                    mesh),
                                        slabs, params, np.float32(0.0), 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"lao_halo": lao_march.HALO_LAUNCHES,
                    "lao_march": lao_march.LAUNCHES,
                    "dos_halo_band": dos_sweep.HALO_BAND_LAUNCHES,
                    "dos_band": dos_sweep.BAND_LAUNCHES,
                    "dos_sweep": dos_sweep.LAUNCHES,
                    "dos_halo": dos_sweep.HALO_LAUNCHES}
        collectives = dict(halo.COLLECTIVES)
        gathered = {key: gather_state(v, mesh, GLOO4_RES)
                    for key, v in halo_frames.items()}
        whole_frames = {}
        for key, params in cases:
            module = renderer_module(key)
            rows = shard_render_frame(module, mesh, wholes[key])(
                place_state(_clone(wholes[key]), mesh), scene, params,
                np.float32(0.0), 1)
            whole_frames[key] = gather_state(rows, mesh, GLOO4_RES)
        torch.cuda.synchronize()
        grads = gloo4_halo_grad(mesh, scene)
        if rank == 0:
            torch.save({"halo": _cpu(gathered),
                        "whole": _cpu(whole_frames), "launches": launches,
                        "collectives": collectives, "seconds": seconds,
                        "halo_grad": grads}, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


#: the four-rank sharded gradient's bucket counts
GLOO4_BUCKETS = (1, 4)


def gloo4_halo_grad(mesh, scene):
    """``halo_grad.make_sharded_grad`` of an EAM loss (64 slices, a target
    of 0.4) on the four-rank mesh's 2 slabs of :func:`gloo_scene` at
    GLOO4_RES², rows over ``data`` = 2, with each of GLOO4_BUCKETS: the
    loss, the gradient joined over ``space`` (host), the planes of each
    gradient reduction over ``data`` in the order issued, the step's
    collectives, its seconds and its buckets' depth."""
    import numpy as np
    import torch

    from vpt_tpu_torch.parallel import halo, halo_grad, shard
    from vpt_tpu_torch.renderers import eam

    params = eam.Params(slices=64, random=False)

    def expected(sc, p, h, w, frames, seed0=0.0, score_floor=None):
        return eam.generate(sc, p, np.float32(seed0), h, w)

    target = torch.full((GLOO4_RES, GLOO4_RES, 3), 0.4, device="cuda")
    slabs = halo_grad.place_slabs(scene.volume, mesh, 2)
    reduced, real = [], halo_grad.all_reduce_async

    def counting(t, group):
        reduced.append(int(t.shape[0]))
        return real(t, group)

    halo_grad.all_reduce_async = counting
    out = {}
    try:
        for nb in GLOO4_BUCKETS:
            grad_fn = halo_grad.make_sharded_grad(
                mesh, scene, params, GLOO4_RES, GLOO4_RES, 1, 2,
                expected=expected, num_buckets=nb)
            reduced.clear()
            halo.COLLECTIVES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = grad_fn(slabs, target, 0.0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out[nb] = (float(loss), shard.gather_blocks(
                g, 2, mesh, ("space",)).reshape(scene.volume.shape).cpu(),
                list(reduced), dict(halo.COLLECTIVES), seconds,
                scene.volume.shape[0] // 2 // nb)
    finally:
        halo_grad.all_reduce_async = real
    return out


def gloo4_halo_grad_line(got):
    """The four-rank sharded gradient (:func:`gloo4_halo_grad`) checked:
    one reduction over ``data`` a bucket (the last bucket's with the halo
    plane), the buckets' gradient within 1e-5 of the largest entry of the
    one-bucket gradient and the same loss; put in words."""
    words = []
    base_loss, base = got[1][:2]
    scale = float(base.abs().max())
    check(scale > 0.0, "path parallel gloo 4: the sharded gradient is 0")
    for nb, (loss, grad, reduced, collectives, seconds, depth) in \
            got.items():
        check(reduced == [depth] * (nb - 1) + [depth + 1],
              f"path parallel gloo 4: {nb} buckets reduced planes "
              f"{reduced} over data")
        err = float((grad - base).abs().max())
        check(loss == base_loss and err <= 1e-5 * scale,
              f"path parallel gloo 4: {nb} buckets' loss {loss} / "
              f"{base_loss}, gradient max abs err {err:.3g}")
        words.append(f"{nb} bucket(s): {len(reduced)} data all-reduces a "
                     f"step (planes {reduced}), collectives {collectives}, "
                     f"{seconds:.3f} s, gradient max abs err {err:.3g} "
                     "against one bucket's")
    return ("halo_grad.make_sharded_grad (EAM, 64 slices, 2 slabs, data "
            f"2) on {GLOO4_VOLUME}^3 at {GLOO4_RES}^2: " + "; ".join(words))


def phase_parallel_gloo4(dev):
    """Four ranks on the one card over ``gloo``, ``data`` = 2 × ``space`` =
    2 (:func:`gloo4_rank`): the LAO frame and the DOS sweep's first frame
    of a 128³ scene at 256² through ``halo.sharded_render_frame``, with
    their launch counts (K10's halo instance ceil(64 / 8) + 1 times a rank,
    K9's halo band instance ceil(n / 8) + n for n active slices, no
    whole-scene K10 or K9 instance) and rank 0's collectives (LAO one
    all-reduce a chunk of 8 slices; DOS one all-gather over ``data`` a
    slice and one all-reduce over ``space`` a chunk of 8 active slices);
    DOS's frame equals ``shard_render_frame``'s on the whole scene bit for
    bit and is within :func:`dos_bands_agree`'s bounds of the 1024² band
    (3e-5, 90% of the values within 1e-6) of one process's cooperative K9
    frame; LAO's, whose ranks sum their own AO taps before the all-reduce,
    is within K10's bound (:func:`halo_states_agree`, and at most 1e-5) of
    ``shard_render_frame``'s and of one process's K10 frame.  Returns
    (launches, errors by JSON name, seconds of the frames)."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from vpt_tpu_torch.renderers import dos

    t0 = time.perf_counter()
    scene = gloo_scene()
    want = {}
    for key, params in gloo4_cases():
        state = renderer_module(key).reset(params, GLOO4_RES, GLOO4_RES,
                                           scene)
        want[key] = _cpu(renderer_module(key).render_frame(
            state, scene, params, np.float32(0.0), 1))
    lao_params, dos_params = (p for _, p in gloo4_cases())
    active = dos.active_slices(dos.reset(dos_params, GLOO4_RES, GLOO4_RES,
                                         scene), dos_params)
    torch.cuda.synchronize()
    del scene
    torch.cuda.empty_cache()
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke")
    os.makedirs(folder, exist_ok=True)
    store = tempfile.mktemp(dir=folder, prefix="gloo4_store_")
    out = os.path.join(folder, "gloo4_frames.pt")
    mp.start_processes(gloo4_rank, args=(4, store, out), nprocs=4,
                       start_method="spawn")
    got = torch.load(out, weights_only=False)
    launches = got["launches"]
    from vpt_tpu_torch.kernels import lao_march

    chunks = -(-lao_params.slices // 8)
    check(launches["lao_halo"] == lao_march.halo_frame_launches(lao_params)
          and launches["lao_march"] == 0,
          f"path parallel gloo 4: K10 launches {launches}")
    check(launches["dos_halo_band"] == -(-active // 8) + active
          and launches["dos_band"] == launches["dos_sweep"]
          == launches["dos_halo"] == 0,
          f"path parallel gloo 4: K9 launches {launches} for {active} "
          "active slices")
    check(got["collectives"] == {"all_reduce": chunks + -(-active // 8),
                                 "all_gather": active},
          f"path parallel gloo 4: collectives {got['collectives']}")
    a, b = got["halo"]["dos"], got["whole"]["dos"]
    for k in b:
        check(torch.equal(a[k], b[k]), f"path parallel gloo 4: the halo dos "
              f"{k} differs from shard_render_frame's whole-scene frame")
    # K10's halo instance sums each rank's AO taps before the all-reduce
    # (csrc/lao_march.cu): over 2 slabs its frame is within K10's bound of
    # the whole-scene frames (99.99% of the values within 1e-6, none
    # further than 1e-5), bit for bit on one slab
    lerr = max(halo_states_agree("path parallel gloo 4 lao against "
                                 "shard_render_frame", "lao",
                                 got["halo"]["lao"], got["whole"]["lao"],
                                 False),
               halo_states_agree("path parallel gloo 4 lao against one "
                                 "process's K10", "lao", got["halo"]["lao"],
                                 want["lao"], False))
    check(lerr <= 1e-5, f"path parallel gloo 4: LAO max abs err {lerr:.3g} "
          "(bound 1e-5)")
    derr, dshare = dos_bands_agree("path parallel gloo 4", got["halo"]["dos"],
                                   want["dos"], 3e-5, 0.9)
    print("path parallel gloo 4: " + gloo4_halo_grad_line(got["halo_grad"]),
          flush=True)
    print(f"path parallel gloo 4: 4 ranks on one card over gloo, data 2 x "
          f"space 2, {GLOO4_VOLUME}^3 at {GLOO4_RES}^2: LAO ({chunks + 1} "
          f"K10 halo launches a rank) and DOS's first frame ({active} active "
          f"slices, {launches['dos_halo_band']} K9 halo band launches a "
          f"rank) through halo.sharded_render_frame in "
          f"{got['seconds']:.3f} s on rank 0; DOS equal bit for bit to "
          f"shard_render_frame's whole-scene frame, against the cooperative "
          f"K9 frame max abs err {derr:.3g} (bound 3e-5), {dshare:.6f} "
          f"within 1e-6; LAO within K10's bound of shard_render_frame's and "
          f"one process's K10 frames (max abs err {lerr:.3g}, bound 1e-5); "
          f"collectives on rank 0 {got['collectives']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, {"dos_halo_band": derr, "lao_halo": lerr}, \
        got["seconds"]


class LaunchCounter:
    """A counter of launches kept under another name in a module (a
    kernel's second instance, e.g. ``mcm_event.HALO_LAUNCHES``), with the
    ``LAUNCHES`` attribute the phases set to 0 and read."""

    def __init__(self, module, name):
        self._module, self._name = module, name

    @property
    def LAUNCHES(self):  # noqa: N802 — the modules' counter name
        return getattr(self._module, self._name)

    @LAUNCHES.setter
    def LAUNCHES(self, value):  # noqa: N802
        setattr(self._module, self._name, value)


#: the slab fetch's positions (256² photons) and slabs
SLAB_POSITIONS, SLAB_COUNT = 256 * 256, 4


def halo_frame_bytes(steps, skip, values=1):
    """Bytes a pixel of a frame of ``steps`` events over a HaloScene, the
    least that any split of the event around the all-reduce moves: the
    photon's state (56 bytes: position, direction, transmittance,
    radiance, bounces, samples; 60 with cheb-skip) in and out once an
    event, plus the value (``values`` floats: 2 for a two-channel volume;
    out before the all-reduce, in after) and the stream (out, in) across
    it; the frame's first flight reads only the position, direction (and
    cheb), its last interaction writes no value or stream.  K5's halo
    instance moves exactly this (csrc/mcm_event.cu, ArgsHalo: the
    interaction redraws the flight from the saved stream instead of
    storing the tentative position or the free path)."""
    state = 60 if skip else 56
    carry = 4 * values + 4
    first = (28 if skip else 24) + carry
    return first + (steps - 1) * 2 * (state + carry) + (state + carry) \
        + state
#: float32 operations of a slab fetch beyond the whole fetch's (the
#: owner's division, clip and compare, the local plane)
SLAB_OPS = 40
#: likewise through the slab's plane map (K10 halo, K9's halo fetch):
#: the owner's compare and the select of 0; the map's load places the cell
PLANE_OPS = 2


def slab_scenes():
    """The scenes of the slab check: the headline's 128³ sphere (bf16
    tables, cheb-skip, ``tf_mxu``), a float32 blobs 128³ and a
    two-channel blobs 128³ (:func:`rg_scene`)."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    headline = make_scene(volume.sphere_volume(128),
                          transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                          tracking="auto", pack_dtype=torch.bfloat16,
                          tf_mxu=True)
    f32 = make_scene(volume.blobs_volume(128, seed=3),
                     transfer.gray_ramp(alpha_scale=0.8))
    return {"headline": headline, "float32": f32, "rg": rg_scene(128)}


def rg_scene(n):
    """A two-channel scene: ``with_gradient_magnitude(blobs_volume(n))``
    with the gray ramp (bf16 corner rows and packed 2D TF)."""
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    return make_scene(volume.with_gradient_magnitude(
        volume.blobs_volume(n, seed=3)), transfer.gray_ramp(alpha_scale=0.8))


def phase_slab_fetch(scenes):
    """K3's slab instance against its plain twin and the whole-table
    fetch: on each scene, SLAB_COUNT slabs' masked fetches of 256²
    positions (uniform in [-0.1, 1.1]³, NaN in a few) each equal the
    plain twin bit for bit (values, cells with -1 where masked,
    fractions), and their sum equals K3's whole-table fetch bit for bit;
    interleaved thin slabs (interleave 2) and unmasked fetches
    (``resident.py``'s) equal their plain twins bit for bit.  Then slab
    0's fetch timed against the whole
    fetch in turns (CUDA events and device time), its plain twin, and its
    bound (the positions read, the values written, the distinct owned
    rows read once).  Returns the row's numbers."""
    import torch

    from vpt_tpu_torch.kernels import corner_gather
    from vpt_tpu_torch.parallel import halo

    g = torch.Generator().manual_seed(11)
    pos = torch.rand(SLAB_POSITIONS, 3, generator=g) * 1.2 - 0.1
    pos[:4, 0] = float("nan")
    pos = pos.cuda()
    worst = 0.0
    for label, scene in scenes.items():
        shape = tuple(scene.volume.shape)
        whole = corner_gather.corner_fetch(scene.volume_packed, shape, pos)
        total = torch.zeros_like(whole)
        for k in range(SLAB_COUNT):
            rows = halo.slab_table(scene.volume_packed, shape, SLAB_COUNT, k)
            got = corner_gather.slab_fetch(rows, shape, k, SLAB_COUNT, 1,
                                           pos, save=True)
            want = corner_gather.slab_fetch_plain(rows, shape, k, SLAB_COUNT,
                                                  1, pos, save=True)
            for a, b in zip(got, want):
                check(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)),
                      f"K3 slab {label} slab {k}/{SLAB_COUNT}: the kernel "
                      "differs from its plain twin")
            total = total + got[0]
        torch.cuda.synchronize()
        fine = ~torch.isnan(whole)
        check(torch.equal(total[fine], whole[fine])
              and torch.equal(torch.isnan(total), torch.isnan(whole)),
              f"K3 slab {label}: {SLAB_COUNT} slabs do not sum to the "
              "whole fetch")
        worst = max(worst, float((total[fine] - whole[fine]).abs().max()))
        for m, masked in ((2, True), (2, False), (1, False)):
            for k in range(2):
                thin = halo.slab_table(scene.volume_packed, shape, 2, k, m)
                got = corner_gather.slab_fetch(thin, shape, k, 2, m, pos,
                                               masked, save=True)
                want = corner_gather.slab_fetch_plain(thin, shape, k, 2, m,
                                                      pos, masked, save=True)
                for a, b in zip(got, want):
                    check(torch.equal(torch.nan_to_num(a),
                                      torch.nan_to_num(b)),
                          f"K3 slab {label} slab {k}/2 interleave {m} "
                          f"masked {masked}: the kernel differs from its "
                          "plain twin")
        torch.cuda.synchronize()
        print(f"corner_gather slab {label}: {SLAB_COUNT} slabs of "
              f"{SLAB_POSITIONS} positions equal their plain twins and sum "
              "to the whole-table fetch bit for bit; 2 slabs interleaved "
              "(m = 2, masked and unmasked) and contiguous unmasked equal "
              "their plain twins bit for bit", flush=True)
    scene = scenes["headline"]
    shape = tuple(scene.volume.shape)
    rows = halo.slab_table(scene.volume_packed, shape, SLAB_COUNT, 0)
    times = in_turns({
        "slab": lambda: corner_gather.slab_fetch(rows, shape, 0, SLAB_COUNT,
                                                 1, pos),
        "whole": lambda: corner_gather.corner_fetch(scene.volume_packed,
                                                    shape, pos)}, 200)
    device = device_turns({
        "slab": lambda: corner_gather.slab_fetch(rows, shape, 0, SLAB_COUNT,
                                                 1, pos),
        "whole": lambda: corner_gather.corner_fetch(scene.volume_packed,
                                                    shape, pos)},
        "fetch_kernel")
    plain_ms = cuda_ms(lambda: corner_gather.slab_fetch_plain(
        rows, shape, 0, SLAB_COUNT, 1, pos), 20)
    _, cells, _ = corner_gather.slab_fetch(rows, shape, 0, SLAB_COUNT, 1,
                                           pos, save=True)
    owned = cells[cells >= 0]
    row_bytes = rows.shape[1] * rows.element_size()
    nbytes = SLAB_POSITIONS * (12 + 4) + owned.unique().numel() * row_bytes
    ops = SLAB_POSITIONS * SLAB_OPS + owned.numel() * 30
    bound_ms, bound_by = roofline(nbytes, ops)
    print(f"corner_gather slab: slab 0 of {SLAB_COUNT} on the headline, "
          f"{SLAB_POSITIONS} positions: {times['slab']:.4f} ms a call "
          f"(whole-table fetch {times['whole']:.4f} ms), device "
          f"{fmt_ms(device['slab'])} (whole {fmt_ms(device['whole'])}); "
          f"plain twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes} bytes: {owned.numel()} owned samples, "
          f"{owned.unique().numel()} distinct rows)", flush=True)
    return {"max_abs_err": worst, "ms": times["slab"],
            "device_ms": device["slab"], "whole_ms": times["whole"],
            "whole_device_ms": device["whole"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_halo_event(scene):
    """K5's halo instance against its plain twin: on each of 2 slabs of
    the headline (no group: a slab's own masked values), 2 frames at 512²
    equal ``event_frame_plain`` over the same HaloScene bit for bit; on
    one slab the frames equal the whole-frame K5's bit for bit.  Then a
    one-slab halo frame timed against the whole-frame K5 at 512²
    (:func:`halo_row`).  Returns the row's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, 512, 512, scene)
    worst = 0.0
    for count in (2, 1):
        for k in range(count):
            hs = halo.halo_scene(scene, k, count)
            got = {key: v.clone() for key, v in state.items()}
            want = {key: v.clone() for key, v in state.items()}
            for n in (1, 2):
                seed = np.float32(0.1 * n)
                mcm.render_frame(got, hs, params, seed, n)
                if count == 1:
                    mcm.render_frame(want, scene, params, seed, n)
                else:
                    mcm_event.event_frame_plain(
                        want, dataclasses.replace(hs, kernels=False), params,
                        seed)
            torch.cuda.synchronize()
            for key in want:
                check(torch.equal(got[key], want[key]),
                      f"K5 halo slab {k}/{count}: {key} differs from "
                      + ("the whole-frame K5" if count == 1
                         else "the plain twin"))
            worst = max(worst, float((got["radiance"]
                                      - want["radiance"]).abs().max()))
    print("mcm_event halo: 2 frames at 512^2 on each of 2 slabs equal the "
          "plain loop over the HaloScene bit for bit, and on one slab the "
          "whole-frame K5 bit for bit", flush=True)
    return {"max_abs_err": worst,
            **halo_row("headline", scene, state, params)}


def halo_row(label, scene, state, params):
    """A one-slab halo frame from ``state`` timed against the whole-frame
    K5 in turns (CUDA events; device time of its steps + 1 launches), the
    plain twin's frame, and the bound: :func:`halo_frame_bytes` a pixel
    (a value pair on a two-channel scene), the distinct corner rows and
    the event kernel's operations (:func:`event_bound`'s, which the whole
    frame's equal), with the frame's share of it.  Returns the row's
    numbers but its error."""
    import dataclasses

    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.parallel import halo

    hs = halo.halo_scene(scene, 0, 1)
    a, b, c = _clone(state), _clone(state), _clone(state)
    frames = {"halo": lambda: mcm_event.event_frame(a, hs, params, 0.3),
              "whole": lambda: mcm_event.event_frame(b, scene, params, 0.3)}
    times = in_turns(frames, 20)
    device = device_turns(frames, "mcm_", reps=10)
    # the profiler's mean a launch: times the frame's steps + 1 launches
    if device["halo"] is not None:
        device["halo"] *= params.steps + 1
    plain_ms = cuda_ms(lambda: mcm_event.event_frame_plain(
        c, dataclasses.replace(hs, kernels=False), params, 0.3), 2)
    d = _clone(state)
    mcm_event.event_frame(d, scene, params, 0.3)
    deposits = float(d["samples"].sum(dtype=torch.float64)
                     - state["samples"].sum(dtype=torch.float64))
    work = event_work(scene, state, params, 0.3)
    height, width = state["samples"].shape
    n = height * width
    skip = "cheb" in state
    state_bytes = 60 if skip else 56
    _, _, whole_bytes, ops = event_bound(scene, n, params.steps, deposits,
                                         work["rows"],
                                         state_bytes=state_bytes)
    pixel = halo_frame_bytes(params.steps, skip, values=scene.channels)
    nbytes = whole_bytes - 2 * n * state_bytes + n * pixel
    bound_ms, bound_by = roofline(nbytes, ops)
    share = None if device["halo"] is None else bound_ms / device["halo"]
    table = scene.tracking_packed if skip else scene.volume_packed
    occ = mcm_event.halo_occupancy(table.dtype, scene.transfer_1d.shape[0],
                                   channels=scene.channels)
    print(f"mcm_event halo {label}: one slab, {height}x{width} steps "
          f"{params.steps}: {times['halo']:.4f} ms a frame "
          f"({params.steps + 1} launches; whole-frame K5 "
          f"{times['whole']:.4f} ms), device {fmt_ms(device['halo'])} "
          f"(whole {fmt_ms(device['whole'])}); plain twin {plain_ms:.4f} "
          f"ms; bound {bound_ms:.4f} ms ({bound_by}, {nbytes} bytes, "
          f"{pixel} a pixel of state, value and stream), "
          + ("share not measured" if share is None
             else f"{share:.3f} of it") +
          f"; {occ['registers']} registers, {occ['local_bytes']} local "
          f"bytes, {occ['blocks_per_sm']} blocks an SM", flush=True)
    return {"ms": times["halo"], "device_ms": device["halo"],
            "whole_ms": times["whole"], "whole_device_ms": device["whole"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bound_share": share,
            "registers": occ["registers"], "local_bytes": occ["local_bytes"]}


def phase_halo_layouts(scenes):
    """K5's halo instance on the slab layouts and the two-channel fetch:
    on the headline at 512², 2 slabs interleaved (m = 2) and 2 slabs
    unmasked (``collective=False``) each equal the plain loop over the
    same HaloScene bit for bit; on the two-channel 128³ scene
    (:func:`rg_scene`) one slab's 2 frames equal K5's ext frames of the
    whole scene bit for bit, and each of 2 slabs' (masked, the value pair
    unsummed) its plain twin.  Then the two-channel halo frame on one slab
    timed against the ext frame (:func:`halo_row`).  Returns the row's
    numbers."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    head, rg = scenes["headline"], scenes["rg"]
    state = mcm.reset(params, 512, 512, head)
    for kw in ({"interleave": 2}, {"collective": False}):
        for k in range(2):
            hs = halo.halo_scene(head, k, 2, **kw)
            got, want = _clone(state), _clone(state)
            mcm.render_frame(got, hs, params, np.float32(0.1), 1)
            mcm_event.event_frame_plain(
                want, dataclasses.replace(hs, kernels=False), params,
                np.float32(0.1))
            torch.cuda.synchronize()
            for key in want:
                check(torch.equal(got[key], want[key]),
                      f"K5 halo {kw} slab {k}/2: {key} differs from the "
                      "plain twin")
    state = mcm.reset(params, 512, 512, rg)
    worst = 0.0
    for count in (1, 2):
        for k in range(count):
            hs = halo.halo_scene(rg, k, count)
            got, want = _clone(state), _clone(state)
            for n in (1, 2):
                seed = np.float32(0.1 * n)
                mcm.render_frame(got, hs, params, seed, n)
                if count == 1:
                    mcm.render_frame(want, rg, params, seed, n)
                else:
                    mcm_event.event_frame_plain(
                        want, dataclasses.replace(hs, kernels=False), params,
                        seed)
            torch.cuda.synchronize()
            for key in want:
                check(torch.equal(got[key], want[key]),
                      f"K5 halo two-channel slab {k}/{count}: {key} differs "
                      "from " + ("K5's ext frame" if count == 1
                                 else "the plain twin"))
            worst = max(worst, float((got["radiance"]
                                      - want["radiance"]).abs().max()))
    print("mcm_event halo layouts: 512^2 headline frames on 2 interleaved "
          "(m = 2) and 2 unmasked slabs equal the plain loop over the "
          "HaloScene bit for bit; two-channel 128^3 frames on one slab equal "
          "K5's ext frames, on 2 slabs the plain twin, bit for bit",
          flush=True)
    return {"max_abs_err": worst,
            **halo_row("two-channel 128^3", rg, state, params)}


# -- the halo instances of K6, K7, K8 and K9 ---------------------------------

#: the renderers whose frames run a halo instance of K6-K9 (the two-rank
#: check's), those of ``path parallel halo frames`` (K10's too), and the
#: instances' launch counters (``launches`` of the JSON rows)
HALO_FRAME_KEYS = ("eam", "mip", "depth", "iso", "mcs", "dos")
HALO_PATH_KEYS = HALO_FRAME_KEYS + ("lao",)
HALO_COUNTERS = {"march_halo": ("march", "HALO_LAUNCHES"),
                 "iso_shade_halo": ("iso_shade", "HALO_LAUNCHES"),
                 "mcs_halo": ("mcs_frame", "HALO_LAUNCHES"),
                 "dos_halo": ("dos_sweep", "HALO_LAUNCHES"),
                 "lao_halo": ("lao_march", "HALO_LAUNCHES")}
#: the whole-scene kernel each halo instance splits, by its counter name
HALO_WHOLE = {"march_halo": "march_frame", "iso_shade_halo": "iso_shade",
              "mcs_halo": "mcs_frame", "dos_halo": "dos_sweep",
              "lao_halo": "lao_march"}
#: the halo instance a renderer's halo frame runs, by renderer key
HALO_NAME = {"mcs": "mcs_halo", "dos": "dos_halo", "lao": "lao_halo"}


def halo_counters():
    """The halo instances' :class:`LaunchCounter` entries, by JSON name."""
    import importlib

    return {name: LaunchCounter(importlib.import_module(
        f"vpt_tpu_torch.kernels.{module}"), attr)
        for name, (module, attr) in HALO_COUNTERS.items()}


def march_halo_frame_bytes(pixels, marched, slices, channels, state_bytes):
    """Bytes of a K6 halo frame besides its corner rows, the least that a
    split of the march around one all-reduce a frame moves: the state in
    and out once (``state_bytes`` each, of every pixel), and each of the
    ``slices`` samples' values (4 bytes, 8 for a pair) of every pixel whose
    ray meets the cube (``marched``: a miss moves no value) out and in
    across the all-reduce.  K6's halo instance moves exactly this (544
    bytes a marched pixel at 64 slices of one channel)."""
    return pixels * 2 * state_bytes + marched * slices * 2 * 4 * channels


def iso_halo_display_bytes(pixels, hits, channels):
    """Bytes of a K7 halo display besides its corner rows: every pixel's
    state read once and the image written once (32 bytes a pixel), and a
    hit's seven values (4 bytes, 8 a pair) out and in across the
    all-reduce and its slot's pixel index written and read (8 bytes)."""
    return pixels * 2 * 16 + hits * (2 * 7 * 4 * channels + 2 * 4)


def mcs_halo_frame_bytes(pixels, fetches, channels):
    """Bytes of a K8 halo frame besides its corner rows, a lower bound of
    any split of the tracking around one all-reduce a fetch: the state in
    and out once, and across each fetch's all-reduce the pixel's carry
    (stream 4, phase 4, tracking 16) and value (4, 8 a pair) out and in
    (the diffuse colour's round trip is not counted)."""
    return pixels * 2 * 16 + fetches * 2 * (24 + 4 * channels)


def dos_halo_frame_bytes(pixels, active, channels):
    """Bytes a K9 halo frame moves besides the cooperative sweep's
    (:func:`dos_work`): each active slice's value a pixel (4 bytes, 8 a
    pair) out and in across the all-reduce of its chunk."""
    return pixels * active * 2 * 4 * channels


def kernel_means(fn, reps=10):
    """{kernel name: mean device ms a launch} of the card's kernels over
    ``reps`` calls of ``fn`` (torch.profiler, after a warm-up call); {}
    when the window recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and e.device_time_total > 0}


def halo_turns(halo, whole, launches, reps=10, rounds=2,
               whole_launches=None):
    """Median device ms a call of ``halo`` and of ``whole`` ((callable,
    kernel-name part) each), in turns (H W W H, ``rounds`` times): a call's
    time is the profiler's mean a launch of each matching kernel times its
    launches a call, ``launches(name)`` for the halo call (the profiler may
    drop launches, so its total is not used); ``whole_launches(name)``, by
    default 1, for the whole frame.  None where no window recorded the
    kernel."""
    times = {"halo": [], "whole": []}
    calls = {"halo": halo, "whole": whole}
    counts = {"halo": launches, "whole": whole_launches or (lambda k: 1)}
    for _ in range(rounds):
        for name in ("halo", "whole", "whole", "halo"):
            fn, part = calls[name]
            means = {k: v for k, v in kernel_means(fn, reps).items()
                     if part in k}
            if means:
                times[name].append(sum(v * counts[name](k)
                                       for k, v in means.items()))
    return {k: sorted(t)[len(t) // 2] if t else None
            for k, t in times.items()}


def halo_frame_states(key, scene, params, height, width, slabs=(1, 0),
                      display=False, **kw):
    """One frame of renderer ``key`` from its reset over the HaloScene of
    slab ``slabs`` = (count, index) (no group), and the same frame through
    the whole-scene kernel and through the plain twin over the same
    HaloScene: ``(halo, whole, plain)`` states; with ``display`` (ISO) the
    three displays of the whole-scene kernel's frame."""
    import dataclasses

    from vpt_tpu_torch.kernels import dos_sweep, iso_shade, march, mcs_frame
    from vpt_tpu_torch.parallel import halo

    module = renderer_module(key)
    count, index = slabs
    hs = halo.halo_scene(scene, index, count, **kw)
    ref = dataclasses.replace(hs, kernels=False)
    state = module.reset(params, height, width, scene)
    got, whole, plain = _clone(state), _clone(state), _clone(state)
    seed = 0.0 if key == "dos" else 0.37
    if display:
        module.render_frame(whole, scene, params, seed, 1)
        return (iso_shade.shade(whole, hs, params),
                iso_shade.shade(whole, scene, params),
                iso_shade.iso_shade_plain(whole, ref, params))
    module.render_frame(got, hs, params, seed, 1)
    module.render_frame(whole, scene, params, seed, 1)
    if key == "mcs":
        mcs_frame.mcs_frame_plain(plain, ref, params, seed, 1)
    elif key == "dos":
        dos_sweep.sweep_frame_plain(plain, ref, params)
    else:
        march.march_frame_plain(key, plain, ref, params, seed, 1)
    return got, whole, plain


def halo_states_agree(label, key, got, want, exact):
    """``got`` equals ``want`` bit for bit (``exact``), else within the
    kernel's bound of its plain version (PERF.md §2): at least 99.99% of
    the values within 1e-6 (EAM, MIP, MCS, DOS: its colour and occlusion,
    the depth equal), equal for Depth, ISO and ISO's display.  Returns the
    largest difference."""
    import torch

    got = got if isinstance(got, dict) else {"state": got}
    want = want if isinstance(want, dict) else {"state": want}
    worst = 0.0
    for k in want:
        check(bool(torch.isfinite(got[k]).all()), f"{label}: {k} not "
              "finite")
        if exact or key in ("depth", "iso") or k not in ("state", "color",
                                                         "occlusion"):
            check(torch.equal(got[k], want[k]), f"{label}: {k} differs "
                  + ("bit for bit" if exact else "from the plain twin"))
            continue
        diff = (got[k] - want[k]).abs()
        share = float((diff <= 1e-6).float().mean())
        check(share >= 0.9999, f"{label}: {k} {share:.6f} of the values "
              "within 1e-6 (bound 0.9999)")
        worst = max(worst, float(diff.max()))
    return worst


def mcs_halo_slowest(state, hs, params, seed, n):
    """L + 1 of a K8 halo frame from ``state`` (L the slowest pixel's
    fetches): the frame's launches with a batch of one launch, a read
    after each, on a copy of the state."""
    from vpt_tpu_torch.kernels import mcs_frame

    batch = mcs_frame.HALO_BATCH
    mcs_frame.HALO_BATCH = 1
    try:
        return mcs_frame.halo_mcs_frame(state.clone(), hs, params, seed, n)
    finally:
        mcs_frame.HALO_BATCH = batch


def halo_kernel_rows(label, scene, params_of, res=512):
    """The halo instances of K6 (each mode), K7, K8 and K9 on ``scene`` at
    ``res``²: on one slab each frame (ISO's display) equals the whole-scene
    kernel's bit for bit; on 2 slabs (no group, contiguous and interleave
    2) each slab's frame is within the kernel's bound of the plain twin
    over the same HaloScene; then on one slab each timed in turns against
    the whole-scene kernel (:func:`halo_turns`), with its launches a frame,
    the loop ms, the plain twin's ms, registers and spills and its bound:
    the whole frame's corner rows and operations (K6: :func:`march_work`,
    K7: :func:`shade_work`, K8: the whole frame's own count of its fetches
    and :func:`mcs_work`'s rows, K9: :func:`dos_work`) plus the
    ``*_frame_bytes`` of the split.  Returns {JSON name: fields}."""
    import dataclasses

    import torch

    from vpt_tpu_torch.kernels import dos_sweep, iso_shade, march, mcs_frame
    from vpt_tpu_torch.kernels import tf1d
    from vpt_tpu_torch.parallel import halo

    n = res * res
    channels = scene.channels
    tf_mode = tf1d.mode_code(scene.tf_mxu)
    hs = halo.halo_scene(scene, 0, 1)
    ref = dataclasses.replace(hs, kernels=False)
    worst = {name: 0.0 for name in HALO_COUNTERS}
    name_of = {"eam": "march_halo", "mip": "march_halo",
               "depth": "march_halo", "iso": "march_halo",
               "mcs": "mcs_halo", "dos": "dos_halo"}
    # equality on one slab, the plain twin on 2 slabs
    for key in HALO_FRAME_KEYS:
        params = params_of(key)
        got, whole, _ = halo_frame_states(key, scene, params, res, res)
        halo_states_agree(f"{label} {key} halo one slab", key, got, whole,
                          True)
        if key == "iso":
            disp, want, _ = halo_frame_states(key, scene, params, res, res,
                                              display=True)
            halo_states_agree(f"{label} iso display halo one slab", key,
                              disp, want, True)
        for count, index, m in ((2, 0, 1), (2, 1, 2)):
            got, _, plain = halo_frame_states(
                key, scene, params, res, res, (count, index), interleave=m)
            err = halo_states_agree(
                f"{label} {key} halo slab {index}/{count} m{m}", key, got,
                plain, False)
            worst[name_of[key]] = max(worst[name_of[key]], err)
            if key == "iso":
                got, _, plain = halo_frame_states(
                    key, scene, params, res, res, (count, index),
                    display=True, interleave=m)
                halo_states_agree(f"{label} iso display halo slab {index}/"
                                  f"{count} m{m}", key, got, plain, False)
        torch.cuda.synchronize()
    print(f"{label} halo frames: EAM, MIP, Depth, ISO (frame, display), "
          f"MCS, DOS at {res}^2 on one slab equal their whole-scene "
          "kernels' bit for bit; on 2 slabs (contiguous, interleave 2) "
          "within their kernels' bounds of the plain twins", flush=True)

    rows = {}
    table = scene.volume_packed
    row_bytes = table.shape[1] * table.element_size()
    # K6: every mode timed, the row's own numbers EAM's
    k6 = {}
    for key in ("eam", "mip", "depth", "iso"):
        module = renderer_module(key)
        params = params_of(key)
        state = module.reset(params, res, res, scene)
        module.render_frame(state, scene, params, 0.4, 1)
        a, b, c = state.clone(), state.clone(), state.clone()
        slices = params.slices if key in ("eam", "depth") else params.steps
        per_frame = 2

        def halo_call(a=a, key=key, params=params):
            march.march_frame(key, a, hs, params, 0.5, 2)

        t = halo_turns(
            (halo_call, "march_halo_"),
            (lambda: march.march_frame(key, b, scene, params, 0.5, 2),
             "march_kernel" if channels == 1 else "march_ext_kernel"),
            lambda k: 1)
        split = {k.split("march_halo_")[1].split("_kernel")[0]: v
                 for k, v in kernel_means(halo_call).items()
                 if "march_halo_" in k}
        ms = in_turns({
            "halo": halo_call,
            "whole": lambda: march.march_frame(key, b, scene, params, 0.5,
                                               2)}, 10, rounds=1)
        plain_ms = cuda_ms(lambda: march.march_frame_plain(
            key, c, ref, params, 0.5, 2), 1)
        samples, distinct, _, miss = march_work(key, scene, params, 0.5,
                                                res, res)
        marched = n - int(miss.sum())
        split_bytes = march_halo_frame_bytes(n, marched, slices, channels,
                                             4 if key == "mip" else 16)
        nbytes = distinct * row_bytes + tf_row_bytes(scene) + split_bytes
        ops = samples * (MARCH_OPS_SAMPLE + SLAB_OPS) + n * MARCH_OPS_PIXEL
        bound_ms, bound_by = roofline(nbytes, ops)
        occ = [march.halo_occupancy(key, table.dtype,
                                    scene.transfer_1d.shape[0], tf_mode,
                                    channels=channels, stage=stage,
                                    depth=scene.volume.shape[0])
               for stage in (0, 1)]
        share = None if t["halo"] is None else bound_ms / t["halo"]
        print(f"march halo {label} {key}: one slab, {res}^2, {slices} "
              f"slices: {ms['halo']:.4f} ms a frame ({per_frame} launches, "
              f"1 all-reduce with a group; whole-frame K6 "
              f"{ms['whole']:.4f} ms), device {fmt_ms(t['halo'])} (whole "
              f"{fmt_ms(t['whole'])}"
              + (f", {t['halo'] / t['whole']:.3f}x" if t["halo"]
                 and t["whole"] else "")
              + "; fetch " + fmt_ms(split.get("fetch")) + ", fold "
              + fmt_ms(split.get("fold"))
              + f"); plain twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}, {nbytes} bytes: {samples} samples, {distinct} "
              f"distinct rows, {split_bytes} bytes of state and values), "
              + ("share not measured" if share is None
                 else f"{share:.3f} of it")
              + f"; pixel-slices fetched {marched * slices}, folded "
              f"{samples}; fetch {occ[0]['registers']} registers, "
              f"{occ[0]['local_bytes']} spill bytes, "
              f"{occ[0]['blocks_per_sm']} blocks an SM; fold "
              f"{occ[1]['registers']} registers, {occ[1]['local_bytes']} "
              f"spill bytes, {occ[1]['blocks_per_sm']} blocks an SM",
              flush=True)
        k6[key] = {"ms": ms["halo"], "device_ms": t["halo"],
                   "fetch_device_ms": split.get("fetch"),
                   "fold_device_ms": split.get("fold"),
                   "whole_ms": ms["whole"], "whole_device_ms": t["whole"],
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_share": share,
                   "launches_a_frame": per_frame,
                   "fetched_pixel_slices": marched * slices,
                   "folded_pixel_slices": samples,
                   "registers": [o["registers"] for o in occ],
                   "local_bytes": [o["local_bytes"] for o in occ]}
    row = dict(k6["eam"])
    for key, fields in k6.items():
        for k, v in fields.items():
            row[f"{k}_{key}"] = v
    rows["march_halo"] = row

    # K7: ISO's display
    iso = renderer_module("iso")
    params = params_of("iso")
    state = iso.reset(params, res, res, scene)
    iso.render_frame(state, scene, params, 0.4, 1)
    t = halo_turns((lambda: iso.display(state, hs, params), "iso_halo_"),
                   (lambda: iso.display(state, scene, params),
                    "iso_shade_kernel" if channels == 1
                    else "iso_shade_ext_kernel"),
                   lambda k: 1)
    split = {k.split("iso_halo_")[1].split("_kernel")[0]: v
             for k, v in kernel_means(
                 lambda: iso.display(state, hs, params)).items()
             if "iso_halo_" in k}
    ms = in_turns({"halo": lambda: iso.display(state, hs, params),
                   "whole": lambda: iso.display(state, scene, params)}, 20,
                  rounds=1)
    plain_ms = cuda_ms(lambda: iso_shade.iso_shade_plain(state, ref,
                                                         params), 2)
    hits, distinct = shade_work(scene, state, params.gradient_step)
    nbytes = distinct * row_bytes + tf_row_bytes(scene) \
        + iso_halo_display_bytes(n, hits, channels)
    ops = hits * (7 * (SHADE_OPS_TAP + SLAB_OPS) + SHADE_OPS_PIXEL)
    bound_ms, bound_by = roofline(nbytes, ops)
    occ = [iso_shade.halo_occupancy(stage, table.dtype, tf_mode,
                                    channels=channels) for stage in (0, 1)]
    share = None if t["halo"] is None else bound_ms / t["halo"]
    print(f"iso_shade halo {label}: one slab, {res}^2, {hits} hits: "
          f"{ms['halo']:.4f} ms a display (2 launches, 1 all-reduce of "
          f"{7 * hits * channels} values with a group; whole K7 "
          f"{ms['whole']:.4f} ms), device {fmt_ms(t['halo'])} (whole "
          f"{fmt_ms(t['whole'])}; fetch {fmt_ms(split.get('fetch'))}, shade "
          f"{fmt_ms(split.get('shade'))}); plain twin "
          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes} bytes), "
          + ("share not measured" if share is None else f"{share:.3f} of it")
          + f"; fetch {occ[0]['registers']} registers, "
          f"{occ[0]['local_bytes']} spill bytes; shade {occ[1]['registers']}"
          f" registers, {occ[1]['local_bytes']} spill bytes", flush=True)
    rows["iso_shade_halo"] = {
        "ms": ms["halo"], "device_ms": t["halo"], "whole_ms": ms["whole"],
        "whole_device_ms": t["whole"], "plain_ms": plain_ms,
        "fetch_device_ms": split.get("fetch"),
        "shade_device_ms": split.get("shade"),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": share,
        "launches_a_frame": 2, "hits": hits,
        "registers": [o["registers"] for o in occ],
        "local_bytes": [o["local_bytes"] for o in occ]}

    # K8: MCS
    mcs = renderer_module("mcs")
    params = params_of("mcs")
    state = mcs.reset(params, res, res, scene)
    a, b, c = state.clone(), state.clone(), state.clone()
    slowest = mcs_halo_slowest(state, hs, params, 0.5, 2)
    reads = mcs_frame.HALO_READS
    per_frame = mcs_frame.halo_mcs_frame(state.clone(), hs, params, 0.5, 2)
    reads = mcs_frame.HALO_READS - reads
    batch = mcs_frame.HALO_BATCH
    check(slowest <= per_frame <= slowest - 1 + batch
          and reads <= -(-slowest // batch) + 1,
          f"{label} mcs halo: {per_frame} launches, {reads} reads with "
          f"L + 1 = {slowest}, B = {batch}")
    t = halo_turns((lambda: mcs_frame.halo_mcs_frame(a, hs, params, 0.5, 2),
                    "mcs_halo_"),
                   (lambda: mcs.render_frame(b, scene, params, 0.5, 2),
                    "mcs_frame_kernel" if channels == 1
                    else "mcs_frame_ext_kernel"),
                   lambda k: per_frame - 1 if "tail" in k else 1)
    ms = in_turns({
        "halo": lambda: mcs_frame.halo_mcs_frame(a, hs, params, 0.5, 2),
        "whole": lambda: mcs.render_frame(b, scene, params, 0.5, 2)}, 10,
        rounds=1)
    # the batch: each of 2, 4 and 8 timed in turns (the call's time to a
    # finished frame, host clock)
    def with_batch(k):
        def call():
            mcs_frame.HALO_BATCH = k
            mcs_frame.halo_mcs_frame(a, hs, params, 0.5, 2)
        return call

    batch_ms = {}
    for _ in range(2):
        for k in (2, 4, 8, 8, 4, 2):
            batch_ms.setdefault(k, []).append(synced_call_ms(with_batch(k),
                                                             10))
    mcs_frame.HALO_BATCH = batch
    batch_ms = {k: sorted(v)[len(v) // 2] for k, v in batch_ms.items()}
    call_ms = batch_ms[batch]
    plain_ms = cuda_ms(lambda: mcs_frame.mcs_frame_plain(c, ref, params,
                                                         0.5, 2), 1)
    counts = torch.zeros(2, dtype=torch.int64, device=state.device)
    mcs_frame.mcs_frame(state.clone(), scene, params, 0.5, 2, counts=counts)
    steps, fetches = (int(v) for v in counts.tolist())
    _, distinct = mcs_work(scene, params, 0.5, res, res)
    use_skip = scene.tracking_packed is not None
    mtable = scene.tracking_packed if use_skip else table
    nbytes = distinct * mtable.shape[1] * mtable.element_size() \
        + tf_row_bytes(scene) + mcs_halo_frame_bytes(n, fetches, channels)
    ops = fetches * (MCS_OPS_STEP + SLAB_OPS) + n * MCS_OPS_PIXEL
    bound_ms, bound_by = roofline(nbytes, ops)
    occ = mcs_frame.halo_occupancy(mtable.dtype, scene.transfer_1d.shape[0],
                                   channels=channels)
    tail = mcs_frame.halo_occupancy(mtable.dtype,
                                    scene.transfer_1d.shape[0],
                                    channels=channels, tail=True)
    share = None if t["halo"] is None else bound_ms / t["halo"]
    group_batch = mcs_frame.HALO_REDUCE_BATCH
    group_launches = -(-slowest // group_batch) * group_batch
    print(f"mcs halo {label}: one slab, {res}^2: {per_frame} launches "
          f"(L + 1 = {slowest}, B = {batch}), {reads} host reads; with a "
          f"group (B = {group_batch}) {group_launches} launches, "
          f"{group_launches - 1} all-reduces; call {call_ms:.4f} ms "
          f"(host clock; B = 2 / 4 / 8: "
          + " / ".join(f"{batch_ms[k]:.4f}" for k in (2, 4, 8))
          + f"), loop {ms['halo']:.4f} ms (whole K8 {ms['whole']:.4f} ms), "
          f"device {fmt_ms(t['halo'])} (whole {fmt_ms(t['whole'])}); plain "
          f"twin {plain_ms:.4f} ms; {steps} tracking steps, {fetches} "
          f"fetches; bound {bound_ms:.4f} ms ({bound_by}, {nbytes} bytes), "
          + ("share not measured" if share is None else f"{share:.3f} of it")
          + f"; launch 0 {occ['registers']} registers, "
          f"{occ['local_bytes']} spill bytes; tail {tail['registers']} "
          f"registers, {tail['local_bytes']} spill bytes, "
          f"{tail['blocks_per_sm']} blocks an SM", flush=True)
    rows["mcs_halo"] = {
        "ms": ms["halo"], "call_ms": call_ms, "device_ms": t["halo"],
        "whole_ms": ms["whole"], "whole_device_ms": t["whole"],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": share, "launches_a_frame": per_frame,
        "slowest_plus_one": slowest, "batch": batch,
        "host_reads_a_frame": reads,
        "call_ms_by_batch": {str(k): v for k, v in batch_ms.items()},
        "fetches": fetches, "registers": [occ["registers"],
                                          tail["registers"]],
        "local_bytes": [occ["local_bytes"], tail["local_bytes"]]}

    # K9: DOS, a sweep's first frame
    dos = renderer_module("dos")
    params = params_of("dos")

    def dos_frame(s):
        return lambda: dos.render_frame(dos.reset(params, res, res, scene),
                                        s, params, 0.0, 1)

    before = dos_sweep.HALO_LAUNCHES
    dos_frame(hs)()
    per_frame = dos_sweep.HALO_LAUNCHES - before
    check(per_frame == 2, f"{label} dos halo: {per_frame} launches a frame")
    t = halo_turns((dos_frame(hs), "dos_halo_"),
                   (dos_frame(scene), "dos_sweep"), lambda k: 1)
    ms = in_turns({"halo": dos_frame(hs), "whole": dos_frame(scene)}, 5,
                  rounds=1)
    # the frame's call alone: the state reset in place, untimed, first
    timed = dos.reset(params, res, res, scene)
    call_ms = synced_call_ms(
        lambda: dos.render_frame(timed, hs, params, 0.0, 1), 10,
        setup=lambda: dos_reset(params, res, scene, timed))
    plain_ms = cuda_ms(lambda: dos_sweep.sweep_frame_plain(
        dos.reset(params, res, res, scene), ref, params), 1)
    nbytes, ops, written, active = dos_work(scene, params, res, res, 1)
    nbytes += dos_halo_frame_bytes(n, active, channels)
    ops += n * active * PLANE_OPS
    bound_ms, bound_by = roofline(nbytes, ops)
    occ = [dos_sweep.halo_occupancy(stage, table.dtype, tf_mode,
                                    params.samples, channels=channels,
                                    steps=params.steps)
           for stage in (0, 1)]
    share = None if t["halo"] is None else bound_ms / t["halo"]
    print(f"dos halo {label}: one slab, {res}^2, a sweep's first frame "
          f"({active} active slices, {written} written pixels): "
          f"{per_frame} launches, 1 all-reduce with a group, 0 host reads; "
          f"call {call_ms:.4f} ms (host clock, the reset untimed), loop "
          f"{ms['halo']:.4f} ms with a reset a frame (cooperative K9 "
          f"{ms['whole']:.4f} ms), device "
          f"{fmt_ms(t['halo'])} (whole {fmt_ms(t['whole'])}); plain twin "
          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, {nbytes} "
          "bytes), "
          + ("share not measured" if share is None else f"{share:.3f} of it")
          + f"; fetch {occ[0]['registers']} registers, "
          f"{occ[0]['local_bytes']} spill bytes; fold {occ[1]['registers']}"
          f" registers, {occ[1]['local_bytes']} spill bytes, "
          f"{occ[1]['blocks_per_sm']} blocks of 512 an SM", flush=True)
    rows["dos_halo"] = {
        "ms": ms["halo"], "call_ms": call_ms, "device_ms": t["halo"],
        "whole_ms": ms["whole"], "whole_device_ms": t["whole"],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": share, "launches_a_frame": per_frame,
        "all_reduces_a_frame": 1, "host_reads_a_frame": 0,
        "active_slices": active,
        "registers": [o["registers"] for o in occ],
        "local_bytes": [o["local_bytes"] for o in occ]}
    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
    return rows


def phase_halo_frames(scenes):
    """The halo instances of K6-K9 (:func:`halo_kernel_rows`) on the
    headline (bf16 tables, ``tf_mxu``; MCS on its cheb-skip table) and on
    the two-channel 128³ (:func:`rg_scene`) at 512², default Params (MCS
    extinction 8; DOS a sweep's first frame).  Returns the JSON rows'
    fields: the headline's, with the two-channel numbers under
    ``rg_...``."""
    def params_of(key):
        module = renderer_module(key)
        return module.Params(extinction=8.0) if key == "mcs" \
            else module.Params()

    rows = halo_kernel_rows("headline", scenes["headline"], params_of)
    rg = halo_kernel_rows("two-channel 128^3", scenes["rg"], params_of)
    for name, row in rows.items():
        # no one PyTorch call computes a halo frame
        row["library_ms"] = None
        row["max_abs_err"] = max(row["max_abs_err"], rg[name]["max_abs_err"])
        for k, v in rg[name].items():
            if k != "max_abs_err":
                row[f"rg_{k}"] = v
    return rows


def lao_halo_frame_bytes(active, pixels, chunks, values):
    """Bytes a K10 halo frame moves besides K10's own (:func:`time_lao`'s:
    the corner rows, rx and the frame, the TF table), the least that a
    split of the march around one all-reduce a chunk of 8 slices moves:
    each active pixel-slice's ``values`` values (4 bytes each:
    ``lao_march.halo_values``) out before the all-reduce and in after it,
    and each pixel's accumulator (16 bytes) out and in across each of the
    ``chunks`` all-reduces.  K10's halo instance moves this and each
    chunk's overshoot past a pixel's exit."""
    return active * values * 4 * 2 + pixels * chunks * 2 * 16


def lao_halo_states(scene, params, res, slabs=(1, 0), plain=False, **kw):
    """One LAO frame at ``res``² over the HaloScene of slab ``slabs`` =
    (count, index) (no group), and the same frame through the whole-scene
    K10, or with ``plain`` through the plain twin over the same HaloScene:
    ``(halo frame, reference)``."""
    from vpt_tpu_torch.kernels import lao_march
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import lao

    count, index = slabs
    hs = halo.halo_scene(scene, index, count, **kw)
    got = lao.reset(params, res, res, scene)
    want = got.clone()
    lao.render_frame(got, hs, params, 0.5, 1)
    if plain:
        lao_march.lao_frame_plain(want, hs, params)
    else:
        lao.render_frame(want, scene, params, 0.5, 1)
    return got, want


def halo_sass_per_slice(bf16):
    """K10 halo's SASS a pixel-slice in this tree's library
    (``bench_mcm_event.halo_sass_slice`` of the headline-type instance:
    its fold's and fetch's slice loops, the fetch's AO loop counted once a
    tap), by ``cuobjdump -sass``."""
    import bench_mcm_event
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.renderers import lao

    b = int(bf16)
    tree = {k: v for k, v in bench_mcm_event.sass_tree(
        _build.BUILD_DIR / _build.LIB_NAME, "lao_halo").items()
        if f"ILb{b}ELb{b}ELi0ELb0EiE" in k}
    check(len(tree) == 1, f"{len(tree)} K10 halo instances of the headline's "
          "type in the library")
    (name, loops), = tree.items()
    return bench_mcm_event.halo_sass_slice(loops, bench_mcm_event.halo_taps(
        len(lao.lao_taps(lao.Params())), name))


def lao_halo_row(label, scene, params, res=512, timed=True):
    """K10's halo instance on ``scene`` at ``res``²: on one slab its frame
    equals K10's bit for bit in ``lao_march.halo_frame_launches`` launches
    (K10's counter still); on 2 slabs (no group, contiguous and interleave
    2) each slab's frame is within K10's bound of the plain twin over the
    same HaloScene (:func:`halo_states_agree`).  With ``timed``, on one
    slab timed in turns against K10 (:func:`halo_turns`), the loop ms, the
    host µs a launch (a frame call that finds the queue empty, over its
    launches), the plain twin's ms, registers and spills, the SASS a
    pixel-slice and issue floor (:func:`halo_sass_per_slice`, K10's warp-
    slices), that the fold/fetch split was not kept, and the bound: K10's
    (:func:`lao_work`, :func:`lao_ops`) plus :func:`lao_halo_frame_bytes`
    and the plane map's operations a fetch (:data:`PLANE_OPS`).  Returns
    the row's fields."""
    import torch

    import bench_mcm_event
    from vpt_tpu_torch.kernels import lao_march
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import lao

    chunks = -(-params.slices // 8)
    per_frame = lao_march.halo_frame_launches(params)
    before = (lao_march.LAUNCHES, lao_march.HALO_LAUNCHES)
    hs = halo.halo_scene(scene, 0, 1)
    got = lao.reset(params, res, res, scene)
    lao.render_frame(got, hs, params, 0.5, 1)
    check((lao_march.LAUNCHES, lao_march.HALO_LAUNCHES)
          == (before[0], before[1] + per_frame),
          f"{label} K10 halo: launches {lao_march.HALO_LAUNCHES - before[1]}")
    want = lao.reset(params, res, res, scene)
    lao.render_frame(want, scene, params, 0.5, 1)
    halo_states_agree(f"{label} lao halo one slab", "lao", got, want, True)
    check(float(got[..., :3].max()) > 0.0, f"{label} K10 halo: a black "
          "frame")
    worst = 0.0
    for count, index, m in ((2, 0, 1), (2, 1, 2)):
        got, plain = lao_halo_states(scene, params, res, (count, index),
                                     plain=True, interleave=m)
        worst = max(worst, halo_states_agree(
            f"{label} lao halo slab {index}/{count} m{m}", "lao", got,
            plain, False))
    check(worst <= 1e-5, f"{label} K10 halo: 2 slabs max abs err "
          f"{worst:.3g} (bound 1e-5)")
    torch.cuda.synchronize()
    row = {"max_abs_err": worst}
    if not timed:
        print(f"{label} K10 halo: {res}^2 on one slab equal to K10 bit for "
              f"bit ({per_frame} launches); on 2 slabs within K10's bound "
              f"of the plain twin (max abs err {worst:.3g})", flush=True)
        return row
    a, b, c = (lao.reset(params, res, res, scene) for _ in range(3))
    table = scene.volume_packed
    whole_part = "lao_kernel" if scene.channels == 1 \
        and not params.baked_gradient else "lao_ext_kernel"

    def launches_of(kernel):
        return chunks + 1

    def frame():
        lao.render_frame(a, hs, params, 0.5, 1)

    t = halo_turns((frame, "lao_halo_"),
                   (lambda: lao.render_frame(b, scene, params, 0.5, 1),
                    whole_part), launches_of)
    ms = in_turns({"halo": frame,
                   "whole": lambda: lao.render_frame(b, scene, params, 0.5,
                                                     1)}, 10, rounds=1)
    host_us = _host_call_us(frame, 50) / per_frame
    plain_ms = cuda_ms(lambda: lao_march.lao_frame_plain(c, hs, params), 1)
    samples, fetches, rows, hits, _ = lao_work(scene, params, res, res)
    values = lao_march.halo_values(params)
    n = res * res
    nbytes = rows * table.shape[1] * table.element_size() + 20 * n \
        + scene.transfer_packed.numel() * scene.transfer_packed.element_size() \
        + lao_halo_frame_bytes(samples, n, chunks, values)
    ops = lao_ops(scene, params, samples, fetches, hits) + fetches * PLANE_OPS
    bound_ms, bound_by = roofline(nbytes, ops)
    occ = lao_march.halo_occupancy(table.dtype, scene.transfer_packed.dtype,
                                   channels=scene.channels,
                                   baked=params.baked_gradient)
    counts = torch.zeros(2, dtype=torch.int64, device=a.device)
    lao_march.lao_frame(b, scene, params, counts)
    warp_slices = int(counts[1])
    sass = halo_sass_per_slice(table.dtype == torch.bfloat16)
    clock = bench_mcm_event.sm_clock_mhz()[0]
    floor_ms = sass * warp_slices / (bench_mcm_event.SMS
                                     * bench_mcm_event.SCHEDULERS * clock
                                     * 1e6) * 1e3
    share = None if t["halo"] is None else bound_ms / t["halo"]
    print(f"lao halo {label}: one slab, {res}^2, {params.slices} slices: "
          f"{ms['halo']:.4f} ms a frame ({per_frame} launches of one kernel "
          f"that folds and fetches (the fold/fetch split measured slower, "
          f"not kept), {chunks} all-reduces with a group of {values} values "
          f"a pixel-slice; K10 {ms['whole']:.4f} ms), device "
          f"{fmt_ms(t['halo'])} (K10 {fmt_ms(t['whole'])}"
          + (f", {t['halo'] / t['whole']:.3f}x" if t["halo"] and t["whole"]
             else "")
          + f"); host {host_us:.2f} us a launch; plain twin {plain_ms:.4f} "
          f"ms; {samples} active pixel-slices, {fetches} fetches of {rows} "
          f"distinct rows; bound {bound_ms:.4f} ms ({bound_by}, {nbytes} "
          f"bytes, {ops} operations), "
          + ("share not measured" if share is None else f"{share:.3f} of it")
          + f"; {sass} SASS a pixel-slice, issue floor {floor_ms:.4f} ms "
          f"({warp_slices} warp-slices at {clock} MHz); "
          f"{occ['registers']} registers, {occ['local_bytes']} spill bytes, "
          f"{occ['blocks_per_sm']} blocks an SM",
          flush=True)
    row.update({"ms": ms["halo"], "device_ms": t["halo"],
                "whole_ms": ms["whole"], "whole_device_ms": t["whole"],
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": share,
                "launches_a_frame": per_frame, "active_slices": samples,
                "values_a_slice": values, "split_kept": False,
                "host_us_a_launch": host_us, "sass_per_slice": sass,
                "warp_slices": warp_slices, "issue_floor_ms": floor_ms,
                "registers": occ["registers"],
                "local_bytes": occ["local_bytes"]})
    return row


#: the halo band check's two uneven bands of a 512² image
HALO_BANDS = ((0, 201), (201, 512))


def band_pair_frame(scene, params, state, run, res=512, host=None):
    """A sweep's frame from ``state`` on the two bands of
    :data:`HALO_BANDS` in one process: each active slice the whole image's
    previous occlusion as both bands' extended buffer, then
    ``run(band, ext, 0, scene, params, k, window, n_active)`` on each (K9's
    band instance, its halo instance over a HaloScene, or the plain band
    twin).  ``host``: None, or a list to which each ``run`` call's host
    nanoseconds are appended.  Returns the whole frame's colour, occlusion
    and depth, and the active slices."""
    import torch

    from vpt_tpu_torch.renderers import dos

    bands = [{k: (v[r0:r1].clone() if k in ("color", "occlusion")
                  else v.clone()) for k, v in state.items()}
             for r0, r1 in HALO_BANDS]
    active = dos.active_slices(bands[0], params)
    for k in range(active):
        ext = torch.cat([band["occlusion"] for band in bands])
        for (r0, _), band in zip(HALO_BANDS, bands):
            t0 = time.perf_counter_ns()
            run(band, ext, 0, scene, params, k, (r0, res), active)
            if host is not None:
                host.append(time.perf_counter_ns() - t0)
    out = {key: torch.cat([band[key] for band in bands])
           for key in ("color", "occlusion")}
    out["depth"] = state["depth"] + float(active) * state["slice_distance"]
    return out, active


def band_calls_host_us(scene, params, start, res=512, reps=5):
    """Host µs of one ``dos_sweep.band_slice`` call of
    :func:`band_pair_frame`'s frame over ``scene`` (the calls alone, not
    the ``torch.cat`` between them; the card synchronised before each
    frame, the median of ``reps`` frames after a warm-up one) and the
    calls a frame."""
    import torch

    from vpt_tpu_torch.kernels import dos_sweep

    band_pair_frame(scene, params, start, dos_sweep.band_slice, res)
    per_call = []
    for _ in range(reps):
        torch.cuda.synchronize()
        host = []
        band_pair_frame(scene, params, start, dos_sweep.band_slice, res,
                        host)
        per_call.append(sum(host) / len(host) / 1e3)
    torch.cuda.synchronize()
    return sorted(per_call)[reps // 2], len(host)


def dos_halo_band_row(label, scene, res=512, timed=True):
    """K9's halo band instance on ``scene``: a 512² sweep's first frame
    (default Params) on two uneven bands (:func:`band_pair_frame`) over
    the HaloScene of one slab equals K9's band instance on the whole scene
    bit for bit, in ceil(n / 8) fetches and n folds a band for n active
    slices (the band instance's counter still); on 2 slabs (no group,
    contiguous and interleave 2) within K9's bound of the plain band twin
    over the same HaloScene.  With ``timed``, the band frame on one slab
    timed in turns against the band instance's (:func:`halo_turns`: each
    kernel's mean a launch times its launches), the loop ms, the host µs of
    the ``band_slice`` calls alone (a call, and a launch: a call launches
    the fold and at a chunk's first slice the fetch) against the band
    instance's a slice (:func:`band_calls_host_us`), the plain twin's ms
    and the bound: :func:`dos_work`'s frame plus the values out and in
    across each chunk's all-reduce (:func:`dos_halo_frame_bytes`) and the
    plane map's operations a pixel-slice.  Returns the row's fields."""
    import torch

    from vpt_tpu_torch.kernels import dos_sweep, tf1d
    from vpt_tpu_torch.parallel import halo
    from vpt_tpu_torch.renderers import dos

    params = dos.Params()
    start = dos.reset(params, res, res, scene)
    hs = halo.halo_scene(scene, 0, 1)

    def plain(band, ext, ext_row0, sc, p, k, window, n_active):
        dos_sweep.band_slice_plain(band, ext, ext_row0, sc, p, k, window)

    before = (dos_sweep.BAND_LAUNCHES, dos_sweep.HALO_BAND_LAUNCHES)
    got, active = band_pair_frame(hs, params, start, dos_sweep.band_slice,
                                  res)
    per_band = -(-active // 8) + active
    check((dos_sweep.BAND_LAUNCHES, dos_sweep.HALO_BAND_LAUNCHES)
          == (before[0], before[1] + 2 * per_band),
          f"{label} K9 halo band: launches "
          f"{dos_sweep.HALO_BAND_LAUNCHES - before[1]}")
    want, _ = band_pair_frame(scene, params, start, dos_sweep.band_slice,
                              res)
    halo_states_agree(f"{label} dos halo band one slab", "dos", got, want,
                      True)
    check(float(got["color"][..., 3].max()) > 0.0, f"{label} K9 halo band: "
          "no colour")
    worst = 0.0
    for count, index, m in ((2, 0, 1), (2, 1, 2)):
        hs2 = halo.halo_scene(scene, index, count, interleave=m)
        got, _ = band_pair_frame(hs2, params, start, dos_sweep.band_slice,
                                 res)
        want, _ = band_pair_frame(hs2, params, start, plain, res)
        worst = max(worst, halo_states_agree(
            f"{label} dos halo band slab {index}/{count} m{m}", "dos", got,
            want, False))
    torch.cuda.synchronize()
    row = {"max_abs_err": worst}
    if not timed:
        print(f"{label} K9 halo band: two bands of {res}^2 on one slab equal "
              f"to K9's band instance bit for bit ({2 * per_band} launches);"
              f" on 2 slabs within K9's bound of the plain band twin (max abs"
              f" err {worst:.3g})", flush=True)
        return row

    def halo_frame():
        band_pair_frame(hs, params, start, dos_sweep.band_slice, res)

    def band_frame():
        band_pair_frame(scene, params, start, dos_sweep.band_slice, res)

    def launches_of(kernel):
        return 2 * (-(-active // 8) if "fetch" in kernel else active)

    t = halo_turns((halo_frame, "dos_halo_"), (band_frame, "dos_band_"),
                   launches_of, reps=5, whole_launches=lambda k: 2 * active)
    ms = in_turns({"halo": halo_frame, "whole": band_frame}, 5, rounds=1)
    call_us, calls = band_calls_host_us(hs, params, start, res)
    band_call_us, _ = band_calls_host_us(scene, params, start, res)
    launch_us = call_us * calls / (2 * per_band)
    plain_ms = cuda_ms(lambda: band_pair_frame(hs, params, start, plain, res),
                       1)
    n = res * res
    nbytes, ops, written, _ = dos_work(scene, params, res, res, 1)
    nbytes += dos_halo_frame_bytes(n, active, scene.channels)
    ops += n * active * PLANE_OPS
    bound_ms, bound_by = roofline(nbytes, ops)
    table = scene.volume_packed
    tf_mode = tf1d.mode_code(scene.tf_mxu)
    occ = [dos_sweep.halo_occupancy(0, table.dtype, tf_mode, params.samples,
                                    channels=scene.channels)]
    share = None if t["halo"] is None else bound_ms / t["halo"]
    print(f"dos halo band {label}: one slab, two bands of {res}^2, a sweep's "
          f"first frame ({active} active slices, {written} written pixels): "
          f"{ms['halo']:.4f} ms a frame ({2 * per_band} launches, "
          f"{2 * -(-active // 8)} all-reduces with a group; K9's band "
          f"instance {ms['whole']:.4f} ms), device {fmt_ms(t['halo'])} "
          f"(band instance {fmt_ms(t['whole'])}"
          + (f", {t['halo'] / t['whole']:.3f}x" if t["halo"] and t["whole"]
             else "")
          + f"); host {call_us:.2f} us a band_slice call ({calls} a frame), "
          f"{launch_us:.2f} us a launch (the band instance {band_call_us:.2f}"
          f" us a slice); plain twin {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes} bytes), "
          + ("share not measured" if share is None else f"{share:.3f} of it")
          + f"; fetch {occ[0]['registers']} registers, "
          f"{occ[0]['local_bytes']} spill bytes", flush=True)
    row.update({"ms": ms["halo"], "device_ms": t["halo"],
                "whole_ms": ms["whole"], "whole_device_ms": t["whole"],
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": share,
                "launches_a_frame": 2 * per_band, "active_slices": active,
                "host_us_a_call": call_us, "host_us_a_launch": launch_us,
                "band_host_us_a_slice": band_call_us,
                "registers": occ[0]["registers"],
                "local_bytes": occ[0]["local_bytes"]})
    return row


def phase_halo_lao_band(scenes):
    """K10's halo instance (:func:`lao_halo_row`: the headline timed, the
    two-channel 128³ and its baked-gradient twin held bit for bit and to
    the plain twin) and K9's halo band instance (:func:`dos_halo_band_row`:
    the headline timed, the two-channel 128³ held) at 512², default
    Params.  Returns the JSON rows' fields by name, the two-channel
    checks' errors under ``rg_max_abs_err``."""
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import lao, make_scene

    t0 = time.perf_counter()
    rows = {"lao_halo": lao_halo_row("headline", scenes["headline"],
                                     lao.Params()),
            "dos_halo_band": dos_halo_band_row("headline",
                                               scenes["headline"])}
    rg = {"lao_halo": lao_halo_row("two-channel 128^3", scenes["rg"],
                                   lao.Params(), timed=False),
          "dos_halo_band": dos_halo_band_row("two-channel 128^3",
                                             scenes["rg"], timed=False)}
    baked = make_scene(volume.with_lao_gradient(volume.blobs_volume(128,
                                                                    seed=3)),
                       transfer.gray_ramp(alpha_scale=0.8))
    rg["lao_halo"]["max_abs_err"] = max(
        rg["lao_halo"]["max_abs_err"],
        lao_halo_row("baked 128^3", baked, lao.Params(baked_gradient=True),
                     timed=False)["max_abs_err"])
    for name, row in rows.items():
        row["library_ms"] = None
        row["rg_max_abs_err"] = rg[name]["max_abs_err"]
        row["max_abs_err"] = max(row["max_abs_err"], row["rg_max_abs_err"])
    print(f"halo LAO and DOS band kernels: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def halo_frames_path(grid, scene, counters, res):
    """``path parallel``'s halo frames, in its world of one: every launch
    counter at 0, then one frame each of EAM, MIP, Depth, ISO with its
    display, MCS, DOS and LAO of config 4 at ``res``² through
    ``halo.sharded_render_frame`` on one slab (the halo instances of
    K6-K10) and the counts read; none of the whole-scene kernels runs, and
    a world of one issues no collective.  After the counts: each frame against
    ``shard_render_frame``'s whole-scene kernel frame bit for bit and
    against its plain twin over the same HaloScene within the kernel's
    bound, and each halo frame timed against the whole-scene frame in
    turns.  Returns (launches, errors by JSON name, numbers)."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch.kernels import dos_sweep, iso_shade, lao_march, march
    from vpt_tpu_torch.kernels import mcs_frame
    from vpt_tpu_torch.parallel import halo, place_state, shard_render_frame
    from vpt_tpu_torch.parallel.mesh import axis_group

    t0 = time.perf_counter()
    for module in counters.values():
        module.LAUNCHES = 0
    mcs_frame.HALO_READS = 0
    halo.COLLECTIVES.clear()
    frames, wholes, params_of, slabs = {}, {}, {}, None
    for key in HALO_PATH_KEYS:
        module = renderer_module(key)
        params = module.Params(extinction=8.0) if key == "mcs" \
            else module.Params()
        params_of[key] = params
        wholes[key] = module.reset(params, res, res, scene)
        frame_fn, slabs = halo.sharded_render_frame(module, grid, scene, 1,
                                                    wholes[key])
        # a copy: place_state keeps DOS's 0-d depth, which K9 advances
        state = place_state(_clone(wholes[key]), grid)
        frames[key] = frame_fn(state, slabs, params,
                               np.float32(0.0 if key == "dos" else 0.37), 1)
        if key == "iso":
            hs = halo.halo_scene(scene, 0, 1, axis_group(grid, "space"),
                                 slabs)
            frames["display"] = module.display(frames[key], hs, params)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    mcs_reads = mcs_frame.HALO_READS
    collectives = dict(halo.COLLECTIVES)
    run_s = time.perf_counter() - t0
    for name in HALO_COUNTERS:
        check(launches[name] > 0, f"path parallel halo frames: {name} was "
              "not launched")
        check(launches[HALO_WHOLE[name]] == 0, f"path parallel halo frames: "
              f"{launches[HALO_WHOLE[name]]} launches of the whole-scene "
              f"{HALO_WHOLE[name]}")
    check(not collectives, f"path parallel halo frames: collectives in a "
          f"world of one {collectives}")
    check(launches["march_halo"] == 2 * 4, f"path parallel halo frames: "
          f"{launches['march_halo']} K6 halo launches (a fetch and a fold "
          "a frame of EAM, MIP, Depth and ISO)")
    check(launches["iso_shade_halo"] == 2, "path parallel halo frames: K7 "
          "halo launches")
    check(launches["lao_halo"]
          == lao_march.halo_frame_launches(params_of["lao"]),
          f"path parallel halo frames: {launches['lao_halo']} K10 halo "
          "launches")
    check(launches["dos_halo"] == 2, f"path parallel halo frames: "
          f"{launches['dos_halo']} K9 halo launches")
    # K8 halo: L + 1 to L + B launches in at most ceil((L + 1) / B) + 1
    # reads, L + 1 the launches of the frame read after every launch
    slowest = mcs_halo_slowest(
        place_state(_clone(wholes["mcs"]), grid),
        halo.halo_scene(scene, 0, 1, axis_group(grid, "space"), slabs),
        params_of["mcs"], np.float32(0.37), 1)
    batch = mcs_frame.HALO_BATCH
    check(slowest <= launches["mcs_halo"] <= slowest - 1 + batch
          and mcs_reads <= -(-slowest // batch) + 1,
          f"path parallel halo frames: {launches['mcs_halo']} K8 halo "
          f"launches, {mcs_reads} reads with L + 1 = {slowest}, B = {batch}")

    # against the whole-scene kernels and the plain twins, then timed
    hs = halo.halo_scene(scene, 0, 1, axis_group(grid, "space"), slabs)
    ref = dataclasses.replace(hs, kernels=False)
    errors = {name: 0.0 for name in HALO_COUNTERS}
    turns = {}
    for key in HALO_PATH_KEYS:
        module = renderer_module(key)
        params = params_of[key]
        seed = np.float32(0.0 if key == "dos" else 0.37)
        whole = shard_render_frame(module, grid, wholes[key])(
            place_state(_clone(wholes[key]), grid), scene, params, seed, 1)
        plain = place_state(_clone(wholes[key]), grid)
        if key == "mcs":
            mcs_frame.mcs_frame_plain(plain, ref, params, seed, 1)
        elif key == "dos":
            dos_sweep.sweep_frame_plain(plain, ref, params)
        elif key == "lao":
            lao_march.lao_frame_plain(plain, ref, params)
        else:
            march.march_frame_plain(key, plain, ref, params, seed, 1)
        torch.cuda.synchronize()
        name = HALO_NAME.get(key, "march_halo")
        halo_states_agree(f"path parallel halo {key}", key, frames[key],
                          whole, True)
        errors[name] = max(errors[name], halo_states_agree(
            f"path parallel halo {key} plain", key, frames[key], plain,
            False))
        if key == "iso":
            halo_states_agree("path parallel halo iso display", key,
                              frames["display"],
                              module.display(whole, scene, params), True)
            halo_states_agree("path parallel halo iso display plain", key,
                              frames["display"],
                              iso_shade.iso_shade_plain(whole, ref, params),
                              False)
        del whole, plain
        a, b = _clone(frames[key]), _clone(frames[key])
        if key == "dos":
            def run_halo(a=a):
                module.render_frame(dos_reset(params, res, scene, a), hs,
                                    params, 0.0, 1)

            def run_whole(b=b):
                module.render_frame(dos_reset(params, res, scene, b), scene,
                                    params, 0.0, 1)
        else:
            def run_halo(a=a, module=module, params=params):
                module.render_frame(a, hs, params, 0.5, 2)

            def run_whole(b=b, module=module, params=params):
                module.render_frame(b, scene, params, 0.5, 2)
        turns[key] = in_turns({"halo": run_halo, "whole": run_whole}, 5,
                              rounds=1)
    del frames
    torch.cuda.empty_cache()
    print(f"path parallel halo frames: config 4 at {res}^2 on one slab, "
          f"one frame each of EAM, MIP, Depth, ISO (and its display), MCS "
          f"(extinction 8), DOS and LAO through halo.sharded_render_frame in "
          f"{run_s:.3f} s: equal bit for bit to shard_render_frame's "
          f"whole-scene kernel frames, within the kernels' bounds of the "
          f"plain twins (max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errors.items())
          + "); in turns, ms a frame halo / whole: "
          + ", ".join(f"{k} {v['halo']:.4f} / {v['whole']:.4f}"
                      for k, v in turns.items())
          + "; launches: " + ", ".join(f"{k} {launches[k]}"
                                       for k in HALO_COUNTERS)
          + f" (K8 halo: L + 1 = {slowest}, {mcs_reads} host reads)",
          flush=True)
    return launches, errors, turns


def dos_reset(params, res, scene, state):
    """``state`` (a DOS state dict) reset in place to ``dos.reset``'s
    values: a frame timed again starts the same sweep."""
    from vpt_tpu_torch.renderers import dos

    fresh = dos.reset(params, res, res, scene)
    for k, v in fresh.items():
        state[k].copy_(v)
    return state


def gloo_halo_frames(mesh, scene):
    """The two-rank check's halo frames of EAM, MIP, Depth, ISO (and its
    display), MCS and DOS (default Params; MCS extinction 8) on
    ``mesh``'s ``space`` slabs at GLOO_HALO_RES², gathered, with each
    frame's collectives; with ``mesh`` None one process's whole-scene
    kernel frames (and K7's display)."""
    import numpy as np

    from vpt_tpu_torch.kernels import dos_sweep, iso_shade, march, mcs_frame
    from vpt_tpu_torch.parallel import gather_state, halo, place_state
    from vpt_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    res = GLOO_HALO_RES
    out = {}
    for key in HALO_FRAME_KEYS:
        module = renderer_module(key)
        params = module.Params(extinction=8.0) if key == "mcs" \
            else module.Params()
        seed = np.float32(0.0 if key == "dos" else 0.37)
        state = module.reset(params, res, res, scene)
        if mesh is None:
            out[key] = {"state": module.render_frame(state, scene, params,
                                                     seed, 1)}
            if key == "iso":
                out[key]["display"] = module.display(out[key]["state"],
                                                     scene, params)
            continue
        count = axis_size(mesh, "space")
        frame_fn, slabs = halo.sharded_render_frame(module, mesh, scene,
                                                    count, state)
        halo.COLLECTIVES.clear()
        before = (mcs_frame.HALO_LAUNCHES, mcs_frame.HALO_READS,
                  dos_sweep.HALO_LAUNCHES, march.HALO_LAUNCHES)
        rows = frame_fn(place_state(state, mesh), slabs, params, seed, 1)
        out[key] = {"collectives": dict(halo.COLLECTIVES),
                    "mcs_launches": mcs_frame.HALO_LAUNCHES - before[0],
                    "mcs_reads": mcs_frame.HALO_READS - before[1],
                    "dos_launches": dos_sweep.HALO_LAUNCHES - before[2],
                    "march_launches": march.HALO_LAUNCHES - before[3]}
        gathered = gather_state(rows, mesh, res)
        if key == "iso":
            hs = halo.halo_scene(scene, axis_index(mesh, "space"), count,
                                 axis_group(mesh, "space"), slabs)
            halo.COLLECTIVES.clear()
            iso_shade.HALO_HITS = None
            out[key]["display"] = module.display(gathered, hs, params)
            out[key]["display_collectives"] = dict(halo.COLLECTIVES)
            out[key]["display_hits"] = iso_shade.HALO_HITS
        out[key]["state"] = gathered
    return out


def _cpu(tree):
    """A nested dict of tensors (and other values) with every tensor on the
    host."""
    import torch

    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu() if torch.is_tensor(tree) else tree


def halo_frame_counts(frames):
    """The launch and collective counts of :func:`gloo_halo_frames`'s
    frames, by renderer key: what every rank of the group must count
    alike."""
    return {key: {k: v for k, v in out.items()
                  if k not in ("state", "display")}
            for key, out in frames.items()}


def check_gloo_halo_frames(got, want, other):
    """The two ranks' halo frames (2 slabs) against one process's
    whole-scene kernel frames, bit for bit, with their collectives a
    frame: K6 1 in 2 launches, K7's display 1 of 7 values a hit and
    channel, K8 its launches − 1 (in at most ceil(launches /
    HALO_REDUCE_BATCH) + 1 host reads), K9 1 in 2 launches; ``other``, the
    other rank's counts (:func:`halo_frame_counts`), equal rank 0's.
    Returns a summary."""
    import torch

    from vpt_tpu_torch.kernels import mcs_frame

    counts = halo_frame_counts(got)
    check(counts == other, f"path parallel gloo: the ranks' halo frame "
          f"counts differ: {counts} against {other}")
    parts = []
    for key in HALO_FRAME_KEYS:
        g, w = got[key], want[key]
        names = ("state", "display") if key == "iso" else ("state",)
        for name in names:
            a = g[name] if isinstance(g[name], dict) else {"": g[name]}
            b = w[name] if isinstance(w[name], dict) else {"": w[name]}
            for k in b:
                check(torch.equal(a[k], b[k]), f"path parallel gloo: "
                      f"the halo {key} {name} {k} (2 slabs) differs from "
                      "one process's whole-scene kernel frame")
        reduces = g["collectives"].get("all_reduce", 0)
        module = renderer_module(key)
        params = module.Params()
        if key in ("eam", "depth", "mip", "iso"):
            check(reduces == 1 and g["march_launches"] == 2,
                  f"path parallel gloo: {key} halo frame {reduces} "
                  f"all-reduces in {g['march_launches']} launches")
        elif key == "dos":
            check(reduces == 1 and g["dos_launches"] == 2,
                  f"path parallel gloo: DOS halo frame {reduces} "
                  f"all-reduces in {g['dos_launches']} launches")
        else:
            check(reduces == g["mcs_launches"] - 1 and g["mcs_reads"]
                  <= -(-g["mcs_launches"]
                       // mcs_frame.HALO_REDUCE_BATCH) + 1,
                  f"path parallel gloo: MCS halo frame {reduces} "
                  f"all-reduces and {g['mcs_reads']} reads in "
                  f"{g['mcs_launches']} launches")
        parts.append(f"{key} {reduces}")
    check(got["iso"]["display_collectives"] == {"all_reduce": 1},
          f"path parallel gloo: the ISO display's collectives "
          f"{got['iso']['display_collectives']}")
    hits = int((want["iso"]["state"][..., 3] > 0).sum())
    check(got["iso"]["display_hits"] == hits, f"path parallel gloo: the "
          f"ISO display all-reduced {got['iso']['display_hits']} hits' "
          f"values, the state holds {hits}")
    return ("halo frames of EAM, MIP, Depth, ISO (its display: 1 "
            f"all-reduce of {hits} hits' 7 values), MCS and DOS on 2 "
            "slabs equal one process's "
            "whole-scene kernel frames bit for bit; all-reduces a frame "
            + ", ".join(parts) + f" (MCS in {got['mcs']['mcs_launches']} "
            f"launches and {got['mcs']['mcs_reads']} host reads, DOS in "
            f"{got['dos']['dos_launches']} launches), the same on both "
            "ranks")


#: path resident's two-channel frames: the volume and the image
RESIDENT_RG_VOLUME, RESIDENT_RG_RES = 128, 512


def resident_frame_bytes(steps, skip, rows, moved=0):
    """Bytes of one exact resident frame over ``rows`` pool rows, the least
    that any split of the event around the migration moves: each event a
    row's photon state (56 bytes, 60 with cheb-skip) in and out once (the
    tentative position is the state's own position), its stream in and
    out (8 bytes each way: the port's int64 layout) and its flags in
    (occupied, pending) and pending out; its NDC once a frame (8 bytes,
    the reseed); and each of ``moved`` migrating rows read at its sender
    and written at its receiver (the state, NDC, pixel id, stream and
    pending flag).  K5's resident instance moves this (csrc/mcm_event.cu,
    ArgsResident)."""
    state = 60 if skip else 56
    row = state + 8 + 4 + 8 + 1
    return rows * (steps * (2 * state + 2 * 8 + 3) + 8) + moved * 2 * row


def resident_row(label, scene, pool, tables, frame_fn, plain_fn, whole,
                 frame, params, res):
    """The resident instance's row on ``scene`` at ``res``²: a resident
    frame (``frame_fn`` on a copy of ``pool``) timed against ``frame``,
    the K5 frame of the whole scene on a copy of ``whole``, in turns (CUDA
    events; device time of its steps + 1 launches), the plain resident
    frame (``plain_fn``), and the bound: :func:`resident_frame_bytes` in
    place of the whole frame's state, the distinct corner rows and
    :func:`event_bound`'s operations of a frame from the reset state."""
    import torch

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.renderers import mcm

    a, b, c = _clone(pool), _clone(whole), _clone(pool)
    times = in_turns({
        "resident": lambda: frame_fn(a, tables, params, 0.5, 3),
        "whole": lambda: frame(b, scene, params, 0.5, 3)}, 5)
    device = device_turns({
        "resident": lambda: frame_fn(a, tables, params, 0.5, 3),
        "whole": lambda: frame(b, scene, params, 0.5, 3)}, "mcm_", reps=5)
    if device["resident"] is not None:
        device["resident"] *= params.steps + 1
    plain_ms = cuda_ms(lambda: plain_fn(c, params, 0.5), 1)
    n = res * res
    start = mcm.reset(params, res, res, scene)
    d = _clone(start)
    mcm_event.event_frame(d, scene, params, 0.3)
    deposits = float(d["samples"].sum(dtype=torch.float64)
                     - start["samples"].sum(dtype=torch.float64))
    work = event_work(scene, start, params, 0.3)
    skip = "cheb" in start
    state = 60 if skip else 56
    _, _, whole_bytes, ops = event_bound(scene, n, params.steps, deposits,
                                         work["rows"], state_bytes=state)
    nbytes = whole_bytes - 2 * n * state \
        + resident_frame_bytes(params.steps, skip, n)
    bound_ms, bound_by = roofline(nbytes, ops)
    share = None if device["resident"] is None \
        else bound_ms / device["resident"]
    channels = scene.channels
    occ = mcm_event.resident_occupancy(
        scene.volume_packed.dtype, scene.transfer_1d.shape[0],
        channels=channels)
    print(f"mcm_event resident {label}: one slab, {res}^2 steps 8: "
          f"{times['resident']:.4f} ms a frame ({params.steps + 1} "
          f"launches; K5 {times['whole']:.4f} ms), device "
          f"{fmt_ms(device['resident'])} (K5 {fmt_ms(device['whole'])}); "
          f"plain resident frame {plain_ms:.4f} ms; bound {bound_ms:.4f} "
          f"ms ({bound_by}, {nbytes} bytes, "
          f"{resident_frame_bytes(params.steps, skip, 1)} a row), "
          + ("share not measured" if share is None
             else f"{share:.3f} of it") +
          f"; {occ['registers']} registers, {occ['local_bytes']} local "
          f"bytes, {occ['blocks_per_sm']} blocks an SM", flush=True)
    return {"ms": times["resident"], "device_ms": device["resident"],
            "whole_ms": times["whole"], "whole_device_ms": device["whole"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bound_share": share,
            "registers": occ["registers"], "local_bytes": occ["local_bytes"]}


def phase_resident_path(grid, scene, counters):
    """``path resident`` in ``path parallel``'s world of one over ``nccl``
    (``grid``) on config 4's full scene (``scene``: 512³ blobs, float32
    tables): with every launch counter at 0, ``resident_reset`` (the
    default capacity) and 2 frames of ``resident_render_frame`` at 1024²
    from the reset state (K5's resident instance, steps + 1 launches a
    frame), then on a two-channel 128³ scene at 512² 2 resident frames and
    2 frames of ``halo.sharded_render_frame`` (the two-channel resident and
    halo instances); the counts read.  After them: the assembled resident
    state against ``shard_render_frame``'s K5 frames bit for bit in every
    field, the two-channel resident and halo states against K5's ext
    frames, every pool field and counter against the plain resident
    frames' (``kernels=False``), and each resident row timed
    (:func:`resident_row`).  Returns the launches and the two rows."""
    import dataclasses

    import numpy as np
    import torch

    from vpt_tpu_torch.parallel import halo, place_state, resident
    from vpt_tpu_torch.parallel import shard_render_frame
    from vpt_tpu_torch.renderers import mcm

    t_all = time.perf_counter()
    params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
    res, rg_res = PARALLEL_RES, RESIDENT_RG_RES
    rg = rg_scene(RESIDENT_RG_VOLUME)
    seeds = [np.float32(0.1 * n) for n in (1, 2)]
    torch.cuda.synchronize()
    for module in counters.values():
        module.LAUNCHES = 0
    halo.COLLECTIVES.clear()
    pool = resident.resident_reset(scene, params, res, res, grid, 1)
    start = _clone(pool)
    frame_fn, tables = resident.resident_render_frame(grid, scene, 1, res,
                                                      res)
    host_ms = []
    for n, seed in enumerate(seeds, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame_fn(pool, tables, params, seed, n)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    rg_pool = resident.resident_reset(rg, params, rg_res, rg_res, grid, 1)
    rg_start = _clone(rg_pool)
    rg_fn, rg_tables = resident.resident_render_frame(grid, rg, 1, rg_res,
                                                      rg_res)
    rg_whole = mcm.reset(params, rg_res, rg_res, rg)
    rg_halo_fn, rg_slabs = halo.sharded_render_frame(mcm, grid, rg, 1,
                                                     rg_whole)
    rg_halo = place_state(rg_whole, grid)
    for n, seed in enumerate(seeds, 1):
        rg_fn(rg_pool, rg_tables, params, seed, n)
        rg_halo_fn(rg_halo, rg_slabs, params, seed, n)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    collectives = dict(halo.COLLECTIVES)
    per_frame = params.steps + 1
    for name, want in (("mcm_event_resident", 4 * per_frame),
                       ("mcm_event_resident_rg", 2 * per_frame),
                       ("mcm_event_halo", 2 * per_frame),
                       ("mcm_event_halo_rg", 2 * per_frame),
                       ("mcm_event", 0)):
        check(launches[name] == want, f"path resident: {launches[name]} "
              f"{name} launches, not {want}")
    check(not collectives, f"path resident: a world of one issued "
          f"{collectives}")

    # after the counts: the K5 frames of the whole scene, the plain
    # resident frames
    whole = mcm.reset(params, res, res, scene)
    frame = shard_render_frame(mcm, grid, whole)
    want = place_state(whole, grid)
    for n, seed in enumerate(seeds, 1):
        frame(want, scene, params, seed, n)
    got = resident.assemble(pool, res, res, grid)
    torch.cuda.synchronize()
    for k in want:
        check(torch.equal(got[k], want[k]), f"path resident: the resident "
              f"frame's {k} differs from shard_render_frame's K5 frame")
    check(all(int(pool[c]) == 0 for c in ("migrated", "stalled", "dropped")),
          "path resident: a world of one migrated, stalled or dropped")
    rg_want = mcm.reset(params, rg_res, rg_res, rg)
    for n, seed in enumerate(seeds, 1):
        mcm.render_frame(rg_want, rg, params, seed, n)
    rg_got = resident.assemble(rg_pool, rg_res, rg_res, grid)
    torch.cuda.synchronize()
    for k in rg_want:
        check(torch.equal(rg_got[k], rg_want[k]), f"path resident: the "
              f"two-channel resident frame's {k} differs from K5's ext "
              "frame")
        check(torch.equal(rg_halo[k], rg_want[k]), f"path resident: the "
              f"two-channel halo frame's {k} differs from K5's ext frame")
    plains = {}
    for label, sc, kernel_pool, first, r in (
            ("config 4", scene, pool, start, res),
            ("two-channel", rg, rg_pool, rg_start, rg_res)):
        pfn, ptables = resident.resident_render_frame(
            grid, dataclasses.replace(sc, kernels=False), 1, r, r)
        plain = _clone(first)
        for n, seed in enumerate(seeds, 1):
            pfn(plain, ptables, params, seed, n)
        torch.cuda.synchronize()
        for k in kernel_pool:
            check(torch.equal(kernel_pool[k], plain[k]), f"path resident "
                  f"{label}: the pool's {k} differs from the plain "
                  "resident frame's")
        plains[label] = (pfn, ptables)
    radiance_err = float((got["radiance"] - want["radiance"]).abs().max())
    rows = {}
    for name, label, sc, kernel_pool, fn, tabs, r, w in (
            ("mcm_event_resident", "config 4", scene, pool, frame_fn, tables,
             res, want),
            ("mcm_event_resident_rg", "two-channel", rg, rg_pool, rg_fn,
             rg_tables, rg_res, rg_want)):
        pfn, ptables = plains[label]

        def plain_frame(p, prm, seed, pfn=pfn, ptables=ptables):
            pfn(p, ptables, prm, seed, 3)

        def k5_frame(st, sc_, prm, seed, n, sc=sc):
            mcm.render_frame(st, sc, prm, seed, n)

        rows[name] = resident_row(label, sc, kernel_pool, tabs, fn,
                                  plain_frame, w, k5_frame, params, r)
        rows[name]["max_abs_err"] = radiance_err if name.endswith(
            "resident") else float((rg_got["radiance"]
                                    - rg_want["radiance"]).abs().max())
    rows["mcm_event_resident"]["host_ms_frames"] = host_ms
    print(f"path resident: config 4 full ({PARALLEL_VOLUME}^3 blobs, "
          f"float32 tables) at {res}^2 in a world of one over nccl, 2 "
          f"frames from the reset state through resident_render_frame: "
          f"{', '.join(f'{x:.3f}' for x in host_ms)} ms a frame (host "
          f"clock), {per_frame} K5 resident launches a frame, equal bit for "
          f"bit to shard_render_frame's K5 frames in every field and the "
          f"pool to the plain resident frames'; a two-channel "
          f"{RESIDENT_RG_VOLUME}^3 scene at {rg_res}^2: resident and halo "
          f"frames equal to K5's ext frames bit for bit; bound share "
          f"{rows['mcm_event_resident']['bound_share']}; launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; {time.perf_counter() - t_all:.1f} s", flush=True)
    return launches, rows


def gloo_resident(mesh, big, rg):
    """The two-rank resident check on ``mesh`` (``space`` = 2), 2 frames at
    512² (config 4's Params): on ``big`` (256³) contiguous and interleaved
    (m = 2) slabs stall-free and with ``fanout=2`` (stalls forced; also
    the plain resident frames on the same ranks, ``kernels=False``), on
    ``rg`` (two channels, 128³) contiguous; each case's assembled state,
    counters and occupied rows summed over the ranks, collectives a frame
    and host ms; whether every pool field equals the plain run's on both
    ranks (fanout 2)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from vpt_tpu_torch.kernels import mcm_event
    from vpt_tpu_torch.parallel import halo, resident
    from vpt_tpu_torch.renderers import mcm

    params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
    res, frames = GLOO_HALO_RES, GLOO_HALO_FRAMES
    out = {}
    mcm_event.RESIDENT_LAUNCHES = mcm_event.RESIDENT_RG_LAUNCHES = 0
    for name, sc, kw in (("contiguous", big, {}),
                         ("interleave2", big, {"interleave": 2}),
                         ("fanout2", big, {"fanout": 2}),
                         ("two-channel", rg, {})):
        m = kw.get("interleave", 1)
        pool = resident.resident_reset(sc, params, res, res, mesh, 2,
                                       interleave=m)
        start = _clone(pool)
        fn, tables = resident.resident_render_frame(mesh, sc, 2, res, res,
                                                    **kw)
        halo.COLLECTIVES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for n in range(1, frames + 1):
            fn(pool, tables, params, np.float32(0.1 * n), n)
        torch.cuda.synchronize()
        entry = {"host_ms": (time.perf_counter() - t0) * 1e3 / frames,
                 "collectives": dict(halo.COLLECTIVES)}
        sums = torch.stack([pool[c].to(torch.int64) for c in
                            ("migrated", "stalled", "dropped")]
                           + [pool["occupied"].sum()])
        dist.all_reduce(sums)
        entry["counters"] = sums.tolist()
        entry["state"] = {k: v.cpu() for k, v in resident.assemble(
            pool, res, res, mesh).items()}
        if name == "fanout2":
            pfn, ptables = resident.resident_render_frame(
                mesh, dataclasses.replace(sc, kernels=False), 2, res, res,
                **kw)
            plain = start
            for n in range(1, frames + 1):
                pfn(plain, ptables, params, np.float32(0.1 * n), n)
            same = torch.tensor([int(all(torch.equal(pool[k], plain[k])
                                         for k in pool))], device="cuda")
            dist.all_reduce(same)
            entry["plain_equal"] = int(same) == dist.get_world_size()
        out[name] = entry
    out["launches"] = (mcm_event.RESIDENT_LAUNCHES,
                       mcm_event.RESIDENT_RG_LAUNCHES)
    return out


def check_gloo_resident(got, want_halo, want_rg):
    """``path resident``'s two-rank checks (:func:`gloo_resident`): the
    stall-free states equal one process's K5 frames (which the world of
    one's resident frames equal) bit for bit with nothing dropped, the
    fanout-2 pools every field equal to the plain run's with stalls and
    one photon a pixel, the two-channel state equal to K5's ext frames;
    prints migrated and stalled a frame, the bytes on the wire an event
    and the crossing share."""
    n_pix = GLOO_HALO_RES * GLOO_HALO_RES
    events = GLOO_HALO_FRAMES * 8
    # a migrating row on the wire: its packed words (the state, NDC, pixel
    # id, the stream's two words, pending)
    row_bytes = 4 * (3 + 3 + 1 + 3 + 3 + 1 + 2 + 1 + 2 + 1)
    lines = []
    for name, entry in got.items():
        if name == "launches":
            continue
        migrated, stalled, dropped, occupied = entry["counters"]
        check(dropped == 0 and occupied == n_pix,
              f"path resident gloo {name}: {dropped} dropped, {occupied} "
              "photons")
        want = want_rg if name == "two-channel" else want_halo
        if name == "fanout2":
            check(entry["plain_equal"], "path resident gloo fanout2: the "
                  "pools differ from the plain resident frames'")
            check(stalled > 0, "path resident gloo fanout2: nothing "
                  "stalled")
        else:
            check(stalled == 0, f"path resident gloo {name}: {stalled} "
                  "stalled")
            for k, v in want.items():
                check(bool((entry["state"][k] == v.cpu()).all()),
                      f"path resident gloo {name}: {k} differs from the "
                      "world-of-one frame")
        lines.append(f"{name}: migrated {migrated / GLOO_HALO_FRAMES:g} and "
                     f"stalled {stalled / GLOO_HALO_FRAMES:g} a frame, "
                     f"{migrated * row_bytes / events:.1f} bytes on the wire "
                     f"an event, crossing share "
                     f"{migrated / (n_pix * events):.6f}, "
                     f"{entry['host_ms']:.3f} ms a frame (host clock), "
                     f"collectives {entry['collectives']}")
    check(got["launches"][0] > 0 and got["launches"][1] > 0,
          f"path resident gloo: launches {got['launches']}")
    print(f"path resident gloo: 2 ranks on one card over gloo, space 2, "
          f"{GLOO_HALO_RES}^2 x {GLOO_HALO_FRAMES} frames (256^3 blobs; the "
          f"two-channel case 128^3), rank 0's K5 resident launches "
          f"{got['launches'][0]} ({got['launches'][1]} two-channel); the "
          "stall-free states equal to the world-of-one frames bit for bit, "
          "fanout 2 equal to the plain resident frames in every pool field; "
          + "; ".join(lines), flush=True)


def dos_bands_agree(label, got, want, bound, share):
    """A DOS frame of row bands against the cooperative K9 frame on a
    float32 scene: vpt_tpu's sharded taps against its shifted ones, which
    its ``_shifted_occlusion_taps`` says agree up to float-associativity
    ulps.  The sharded tap's texel coordinate t·W − 0.5 rounds at ulp(W /
    2) (6.1e-5 at 1024²) where the shifted tap's fraction is nearly exact,
    so a tap's weight may differ by that and the occlusion by that times
    the step between neighbouring texels, over every slice.  Colour and
    occlusion within ``bound``, and at least ``share`` of their values
    within 1e-6; the bounds are set from the readings PERF.md gives: 2
    bands of 512² within 1e-6 (9.54e-7), one band of 1024² within the
    port's float32 DOS bound against vpt_tpu, 3e-5 (1.31e-6), with 92.2%
    of its values within 1e-6 (held at 90%); that band equals the plain
    band bit for bit.  Returns the max abs error and the share."""
    err, within = 0.0, 1.0
    for key in ("color", "occlusion"):
        diff = (got[key].cpu() - want[key].cpu()).abs()
        err = max(err, float(diff.max()))
        within = min(within, float((diff <= 1e-6).float().mean()))
    check(err <= bound and within >= share,
          f"{label}: the DOS bands {err} from the cooperative K9 frame, "
          f"{within} of the values within 1e-6 (bounds {bound}, {share})")
    return err, within


def band_frame_plain(state, scene, params, window, extend):
    """``dos.render_band`` with the plain band slice
    (``dos_sweep.band_slice_plain``) in place of K9's band instance, on a
    copy of the band's ``state``: the same slices, extensions and depth
    advance.  Returns the copy."""
    from vpt_tpu_torch.kernels import dos_sweep
    from vpt_tpu_torch.renderers import dos

    state = {k: v.clone() for k, v in state.items()}
    active = dos.active_slices(state, params)
    for k in range(active):
        ext, ext_row0 = extend(state["occlusion"])
        dos_sweep.band_slice_plain(state, ext, ext_row0, scene, params, k,
                                   window)
    state["depth"] = state["depth"] + float(active) * state["slice_distance"]
    return state


def event_positions(state, scene, params, seed):
    """The (N, 3) tentative positions of one MCM event of every pixel's
    photon in ``state``: the plain flight phase (``mcm.flight_phase``)
    from the pixels' streams for ``seed``, as a frame's first event."""
    from vpt_tpu_torch import rng, sampling
    from vpt_tpu_torch.renderers import mcm

    h, w = state["position"].shape[:2]
    ndc = sampling.pixel_ndc(h, w, device=state["position"].device)
    rstate = rng.seed_pixels(ndc * 0.5 + 0.5, seed)
    skip = mcm.uses_skip(state, scene)
    cell = mcm.skip_cell_size(scene) if skip else None
    _, position = mcm.flight_phase(state, rstate, params, skip, cell)
    return position.reshape(-1, 3).contiguous()


def slab_kernels_agree(scene, pos):
    """K3's slab instance and its backward K4 against their plain twins at
    the config-4 fit's shapes: the 512³ float32 slab table of slab 0 of 1
    (the fit's on one card) and of slab 1 of 2 (half its rows, the rest
    masked out), ``pos`` one event's 1024² positions.  The fetch equals
    ``slab_fetch_plain`` bit for bit (values, cells with -1 where masked,
    fractions); ``corner_grad`` of a seeded cotangent on those cells into
    the slab table equals ``corner_grad_plain`` within the float32
    reordering bound (:func:`order_bound`).  Returns the max abs errors
    and a line of text."""
    import torch

    from vpt_tpu_torch.kernels import corner_gather, corner_scatter
    from vpt_tpu_torch.parallel import halo

    shape = tuple(scene.volume.shape)
    g = torch.Generator(device=pos.device).manual_seed(21)
    ct = torch.randn(pos.shape[0], 1, device=pos.device, generator=g)
    k3_err = k4_err = 0.0
    parts = []
    for count, k in ((1, 0), (2, 1)):
        rows = halo.slab_table(scene.volume_packed, shape, count, k)
        got = corner_gather.slab_fetch(rows, shape, k, count, 1, pos,
                                       save=True)
        want = corner_gather.slab_fetch_plain(rows, shape, k, count, 1, pos,
                                              save=True)
        for a, b, what in zip(got, want, ("value", "cell", "fraction")):
            check(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)),
                  f"path parallel: K3 slab {k}/{count}'s {what} differs "
                  f"from slab_fetch_plain at {tuple(pos.shape)}")
        k3_err = max(k3_err, float((got[0] - want[0]).abs().max()))
        cells, f = got[1], got[2]
        owned = cells[cells >= 0]
        n = rows.shape[0]
        if count == 1:
            # the fit's fetch on one card timed: the distinct rows read
            # once, each position read and its value, cell and fractions
            # written once (phase_corner_kernels' K3 bound)
            slab_ms = profiler_device_ms(
                lambda: corner_gather.slab_fetch(rows, shape, k, count, 1,
                                                 pos, save=True),
                "slab_fetch_kernel")
            slab_bound, slab_by = roofline(
                int(owned.unique().numel()) * rows.shape[1] * 4
                + cells.numel() * (12 + 4 + 8 + 12), 42 * cells.numel())
            timing = (f"K3 slab {fmt_ms(slab_ms)} of device a fetch, bound "
                      f"{slab_bound:.4f} ms ({slab_by})")
        del rows, want
        diff = (corner_scatter.corner_grad(cells, f, ct, n, 1)
                - corner_scatter.corner_grad_plain(cells, f, ct, n, 1)).abs()
        bound = order_bound(
            torch.bincount(owned, minlength=n)[:, None],
            corner_scatter.corner_grad_plain(cells, f, ct.abs(), n, 1))
        err = float(diff.max())
        check(bool((diff <= bound).all()), f"path parallel: K4 into slab "
              f"{k}/{count}'s table max abs err {err} beyond the reordering "
              "bound")
        k4_err = max(k4_err, err)
        parts.append(f"slab {k} of {count} ({n} rows, {owned.numel()} of "
                     f"{cells.numel()} samples owned): K3 slab equal to "
                     f"slab_fetch_plain bit for bit, K4 max abs err {err:.3g} "
                     f"(bound max {float(bound.max()):.3g})"
                     + (f", {timing}" if count == 1 else ""))
        del got, cells, f, owned, diff, bound
        torch.cuda.empty_cache()
    return {"k3_err": k3_err, "k4_err": k4_err, "k3_device_ms": slab_ms,
            "k3_bound_ms": slab_bound, "text": "; ".join(parts)}


def phase_dos_band(scene):
    """K9's band instance against its plain twin: a 512² DOS sweep's first
    frame (default Params) on two uneven bands (201 and 311 rows) with the
    whole image as the extended buffer equals ``band_slice_plain`` bit for
    bit and the cooperative K9 frame (vpt_tpu's sharded taps against the
    shifted ones) within 5e-4, the port's DOS bound on bf16 tables with
    ``tf_mxu`` (``tests/test_torch_dos.py``; float32 scenes: ``path
    parallel gloo``'s 2 bands within 1e-6, ``path parallel``'s 1024² band
    equal to the plain band bit for bit and within
    :func:`dos_bands_agree`'s bounds of the cooperative frame).  Then one
    band slice of the whole image timed (CUDA events and device time)
    against the cooperative frame's time a slice (the same two clocks),
    the plain twin's slice, and the bound of a slice (:func:`dos_work`'s
    bytes and operations a slice of the frame).  Returns the row's
    numbers."""
    import torch

    from vpt_tpu_torch.kernels import dos_sweep
    from vpt_tpu_torch.renderers import dos

    params = dos.Params()
    size = 512
    coop = dos.reset(params, size, size, scene)
    dos.render_frame(coop, scene, params, 0.0, 1)
    results = []
    for plain in (False, True):
        whole = dos.reset(params, size, size, scene)
        bands = [(r0, {k: (v[r0:r1].clone() if k in ("color", "occlusion")
                           else v.clone()) for k, v in whole.items()})
                 for r0, r1 in ((0, 201), (201, size))]
        run = dos_sweep.band_slice_plain if plain else dos_sweep.band_slice
        active = dos.active_slices(bands[0][1], params)
        for k in range(active):
            ext = torch.cat([band["occlusion"] for _, band in bands])
            for r0, band in bands:
                run(band, ext, 0, scene, params, k, (r0, size))
        torch.cuda.synchronize()
        results.append({key: torch.cat([band[key] for _, band in bands])
                        for key in ("color", "occlusion")})
    err = 0.0
    for key in ("color", "occlusion"):
        check(torch.equal(results[0][key], results[1][key]),
              f"K9 band: {key} differs from the plain twin")
        gap = float((results[0][key] - coop[key]).abs().max())
        check(gap <= 5e-4, f"K9 band: {key} {gap} from the cooperative "
              "sweep (bound 5e-4, bf16 tables)")
        err = max(err, gap)
    state = dos.reset(params, size, size, scene)
    ext = state["occlusion"].clone()
    band_ms = cuda_ms(lambda: dos_sweep.band_slice(
        state, ext, 0, scene, params, 0, (0, size)), 200)
    band_device_ms = profiler_device_ms(lambda: dos_sweep.band_slice(
        state, ext, 0, scene, params, 0, (0, size)), "dos_band")
    frame = dos.reset(params, size, size, scene)
    def coop_frame():
        dos_sweep.sweep_frame({**frame, "depth": frame["depth"].clone()},
                              scene, params)

    coop_ms = cuda_ms(coop_frame, 20) / active
    coop_device_ms = profiler_device_ms(coop_frame, "dos_sweep_kernel", 20)
    if coop_device_ms is not None:
        coop_device_ms /= active
    plain_ms = cuda_ms(lambda: dos_sweep.band_slice_plain(
        state, ext, 0, scene, params, 0, (0, size)), 5)
    nbytes, ops, written, _ = dos_work(scene, params, size, size, 1)
    nbytes, ops = nbytes / active, ops / active
    bound_ms, bound_by = roofline(nbytes, ops)
    print(f"dos_sweep band: two bands of a 512^2 sweep's first frame "
          f"({active} slices) equal their plain twin bit for bit, the "
          f"cooperative K9 within {err:.3g} (bound 5e-4); a whole-image "
          f"band slice {band_ms:.4f} ms, device {fmt_ms(band_device_ms)} "
          f"(the cooperative frame {coop_ms:.4f} ms a slice, device "
          f"{fmt_ms(coop_device_ms)} a slice), plain twin {plain_ms:.4f} ms a "
          f"slice; bound {bound_ms:.4f} ms a slice ({bound_by}, "
          f"{nbytes:.6g} bytes)", flush=True)
    return {"max_abs_err": err, "ms": band_ms, "device_ms": band_device_ms,
            "coop_ms_per_slice": coop_ms,
            "coop_device_ms_per_slice": coop_device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


#: the demos at their default sizes, and the kernels each must launch
DEMOS = (("render_demo", ("mcm_event", "march_frame", "iso_shade",
                          "mcs_frame", "dos_sweep", "lao_march", "tonemap")),
         ("inverse_demo", ("corner_gather", "corner_scatter")),
         ("depth_fit_demo", ("corner_gather", "corner_scatter")))


def phase_demos_path(dev, counters):
    """``path demos``: the three demos' ``main`` at their default sizes on
    the card, each with every launch counter at 0 first and read after.
    Returns the launches summed over the three."""
    import contextlib
    import importlib
    import io

    import torch

    totals = {name: 0 for name in counters}
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke", "render_demo.png")
    for name, kernels in DEMOS:
        demo = importlib.import_module(f"vpt_tpu_torch.examples.{name}")
        argv = ["--out", out] if name == "render_demo" else []
        for module in counters.values():
            module.LAUNCHES = 0
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            demo.main(argv)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = {k: m.LAUNCHES for k, m in counters.items()}
        for kernel in kernels:
            check(launches[kernel] > 0, f"path demos {name}: {kernel} not "
                  "launched")
        for k, v in launches.items():
            totals[k] += v
        last = text.getvalue().strip().splitlines()[-1]
        print(f"path demos {name}: {call_s:.3f} s; {last}; launches: "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v),
              flush=True)
    check(png_pixels(out).shape == (384, 768, 3),
          "path demos: the montage is not 2 x 4 panels of 192^2")
    demo_panels_agree()
    return totals


def demo_panels_agree():
    """``render_demo``'s eight HDR images at 192² (before the tone map)
    against the same progressive renders through each kernel's plain
    version (:func:`plain_frame`, the seeds of ``render_progressive``;
    ISO's display through ``iso_shade_plain``), within
    ``compare_states``' bounds (Depth and ISO equal); its launches come
    after ``path demos``' counts were read."""
    import numpy as np

    from vpt_tpu_torch.examples import render_demo
    from vpt_tpu_torch.kernels import iso_shade
    from vpt_tpu_torch.renderers import make_renderer

    t0 = time.perf_counter()
    res = 192
    scene = render_demo.demo_scene()
    got = render_demo.render_images(scene, res, verbose=False)
    before = launch_counts()
    for key in sorted(got):
        r = make_renderer(key, height=res, width=res)
        rs = np.random.default_rng(1)
        state = r.module.reset(r.params, res, res, scene)
        for n in range(1, render_demo.FRAMES.get(key, 4) + 1):
            plain_frame(key, state, scene, r.params,
                        np.float32(rs.random(dtype=np.float32)), n)
        want = iso_shade.iso_shade_plain(state, scene, r.params) \
            if key == "iso" else r.module.display(state, scene, r.params)
        check(launch_counts() == before,
              f"path demos: the plain {key} render launched a kernel")
        compare_states("render_demo 192^2", key, got[key], want,
                       key in ("depth", "iso"))
    print(f"path demos render_demo: the eight images against their plain "
          f"versions; {time.perf_counter() - t0:.1f} s", flush=True)


def run():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from vpt_tpu_torch.kernels import _build, corner_gather
        from vpt_tpu_torch.kernels import corner_scatter, dos_sweep
        from vpt_tpu_torch.kernels import iso_shade, lao_march, march
        from vpt_tpu_torch.kernels import mcm_event, mcs_frame, tf1d
        from vpt_tpu_torch.kernels import tonemap_kernel
    except ImportError as exc:
        raise SmokeFailure(f"vpt_tpu_torch is not importable from {root}: "
                           f"{exc}") from exc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
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
    t0 = time.perf_counter()
    k4_bucket, k4_fit_call = phase_bucket_kernel(dev)
    k4.update(k4_fit_call)
    k4["max_abs_err"] = max(k4["max_abs_err"],
                            k4_fit_call["fit_eam_call_max_abs_err"])
    print(f"corner_grad_bucket: {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_fit_check(dev)

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene, mcm

    headline = make_scene(volume.sphere_volume(128),
                          transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                          tracking="auto", pack_dtype=torch.bfloat16,
                          tf_mxu=True)
    occupancy = print_event_occupancy(headline)
    params8 = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    for height, width, frames in ((512, 512, 3), (512, 1024, 2)):
        err = _frames_agree(headline, params8, height, width, frames,
                            f"headline {width}x{height} {frames} frames")[1]
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
    k5.update(time_event_kernel(headline, params8))
    for steps in (8, 32):
        k5[f"device_ms_steps{steps}"], k5[f"bound_ms_steps{steps}"], _ = \
            print_kernel_device_ms(headline, steps)
    # the row's frame is the steps-8 one
    k5["device_ms"] = k5["device_ms_steps8"]
    k5["registers"] = occupancy["registers"]
    k5["blocks_per_sm"] = occupancy["blocks_per_sm"]

    errors = phase_frame_kernels(headline, dev)
    k6, k7, k8 = time_frame_kernels(headline)
    for row, name in ((k6, "march_frame"), (k7, "iso_shade"),
                      (k8, "mcs_frame")):
        row["max_abs_err"] = errors[name]
    k9, k10 = phase_dos_lao(headline)
    window_errors = phase_window_checks(headline)
    for row, name in ((k5, "mcm_event"), (k6, "march_frame"),
                      (k8, "mcs_frame"), (k10, "lao_march")):
        row["window_max_abs_err"] = window_errors[name]
        row["max_abs_err"] = max(row["max_abs_err"], window_errors[name])

    counters = {"mcm_event": mcm_event, "tf1d_lookup": tf1d,
                "tonemap": tonemap_kernel, "corner_gather": corner_gather,
                "corner_scatter": corner_scatter, "march_frame": march,
                "iso_shade": iso_shade, "mcs_frame": mcs_frame,
                "dos_sweep": dos_sweep, "lao_march": lao_march,
                "mcm_event_halo": LaunchCounter(mcm_event, "HALO_LAUNCHES"),
                "corner_gather_slab": LaunchCounter(corner_gather,
                                                    "SLAB_LAUNCHES"),
                "dos_band": LaunchCounter(dos_sweep, "BAND_LAUNCHES"),
                "corner_scatter_bucket": LaunchCounter(corner_scatter,
                                                       "BUCKET_LAUNCHES"),
                "mcm_event_resident": LaunchCounter(mcm_event,
                                                    "RESIDENT_LAUNCHES"),
                "mcm_event_halo_rg": LaunchCounter(mcm_event,
                                                   "HALO_RG_LAUNCHES"),
                "mcm_event_resident_rg": LaunchCounter(
                    mcm_event, "RESIDENT_RG_LAUNCHES"),
                "dos_halo_band": LaunchCounter(dos_sweep,
                                               "HALO_BAND_LAUNCHES"),
                **halo_counters()}
    t0 = time.perf_counter()
    scenes = slab_scenes()
    k3_slab = phase_slab_fetch(scenes)
    k5_halo = phase_halo_event(scenes["headline"])
    k5_halo_rg = phase_halo_layouts(scenes)
    k9_band = phase_dos_band(scenes["headline"])
    t1 = time.perf_counter()
    halo_rows = phase_halo_frames(scenes)
    print(f"halo frame kernels: {time.perf_counter() - t1:.1f} s",
          flush=True)
    new_rows = phase_halo_lao_band(scenes)
    halo_rows["lao_halo"] = new_rows["lao_halo"]
    k9_halo_band = new_rows["dos_halo_band"]
    del scenes
    torch.cuda.empty_cache()
    print(f"halo kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    rates, render_launches = phase_main_path(dev, counters)
    paths = phase_renderer_paths(dev, counters, headline)
    unpacked_launches, unpacked_errors = phase_unpacked_path(dev, counters)
    grid5, _ = phase_grid_path(dev, counters, headline, rates)
    env5, env8, _ = phase_env_path(dev, counters, headline)
    clamp6, _ = phase_clamp_path(dev, counters, headline)
    for row, extra, keys in ((k5, {**grid5, **env5}, ("grid_max_abs_err",
                                                      "env_max_abs_err")),
                             (k8, env8, ("env_max_abs_err",)),
                             (k6, clamp6, ("clamp_max_abs_err",))):
        row.update(extra)
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [extra[k] for k in keys])
    del headline
    torch.cuda.empty_cache()
    ext_rows = {}
    for key, phase in (("channels", phase_channels_path),
                       ("filters", phase_filters_path)):
        t0 = time.perf_counter()
        fields, worst, launches = phase(dev, counters)
        merge_ext(ext_rows, worst, fields, key)
        for name in EXT_NAMES:
            total = sum(got[name] for got in launches.values())
            check(total > 0, f"kernel {name} was not launched on path {key}")
            ext_rows[name][f"launches_{key}"] = total
        print(f"path {key}: {time.perf_counter() - t0:.1f} s", flush=True)
    for row, name in ((k5, "mcm_event"), (k6, "march_frame"),
                      (k7, "iso_shade"), (k8, "mcs_frame"),
                      (k9, "dos_sweep"), (k10, "lao_march")):
        row.update(ext_rows[name])
        row["max_abs_err"] = max(row["max_abs_err"],
                                 row["channels_max_abs_err"],
                                 row["filters_max_abs_err"])
    t0 = time.perf_counter()
    baked10, baked_err, baked_launches = phase_baked_path(dev, counters)
    check(baked_launches["lao_march"] > 0,
          "kernel lao_march was not launched on path baked")
    k10.update(baked10)
    k10["baked_max_abs_err"] = baked_err
    k10["max_abs_err"] = max(k10["max_abs_err"], baked_err)
    k10["launches_baked"] = baked_launches["lao_march"]
    print(f"path baked: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    cli_launches = phase_cli_path(dev, counters)
    fit_launches = phase_fit_path(dev, counters)
    t0 = time.perf_counter()
    fit_mcs_launches, fit_mcs_rows = phase_fit_mcs_path(dev, counters)
    print(f"path fit mcs: {time.perf_counter() - t0:.1f} s", flush=True)
    k3.update(fit_mcs_rows["corner_gather"])
    k4.update(fit_mcs_rows["corner_scatter"])
    inverse = {}
    for key, phase in (("fit eam", phase_fit_eam_path),
                       ("fit iso", phase_fit_iso_path),
                       ("inpaint", phase_inpaint_path)):
        t0 = time.perf_counter()
        inverse[key], rows_of = phase(dev, counters)
        k3.update(rows_of["corner_gather"])
        k4.update(rows_of["corner_scatter"])
        print(f"path {key}: {time.perf_counter() - t0:.1f} s", flush=True)
    bvp = os.path.join(root, "build", "smoke", "blobs256.bvp")
    t0 = time.perf_counter()
    view_launches = phase_view_path(dev, counters, bvp, card)
    print(f"path view: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    animate_launches = phase_animate_path(dev, counters, bvp)
    print(f"path animate: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    config3_launches, rows_of = phase_config3_path(dev, counters)
    k3.update(rows_of["corner_gather"])
    k4.update(rows_of["corner_scatter"])
    print(f"path config3: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    parallel_launches, parallel_errors, parallel_numbers = \
        phase_parallel_path(dev, counters)
    for row, name in ((k5, "mcm_event"), (k2, "tonemap"),
                      (k5_halo, "mcm_event_halo"), (k9_band, "dos_band"),
                      (k3_slab, "corner_gather_slab"),
                      (k4, "corner_scatter")):
        row["parallel_max_abs_err"] = parallel_errors[name]
        row["max_abs_err"] = max(row["max_abs_err"], parallel_errors[name])
    k5_halo["ms_1024_config4"] = parallel_numbers["halo_ms_1024"]
    k5_halo["whole_ms_1024_config4"] = parallel_numbers["whole_ms_1024"]
    k3_slab["config4_fit"] = {k: parallel_numbers[k] for k in (
        "fit_losses", "fit_step_s", "fit_peak_gib", "slab_fit_device_ms",
        "slab_fit_bound_ms")}
    k4_bucket["parallel"] = {k: parallel_numbers[k] for k in (
        "fit_step_s", "fit_peak_gib", "fit_k4_bucket_per_step",
        "eam_step_s", "eam_peak_gib", "eam_peak_above_gib",
        "eam_k4_bucket_per_step", "eam_k3_per_step")}
    resident_launches = parallel_numbers["resident_launches"]
    k5_resident = parallel_numbers["resident_rows"]["mcm_event_resident"]
    k5_resident_rg = parallel_numbers["resident_rows"][
        "mcm_event_resident_rg"]
    frames_launches = parallel_numbers["frames_launches"]
    for name, row in halo_rows.items():
        err = parallel_numbers["frames_errors"][name]
        row["parallel_max_abs_err"] = err
        row["max_abs_err"] = max(row["max_abs_err"], err)
    for key, turn in parallel_numbers["frames_turns"].items():
        name = HALO_NAME.get(key, "march_halo")
        halo_rows[name][f"ms_1024_config4_{key}"] = turn["halo"]
        halo_rows[name][f"whole_ms_1024_config4_{key}"] = turn["whole"]
    print(f"path parallel: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_parallel_gloo(dev)
    print(f"path parallel gloo: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    gloo4_launches, gloo4_errors, gloo4_seconds = phase_parallel_gloo4(dev)
    k9_halo_band["parallel_gloo4_max_abs_err"] = \
        gloo4_errors["dos_halo_band"]
    halo_rows["lao_halo"]["parallel_gloo4_max_abs_err"] = \
        gloo4_errors["lao_halo"]
    k9_halo_band["parallel_gloo4_frames_s"] = gloo4_seconds
    print(f"path parallel gloo 4: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    demos_launches = phase_demos_path(dev, counters)
    print(f"path demos: {time.perf_counter() - t0:.1f} s", flush=True)
    for path, launches, names in (
            ("forward render", render_launches,
             ("mcm_event", "tf1d_lookup", "tonemap", "corner_gather")),
            ("fit", fit_launches,
             ("corner_gather", "corner_scatter", "tf1d_lookup")),
            ("fit mcs", fit_mcs_launches,
             ("corner_gather", "corner_scatter")),
            *((key, launches, ("corner_gather", "corner_scatter"))
              for key, launches in inverse.items()),
            ("view", view_launches, ("mcm_event", "tonemap", "march_frame",
                                     "iso_shade", "mcs_frame", "dos_sweep",
                                     "lao_march")),
            ("animate", animate_launches, ("mcm_event", "tonemap")),
            ("config3", config3_launches,
             ("mcm_event", "corner_gather", "corner_scatter", "tonemap")),
            ("unpacked", unpacked_launches,
             ("mcm_event", "march_frame", "iso_shade", "mcs_frame",
              "dos_sweep", "lao_march")),
            ("parallel", parallel_launches,
             ("mcm_event", "tonemap", "corner_gather",
              "corner_scatter_bucket", "mcm_event_halo",
              "corner_gather_slab", "dos_band")),
            ("demos", demos_launches,
             ("mcm_event", "march_frame", "iso_shade", "mcs_frame",
              "dos_sweep", "lao_march", "tonemap", "corner_gather",
              "corner_scatter")),
            ("resident", resident_launches,
             ("mcm_event_resident", "mcm_event_resident_rg",
              "mcm_event_halo_rg")),
            ("halo frames", frames_launches, tuple(HALO_COUNTERS)),
            ("parallel gloo 4", gloo4_launches,
             ("lao_halo", "dos_halo_band"))):
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
                        "mcm_event (the fit path launches it too, once an "
                        "event of the no_grad target render)", **k1},
        {"name": "tonemap", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/tonemap.cu",
         "replaces": "vpt_tpu/pallas/tonemap_kernel.py:36",
         "launched_by": "ToneMapper('reinhard') on the display image", **k2},
        {"name": "corner_gather", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/corner_gather.cu",
         "replaces": "benchmarks/pallas_gather.py:26",
         "launched_by": "train.fit_mc: sampling.CornerFetch forward, one "
                        "corner_fetch with saved cells per event, and one "
                        "per event of the no_grad target render (fit "
                        "path); train.fit_mc(renderer='mcs'): the no-grad "
                        "fetch of every tracking step of the TF fit, and "
                        "CornerFetch in its 64^2 volume-gradient check "
                        "(fit mcs path); cli fit: CornerFetch forward, one "
                        "a chunk of 8 slices a view (fit eam path), one a "
                        "diff_iso render (fit iso path), one an event of "
                        "the MCM fit (inpaint path); Scene.sample_color "
                        "(render path)",
         **k3},
        {"name": "corner_scatter", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/corner_scatter.cu",
         "replaces": "benchmarks/pallas_scatter_bwd.py:41",
         "launched_by": "train.fit_mc: sampling.CornerFetch backward, one "
                        "corner_grad per event (fit path); the backward of "
                        "mcs_expected_image's volume gradient, one a "
                        "tracking step (fit mcs path); cli fit: the "
                        "backward of each CornerFetch above (fit eam, fit "
                        "iso and inpaint paths)", **k4},
        {"name": "corner_scatter_bucket", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/corner_scatter.cu",
         "replaces": "benchmarks/pallas_scatter_bwd.py:41",
         "launched_by": "the backward of a sampling.BucketedTable's join: "
                        "one corner_grad_bucket a z bucket in ascending z, "
                        "each bucket's reduction issued before the next "
                        "launch (the parallel path: "
                        "overlap.bucketed_train_step's EAM steps, 4 a step, "
                        "and halo_grad.make_sharded_grad's config-4 fit "
                        "steps, 4 a step); ms and device_ms bucket 0 of a "
                        "bucketed EAM step", **k4_bucket},
        {"name": "march_frame", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/march.cu",
         "replaces": "vpt_tpu/renderers/_march.py:29",
         "launched_by": "Renderer.render of eam, mip, depth and iso (every "
                        "frame; the EAM, MIP, Depth and ISO paths); runs "
                        "the ray.cuh corner fetch and the tf1d.cuh lookup "
                        "on every sample", **k6},
        {"name": "iso_shade", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/iso_shade.cu",
         "replaces": "vpt_tpu/renderers/iso.py:109",
         "launched_by": "Renderer.display of iso (the ISO path)", **k7},
        {"name": "mcs_frame", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcs_frame.cu",
         "replaces": "vpt_tpu/renderers/mcs.py:47",
         "launched_by": "Renderer.render of mcs (every frame; the MCS "
                        "path)", **k8},
        {"name": "dos_sweep", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/dos_sweep.cu",
         "replaces": "vpt_tpu/renderers/dos.py:126",
         "launched_by": "Renderer.render of dos (one cooperative launch a "
                        "frame; the DOS path, and the ext instance on the "
                        "channels and filters paths); runs the ray.cuh "
                        "corner fetch and the tf1d.cuh lookup", **k9},
        {"name": "lao_march", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/lao_march.cu",
         "replaces": "vpt_tpu/renderers/lao.py:63",
         "launched_by": "Renderer.render of lao (every frame; the LAO "
                        "path, the ext instance on the channels and filters "
                        "paths, the baked instance on the baked path); runs "
                        "the ray.cuh corner fetch", **k10},
        {"name": "mcm_event_halo", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcm_event.cu",
         "replaces": "vpt_tpu/parallel/halo.py:199",
         "launched_by": "halo.sharded_render_frame's MCM frame (steps + 1 "
                        "launches a frame, each finishing an event and "
                        "starting the next, the value's all-reduce between "
                        "them; the parallel path's 32 frames of config 4); "
                        "ms and device_ms a 512^2 headline frame of 8 "
                        "events on one slab",
         **k5_halo},
        {"name": "corner_gather_slab", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/corner_gather.cu",
         "replaces": "benchmarks/pallas_gather.py:26",
         "launched_by": "halo_grad.make_sharded_grad: "
                        "sampling.SlabCornerFetch forward, one masked slab "
                        "fetch an event of the MCM expected image (the "
                        "parallel path's config-4 fit); its backward is "
                        "corner_scatter_bucket", **k3_slab},
        {"name": "dos_band", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/dos_sweep.cu",
         "replaces": "vpt_tpu/parallel/dos_halo.py:70",
         "launched_by": "dos_halo.sharded_render_frame and "
                        "shard.shard_render_frame of DOS: one launch an "
                        "active slice of a band (the parallel path's 1024^2 "
                        "frame); ms a slice of a 512^2 headline frame",
         **k9_band},
        {"name": "mcm_event_resident", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcm_event.cu",
         "replaces": "vpt_tpu/parallel/resident.py:441",
         "launched_by": "resident.resident_render_frame (steps + 1 "
                        "launches an exact frame around the migrations; "
                        "the resident path's 2 frames of config 4 at "
                        "1024^2 in a world of one); ms and device_ms a "
                        "frame there", **k5_resident},
        {"name": "mcm_event_halo_rg", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcm_event.cu",
         "replaces": "vpt_tpu/parallel/halo.py:199",
         "launched_by": "halo.sharded_render_frame's MCM frame on a "
                        "two-channel scene (the resident path's 2 frames "
                        "of a 128^3 RG scene at 512^2); ms and device_ms a "
                        "512^2 frame of that scene on one slab",
         **k5_halo_rg},
        {"name": "mcm_event_resident_rg", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcm_event.cu",
         "replaces": "vpt_tpu/parallel/resident.py:441",
         "launched_by": "resident.resident_render_frame on a two-channel "
                        "scene (the resident path's 2 frames of a 128^3 RG "
                        "scene at 512^2); ms and device_ms a frame there",
         **k5_resident_rg},
        {"name": "march_halo", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/march.cu",
         "replaces": "vpt_tpu/parallel/halo.py:248",
         "launched_by": "halo.sharded_render_frame's EAM, MIP, Depth and "
                        "ISO frames (2 launches a frame, a fetch of every "
                        "slice and a fold, one all-reduce of the values "
                        "between them; the halo frames path of config 4 at "
                        "1024^2); ms and device_ms a 512^2 headline EAM "
                        "frame on one slab (every mode beside it)",
         **halo_rows["march_halo"]},
        {"name": "iso_shade_halo", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/iso_shade.cu",
         "replaces": "vpt_tpu/parallel/halo.py:263",
         "launched_by": "ISO's display over a HaloScene (2 launches around "
                        "one all-reduce of the hits' seven fetches, their "
                        "slots in pixel order; the halo frames path); ms "
                        "and device_ms a 512^2 headline display on one "
                        "slab", **halo_rows["iso_shade_halo"]},
        {"name": "mcs_halo", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/mcs_frame.cu",
         "replaces": "vpt_tpu/parallel/halo.py:199",
         "launched_by": "halo.sharded_render_frame's MCS frame (a launch a "
                        "fetch of the slowest pixel and one more, to the "
                        "end of a batch of HALO_BATCH, HALO_REDUCE_BATCH "
                        "where a group sums, between two host "
                        "reads; the halo frames path); ms, call_ms and "
                        "device_ms a 512^2 headline frame on one slab, "
                        "extinction 8",
         **halo_rows["mcs_halo"]},
        {"name": "dos_halo", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/dos_sweep.cu",
         "replaces": "vpt_tpu/parallel/halo.py:248",
         "launched_by": "halo.sharded_render_frame's DOS frame (a fetch of "
                        "every slice, an all-reduce and a cooperative fold "
                        "a frame; the halo frames path); ms, call_ms and "
                        "device_ms a 512^2 headline sweep's first frame on "
                        "one slab", **halo_rows["dos_halo"]},
        {"name": "lao_halo", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/lao_march.cu",
         "replaces": "vpt_tpu/parallel/halo.py:237",
         "launched_by": "halo.sharded_render_frame's LAO frame "
                        "(ceil(slices / 8) + 1 launches a frame, an "
                        "all-reduce of a chunk's 28 tap values a "
                        "pixel-slice between them; the halo frames path of "
                        "config 4 at 1024^2 and the four-rank gloo path); "
                        "ms and device_ms a 512^2 headline frame on one "
                        "slab", **halo_rows["lao_halo"]},
        {"name": "dos_halo_band", "route": "cuda",
         "source": "vpt_tpu_torch/csrc/dos_sweep.cu",
         "replaces": "vpt_tpu/parallel/halo.py:248",
         "launched_by": "halo.sharded_render_frame's DOS frame with rows "
                        "over data (dos.render_band: a fetch and an "
                        "all-reduce a chunk of 8 active slices, a fold a "
                        "slice; the four-rank gloo path, data 2 x space "
                        "2); ms and device_ms a 512^2 headline sweep's "
                        "first frame on two bands of one slab",
         **k9_halo_band},
    ]
    for row in rows:
        if row["name"] in ("mcm_event_resident", "mcm_event_halo_rg",
                           "mcm_event_resident_rg"):
            row["launches"] = resident_launches[row["name"]]
        elif row["name"] in ("mcm_event_halo", "corner_gather_slab",
                             "dos_band", "corner_scatter_bucket"):
            row["launches"] = parallel_launches[row["name"]]
        elif row["name"] in HALO_COUNTERS:
            row["launches"] = frames_launches[row["name"]]
        elif row["name"] == "dos_halo_band":
            row["launches"] = gloo4_launches[row["name"]]
        elif row["name"].startswith("corner"):
            row["launches"] = fit_launches[row["name"]] \
                + fit_mcs_launches[row["name"]] \
                + sum(got[row["name"]] for got in inverse.values())
            row["launches_fit_mcm"] = fit_launches[row["name"]]
        elif row["name"] in ("march_frame", "iso_shade", "mcs_frame",
                             "dos_sweep", "lao_march"):
            row["launches"] = sum(p["launches"][row["name"]]
                                  for p in paths.values())
        else:
            row["launches"] = render_launches[row["name"]]
        row["launches_cli"] = cli_launches[row["name"]]
        row["launches_view"] = view_launches[row["name"]]
        row["launches_animate"] = animate_launches[row["name"]]
        row["launches_config3"] = config3_launches[row["name"]]
        row["launches_unpacked"] = unpacked_launches[row["name"]]
        row["launches_parallel"] = parallel_launches[row["name"]]
        row["launches_demos"] = demos_launches[row["name"]]
        row["launches_resident"] = resident_launches[row["name"]]
        row["launches_halo_frames"] = frames_launches[row["name"]]
        if row["name"] in gloo4_launches:
            row["launches_parallel_gloo4"] = gloo4_launches[row["name"]]
        if row["name"] in unpacked_errors:
            row["unpacked_max_abs_err"] = unpacked_errors[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     unpacked_errors[row["name"]])
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all, the "
          "build included", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the contract's keys first, then what each kernel adds
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **{k: v for k, v in row.items() if k not in keys}}
        for row in rows]}), flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def _host_us(fn, reps=10_000):
    """Host microseconds per call of ``fn`` over ``reps`` calls
    (perf_counter_ns), after one warm-up call.  For a call that launches
    work this is the loop time: the larger of its host time and its
    device time once the launch queue is full."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return elapsed / reps / 1e3


def _host_turns(fns, reps=10_000, rounds=3):
    """Median host microseconds per call of each of ``fns`` (name ->
    callable) by :func:`_host_us`, in turns (A B ... B A, ``rounds``
    times): alternatives for one piece compared under the same drift."""
    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for name in order:
            times[name].append(_host_us(fns[name], reps))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def trace_counts(fn):
    """Run ``fn()`` once under torch.profiler: the kernels it ran on the
    card, its host-to-device copies and the stream synchronisations it
    waited on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return {"kernels": [e.name[:80] for e in events
                        if e.device_type == DeviceType.CUDA
                        and not e.name.startswith(("Memcpy", "Memset"))],
            "htod": sum("HtoD" in e.name for e in events),
            "stream_syncs": sum(e.name == "cudaStreamSynchronize"
                                for e in events)}


#: ``--part gloo``: the batches timed where the group sums (each the
#: frame's launches between two host reads), its rounds in turns and the
#: calls a turn
GLOO_BATCHES, GLOO_BATCH_ROUNDS, GLOO_BATCH_CALLS = (1, 2, 4, 8), 4, 10


def gloo_batch_rank(rank, world, store, out, tree):
    """One rank of ``--part gloo``: the K8 halo frame of ``path parallel
    gloo`` (the 256³ scene on ``space`` = 2 slabs at GLOO_HALO_RES²,
    extinction 8, one frame) over a ``gloo`` group on the one card, with
    each of GLOO_BATCHES as ``HALO_REDUCE_BATCH`` (a tree without it: its
    own frame), then K6's halo frame of EAM and K7's ISO display (of an
    ISO frame's hits) on the same slabs, all in turns, each call's time on
    the host clock between two synchronisations, and of it the host's time
    inside ``torch.distributed.all_reduce``; writes ``{out}{rank}.pt``:
    each call's turn medians of both (ms) and its launches, host reads and
    all-reduces."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import torch.distributed as dist

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import iso_shade, march, mcs_frame
    from vpt_tpu_torch.parallel import halo, make_mesh
    from vpt_tpu_torch.parallel.mesh import axis_group, axis_index
    from vpt_tpu_torch.renderers import make_scene

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        scene = make_scene(volume.blobs_volume(GLOO_HALO_VOLUME, seed=3),
                           transfer.gray_ramp(alpha_scale=0.9))
        mesh = make_mesh(world, space=world)
        hs = halo.halo_scene(scene, axis_index(mesh, "space"), world,
                             axis_group(mesh, "space"))
        mcs = renderer_module("mcs")
        params = mcs.Params(extinction=8.0)
        state = mcs.reset(params, GLOO_HALO_RES, GLOO_HALO_RES, scene)
        batches = GLOO_BATCHES if hasattr(mcs_frame, "HALO_REDUCE_BATCH") \
            else (0,)
        spent = [0.0]
        all_reduce = dist.all_reduce

        def timed_all_reduce(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return all_reduce(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t0

        dist.all_reduce = timed_all_reduce

        # the EAM halo frame and the ISO display of an ISO frame's hits on
        # the same slabs, as the tree's march and ISO display run them
        eam, iso = renderer_module("eam"), renderer_module("iso")
        eparams, iparams = eam.Params(), iso.Params()
        estate = eam.reset(eparams, GLOO_HALO_RES, GLOO_HALO_RES, scene)
        hits = iso.reset(iparams, GLOO_HALO_RES, GLOO_HALO_RES, scene)
        iso.render_frame(hits, scene, iparams, np.float32(0.37), 1)
        other = {
            "eam": (march, lambda: eam.render_frame(
                estate, hs, eparams, np.float32(0.37), 2)),
            "iso_display": (iso_shade, lambda: iso.display(hits, hs,
                                                           iparams))}

        def frame(k):
            if k in other:
                module, call = other[k]
                before = (module.HALO_LAUNCHES, 0,
                          halo.COLLECTIVES.get("all_reduce", 0))
            else:
                if k:
                    mcs_frame.HALO_REDUCE_BATCH = k
                before = (mcs_frame.HALO_LAUNCHES,
                          getattr(mcs_frame, "HALO_READS", 0),
                          halo.COLLECTIVES.get("all_reduce", 0))

                def call():
                    mcs_frame.halo_mcs_frame(state, hs, params,
                                             np.float32(0.37), 1)
            torch.cuda.synchronize()
            spent[0] = 0.0
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms = ((time.perf_counter() - t0) * 1e3, spent[0] * 1e3)
            if k in other:
                return ms, (other[k][0].HALO_LAUNCHES - before[0], None,
                            halo.COLLECTIVES.get("all_reduce", 0)
                            - before[2])
            return ms, (mcs_frame.HALO_LAUNCHES - before[0],
                        getattr(mcs_frame, "HALO_READS", 0) - before[1],
                        halo.COLLECTIVES.get("all_reduce", 0) - before[2])

        calls = (*batches, *other)
        counts = {}
        for k in calls:
            for _ in range(3):
                counts[k] = frame(k)[1]
        turns = {k: [] for k in calls}
        reduce_turns = {k: [] for k in calls}
        for r in range(GLOO_BATCH_ROUNDS):
            for k in (calls if r % 2 == 0 else calls[::-1]):
                times = []
                for _ in range(GLOO_BATCH_CALLS):
                    ms, c = frame(k)
                    check(c == counts[k], f"gloo batch {k}: counts {c} "
                          f"against {counts[k]}")
                    times.append(ms)
                times.sort()
                turns[k].append(times[len(times) // 2][0])
                reduce_turns[k].append(sorted(
                    t[1] for t in times)[len(times) // 2])
        torch.save({"turns": turns, "reduce_turns": reduce_turns,
                    "counts": counts}, f"{out}{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gloo_batch_numbers(tree):
    """``--part gloo`` for the tree this process imported: two gloo ranks
    (:func:`gloo_batch_rank`), whose counts must agree; rank 0's call
    times.  Returns the numbers by name."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from vpt_tpu_torch.kernels import _build

    _build.library()   # built once, before the ranks load it
    folder = os.path.join(os.path.abspath(tree), "build", "smoke")
    os.makedirs(folder, exist_ok=True)
    store = tempfile.mktemp(dir=folder, prefix="gloo_store_")
    out = os.path.join(folder, "gloo_batch")
    mp.start_processes(gloo_batch_rank, args=(2, store, out, tree),
                       nprocs=2, start_method="spawn")
    got = [torch.load(f"{out}{r}.pt", weights_only=False) for r in (0, 1)]
    check(got[0]["counts"] == got[1]["counts"], "--part gloo: the ranks' "
          f"counts differ: {got[0]['counts']} against {got[1]['counts']}")
    numbers = {}
    for k, turns in got[0]["turns"].items():
        kernel, name = {"eam": ("march_halo", "eam"),
                        "iso_display": ("iso_shade_halo", "display")}.get(
            k, ("mcs_halo", f"B={k}" if k else "own"))
        launches, reads, reduces = got[0]["counts"][k]
        numbers[f"{kernel} gloo call_ms {name}"] = \
            sorted(turns)[len(turns) // 2]
        numbers[f"{kernel} gloo call_ms_range {name}"] = \
            f"{min(turns):.4f}-{max(turns):.4f}"
        reduces_ms = got[0]["reduce_turns"][k]
        numbers[f"{kernel} gloo all_reduce_ms {name}"] = \
            sorted(reduces_ms)[len(reduces_ms) // 2]
        numbers[f"{kernel} gloo launches {name}"] = launches
        if reads is not None:
            numbers[f"{kernel} gloo host_reads {name}"] = reads
        numbers[f"{kernel} gloo all_reduces {name}"] = reduces
    return numbers


#: ``--part bucketed``: the steps timed a call (after one warm-up step)
BUCKETED_STEPS = 5


def timed_steps(step, count):
    """The host seconds of ``count`` calls of ``step`` after one, each
    between two synchronisations; the card's peak memory above what was
    held before them, GiB; the last loss."""
    import torch

    step()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds, (torch.cuda.max_memory_allocated() - held) / 2 ** 30, \
        float(loss)


def k4_counts():
    """(whole-table K4 launches, K4 bucket launches) so far; a tree
    without the bucket instance counts 0 of it."""
    from vpt_tpu_torch.kernels import corner_scatter

    return corner_scatter.LAUNCHES, getattr(corner_scatter,
                                            "BUCKET_LAUNCHES", 0)


def bucketed_gloo_rank(rank, world, store, out, tree):
    """One rank of ``--part bucketed``'s two gloo ranks: the bucketed EAM
    step at GLOO_BUCKET_VOLUME³ (:func:`bucketed_eam_step`, rows over
    ``data`` = 2), BUCKETED_STEPS timed; writes ``{out}{rank}.pt``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        step = bucketed_eam_step(make_mesh(world, axes=("data",)),
                                 GLOO_BUCKET_VOLUME)
        before = k4_counts()
        seconds, peak, loss = timed_steps(step, BUCKETED_STEPS)
        k4 = [(a - b) // (BUCKETED_STEPS + 1)
              for a, b in zip(k4_counts(), before)]
        torch.save({"seconds": seconds, "peak": peak, "loss": loss,
                    "k4": k4}, f"{out}{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def bucketed_path_numbers(tree):
    """``--part bucketed`` for the tree this process imported: in a world
    of one over ``nccl``, ``path parallel``'s bucketed EAM step (64³) and
    config 4's fit step (``config4_pod512.fit_phase``: 512³ blobs, one
    slab, 4 buckets, 2 frames of the MCM expected image at 1024² against
    a flat target, 3 SGD steps), then on two gloo ranks the bucketed EAM
    step at GLOO_BUCKET_VOLUME³: each step's median host seconds and
    range, the peak memory above what was held, the K4 launches a step
    (whole table, bucket instance).  The 512³ volume is cached under
    ``build/smoke`` for the trees after the first."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.examples import config4_pod512
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.parallel import distributed, make_mesh
    from vpt_tpu_torch.renderers import make_scene, mcm

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    numbers = {}
    _build.library()
    check(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                 retries=2, retry_delay=1.0),
          "--part bucketed: no process group")
    try:
        grid = make_mesh(1)
        step = bucketed_eam_step(grid, 64)
        before = k4_counts()
        seconds, peak, loss = timed_steps(step, BUCKETED_STEPS)
        k4 = [(a - b) // (BUCKETED_STEPS + 1)
              for a, b in zip(k4_counts(), before)]
        numbers.update({
            "eam nccl step_s": median(seconds),
            "eam nccl step_s_range": f"{min(seconds):.4f}-"
                                     f"{max(seconds):.4f}",
            "eam nccl peak_above_gib": peak, "eam nccl loss": loss,
            "eam nccl k4_whole": k4[0], "eam nccl k4_bucket": k4[1]})
        del step
        torch.cuda.empty_cache()

        cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "smoke", "blobs512.pt")
        if os.path.exists(cache):
            data = torch.load(cache).cuda()
        else:
            data = volume.blobs_volume(PARALLEL_VOLUME, seed=3).data
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            torch.save(data.cpu(), cache)
        scene = make_scene(data, transfer.gray_ramp(alpha_scale=0.9))
        del data
        params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
        target = torch.full((PARALLEL_RES, PARALLEL_RES, 3), 0.05,
                            device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = k4_counts()
        losses, fit_s, _, fitted = config4_pod512.fit_phase(
            grid, scene, params, target, 3, 4, 1, "cuda",
            say=lambda *a: None)
        check(all(np.isfinite(losses)), f"--part bucketed: config 4 fit "
              f"losses {losses}")
        k4 = [(a - b) // len(fit_s) for a, b in zip(k4_counts(), before)]
        numbers.update({
            "config4 fit step_s": median(fit_s),
            "config4 fit step_s_range": f"{min(fit_s):.4f}-"
                                        f"{max(fit_s):.4f}",
            "config4 fit peak_gib": torch.cuda.max_memory_allocated()
            / 2 ** 30,
            "config4 fit peak_above_gib": (torch.cuda.max_memory_allocated()
                                           - held) / 2 ** 30,
            "config4 fit k4_whole": k4[0], "config4 fit k4_bucket": k4[1]})
        del scene, fitted
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    folder = os.path.join(os.path.abspath(tree), "build", "smoke")
    os.makedirs(folder, exist_ok=True)
    store = tempfile.mktemp(dir=folder, prefix="gloo_store_")
    out = os.path.join(folder, "bucketed_gloo")
    mp.start_processes(bucketed_gloo_rank, args=(2, store, out, tree),
                       nprocs=2, start_method="spawn")
    got = [torch.load(f"{out}{r}.pt", weights_only=False) for r in (0, 1)]
    for r, g in enumerate(got):
        numbers[f"eam gloo rank{r} step_s"] = median(g["seconds"])
        numbers[f"eam gloo rank{r} step_s_range"] = \
            f"{min(g['seconds']):.4f}-{max(g['seconds']):.4f}"
    numbers.update({"eam gloo peak_above_gib": got[0]["peak"],
                    "eam gloo loss": got[0]["loss"],
                    "eam gloo k4_whole": got[0]["k4"][0],
                    "eam gloo k4_bucket": got[0]["k4"][1]})
    return numbers


def launch_path_tree(tree, part="all"):
    """The launch paths in the port found at ``tree`` (this checkout or
    another, such as an archived parent under ``build/``).  ``part``
    "frames": those of K6, K7 and K8 (:func:`frame_path_numbers`); "fetch":
    those of K1 and K3, through calls that every tree with the
    differentiable fit takes alike: host microseconds a call of the pieces
    (the output, the stream handle, the library, the TF lookup and
    ``F.grid_sample`` in turns, ``corner_cells``, the fetch under no_grad
    and under autograd), loop and device times, one differentiable fetch's
    trace, ``Scene.sample_color`` and the 256³ fit's target render and
    value-and-grad; "all": both.  Returns the numbers as a dict."""
    sys.path.insert(0, os.path.abspath(tree))
    from vpt_tpu_torch import sampling

    check(os.path.abspath(sampling.__file__).startswith(
        os.path.abspath(tree)), f"vpt_tpu_torch not imported from {tree}")
    out = {"tree": tree}
    if part == "sweep":
        out["sweep"] = sweep_path_numbers()
        return out
    if part == "gloo":
        out["gloo"] = gloo_batch_numbers(tree)
        return out
    if part == "bucketed":
        out["bucketed"] = bucketed_path_numbers(tree)
        return out
    if part in ("frames", "all"):
        out["frames"] = frame_path_numbers()
    if part in ("fetch", "all"):
        out.update(fetch_path_numbers())
    return out


def _device_ms_per_call(fn, match, reps):
    """Device milliseconds a call of ``fn`` in the kernels whose name holds
    ``match``: torch.profiler's sum over ``reps`` calls (after one warm-up
    call) over ``reps``; None when it recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and match in e.key)
    return total / reps / 1e3 if total > 0 else None


def sweep_path_numbers():
    """The DOS and LAO paths in this process's tree, through
    ``make_renderer`` and ``dos``/``lao.render_frame``, which every tree
    since DOS and LAO were ported takes alike, on the headline scene at
    512² with default Params: a DOS sweep (``reset`` and the frames until
    the depth passes the far depth) on the host clock (the median of 5)
    and on the card (the profiler's sum of the DOS kernels over 3 sweeps),
    the host µs of one DOS frame call that finds the queue empty, the
    device time of a sweep's first frame at 1², 64² and 512², and a LAO
    frame's loop and device time; where the tree has them (since the band
    and halo instances), a sweep's first frame on the two bands of
    :data:`HALO_BANDS` through K9's band instance and the first frame
    over a one-slab HaloScene through K9's halo instance, device time a
    frame.  ``hashes``: a digest of each result's bytes (the sweep's
    state, the LAO frame, the band and halo frames), equal across trees
    when their states are."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import dos, lao, make_renderer, make_scene

    scene = make_scene(volume.sphere_volume(128),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking="auto", pack_dtype=torch.bfloat16,
                       tf_mxu=True)
    renderer = make_renderer("dos", height=512, width=512)
    params = renderer.params
    frames = dos_sweep_frames(scene, params, 512, 512)

    def sweep():
        renderer.reset(scene)
        for i in range(frames):
            renderer.render(scene, 0.2 + 0.001 * i)

    sweep()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    state = dos.reset(params, 512, 512, scene)
    out = {"dos sweep_ms": sorted(times)[2],
           "dos sweep_device_ms": _device_ms_per_call(sweep, "dos_", 3),
           "dos host_us_frame": _host_call_us(
               lambda: dos.render_frame(state, scene, params, 0.1, 1), 200)}
    # a sweep's first frame (its slices all active) at three sizes: what a
    # slice costs with next to no pixels is the per-slice floor of the
    # design (a launch, or a grid barrier)
    for size in (1, 64, 512):
        start = dos.reset(params, size, size, scene)

        def first_frame():
            dos.render_frame({k: v.clone() for k, v in start.items()}, scene,
                             params, 0.1, 1)

        out[f"dos first_frame_device_ms {size}^2"] = _device_ms_per_call(
            first_frame, "dos_", 10)
    lparams = lao.Params()
    lstate = lao.reset(lparams, 512, 512, scene)

    def frame():
        lao.render_frame(lstate, scene, lparams, 0.5, 1)

    out["lao frame_ms"] = cuda_ms(frame, 20)
    out["lao frame_device_ms"] = _device_ms_per_call(frame, "lao_", 20)
    out["lao host_us_frame"] = _host_call_us(frame, 100)
    hashes = {"lao frame": _digest(lstate)}
    renderer.reset(scene)
    for i in range(frames):
        renderer.render(scene, 0.2 + 0.001 * i)
    hashes["dos sweep"] = _digest(renderer.state)
    from vpt_tpu_torch.kernels import dos_sweep
    from vpt_tpu_torch.parallel import halo

    start = dos.reset(params, 512, 512, scene)

    def band(b, ext, row0, sc, p, k, window, n_active):
        dos_sweep.band_slice(b, ext, row0, sc, p, k, window)

    def bands():
        return band_pair_frame(scene, params, start, band)[0]

    out["dos band_frame_device_ms"] = _device_ms_per_call(bands, "dos_band",
                                                          10)
    hashes["dos band frame"] = _digest(bands())
    hs = halo.halo_scene(scene, 0, 1)

    def halo_frame():
        state = {k: v.clone() for k, v in start.items()}
        dos.render_frame(state, hs, params, 0.1, 1)
        return state

    out["dos halo_frame_device_ms"] = _device_ms_per_call(
        halo_frame, "dos_halo_", 10)
    # its kernels apart: the fetch and the fold (or the tree's chunks')
    for part in ("fetch", "fold"):
        out[f"dos halo_frame_{part}_device_ms"] = _device_ms_per_call(
            halo_frame, part + "_kernel", 10)
    hashes["dos halo frame"] = _digest(halo_frame())
    # the halo frame's call to a finished frame (host clock; the state
    # copied from the reset untimed first) at 512² and 1024², and its
    # device time at 1024²
    for size in (512, 1024):
        fresh = dos.reset(params, size, size, scene)
        timed = {k: v.clone() for k, v in fresh.items()}

        def setup(fresh=fresh, timed=timed):
            for k, v in fresh.items():
                timed[k].copy_(v)

        suffix = "" if size == 512 else f" {size}^2"
        out["dos halo_frame_call_ms" + suffix] = synced_call_ms(
            lambda timed=timed: dos.render_frame(timed, hs, params, 0.1, 1),
            10, setup=setup)
        if size == 1024:
            def halo_frame_1024(fresh=fresh):
                state = {k: v.clone() for k, v in fresh.items()}
                dos.render_frame(state, hs, params, 0.1, 1)
                return state

            out["dos halo_frame_device_ms 1024^2"] = _device_ms_per_call(
                halo_frame_1024, "dos_halo_", 5)
            for part in ("fetch", "fold"):
                out[f"dos halo_frame_{part}_device_ms 1024^2"] = \
                    _device_ms_per_call(halo_frame_1024, part + "_kernel", 5)
            hashes["dos halo frame 1024^2"] = _digest(halo_frame_1024())
        del fresh, timed
    if hasattr(dos_sweep, "HALO_BAND_LAUNCHES"):
        # the halo band instance, where the tree has it: the two bands
        # over the one-slab HaloScene, and the band_slice calls' host time
        # alone
        def halo_bands():
            return band_pair_frame(hs, params, start, dos_sweep.band_slice)[0]

        out["dos halo_band_frame_ms"] = cuda_ms(halo_bands, 5)
        out["dos halo_band_frame_device_ms"] = _device_ms_per_call(
            halo_bands, "dos_halo_", 5)
        call_us, calls = band_calls_host_us(hs, params, start)
        active = calls // len(HALO_BANDS)
        launches = len(HALO_BANDS) * (-(-active // 8) + active)
        out["dos halo_band host_us_call"] = call_us
        out["dos halo_band host_us_launch"] = call_us * calls / launches
        out["dos band host_us_slice"] = band_calls_host_us(scene, params,
                                                           start)[0]
        hashes["dos halo band frame"] = _digest(halo_bands())
        # K10's halo instance over the one-slab HaloScene
        lhs = halo.halo_scene(scene, 0, 1)

        def lao_halo():
            lao.render_frame(lstate, lhs, lparams, 0.5, 1)

        out["lao halo_frame_ms"] = cuda_ms(lao_halo, 10)
        out["lao halo_frame_device_ms"] = _device_ms_per_call(
            lao_halo, "lao_halo", 10)
        out["lao halo host_us_frame"] = _host_call_us(lao_halo, 50)
        hashes["lao halo frame"] = _digest(lstate)
    out["hashes"] = hashes
    return out


def _launch_us(fn, match, launches, reps=5):
    """The device µs of each launch of one call of ``fn`` in the kernels
    whose name holds ``match``, in launch order, from torch.profiler's
    events over ``reps`` calls (after a warm-up call): the median of the
    calls that recorded all ``launches``, as a string of numbers; "" when
    none did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and match in e.name),
                    key=lambda e: e.time_range.start)
    calls = [events[k:k + launches]
             for k in range(0, len(events) - launches + 1, launches)]
    if len(events) % launches or not calls:
        return ""
    mid = len(calls) // 2
    return " ".join(
        f"{sorted(c[j].time_range.elapsed_us() for c in calls)[mid]:.1f}"
        for j in range(launches))


def _kernel_split(fn, match):
    """{"<part>_device_ms": mean device ms a launch} of each kernel of a
    call of ``fn`` named ``<match>_<part>_kernel`` (:func:`kernel_means`);
    a kernel named ``<match>_kernel`` reports as ``all``."""
    out = {}
    for name, ms in kernel_means(fn).items():
        if match not in name:
            continue
        part = name.split(match, 1)[1].split("kernel", 1)[0].strip("_")
        out[f"{part or 'all'}_device_ms"] = ms
    return out


def _digest(state):
    """A digest of a state's (or a dict of states') bytes, key by key."""
    import hashlib

    h = hashlib.sha256()
    items = sorted(state.items()) if isinstance(state, dict) \
        else [("", state)]
    for key, value in items:
        h.update(key.encode())
        h.update(value.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fetch_path_numbers():
    """:func:`launch_path_tree`'s numbers of K1 and K3 and the fit."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vpt_tpu_torch import sampling, train, transfer, volume
    from vpt_tpu_torch.kernels import _build, tf1d
    from vpt_tpu_torch.renderers import diff_mc, make_scene, mcm

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(2)
    values = (torch.rand(512, 512, generator=g) * 1.2 - 0.1).to(dev)
    table, width = tf1d.pack_table(torch.rand(2, 256, 4, generator=g).to(dev))
    host, loop, device = {}, {}, {}

    # the candidates for an output and for the stream, each group in turns
    host.update(_host_turns({
        "torch_empty": lambda: torch.empty(
            values.shape + (4,), dtype=torch.float32, device=values.device),
        "new_empty": lambda: values.new_empty(values.shape + (4,))}))
    host.update(_host_turns({
        "stream_current_stream":
            lambda: torch.cuda.current_stream(values.device).cuda_stream,
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(0)}))
    host["library"] = _host_us(_build.library)
    tex = table.t().reshape(1, 4, 1, width).contiguous()
    grid = torch.stack([values * 2.0 - 1.0, torch.zeros_like(values)],
                       dim=-1)[None]

    def library():
        return F.grid_sample(tex, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    def kernel():
        return tf1d.lookup_1d(table, values, width)

    host.update(_host_turns({"lookup_1d": kernel, "grid_sample": library}))
    loop.update(in_turns({"lookup_1d_ms": kernel, "grid_sample_ms": library},
                         200))
    device["k1_ms"] = profiler_device_ms(kernel, "tf1d_kernel")
    device["grid_sample_ms"] = profiler_device_ms(library, "grid_sampler")

    # K3's path at the fit's shape: 256³ float32 table, 256² positions
    shape = (256, 256, 256, 1)
    gd = torch.Generator(device=dev).manual_seed(3)
    packed = sampling.pack_corner_volume(
        torch.rand(shape, device=dev, generator=gd))
    pos = torch.rand(256 * 256, 3, device=dev, generator=gd) * 1.2 - 0.1
    host["corner_cells"] = _host_us(
        lambda: sampling.corner_cells(pos, shape), 2000)

    def fetch():
        with torch.no_grad():
            return sampling.sample_volume_packed(packed, shape, pos)

    host["no_grad_fetch"] = _host_us(fetch, 2000)
    loop["no_grad_fetch_ms"] = cuda_ms(fetch, 200)
    device["no_grad_fetch_ms"] = profiler_device_ms(fetch, "")
    grad_table = packed.clone().requires_grad_(True)

    def diff_fetch():
        return sampling.sample_volume_packed(grad_table, shape, pos)

    host["differentiable_fetch"] = _host_us(diff_fetch, 2000)
    device["differentiable_fetch_ms"] = profiler_device_ms(diff_fetch, "")
    trace = trace_counts(diff_fetch)

    # the render path's sample_color on a 256³ scene, no autograd
    truth = make_scene(volume.blobs_volume(256),
                       transfer.gray_ramp(alpha_scale=0.8))
    with torch.no_grad():
        loop["sample_color_ms"] = cuda_ms(
            lambda: truth.sample_color(pos), 200)

    # the fit at 256³ / 256², steps 16, 16 frames: the target under no_grad
    # and one value-and-grad, host clock, synchronised; each run once
    # first, so that the caching allocator holds the graph's memory
    params = mcm.Params(extinction=train.MC_FIT_EXTINCTION["mcm"], steps=16)

    def target_render():
        with torch.no_grad():
            return diff_mc.mcm_expected_image(truth, params, 256, 256, 16)

    def value_and_grad():
        vol = torch.full(shape, 0.2, device=dev, requires_grad=True)
        loss = train.mc_loss({"volume": vol}, truth, target, params, 16,
                             np.float32(0.1))
        loss.backward()
        return float(loss.detach())

    fit = {}
    for name, fn in (("target_render_ms", target_render),
                     ("value_and_grad_ms", value_and_grad)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            fit[name] = (time.perf_counter() - t0) * 1e3
        if name == "target_render_ms":
            target = result
    fit["loss"] = result
    return {"host_us": host, "loop_ms": loop,
            "device_ms": device, "differentiable_fetch_trace": trace,
            "fit": fit}


def _host_call_us(fn, reps=300):
    """Host microseconds of one call of ``fn`` that finds the launch queue
    empty (the card synchronised before each), over ``reps`` calls after
    one warm-up call: what a wrapper costs the host a frame."""
    import torch

    fn()
    total = 0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / reps / 1e3


def frame_path_numbers():
    """K6's, K7's and K8's launch paths in this process's tree, through
    ``march.march_frame(mode, state, scene, params, seed, n)``,
    ``iso.display(state, scene, params)`` and ``mcs_frame.mcs_frame(state,
    scene, params, seed, n)``, which every tree with these renderers takes
    alike, on the headline scene with default Params: for each renderer at
    512², and ISO's display of one ISO frame's hits, the loop time a call
    (``ms``, CUDA events), the device time and the host µs a call
    (:func:`_host_call_us`); the halo instances of K8, K6 (each mode) and
    K7 over a one-slab HaloScene at 512² and 1024² where the tree has them
    (the call to a finished frame, loop and device time, launches, a
    digest); and the host µs of the wrapper's pieces over
    10^4 calls each where the tree has them (a wrapper that builds the
    argument list every frame: ``frame_scalars``, ``_scene_cache.get``,
    ``check_image``, ``torch.cuda.device``, the ctypes call; one with a
    prepared launch: its ``first``, ``frame_mix``, the cache and the ctypes
    call; both: the scatter direction, K7's argument list), the launching
    pieces at 1×1, where the host sets the pace."""
    import torch

    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.kernels import _build, iso_shade, march, mcs_frame
    from vpt_tpu_torch.renderers import depth, eam, iso, make_scene, mcs, mip

    scene = make_scene(volume.sphere_volume(128),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking="auto", pack_dtype=torch.bfloat16,
                       tf_mxu=True)
    frames = {}
    for key, module in (("eam", eam), ("mip", mip), ("depth", depth),
                        ("iso", iso), ("mcs", mcs)):
        params = module.Params()
        state = module.reset(params, 512, 512, scene)
        if key == "mcs":
            def call():
                mcs_frame.mcs_frame(state, scene, params, 0.5, 2)
        else:
            def call():
                march.march_frame(key, state, scene, params, 0.5, 2)
        frames[key] = {
            "ms": cuda_ms(call, 200),
            "device_ms": profiler_device_ms(
                call, "mcs_frame_kernel" if key == "mcs" else "march_kernel",
                50),
            "host_us": _host_call_us(call)}
    # ISO's display of one ISO frame's hits
    iso_params = iso.Params()
    hits = iso.reset(iso_params, 512, 512, scene)
    march.march_frame("iso", hits, scene, iso_params, 0.4, 1)

    def display():
        return iso.display(hits, scene, iso_params)

    frames["iso_display"] = {
        "ms": cuda_ms(display, 200),
        "device_ms": profiler_device_ms(display, "iso_shade_kernel", 50),
        "host_us": _host_call_us(display)}
    # K8's halo instance over a one-slab HaloScene (extinction 8), where the
    # tree has it: a frame's call to a finished frame (host clock), its
    # loop and device time, launches and host reads (one a launch in a
    # tree without HALO_READS), and a digest of a frame from the reset
    if hasattr(mcs_frame, "halo_mcs_frame"):
        from vpt_tpu_torch.parallel import halo

        hs = halo.halo_scene(scene, 0, 1)
        hparams = mcs.Params(extinction=8.0)
        for size in (512, 1024):
            start = mcs.reset(hparams, size, size, scene)
            state = start.clone()

            def halo_call(state=state):
                mcs_frame.halo_mcs_frame(state, hs, hparams, 0.5, 2)

            reads = getattr(mcs_frame, "HALO_READS", None)
            launches = mcs_frame.halo_mcs_frame(start.clone(), hs, hparams,
                                                0.5, 2)
            reads = launches if reads is None \
                else mcs_frame.HALO_READS - reads
            first = start.clone()
            mcs_frame.halo_mcs_frame(first, hs, hparams, 0.5, 2)
            frames[f"mcs_halo {size}^2"] = {
                "call_ms": synced_call_ms(halo_call, 20),
                "ms": cuda_ms(halo_call, 20),
                "device_ms": _device_ms_per_call(halo_call, "mcs_halo_", 10),
                "launches": launches, "host_reads": reads,
                "launch_us": _launch_us(halo_call, "mcs_halo_", launches),
                "digest": _digest(first)}

    # K6's halo instance in every mode and K7's (ISO's display of one ISO
    # frame's hits) over a one-slab HaloScene, where the tree has them: a
    # call to a finished frame (host clock), its loop and device time, its
    # launches and a digest of a frame from the reset (of the display)
    if hasattr(march, "halo_march_frame"):
        from vpt_tpu_torch.parallel import halo

        hs = halo.halo_scene(scene, 0, 1)
        for size in (512, 1024):
            for key, module in (("eam", eam), ("mip", mip),
                                ("depth", depth), ("iso", iso)):
                params = module.Params()
                start = module.reset(params, size, size, scene)
                state = start.clone()

                def march_call(state=state, key=key, params=params):
                    march.march_frame(key, state, hs, params, 0.5, 2)

                first = start.clone()
                launches = march.HALO_LAUNCHES
                march.march_frame(key, first, hs, params, 0.5, 2)
                launches = march.HALO_LAUNCHES - launches
                frames[f"march_halo {key} {size}^2"] = {
                    "call_ms": synced_call_ms(march_call, 20),
                    "ms": cuda_ms(march_call, 20),
                    "device_ms": _device_ms_per_call(march_call,
                                                     "march_halo", 10),
                    **_kernel_split(march_call, "march_halo"),
                    "launches": launches, "digest": _digest(first)}
            shown = iso.reset(iso_params, size, size, scene)
            march.march_frame("iso", shown, scene, iso_params, 0.4, 1)

            def halo_display(shown=shown):
                return iso.display(shown, hs, iso_params)

            launches = iso_shade.HALO_LAUNCHES
            image = halo_display()
            launches = iso_shade.HALO_LAUNCHES - launches
            frames[f"iso_halo {size}^2"] = {
                "call_ms": synced_call_ms(halo_display, 20),
                "ms": cuda_ms(halo_display, 200),
                "device_ms": _device_ms_per_call(halo_display, "iso_halo_",
                                                 50),
                **_kernel_split(halo_display, "iso_halo"),
                "launches": launches, "digest": _digest(image)}

    pieces = {}
    params, mparams = eam.Params(), mcs.Params()
    state = eam.reset(params, 512, 512, scene)
    tiny = eam.reset(params, 1, 1, scene)
    tiny_mcs = mcs.reset(mparams, 1, 1, scene)
    lib = _build.library()
    stream = _build.current_stream(0)
    if hasattr(march, "launch_args"):          # the argument-list wrapper
        def context():
            with torch.cuda.device(state.device):
                pass

        args = march.launch_args("eam", tiny, scene, params, 0.5, 2)
        pieces.update(
            frame_scalars=_host_us(
                lambda: march.frame_scalars("eam", params, 0.5, 2)),
            scene_cache_get=_host_us(lambda: march._scene_cache.get(scene)),
            check_image=_host_us(lambda: _build.check_image(
                state, (512, 512, 4), state.device, "the eam state")),
            device_context=_host_us(context),
            launch_args=_host_us(lambda: march.launch_args(
                "eam", state, scene, params, 0.5, 2)),
            ctypes_call_1x1=_host_us(lambda: lib.vpt_march_frame(*args)))
    if hasattr(march, "first_of"):             # the prepared launch
        key = ("eam", params, 1, 1)
        p = march._scene_cache.get(scene, key)
        pieces.update(
            first=_host_us(lambda: p.first(0.5)),
            frame_mix=_host_us(lambda: march.frame_mix(2)),
            scene_cache_get=_host_us(lambda: march._scene_cache.get(scene,
                                                                    key)),
            ctypes_call_1x1=_host_us(lambda: p.launch(
                p.address, tiny.data_ptr(), 0.1, 0.5, stream)))
    # K7 at 1x1: the argument list every build exports, and the prepared
    # launch where the tree has one
    tiny_iso = iso.reset(iso_params, 1, 1, scene)
    tiny_out = torch.empty_like(tiny_iso)
    _, sargs = _build.scene_args(scene, scene.volume_packed, "ISO shade")
    light = iso.light_direction(scene, iso_params).tolist()
    legacy = (tiny_iso.data_ptr(), tiny_out.data_ptr(), *sargs[:-1], 1, 1,
              _build.f32(iso_params.gradient_step),
              _build.f32(2.0 * _build.f32(iso_params.gradient_step)), *light,
              stream)
    pieces["iso_argument_list_1x1"] = _host_us(
        lambda: lib.vpt_iso_shade(*legacy))
    if hasattr(iso_shade, "occupancy"):        # the prepared launch
        key = (iso_params, 1, 1)
        p = iso_shade._scene_cache.get(scene, key)
        pieces.update(
            iso_scene_cache_get=_host_us(
                lambda: iso_shade._scene_cache.get(scene, key)),
            iso_new_empty=_host_us(lambda: tiny_iso.new_empty(p.shape)),
            iso_ctypes_call_1x1=_host_us(lambda: p.launch(
                p.address, tiny_iso.data_ptr(), tiny_out.data_ptr(),
                stream)))
    pieces.update(
        mcs_scatter_direction=_host_us(lambda: mcs.scatter_direction(0.5)),
        march_frame_1x1=_host_us(lambda: march.march_frame(
            "eam", tiny, scene, params, 0.5, 2)),
        mcs_frame_1x1=_host_us(lambda: mcs_frame.mcs_frame(
            tiny_mcs, scene, mparams, 0.5, 2)),
        iso_display_1x1=_host_us(lambda: iso.display(tiny_iso, scene,
                                                     iso_params)))
    return {"frames": frames, "pieces_host_us": pieces}


def launch_path(trees, part="all"):
    """:func:`launch_path_tree` for each tree in turn, each in its own
    process (two trees' packages cannot share one), then a table of the
    numbers by tree."""
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--launch-path-tree", tree, part],
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        check(proc.returncode == 0, f"launch path of {tree} failed")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line)["launch_path"])
    tables = [part] if part in ("sweep", "gloo", "bucketed") else []
    if part == "sweep":
        for r in results:
            r["hashes"] = r["sweep"].pop("hashes", {})
        tables.append("hashes")
    if part in ("frames", "all"):
        for r in results:
            for key, row in r["frames"]["frames"].items():
                for k, v in row.items():
                    r.setdefault("frame", {})[f"{key} {k}"] = v
            r["pieces"] = r["frames"]["pieces_host_us"]
        tables += ["frame", "pieces"]
    if part in ("fetch", "all"):
        tables += ["host_us", "loop_ms", "device_ms", "fit"]
    for section in tables:
        names = sorted({k for r in results for k in r[section]})
        for name in names:
            cells = [r[section].get(name) for r in results]
            print(f"{section:9s} {name:30s} " + " ".join(
                "-" if v is None else v if isinstance(v, str)
                else f"{v:12.4f}" for v in cells), flush=True)
    for r in results:
        if "differentiable_fetch_trace" not in r:
            continue
        t = r["differentiable_fetch_trace"]
        print(f"{r['tree']}: one differentiable fetch ran "
              f"{len(t['kernels'])} kernels, {t['htod']} host-to-device "
              f"copies, {t['stream_syncs']} stream synchronisations",
              flush=True)
    return results


def main() -> int:
    if "--launch-path-tree" in sys.argv:
        tree, part = sys.argv[sys.argv.index("--launch-path-tree") + 1:][:2]
        print(json.dumps({"launch_path": launch_path_tree(tree, part)}),
              flush=True)
        return 0
    if "--launch-path" in sys.argv:
        import torch

        check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
        trees = sys.argv[sys.argv.index("--launch-path") + 1:]
        part = "all"
        if trees[:1] == ["--part"]:
            part, trees = trees[1], trees[2:]
        launch_path(trees, part)
        return 0
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
