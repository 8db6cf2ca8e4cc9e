"""Command-line interface of the port.

Mirrors ``vpt_tpu/cli.py``.  The renderer Params dataclasses are
introspected into flags (``--mcm-extinction``, ``--iso-isovalue``, …), the
counterpart of the reference's PropertyBag settings dialogs.  Every command
renders on the CUDA card unless ``--platform cpu`` is given; without a card
it raises.

    python -m vpt_tpu_torch.cli render --platform cpu --volume sphere:32 \\
        --renderer eam --resolution 64 --spp 4 -o /tmp/r.png

    python -m vpt_tpu_torch.cli fit --platform cpu --target a.png b.png \\
        c.png --grid 16 --steps 20 --eam-slices 32 --inpaint-blind

    python -m vpt_tpu_torch.cli animate --platform cpu --volume sphere:32 \\
        --renderer eam --resolution 64 --spp 4 --frames 8 -o /tmp/anim \\
        --video /tmp/anim.gif

    python -m vpt_tpu_torch.cli view --volume blobs:128 --port 8000

Subcommands:
  render   — progressive render of a volume to PNG (sample-counted)
  animate  — render an orbit or circle animation to PNG frames, and with
             ``--video`` to .mp4/.webm/.avi (OpenCV) or .gif (PIL)
  fit      — inverse-render a volume from images: multi-view EAM, the
             MCM/MCS estimators, or ISO depth (``--method``), with the
             occlusion completion of ``inpaint`` (``--inpaint``,
             ``--inpaint-blind``)
  view     — the interactive browser viewer (``runtime.viewer``)
  serve    — static file server with HTTP Range support (BVP streaming)
  info     — list renderers / tone mappers / parameters, or the
             modalities of a BVP archive
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path


def _add_params_args(parser, key, params_cls):
    for f in dataclasses.fields(params_cls):
        name = f"--{key}-{f.name.replace('_', '-')}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=None,
                                metavar="BOOL")
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=None)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=None)
        elif isinstance(default, tuple):
            parser.add_argument(name, type=lambda s: tuple(
                float(x) for x in s.split(",")), default=None,
                metavar="X,Y,Z")


def _collect_params(args, key, params_cls):
    kwargs = {}
    for f in dataclasses.fields(params_cls):
        val = getattr(args, f"{key}_{f.name}", None)
        if val is not None:
            kwargs[f.name] = val
    return params_cls(**kwargs) if kwargs else params_cls()


def _device(args):
    """The render device: the CPU for ``--platform cpu``, else the card
    (``utils.resolve_device`` raises without one)."""
    from .utils import resolve_device

    platform = getattr(args, "platform", None)
    if platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {platform!r} (cpu, cuda or "
                         "gpu)")
    return resolve_device("cpu" if platform == "cpu" else None)


def _load_volume(args, device):
    from . import volume as vol_mod
    from .io import readers

    spec = args.volume
    if spec.startswith("sphere:"):
        return vol_mod.sphere_volume(int(spec.split(":")[1]), device=device)
    if spec.startswith("shell:"):
        return vol_mod.shell_volume(int(spec.split(":")[1]), device=device)
    if spec.startswith("blobs:"):
        return vol_mod.blobs_volume(int(spec.split(":")[1]), device=device)
    if spec.endswith(".bvp") or spec.endswith(".zip"):
        return readers.load_volume(readers.BVPReader(spec),
                                   modality=args.modality, device=device)
    if spec.endswith(".raw"):
        if not args.raw_dims:
            raise SystemExit("--raw-dims WIDTH,HEIGHT,DEPTH required "
                             "for raw volumes")
        w, h, d = (int(x) for x in args.raw_dims.split(","))
        gl_type = {"uint8": 5121, "uint16": 5123,
                   "float32": 5126}[args.raw_type]
        reader = readers.RAWReader(spec, w, h, d, gl_type=gl_type)
        return readers.load_volume(reader, device=device)
    raise SystemExit(f"unrecognized volume spec: {spec}")


def _build_context(args, device):
    from .runtime import RenderingContext
    from .transfer import TransferFunctionBumps, gray_ramp, rasterize

    ctx = RenderingContext(resolution=args.resolution,
                           precision=args.precision,
                           tracking=getattr(args, "tracking", "auto"),
                           tf_srgb=getattr(args, "tf_srgb", False),
                           device=device)
    ctx.set_volume(_load_volume(args, device))

    if args.tf:
        with open(args.tf) as f:
            ctx.set_transfer_function(rasterize(
                TransferFunctionBumps.from_json(f.read(), device)))
    else:
        ctx.set_transfer_function(gray_ramp(alpha_scale=args.tf_alpha,
                                            device=device))

    if args.envmap:
        from . import environment as env_mod
        from .io.image import read_image
        ctx.set_environment_map(env_mod.from_image(read_image(args.envmap),
                                                   device=device))

    from .renderers import factory
    params = _collect_params(args, args.renderer,
                             factory.get_module(args.renderer).Params)
    ctx.choose_renderer(args.renderer, params=params)
    ctx.choose_tone_mapper(args.tonemap,
                           **({"exposure": args.exposure,
                               "gamma": args.gamma}
                              if args.tonemap not in ("artistic", "range")
                              else {}))

    # volume TRS (RenderingContextDialog parity)
    from . import math3d as m4
    if getattr(args, "volume_translate", None):
        ctx.volume_transform.local_translation = args.volume_translate
    if getattr(args, "volume_rotate", None):
        ctx.volume_transform.local_rotation = m4.quat_from_euler(
            *args.volume_rotate)
    if getattr(args, "volume_scale", None):
        ctx.volume_transform.local_scale = args.volume_scale

    # camera pose
    ctx.camera_animator.distance = args.camera_distance
    ctx.camera_animator.yaw = args.yaw
    ctx.camera_animator.pitch = args.pitch
    ctx.camera_animator._update_camera()
    return ctx


def _add_common_args(p):
    from .renderers import factory
    from .tonemap import TONE_MAPPERS

    p.add_argument("--volume", required=True,
                   help="sphere:N | shell:N | blobs:N | file.raw | file.bvp")
    p.add_argument("--modality", default="default",
                   help="modality name inside a BVP archive "
                        "(list with: vpt_tpu_torch info --volume FILE)")
    p.add_argument("--raw-dims", help="W,H,D for raw volumes")
    p.add_argument("--raw-type", default="uint8",
                   choices=["uint8", "uint16", "float32"])
    p.add_argument("--renderer", default="mcm",
                   choices=sorted(factory.MODULES))
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--spp", type=int, default=32,
                   help="progressive samples (frames) to accumulate")
    p.add_argument("--tf", help="transfer-function JSON (widget format)")
    p.add_argument("--tf-alpha", type=float, default=1.0,
                   help="alpha scale of the default gray-ramp TF")
    p.add_argument("--envmap", help="equirectangular environment image")
    p.add_argument("--tonemap", default="reinhard",
                   choices=sorted(TONE_MAPPERS))
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--camera-distance", type=float, default=2.0)
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--volume-translate", metavar="X,Y,Z",
                   type=lambda s: tuple(float(x) for x in s.split(",")))
    p.add_argument("--volume-rotate", metavar="XDEG,YDEG,ZDEG",
                   type=lambda s: tuple(float(x) for x in s.split(",")),
                   help="euler rotation of the volume (degrees)")
    p.add_argument("--volume-scale", metavar="X,Y,Z",
                   type=lambda s: tuple(float(x) for x in s.split(",")))
    p.add_argument("--platform", default=None,
                   help="cpu: render on the CPU (default: the CUDA card)")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "exact"],
                   help="fast: bf16 sampling tables and TF weights; "
                        "exact: float32")
    p.add_argument("--tracking", default="auto",
                   choices=["none", "cheb", "grid", "auto"],
                   help="empty-space tracking for the MC renderers: "
                        "cheb-skip rides the corner fetch (auto engages "
                        "it on scenes with TF-empty cells); grid = the "
                        "coarse local-majorant grid (MCM); none = the "
                        "exact GLSL-stream machine")
    p.add_argument("--tf-srgb", action="store_true",
                   help="run the TF through the reference's SRGB8_ALPHA8 "
                        "texture semantics (8-bit quantize + sRGB decode)")
    for key, module in sorted(factory.MODULES.items()):
        _add_params_args(p, key, module.Params)


def cmd_render(args):
    """Render ``--spp`` frames and write the display image as a PNG.
    Prints the seconds of each stage on the host clock, each ended by a
    synchronize on the card: the context's build (the volume's load), the
    scene build, the frames, the display and the PNG write."""
    import torch

    from .io.image import write_png

    device = _device(args)
    seconds = {}

    def timed(stage, work):
        t0 = time.perf_counter()
        out = work()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[stage] = time.perf_counter() - t0
        return out

    def load():
        ctx = _build_context(args, device)
        if args.resume:
            ctx.load_checkpoint(args.resume)
        return ctx

    ctx = timed("load", load)
    trace = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        trace = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    with trace:
        timed("scene", ctx.get_scene)
        timed("frames", lambda: ctx.render(frames=args.spp))
        image = timed("display", ctx.get_display_image)
    dt = seconds["scene"] + seconds["frames"] + seconds["display"]
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        trace.export_chrome_trace(str(Path(args.trace) / "trace.json"))
    timed("png", lambda: write_png(args.output, image))
    if args.checkpoint:
        ctx.save_checkpoint(args.checkpoint)
    events = args.resolution ** 2 * getattr(ctx.renderer.params, "steps", 1) \
        * args.spp
    print(f"rendered {args.spp} spp at {args.resolution}^2 in {dt:.2f}s "
          f"-> {args.output}")
    print(f"seconds ({device.type}): load {seconds['load']:.4f}, scene "
          f"{seconds['scene']:.4f}, frames {seconds['frames']:.4f} "
          f"({1e3 * seconds['frames'] / max(args.spp, 1):.4f} ms a frame, "
          f"{events / max(seconds['frames'], 1e-12):.6g} events/s), display "
          f"{seconds['display']:.4f}, png {seconds['png']:.4f}")
    print(ctx.profiler.summary())


def cmd_animate(args):
    """Render ``--frames`` frames along the orbit (or a ``--path circle``)
    to ``<output>/frame_NNNN.png``, ``--spp`` samples each, and with
    ``--video`` also encode them; on the card unless ``--platform cpu``."""
    from .runtime.animators import CircleAnimator

    ctx = _build_context(args, _device(args))
    animator = None
    if args.path == "circle":
        animator = CircleAnimator(ctx.camera, radius=args.orbit_radius)
    ctx.record_animation(args.output, frames=args.frames, spp=args.spp,
                         animator=animator, video=args.video, fps=args.fps,
                         progress=lambda p: print(f"\r{p * 100:.0f}%",
                                                  end="", flush=True))
    print(f"\nwrote {args.frames} frames to {args.output}")


def cmd_fit(args):
    """``vpt_tpu``'s ``cli fit``: fit a ``--grid``³ volume (init 0.1, the
    gray ramp TF at alpha scale 1) to the targets by ``--method`` and save
    it as ``<output>.npy`` (eam: also ``<output>.png``, the fitted volume
    rendered from the first view), with the same flags, messages and
    outputs.  On the card unless ``--platform cpu``."""
    import math

    import numpy as np
    import torch

    from .io.image import read_image, write_png
    from .renderers import eam
    from .scene import CameraState, default_camera
    from .train import fit
    from .transfer import gray_ramp

    device = _device(args)
    if args.method != "eam" and getattr(args, "inpaint_blind", False):
        raise SystemExit("--inpaint-blind is eam-only (multi-view "
                         "targets); mcm/mcs fits use --inpaint")
    if args.method != "eam" and len(args.target) > 1:
        raise SystemExit(f"--method {args.method} takes a single --target; "
                         "multi-view fitting is eam-only")
    n = args.grid
    init = torch.full((n, n, n, 1), 0.1, dtype=torch.float32, device=device)
    tf = gray_ramp(alpha_scale=1.0, device=device)
    if args.method == "iso-depth":
        # inverse isosurface geometry from a depth map (BASELINE config 1)
        if args.inpaint:
            print("warning: --inpaint applies to the density-fitting "
                  "methods (eam/mcm/mcs) only — ignored for iso-depth")
        from .renderers import diff_iso, make_scene

        if not args.target[0].endswith(".npy"):
            raise SystemExit(
                "--method iso-depth expects an .npy depth map (H, W) "
                "float32 with -1 marking invalid pixels — e.g. "
                "np.save of diff_iso.render(...)['depth']")
        target_depth = torch.from_numpy(np.asarray(
            np.load(args.target[0]), np.float32)).to(device)
        h, w = target_depth.shape
        params = diff_iso.Params()
        template = make_scene(init, tf, pack=False, device=device)
        vol = init.clone().requires_grad_(True)
        opt = torch.optim.Adam([vol], lr=args.lr)
        for i in range(args.steps):
            opt.zero_grad(set_to_none=True)
            loss = diff_iso.depth_loss(vol, template, params, target_depth,
                                       h, w)
            loss.backward()
            opt.step()
            with torch.no_grad():
                vol.clamp_(0.0, 1.0)
            if i % 25 == 0:
                print(f"step {i}: depth MSE {loss.item():.6f}")
        np.save(args.output, vol.detach().cpu().numpy())
        print(f"final depth MSE {loss.item():.6f}; wrote {args.output}.npy")
        return

    def maybe_inpaint(vol, extinction):
        """Occlusion-aware completion of the fit's null space
        (``inpaint``): voxels optically thick from every axis direction
        are filled with the log-domain biharmonic continuation of the
        recovered material, at ``--inpaint-tau``."""
        if not args.inpaint:
            return vol
        from . import inpaint as inpaint_mod

        filled, mask = inpaint_mod.complete_occluded(
            vol[..., 0], extinction=float(extinction),
            tau=args.inpaint_tau)
        print(f"inpainted {float(mask.to(torch.float32).mean()) * 100:.2f}% "
              f"of voxels (tau={args.inpaint_tau:g}, "
              f"extinction={extinction:g})")
        return torch.clamp(filled, 0.0, 1.0)[..., None]

    if args.method in ("mcm", "mcs"):
        # Monte-Carlo inverse rendering through the detached-decision
        # estimators (BASELINE config 3)
        from . import train as fit_mc_mod
        from .renderers import make_scene
        from .train import fit_mc

        target = torch.from_numpy(read_image(args.target[0])).to(device)
        template = make_scene(init, tf, pack=False, device=device)
        vol, _, losses = fit_mc(
            target, template, init_volume=init, renderer=args.method,
            frames=args.mc_frames, steps=args.steps,
            learning_rate=args.lr, verbose=True)
        vol = maybe_inpaint(vol, fit_mc_mod.MC_FIT_EXTINCTION[args.method])
        np.save(args.output, vol.cpu().numpy())
        print(f"final loss {losses[-1]:.6f}; wrote {args.output}.npy")
        return
    # multi-view EAM fitting: one camera per target image (single-view
    # reconstruction is ill-posed along the view axis)
    from .runtime.animators import OrbitCameraAnimator

    targets = [torch.from_numpy(read_image(t)).to(device)
               for t in args.target]
    n_views = len(targets)
    yaws = args.view_yaw
    if yaws is None:
        # default: spread views evenly over a full horizontal orbit
        yaws = [360.0 * i / n_views for i in range(n_views)]
    pitches = args.view_pitch or [0.0] * n_views
    if len(yaws) != n_views or len(pitches) != n_views:
        raise SystemExit("--view-yaw/--view-pitch must match the number "
                         "of --target images")

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    orbit.distance = args.camera_distance
    views = []
    for yaw, pitch in zip(yaws, pitches):
        orbit.yaw = math.radians(yaw)
        orbit.pitch = math.radians(pitch)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        views.append((cs.mvp_inverse, cs.model_view, cs.projection))

    params = eam.Params(slices=args.eam_slices or 64, random=False)

    # truth-blind completion (--inpaint-blind): withhold the LAST target
    # from the fit and use it to select the completion threshold by
    # reprojection (inpaint.select_tau_blind); needs >= 3 views so that
    # the fit keeps at least two
    blind = args.inpaint_blind
    if blind and n_views < 3:
        raise SystemExit("--inpaint-blind needs at least 3 --target views "
                         "(the last is withheld for tau selection)")
    fit_targets = targets[:-1] if blind else targets
    fit_views = views[:-1] if blind else views

    vol, _, losses = fit(fit_targets, fit_views, init, tf,
                         steps=args.steps, learning_rate=args.lr,
                         params=params, verbose=True)
    from .train import render_eam

    if blind:
        from . import inpaint as inpaint_mod

        h_t, w_t = targets[-1].shape[:2]
        cam_pos = torch.stack([inpaint_mod.camera_position(mv)
                               for (_, mv, _) in fit_views])
        depth = inpaint_mod.optical_depth_views(
            vol[..., 0], float(params.extinction), cam_pos)

        def render_heldout(v):
            with torch.no_grad():
                return [render_eam(v[..., None], tf, views[-1], params,
                                   np.float32(0.0), h_t, w_t)]

        taus = tuple(float(t) for t in args.blind_taus.split(","))
        tau_blind, completed, table = inpaint_mod.select_tau_blind(
            vol[..., 0], taus, [targets[-1]], render_heldout,
            depth=depth)
        print("blind tau selection: " + "; ".join(
            f"tau={r['tau']}: fill={r['filled_frac']:.3f} "
            f"heldout={r['heldout_mse']:.2e}" for r in table))
        print(f"chosen tau = {tau_blind}")
        vol = torch.clamp(completed, 0.0, 1.0)[..., None]
    else:
        vol = maybe_inpaint(vol, params.extinction)
    np.save(args.output, vol.cpu().numpy())
    with torch.no_grad():
        pred = render_eam(vol, tf, views[0], params, np.float32(0.0),
                          *targets[0].shape[:2])
    write_png(args.output + ".png", pred)
    print(f"final loss {losses[-1]:.6f} over {n_views} view(s); "
          f"volume -> {args.output}.npy")


def cmd_serve(args):
    from .io.server import serve

    serve(args.dir, args.port)


def cmd_view(args):
    """Serve the interactive viewer on ``--port``: every ``/frame``
    request renders on the card unless ``--platform cpu``."""
    from .runtime.viewer import ViewerServer

    ctx = _build_context(args, _device(args))
    ViewerServer(ctx, port=args.port).serve_forever()


def cmd_info(args):
    from .renderers import factory
    from .tonemap import TONE_MAPPERS

    if getattr(args, "volume", None):
        import os

        from .io import readers

        if not args.volume.endswith((".bvp", ".zip")):
            raise SystemExit(
                f"info --volume expects a .bvp/.zip archive with a "
                f"manifest, got: {args.volume}")
        if not os.path.exists(args.volume):
            raise SystemExit(f"no such file: {args.volume}")
        mods = readers.list_modalities(readers.BVPReader(args.volume))
        print(f"modalities in {args.volume}:")
        for m in mods:
            dims = m["dimensions"]
            print(f"  {m['name']:16s} {dims['width']}x{dims['height']}"
                  f"x{dims['depth']}  format={m['format']} type={m['type']}")
        return

    print("renderers (Params defaults):")
    for key, module in sorted(factory.MODULES.items()):
        fields = ", ".join(
            f"{f.name}={f.default}" for f in
            dataclasses.fields(module.Params))
        print(f"  {key:6s} {fields}")
    print("tone mappers:", ", ".join(sorted(TONE_MAPPERS)))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vpt_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="progressive render to PNG")
    _add_common_args(p)
    p.add_argument("--output", "-o", default="render.png")
    p.add_argument("--checkpoint", help="save progressive state here")
    p.add_argument("--resume", help="resume progressive state from here")
    p.add_argument("--trace", help="write a torch.profiler trace (Chrome "
                                   "trace format, trace.json) of the render "
                                   "to this directory")
    p.set_defaults(func=cmd_render)

    p = sub.add_parser("animate", help="render an animation sequence")
    _add_common_args(p)
    p.add_argument("--output", "-o", default="frames")
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--path", default="orbit", choices=["orbit", "circle"])
    p.add_argument("--orbit-radius", type=float, default=0.5)
    p.add_argument("--video", help="also encode the animation to video "
                                   "(.mp4/.webm/.avi via OpenCV, .gif via "
                                   "PIL; degrades to GIF with a message "
                                   "when no encoder exists)")
    p.add_argument("--fps", type=int, default=25)
    p.set_defaults(func=cmd_animate)

    p = sub.add_parser("fit", help="inverse-render a volume from images")
    p.add_argument("--target", required=True, nargs="+",
                   help="target image(s) (PNG); several targets fit "
                        "multi-view (eam method only)")
    p.add_argument("--view-yaw", type=float, nargs="+", default=None,
                   help="per-target camera yaw in degrees (default: even "
                        "spread over a full orbit)")
    p.add_argument("--view-pitch", type=float, nargs="+", default=None,
                   help="per-target camera pitch in degrees (default 0)")
    p.add_argument("--camera-distance", type=float, default=2.0)
    p.add_argument("--grid", type=int, default=32)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--eam-slices", type=int, default=None)
    p.add_argument("--method", default="eam",
                   choices=["eam", "mcm", "mcs", "iso-depth"],
                   help="differentiable path: eam (deterministic image), "
                        "mcm/mcs (Monte-Carlo expected-value estimators), "
                        "iso-depth (soft isosurface depth fitting; .npy "
                        "target)")
    p.add_argument("--mc-frames", type=int, default=32,
                   help="MC frames averaged per optimization step")
    p.add_argument("--inpaint", action="store_true",
                   help="complete the fit's occluded null space after "
                        "optimization (inpaint: optical-depth visibility "
                        "+ log-domain biharmonic CG fill; eam/mcm/mcs "
                        "methods)")
    p.add_argument("--inpaint-blind", action="store_true",
                   help="truth-free completion for the multi-view eam "
                        "fit: the LAST --target view is withheld from "
                        "the fit; per-voxel visibility integrates along "
                        "the fit views' capture rays and the threshold "
                        "is chosen by held-out reprojection "
                        "(inpaint.select_tau_blind)")
    p.add_argument("--blind-taus", default="0.05,0.1,0.15,0.25,0.5,1.0",
                   help="candidate thresholds for --inpaint-blind")
    p.add_argument("--inpaint-tau", type=float, default=0.15,
                   help="visibility threshold of the six-axis proxy, "
                        "vpt_tpu's default; the mask thresholds "
                        "extinction-scaled optical depth, so re-sweep "
                        "(or scale) tau when fitting at another "
                        "extinction or scene family")
    p.add_argument("--output", "-o", default="fitted_volume")
    p.add_argument("--platform", default=None,
                   help="cpu: fit on the CPU (default: the CUDA card)")
    p.set_defaults(func=cmd_fit)

    p = sub.add_parser("view", help="interactive browser viewer")
    _add_common_args(p)
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(func=cmd_view)

    p = sub.add_parser("serve", help="range-request static server")
    p.add_argument("--dir", default=".")
    p.add_argument("--port", type=int, default=3000)
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("info", help="list renderers and parameters, or "
                                    "the modalities of a BVP archive")
    p.add_argument("--volume", help="BVP archive to inspect")
    p.set_defaults(func=cmd_info)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
