"""RenderingContext — the engine's top level.

Mirrors ``vpt_tpu/runtime/context.py``: owns the camera node and its orbit
animator, the volume and its transform, the active renderer and tone
mapper, and the progressive render loop.  Rendering is sample-counted
(``render(frames=…)``), the "canvas" is an HDR or display image you fetch,
and progressive state checkpoints to disk.  Everything renders on
``device`` (default: the card); the scene graph's camera math runs on the
CPU in float32 and its three matrices move to the device with the scene.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import environment as envmod
from .. import tonemap as tonemap_mod
from ..renderers import base as renderer_base
from ..renderers import factory
from ..scene import CameraState, Node, Transform, default_camera
from ..transfer import TransferFunctionBumps, rasterize
from ..utils import resolve_device
from ..volume import Volume
from .animators import OrbitCameraAnimator
from .profiler import RenderProfiler


class RenderingContext:
    def __init__(self, resolution: int = 512, filter: str = "linear",
                 precision: str = "fast", tracking: str = "auto",
                 tf_srgb: bool = False, device=None):
        self.device = resolve_device(device)
        self.resolution = resolution
        self.filter = filter
        # 'fast': bf16 sampling tables and bf16 TF lerp weights (8-bit
        # mantissas, ~ the reference's R8/SRGB8 textures); 'exact': float32
        self.precision = precision
        # empty-space tracking policy for the MC renderers
        # (make_scene(tracking=...)); "auto" engages cheb-skip on scenes
        # with TF-empty cells
        self.tracking = tracking
        # run the TF through the reference's SRGB8_ALPHA8 texture semantics
        self.tf_srgb = tf_srgb

        self.camera: Node = default_camera()
        self.camera_animator = OrbitCameraAnimator(self.camera)
        self.volume_transform = Transform(Node())
        self.volume: Optional[Volume] = None
        self.environment = envmod.white(device=self.device)
        self.transfer_texture = rasterize(
            TransferFunctionBumps.default(device=self.device))

        self.renderer: Optional[renderer_base.Renderer] = None
        self.renderer_key: Optional[str] = None
        self.tone_mapper = tonemap_mod.ToneMapper("artistic")
        self.profiler = RenderProfiler()
        self.seed0 = 0  # stream id; frame seeds derive from (seed0, frame)
        self._scene_dirty = True
        self._camera_dirty = True
        self._scene: Optional[renderer_base.Scene] = None

        # camera motion resets accumulation (RenderingContext.js:42-46)
        self.camera.transform.add_change_listener(self._on_view_change)
        self.volume_transform.add_change_listener(self._on_view_change)

    # -- configuration (setVolume/chooseRenderer/… parity) ----------------
    def set_volume(self, volume: Volume):
        self.volume = volume
        self._scene_dirty = True
        if self.renderer:
            self.renderer.state = None

    def set_environment_map(self, env):
        self.environment = env
        self._scene_dirty = True
        if self.renderer:
            self.renderer.state = None

    def set_transfer_function(self, tf):
        """Accepts a texture tensor, a bump list, or TransferFunctionBumps."""
        if isinstance(tf, TransferFunctionBumps):
            tf = rasterize(tf)
        elif isinstance(tf, (list, tuple)):
            tf = rasterize(TransferFunctionBumps.from_list(tf, self.device))
        self.transfer_texture = tf
        self._scene_dirty = True
        if self.renderer:
            self.renderer.state = None

    def set_filter(self, filter: str):
        self.filter = filter
        if self.volume is not None:
            self.volume = Volume(self.volume.data, filter)
        self._scene_dirty = True

    def set_resolution(self, resolution: int):
        self.resolution = resolution
        if self.renderer_key:
            self.choose_renderer(self.renderer_key,
                                 params=self.renderer.params)

    def choose_renderer(self, key: str, params=None):
        self.renderer = factory.make_renderer(
            key, params=params, height=self.resolution,
            width=self.resolution)
        self.renderer_key = key

    def choose_tone_mapper(self, name: str, **params):
        self.tone_mapper = tonemap_mod.ToneMapper(name, params)

    # -- scene assembly ----------------------------------------------------
    def _on_view_change(self):
        # camera-only change: keep the (expensive) packed sampling tables,
        # just refresh the matrices at next get_scene
        self._camera_dirty = True
        if self.renderer:
            self.renderer.state = None   # reset accumulation

    def get_scene(self) -> renderer_base.Scene:
        if self._scene is None or self._scene_dirty:
            if self.volume is None:
                raise RuntimeError("no volume set")
            cam = CameraState.from_nodes(self.camera, self.volume_transform)
            fast = self.precision == "fast"
            self._scene = renderer_base.make_scene(
                self.volume, self.transfer_texture, camera=cam,
                environment=self.environment,
                pack_dtype=torch.bfloat16 if fast else None,
                tf_mxu=fast, tf_srgb=self.tf_srgb, tracking=self.tracking,
                device=self.device)
            self._scene_dirty = False
            self._camera_dirty = False
        elif self._camera_dirty:
            # a new Scene object: the kernels' launch preparations key on
            # the scene and its matrices, so they are prepared anew
            cam = CameraState.from_nodes(self.camera, self.volume_transform)
            self._scene = dataclasses.replace(
                self._scene, mvp_inverse=cam.mvp_inverse.to(self.device),
                model_view=cam.model_view.to(self.device),
                projection=cam.projection.to(self.device))
            self._camera_dirty = False
        return self._scene

    def _frame_seed(self, frame_number: int) -> float:
        """Deterministic per-frame seed from (seed0, frame index), the hash
        of ``vpt_tpu``: a resumed render continues the exact seed sequence
        of an uninterrupted one, in either package."""
        h = (frame_number * 2654435761 + self.seed0 * 40503 + 1) & 0xFFFFFFFF
        h ^= h >> 15
        h = (h * 2246822519) & 0xFFFFFFFF
        h ^= h >> 13
        return (h & 0xFFFFFF) / float(1 << 24)

    # -- render loop (sample-counted) -------------------------------------
    def render(self, frames: int = 1):
        """Advance the progressive render by ``frames`` samples."""
        if self.renderer is None:
            self.choose_renderer("mcm")
        scene = self.get_scene()
        # events = pixels x MC steps per frame (bench.py's metric)
        events = self.resolution ** 2 * getattr(self.renderer.params,
                                                "steps", 1)
        for _ in range(frames):
            seed = self._frame_seed(self.renderer.frame_number + 1)
            with self.profiler.stage("render_frame", events=events):
                self.renderer.render(scene, seed)
        return self

    def get_hdr_image(self):
        return self.renderer.display(self.get_scene())

    def get_display_image(self):
        """Tone-mapped display image (the canvas blit equivalent)."""
        return self.tone_mapper(self.get_hdr_image())

    def save_image(self, path):
        from ..io.image import write_png

        write_png(path, self.get_display_image())

    # -- checkpoint/resume -------------------------------------------------
    def save_checkpoint(self, path):
        from . import checkpoint

        state = self.renderer.state
        extra = {"seed0": self.seed0}
        if isinstance(state, dict):
            extra["state_keys"] = sorted(state)
        checkpoint.save(path, self.renderer_key, state,
                        self.renderer.frame_number,
                        params=self.renderer.params, extra=extra)

    def load_checkpoint(self, path):
        from . import checkpoint

        self.renderer = checkpoint.resume_renderer(
            path, height=self.resolution, width=self.resolution,
            device=self.device)
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
        self.renderer_key = meta["renderer"]
        self.seed0 = meta.get("extra", {}).get("seed0", self.seed0)

    # -- animation rendering (recordAnimation parity, sample-counted) ------
    def record_animation(self, out_dir, frames: int, spp: int = 16,
                         animator=None, duration: float = 1.0,
                         progress=None, video=None, fps: int = 25):
        """Render an animation: for each frame, advance the camera animator,
        reset, accumulate ``spp`` samples, write the frame (replaces the
        time-boxed loop of RenderingContext.js:256-303; sample-counted).
        ``video``: also encode the frames to a video file — the counterpart
        of the reference's MediaRecorder path (RenderingContext.js:305-352);
        the extension picks the codec (.mp4/.webm/.avi via OpenCV, .gif via
        PIL — io/video.py).  Each display image is copied to the host once,
        as uint8, for both the PNG and the encoder."""
        from ..io.image import png_bytes, to_uint8

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        animator = animator or self.camera_animator
        rendered = []
        for i in range(frames):
            t = duration * i / max(frames - 1, 1)
            if hasattr(animator, "update"):
                animator.update(t)
            else:
                animator.rotate(1.0 / frames, 0.0)
            self.renderer.state = None
            self.render(frames=spp)
            pixels = to_uint8(self.get_display_image())
            (out / f"frame_{i:04d}.png").write_bytes(png_bytes(pixels))
            if video:
                rendered.append(pixels)
            if progress:
                progress((i + 1) / frames)
        if video:
            from ..io.video import write_video

            written = write_video(video, rendered, fps=fps)
            print(f"wrote video {written}")
        return out
