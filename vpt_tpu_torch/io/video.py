"""Video encoding for animation recording.

A copy of ``vpt_tpu/io/video.py`` (it imports no JAX), with the same codec
table, fallback and messages.  The reference records real video through
the browser's MediaRecorder (``RenderingContext.js:305-352`` —
canvas.captureStream → webm).  Here the counterpart is :func:`write_video`:
a list of RGB(A) uint8 frames to a playable file, choosing the encoder
from the extension:

- ``.mp4``  — MPEG-4 part 2 (``mp4v``) via OpenCV's VideoWriter
- ``.webm`` — VP8 via OpenCV (matches MediaRecorder's default container)
- ``.avi``  — MJPEG via OpenCV (plays everywhere, no codec assumptions)
- ``.gif``  — animated GIF via PIL (the dependency-free fallback)

OpenCV ships its own encoders, so no system ffmpeg is required; if cv2
is absent or the requested codec fails to open, the writer degrades to
an animated GIF next to the requested path with a clear message rather
than failing the whole animation run.  The fallback picks a file format,
never a device: the frames were rendered before the encoder runs.
``mp4v`` is kept as ``vpt_tpu`` has it (a change of codec belongs to both
packages at once).
"""

from __future__ import annotations

from pathlib import Path

_FOURCC = {".mp4": "mp4v", ".webm": "VP80", ".avi": "MJPG"}


def _write_gif(path, frames, fps: int):
    from PIL import Image

    pil = [Image.fromarray(f[..., :3]) for f in frames]
    pil[0].save(path, save_all=True, append_images=pil[1:],
                duration=int(1000 / max(fps, 1)), loop=0)
    return Path(path)


def write_video(path, frames, fps: int = 25):
    """Encode ``frames`` (list of (H, W, 3|4) uint8 RGB arrays) to
    ``path``.  Returns the path actually written (the GIF fallback path
    when no video encoder is available)."""
    if not frames:
        raise ValueError("write_video needs at least one frame")
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".gif" or ext not in _FOURCC:
        if ext not in (".gif",):
            print(f"write_video: unknown extension {ext!r} — writing an "
                  "animated GIF (use .mp4/.webm/.avi for real video)")
            path = path.with_suffix(".gif")
        return _write_gif(path, frames, fps)
    try:
        import cv2
    except ImportError:
        fallback = path.with_suffix(".gif")
        print(f"write_video: OpenCV not available — falling back to "
              f"animated GIF at {fallback}")
        return _write_gif(fallback, frames, fps)
    h, w = frames[0].shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*_FOURCC[ext])
    writer = cv2.VideoWriter(str(path), fourcc, float(max(fps, 1)), (w, h))
    if not writer.isOpened():
        writer.release()
        fallback = path.with_suffix(".gif")
        print(f"write_video: codec {_FOURCC[ext]} unavailable for {ext} — "
              f"falling back to animated GIF at {fallback}")
        return _write_gif(fallback, frames, fps)
    for f in frames:
        writer.write(cv2.cvtColor(f[..., :3], cv2.COLOR_RGB2BGR))
    writer.release()
    return path
