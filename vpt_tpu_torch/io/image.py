"""Image I/O: PNG write for rendered frames, image read for environment maps.

Mirrors ``vpt_tpu/io/image.py``.  :func:`write_png` encodes with the
standard library alone (:func:`png_bytes`: ``zlib``, ``struct``, 8-bit RGB
or RGBA, filter 0 on every row), so the port writes PNGs where Pillow is
not installed; Pillow decodes the file to the pixels ``vpt_tpu``'s writer
stores.  :func:`read_image` decodes through Pillow, imported when it is
called.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _numpy(image) -> np.ndarray:
    if hasattr(image, "detach"):            # a tensor, on any device
        image = image.detach().cpu().numpy()
    return np.asarray(image)


def to_uint8(image, flip: bool = True) -> np.ndarray:
    """HDR/display float image (H, W, 3|4) → uint8 RGB, top-down rows.

    Render images are bottom-up (OpenGL convention, row 0 = bottom); PNG rows
    are top-down, hence the default flip."""
    arr = _numpy(image)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    if flip:
        arr = arr[::-1]
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray) -> bytes:
    """An (H, W, 3) or (H, W, 4) uint8 image, rows top-down, as the bytes
    of an 8-bit RGB or RGBA PNG."""
    h, w, c = pixels.shape
    if pixels.dtype != np.uint8 or c not in (3, 4):
        raise ValueError("png_bytes takes an (H, W, 3|4) uint8 image")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(pixels).reshape(h, w * c)],
                          axis=1)                 # filter byte 0 a row
    color_type = 2 if c == 3 else 6
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, image, flip: bool = True):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(png_bytes(to_uint8(image, flip=flip)))


def read_image(path, flip: bool = True) -> np.ndarray:
    """Read an image file → float32 (H, W, 4) RGBA in [0, 1], bottom-up."""
    from PIL import Image

    img = np.asarray(Image.open(str(path)).convert("RGBA"),
                     dtype=np.float32) / 255.0
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)
