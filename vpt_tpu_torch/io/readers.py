"""Volume readers: BVP archives and headerless RAW files.

Mirrors ``vpt_tpu/io/readers.py``; :func:`load_volume` puts the assembled
volume on ``device`` (default: the card).  Counterparts of ``src/js/readers/``:
- :class:`RAWReader` synthesizes BVP-style metadata for headerless volumes —
  one z slice per block, single channel (RAWReader.js:15-71);
- :class:`BVPReader` reads the BVP format: a ZIP containing ``manifest.json``
  plus per-block files, streamed block-wise via the range ZIP reader
  (BVPReader.js:13-30);
- :func:`load_volume` assembles the blocks into a (D, H, W, C) float32 array
  with per-block progress callbacks (the texSubImage3D upload path of
  Volume.js:60-75).
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import resolve_device
from ..volume import Volume
from .loaders import make_loader
from .zip_range import ZipRangeReader

# GL constant → numpy dtype for BVP "type" fields (Volume._typize,
# Volume.js:84-113)
_GL_TYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5124: np.int32, 5125: np.uint32, 5126: np.float32,
}
# GL format → channel count (RED/RG/RGB/RGBA)
_GL_FORMATS = {6403: 1, 33319: 2, 6407: 3, 6408: 4,
               6409: 1, 6410: 2}


class AbstractReader:
    def read_metadata(self) -> dict:
        raise NotImplementedError

    def read_block(self, index: int) -> bytes:
        raise NotImplementedError


class RAWReader(AbstractReader):
    def __init__(self, source, width: int, height: int, depth: int,
                 gl_type: int = 5121):
        self.loader = make_loader(source)
        self.width, self.height, self.depth = width, height, depth
        self.gl_type = gl_type
        self._bpv = np.dtype(_GL_TYPES[gl_type]).itemsize

    def read_metadata(self) -> dict:
        placements = [{"index": i, "position": {"x": 0, "y": 0, "z": i}}
                      for i in range(self.depth)]
        blocks = [{"url": "default", "format": "raw",
                   "dimensions": {"width": self.width, "height": self.height,
                                  "depth": 1}}
                  for _ in range(self.depth)]
        return {
            "meta": {"version": 1},
            "modalities": [{
                "name": "default",
                "dimensions": {"width": self.width, "height": self.height,
                               "depth": self.depth},
                "transform": {"matrix": [1, 0, 0, 0, 0, 1, 0, 0,
                                         0, 0, 1, 0, 0, 0, 0, 1]},
                "format": 6403, "internalFormat": 33321,
                "type": self.gl_type,
                "placements": placements,
            }],
            "blocks": blocks,
        }

    def read_block(self, index: int) -> bytes:
        slice_bytes = self.width * self.height * self._bpv
        return self.loader.read_data(index * slice_bytes,
                                     (index + 1) * slice_bytes)


class BVPReader(AbstractReader):
    def __init__(self, source):
        self.zip = ZipRangeReader(source)
        self._metadata: Optional[dict] = None

    def read_metadata(self) -> dict:
        if self._metadata is None:
            self._metadata = json.loads(
                self.zip.read_file("manifest.json").decode("utf-8"))
        return self._metadata

    def read_block(self, index: int) -> bytes:
        meta = self.read_metadata()
        return self.zip.read_file(meta["blocks"][index]["url"])


def _normalize(arr: np.ndarray, dtype) -> np.ndarray:
    arr = arr.astype(np.float32)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        if info.min < 0:
            arr = (arr - info.min) / (info.max - info.min)
        else:
            arr = arr / info.max
    return arr


def list_modalities(reader: AbstractReader) -> list:
    """Names + dimensions of every modality in the archive (a BVP file may
    carry several — e.g. registered CT + PET series)."""
    return [{
        "name": m["name"],
        "dimensions": m["dimensions"],
        "format": m.get("format", 6403),
        "type": m.get("type", 5121),
    } for m in reader.read_metadata()["modalities"]]


def load_volume(reader: AbstractReader, modality: str = "default",
                progress: Optional[Callable[[float], None]] = None,
                filter: str = "linear", device=None) -> Volume:
    """Assemble a volume from reader blocks (Volume.readModality parity) on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    meta = reader.read_metadata()
    mods = [m for m in meta["modalities"] if m["name"] == modality]
    if not mods:
        names = [m["name"] for m in meta["modalities"]]
        raise ValueError(
            f"modality {modality!r} does not exist; archive has {names}")
    mod = mods[0]
    dims = mod["dimensions"]
    w, h, d = dims["width"], dims["height"], dims["depth"]
    dtype = _GL_TYPES[mod.get("type", 5121)]
    channels = _GL_FORMATS.get(mod.get("format", 6403), 1)

    data = np.zeros((d, h, w, channels), np.float32)
    placements = mod["placements"]
    for n, placement in enumerate(placements):
        index = placement["index"]
        pos = placement["position"]
        block_meta = meta["blocks"][index]
        bd = block_meta["dimensions"]
        bw, bh, bdep = bd["width"], bd["height"], bd["depth"]
        raw = np.frombuffer(reader.read_block(index), dtype=dtype,
                            count=bw * bh * bdep * channels)
        block = _normalize(raw, dtype).reshape(bdep, bh, bw, channels)
        x, y, z = pos["x"], pos["y"], pos["z"]
        data[z:z + bdep, y:y + bh, x:x + bw] = block
        if progress:
            progress((n + 1) / len(placements))

    return Volume(torch.from_numpy(data).to(device), filter)


def write_bvp(path, volume, name: str = "default"):
    """Write one or more volumes as a BVP archive (manifest.json + one
    block per modality), compatible with this reader and the reference's
    format.  ``volume`` may be a single Volume (stored under ``name``) or a
    ``{name: Volume}`` dict for a multi-modality archive (e.g. registered
    CT + PET series)."""
    import zipfile

    modalities = volume if isinstance(volume, dict) else {name: volume}
    manifest = {"meta": {"version": 1}, "modalities": [], "blocks": []}
    blobs = {}
    for index, (mod_name, mod_volume) in enumerate(modalities.items()):
        data = mod_volume.data
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        data = np.asarray(data)
        d, h, w, c = data.shape
        url = f"block{index}.raw"
        blobs[url] = (np.clip(data, 0, 1) * 255).astype(np.uint8).tobytes()
        manifest["modalities"].append({
            "name": mod_name,
            "dimensions": {"width": w, "height": h, "depth": d},
            "transform": {"matrix": [1, 0, 0, 0, 0, 1, 0, 0,
                                     0, 0, 1, 0, 0, 0, 0, 1]},
            "format": {1: 6403, 2: 33319, 3: 6407, 4: 6408}[c],
            "internalFormat": 33321,
            "type": 5121,
            "placements": [{"index": index,
                            "position": {"x": 0, "y": 0, "z": 0}}],
        })
        manifest["blocks"].append(
            {"url": url, "format": "raw",
             "dimensions": {"width": w, "height": h, "depth": d}})
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        for url, blob in blobs.items():
            zf.writestr(url, blob)
