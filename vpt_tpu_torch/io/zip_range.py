"""Streaming ZIP reader over a byte-range loader (the port's copy of
``vpt_tpu/io/zip_range.py``).

Counterpart of the reference's ``src/js/readers/ZIPReader.js``: parse the
end-of-central-directory record (_readEOCD, :41-56) and the central directory
(_readCD, :58-78), then range-read an entry's bytes through the loader
(readFile, :20-39) without ever materializing the whole archive.  The
reference supports only stored (uncompressed) entries; deflate is supported
here additionally via zlib.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict

from .loaders import AbstractLoader, make_loader

_EOCD_SIGNATURE = 0x06054B50
_CD_SIGNATURE = 0x02014B50
_LOCAL_SIGNATURE = 0x04034B50
_EOCD_MIN_SIZE = 22


class ZipRangeReader:
    def __init__(self, source):
        self.loader: AbstractLoader = make_loader(source)
        self._entries: Dict[str, dict] = {}
        self._parsed = False

    # -- central directory -------------------------------------------------
    def _read_eocd(self):
        length = self.loader.read_length()
        # EOCD has a variable comment; scan the last 64 KiB + 22 bytes
        tail_size = min(length, 65536 + _EOCD_MIN_SIZE)
        tail = self.loader.read_data(length - tail_size, length)
        idx = tail.rfind(struct.pack("<I", _EOCD_SIGNATURE))
        if idx < 0:
            raise ValueError("not a ZIP file (EOCD signature not found)")
        (_, _, _, _, entries, cd_size, cd_offset, _) = struct.unpack(
            "<IHHHHIIH", tail[idx:idx + _EOCD_MIN_SIZE])
        return entries, cd_size, cd_offset

    def _parse(self):
        if self._parsed:
            return
        entries, cd_size, cd_offset = self._read_eocd()
        cd = self.loader.read_data(cd_offset, cd_offset + cd_size)
        pos = 0
        for _ in range(entries):
            (sig, _, _, _, method, _, _, _, csize, usize, nlen, elen,
             clen, _, _, _, local_offset) = struct.unpack(
                "<IHHHHHHIIIHHHHHII", cd[pos:pos + 46])
            if sig != _CD_SIGNATURE:
                raise ValueError("bad central-directory signature")
            name = cd[pos + 46:pos + 46 + nlen].decode("utf-8")
            self._entries[name] = {
                "method": method,
                "compressed_size": csize,
                "size": usize,
                "local_offset": local_offset,
            }
            pos += 46 + nlen + elen + clen
        self._parsed = True

    # -- public API --------------------------------------------------------
    def namelist(self):
        self._parse()
        return list(self._entries)

    def read_file(self, name: str) -> bytes:
        """Range-read one entry (ZIPReader.readFile parity)."""
        self._parse()
        if name not in self._entries:
            raise KeyError(f"no entry {name!r} in archive")
        entry = self._entries[name]
        # parse the local header to find the data offset (its name/extra
        # lengths may differ from the central directory's)
        header = self.loader.read_data(entry["local_offset"],
                                       entry["local_offset"] + 30)
        (sig, _, _, method, _, _, _, _, _, nlen, elen) = struct.unpack(
            "<IHHHHHIIIHH", header)
        if sig != _LOCAL_SIGNATURE:
            raise ValueError("bad local-file-header signature")
        data_start = entry["local_offset"] + 30 + nlen + elen
        raw = self.loader.read_data(data_start,
                                    data_start + entry["compressed_size"])
        if method == 0:      # stored — the only mode the reference supports
            return raw
        if method == 8:      # deflate
            return zlib.decompress(raw, wbits=-15)
        raise ValueError(f"unsupported compression method {method}")
