"""Byte-range loaders — the reference's Loader abstraction (the port's
copy of ``vpt_tpu/io/loaders.py``).

Counterparts of ``src/js/loaders/``: ``read_length()`` / ``read_data(start,
end)`` over a local file (BlobLoader parity, ``BlobLoader.js:16-19``), an
HTTP source using Range requests (AjaxLoader parity, ``AjaxLoader.js:9-28``),
or an in-memory buffer.  The range abstraction is what lets the BVP/ZIP
reader stream individual blocks without downloading whole archives.
"""

from __future__ import annotations

import io
import urllib.request
from pathlib import Path


class AbstractLoader:
    def read_length(self) -> int:
        raise NotImplementedError

    def read_data(self, start: int, end: int) -> bytes:
        raise NotImplementedError


class FileLoader(AbstractLoader):
    """Local-file loader via seek/read (BlobLoader parity)."""

    def __init__(self, path):
        self.path = Path(path)

    def read_length(self) -> int:
        return self.path.stat().st_size

    def read_data(self, start: int, end: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(start)
            return f.read(end - start)


class BytesLoader(AbstractLoader):
    def __init__(self, data: bytes):
        self.data = data

    def read_length(self) -> int:
        return len(self.data)

    def read_data(self, start: int, end: int) -> bytes:
        return self.data[start:end]


class HTTPLoader(AbstractLoader):
    """HTTP loader: HEAD for length, ``Range: bytes=`` for data
    (AjaxLoader.js:10-28)."""

    def __init__(self, url: str):
        self.url = url

    def read_length(self) -> int:
        req = urllib.request.Request(self.url, method="HEAD")
        with urllib.request.urlopen(req) as resp:
            return int(resp.headers["Content-Length"])

    def read_data(self, start: int, end: int) -> bytes:
        req = urllib.request.Request(
            self.url, headers={"Range": f"bytes={start}-{end - 1}"})
        with urllib.request.urlopen(req) as resp:
            return resp.read()


def make_loader(source) -> AbstractLoader:
    """LoaderFactory parity: path → File, 'http…' → HTTP, bytes → Bytes."""
    if isinstance(source, AbstractLoader):
        return source
    if isinstance(source, (bytes, bytearray)):
        return BytesLoader(bytes(source))
    if isinstance(source, io.BytesIO):
        return BytesLoader(source.getvalue())
    s = str(source)
    if s.startswith("http://") or s.startswith("https://"):
        return HTTPLoader(s)
    return FileLoader(s)
