"""Static file server with HTTP Range support (the port's copy of
``vpt_tpu/io/server.py``).

Parity with the reference's dev server (``bin/server-node:56-75``): serves a
directory with CORS headers and honors ``Range: bytes=`` requests — required
by the HTTPLoader → ZIP streaming path, which fetches only the central
directory and the requested blocks of large BVP archives.
"""

from __future__ import annotations

import os
import re
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

_RANGE_RE = re.compile(r"bytes=(\d*)-(\d*)")


class RangeRequestHandler(SimpleHTTPRequestHandler):
    def end_headers(self):
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Accept-Ranges", "bytes")
        super().end_headers()

    def send_head(self):
        range_header = self.headers.get("Range")
        if not range_header:
            return super().send_head()
        match = _RANGE_RE.match(range_header)
        if not match:
            return super().send_head()

        path = self.translate_path(self.path)
        if not os.path.isfile(path):
            self.send_error(404, "File not found")
            return None
        size = os.path.getsize(path)
        if match.group(1):
            start = int(match.group(1))
            end = int(match.group(2)) if match.group(2) else size - 1
        elif match.group(2):
            # suffix form 'bytes=-N': the last N bytes
            start = max(size - int(match.group(2)), 0)
            end = size - 1
        else:
            self.send_error(416, "Requested Range Not Satisfiable")
            return None
        end = min(end, size - 1)
        if start > end or start >= size:
            self.send_error(416, "Requested Range Not Satisfiable")
            return None

        f = open(path, "rb")
        f.seek(start)
        self.send_response(206)
        self.send_header("Content-Type", self.guess_type(path))
        self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.send_header("Content-Length", str(end - start + 1))
        self.end_headers()
        self._range_remaining = end - start + 1
        return _LimitedFile(f, end - start + 1)


class _LimitedFile:
    """File wrapper that stops after N bytes (for copyfile)."""

    def __init__(self, f, limit):
        self.f = f
        self.limit = limit

    def read(self, n=-1):
        if self.limit <= 0:
            return b""
        if n < 0 or n > self.limit:
            n = self.limit
        data = self.f.read(n)
        self.limit -= len(data)
        return data

    def close(self):
        self.f.close()


def serve(directory: str = ".", port: int = 3000):
    handler = partial(RangeRequestHandler, directory=directory)
    server = ThreadingHTTPServer(("0.0.0.0", port), handler)
    print(f"serving {directory} on :{port} (Range requests enabled)")
    server.serve_forever()


def serve_background(directory: str = ".", port: int = 0):
    """Start the server on a daemon thread; returns (server, port)."""
    import threading

    handler = partial(RangeRequestHandler, directory=directory)
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]
