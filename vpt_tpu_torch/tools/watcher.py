"""File-tree watcher: re-run a command when sources change.

A copy of ``vpt_tpu/tools/watcher.py`` (it imports no JAX).  Counterpart
of ``bin/watcher`` (fs.watch tree → rerun build command): polls a
directory tree's mtimes (stdlib-only, no inotify dependency) and re-runs
the given command on change —
`python -m vpt_tpu_torch.tools.watcher "pytest -q" vpt_tpu_torch/`.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def snapshot(roots, patterns=("*.py", "*.json", "*.md")):
    state = {}
    for root in roots:
        for pattern in patterns:
            for p in Path(root).rglob(pattern):
                try:
                    state[str(p)] = p.stat().st_mtime_ns
                except OSError:
                    pass
    return state


def watch(command: str, roots, interval: float = 0.5, run_first: bool = True):
    prev = snapshot(roots)
    if run_first:
        subprocess.call(command, shell=True)
    while True:
        time.sleep(interval)
        cur = snapshot(roots)
        if cur != prev:
            changed = {k for k in set(prev) | set(cur)
                       if prev.get(k) != cur.get(k)}
            print(f"-- {len(changed)} files changed; rerunning --")
            prev = cur
            subprocess.call(command, shell=True)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="watch tree, rerun command")
    ap.add_argument("command")
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--interval", type=float, default=0.5)
    args = ap.parse_args(argv)
    try:
        watch(args.command, args.roots or ["."], args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
