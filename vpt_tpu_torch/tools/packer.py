"""Part-graph asset packer — the reference build pipeline, re-implemented.

A copy of ``vpt_tpu/tools/packer.py`` (it imports no JAX).

Counterpart of ``bin/packer`` (236 LoC Node): a generic, config-driven asset
pipeline that splits source files into named *parts* on ``#part`` marker
lines, resolves ``#link`` references with a topological sort (cycle
detection included), and emits the parts per-file, concatenated, or as one
JSON dictionary (``bin/packer:57-166``).  The reference uses it to pack GLSL
shaders into ``shaders.json``/``mixins.json``; here it packs any marker-
annotated sources (kernel templates, doc fragments, golden manifests).

Marker syntax (identical to the reference):
    // #part /some/part/name
    ... content ...
    // #link /other/part
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Dict, List

_PART_RE = re.compile(r"^\s*(?://|#)\s*#part\s+(\S+)\s*$")
_LINK_RE = re.compile(r"^\s*(?://|#)\s*#link\s+(\S+)\s*$")


class CyclicLinkError(Exception):
    pass


def parse_parts(text: str) -> Dict[str, dict]:
    """Split a file into {part_name: {content, links}} (bin/packer:57-72)."""
    parts: Dict[str, dict] = {}
    current = None
    for line in text.splitlines(keepends=True):
        m = _PART_RE.match(line)
        if m:
            current = m.group(1)
            parts[current] = {"content": "", "links": []}
            continue
        if current is None:
            continue
        lm = _LINK_RE.match(line)
        if lm:
            parts[current]["links"].append(lm.group(1))
        parts[current]["content"] += line
    return parts


def toposort(parts: Dict[str, dict]) -> List[str]:
    """Order parts so links precede their referrers; raises on cycles
    (bin/packer:74-110)."""
    order: List[str] = []
    state: Dict[str, int] = {}  # 0 = unvisited, 1 = visiting, 2 = done

    def visit(name: str, stack):
        if state.get(name) == 2:
            return
        if state.get(name) == 1:
            raise CyclicLinkError(
                " -> ".join(stack + [name]))
        state[name] = 1
        for dep in parts.get(name, {}).get("links", []):
            if dep in parts:
                visit(dep, stack + [name])
        state[name] = 2
        order.append(name)

    for name in parts:
        visit(name, [])
    return order


def resolve(parts: Dict[str, dict], name: str) -> str:
    """Content of a part with all transitive links prepended in toposorted
    order (deduplicated)."""
    wanted = set()

    def collect(n):
        for dep in parts.get(n, {}).get("links", []):
            if dep in parts and dep not in wanted:
                wanted.add(dep)
                collect(dep)

    collect(name)
    order = [p for p in toposort(parts) if p in wanted]
    return "".join(parts[p]["content"] for p in order) \
        + parts[name]["content"]


def pack(config: dict, root: Path = Path(".")):
    """Run a pack config (packer.json parity, bin/packer:168-236).

    config: {"inputs": [{"path", "action": "copy"|"parse"}],
             "outputs": [{"mode": "each"|"concat"|"json", "path", ...}]}
    """
    root = Path(root)
    all_parts: Dict[str, dict] = {}
    for spec in config.get("inputs", []):
        for path in sorted(root.glob(spec["path"])):
            if spec.get("action", "parse") == "copy":
                dest = root / spec["dest"] / path.name
                dest.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(path, dest)
            else:
                all_parts.update(parse_parts(path.read_text()))

    for out in config.get("outputs", []):
        mode = out.get("mode", "json")
        dest = root / out["path"]
        dest.parent.mkdir(parents=True, exist_ok=True)
        selected = {k: v for k, v in all_parts.items()
                    if k.startswith(out.get("prefix", ""))}
        if mode == "json":
            tree: dict = {}
            for name, part in selected.items():
                node = tree
                keys = [k for k in name.split("/") if k]
                for key in keys[:-1]:
                    node = node.setdefault(key, {})
                node[keys[-1]] = part["content"]
            dest.write_text(json.dumps(tree))
        elif mode == "concat":
            order = toposort(selected)
            dest.write_text("".join(selected[p]["content"] for p in order))
        elif mode == "each":
            for name, part in selected.items():
                f = dest / name.strip("/").replace("/", "_")
                f.parent.mkdir(parents=True, exist_ok=True)
                f.write_text(part["content"])
        else:
            raise ValueError(f"unknown output mode {mode!r}")
    return all_parts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="part-graph asset packer")
    ap.add_argument("config", help="packer config JSON")
    ap.add_argument("--root", default=".")
    args = ap.parse_args(argv)
    config = json.loads(Path(args.config).read_text())
    parts = pack(config, Path(args.root))
    print(f"packed {len(parts)} parts")


if __name__ == "__main__":
    main()
