"""The port's build tools against ``vpt_tpu.tools``: the packer cases of
``tests/test_tools.py`` (parse, toposort, transitive resolve, cycle
detection, the json, concat and each outputs, the copy action and the
command line) on both packers, with equal results and equal files; the
watcher's snapshot of a tree and its rerun on a change."""

import json
import os
import subprocess

import pytest
import torch

from vpt_tpu.tools import packer as jpacker
from vpt_tpu.tools import watcher as jwatcher
from vpt_tpu_torch.tools import packer as tpacker
from vpt_tpu_torch.tools import watcher as twatcher


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tests here run no tensors, but a parallel test run's workers
    all pin torch to one thread; keep this module alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SRC = """\
// #part /lib/constants
PI = 3.14
// #part /lib/helper
// #link /lib/constants
def helper(): pass
// #part /main/prog
// #link /lib/helper
def main(): pass
# #part /py/part
# #link /lib/constants
x = 1
"""

CYCLE = """\
// #part /a
// #link /b
A
// #part /b
// #link /a
B
"""


def test_parse_toposort_resolve_equal():
    jparts, tparts = jpacker.parse_parts(SRC), tpacker.parse_parts(SRC)
    assert tparts == jparts
    assert set(tparts) == {"/lib/constants", "/lib/helper", "/main/prog",
                           "/py/part"}
    assert tparts["/main/prog"]["links"] == ["/lib/helper"]
    order = tpacker.toposort(tparts)
    assert order == jpacker.toposort(jparts)
    assert order.index("/lib/constants") < order.index("/lib/helper") \
        < order.index("/main/prog")
    for name in tparts:
        assert tpacker.resolve(tparts, name) == jpacker.resolve(jparts,
                                                                name)
    text = tpacker.resolve(tparts, "/main/prog")
    assert text.index("PI") < text.index("helper") < text.index("main")


def test_cycle_detection_same_path():
    with pytest.raises(jpacker.CyclicLinkError) as jerr:
        jpacker.toposort(jpacker.parse_parts(CYCLE))
    with pytest.raises(tpacker.CyclicLinkError) as terr:
        tpacker.toposort(tpacker.parse_parts(CYCLE))
    assert str(terr.value) == str(jerr.value) == "/a -> /b -> /a"


def _tree_files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_pack_outputs_equal(tmp_path):
    """The json, concat and each outputs, a prefix filter and the copy
    action write the same files from either packer."""
    config = {
        "inputs": [{"path": "src/*.glsl", "action": "parse"},
                   {"path": "src/*.txt", "action": "copy", "dest": "out/c"}],
        "outputs": [{"mode": "json", "path": "out/parts.json"},
                    {"mode": "json", "path": "out/lib.json",
                     "prefix": "/lib"},
                    {"mode": "concat", "path": "out/all.txt"},
                    {"mode": "each", "path": "out/each"}],
    }
    trees = []
    for name, mod in (("j", jpacker), ("t", tpacker)):
        root = tmp_path / name
        (root / "src").mkdir(parents=True)
        (root / "src" / "a.glsl").write_text(SRC)
        (root / "src" / "b.glsl").write_text("// #part /lib/extra\nE\n")
        (root / "src" / "note.txt").write_text("copied\n")
        parts = mod.pack(config, root)
        trees.append((parts, _tree_files(root)))
    assert trees[1] == trees[0]
    files = trees[1][1]
    assert "PI = 3.14" in json.loads(files["out/parts.json"])["lib"][
        "constants"]
    assert set(json.loads(files["out/lib.json"])["lib"]) == {
        "constants", "helper", "extra"}
    allt = files["out/all.txt"].decode()
    assert allt.index("PI") < allt.index("def main")
    assert files["out/each/lib_constants"] == b"PI = 3.14\n"
    assert files["out/c/note.txt"] == b"copied\n"
    with pytest.raises(ValueError, match="unknown output mode"):
        tpacker.pack({"outputs": [{"mode": "tar", "path": "x"}]},
                     tmp_path / "t")


def test_packer_command_line(tmp_path, capsys):
    (tmp_path / "src.glsl").write_text(SRC)
    cfg = tmp_path / "packer.json"
    cfg.write_text(json.dumps({
        "inputs": [{"path": "src.glsl"}],
        "outputs": [{"mode": "json", "path": "build/parts.json"}]}))
    said = []
    for mod in (jpacker, tpacker):
        mod.main([str(cfg), "--root", str(tmp_path)])
        said.append(capsys.readouterr().out)
    assert said[1] == said[0] == "packed 4 parts\n"


def test_watcher_snapshot_and_rerun(tmp_path, monkeypatch):
    """The snapshot is vpt_tpu's; ``watch`` runs the command first, then
    once for a changed file, and ``main`` returns 0 on an interrupt."""
    (tmp_path / "d").mkdir()
    for name in ("a.py", "b.json", "c.md", "d/e.py", "skip.txt"):
        (tmp_path / name).write_text(name)
    snap = twatcher.snapshot([tmp_path])
    assert snap == jwatcher.snapshot([tmp_path])
    assert len(snap) == 4
    runs, sleeps = [], []

    def fake_sleep(_):
        sleeps.append(1)
        if len(sleeps) == 1:
            (tmp_path / "a.py").write_text("changed, and longer")
            st = (tmp_path / "a.py").stat()
            os.utime(tmp_path / "a.py",
                     ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
        elif len(sleeps) == 3:
            raise KeyboardInterrupt

    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, shell: runs.append(cmd) or 0)
    monkeypatch.setattr(twatcher.time, "sleep", fake_sleep)
    assert twatcher.main(["echo hi", str(tmp_path)]) == 0
    assert runs == ["echo hi", "echo hi"]
