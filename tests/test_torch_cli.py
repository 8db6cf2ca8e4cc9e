"""The port's command-line interface against ``vpt_tpu.cli``, on the CPU.

``render --platform cpu`` of MIP at 24² writes a PNG within 1/255 of
vpt_tpu's in every pixel (measured: equal).  ``animate`` and ``view`` run
(``tests/test_torch_animate.py``, ``tests/test_torch_viewer.py``).  The ``render`` parser takes
the option strings of vpt_tpu's, with the same defaults.  ``info`` lists
every renderer and tone mapper and prints no time.  Without a card and
without ``--platform cpu`` the CLI raises.
"""

import argparse
import json
import re

import numpy as np
import pytest
import torch
from PIL import Image

from vpt_tpu import cli as jcli
from vpt_tpu_torch import cli as tcli
from vpt_tpu_torch import tonemap as ttonemap
from vpt_tpu_torch import volume as tvolume
from vpt_tpu_torch.io import write_bvp
from vpt_tpu_torch.renderers import factory


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
    """vpt_tpu.cli's parser, taken as its main hands it argv."""
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        jcli.main(["info"])
    monkeypatch.undo()
    return seen["parser"]


def _subparser(parser, name):
    return parser._subparsers._group_actions[0].choices[name]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.metavar) for a in parser._actions if a.option_strings}


def test_render_parser_matches_vpt_tpu(monkeypatch):
    jparser, tparser = _jax_parser(monkeypatch), tcli.build_parser()
    assert sorted(tparser._subparsers._group_actions[0].choices) \
        == sorted(jparser._subparsers._group_actions[0].choices)
    jrender, trender = _subparser(jparser, "render"), _subparser(tparser,
                                                                 "render")
    assert [a.option_strings for a in trender._actions] \
        == [a.option_strings for a in jrender._actions]
    assert _options(trender) == _options(jrender)
    for name in ("serve", "info"):
        assert _options(_subparser(tparser, name)) \
            == _options(_subparser(jparser, name))


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def test_render_mip_png_matches_vpt_tpu(tmp_path, capsys):
    argv = ["render", "--platform", "cpu", "--volume", "sphere:16",
            "--renderer", "mip", "--resolution", "24", "--spp", "2"]
    jcli.main(argv + ["-o", str(tmp_path / "jax.png")])
    tcli.main(argv + ["-o", str(tmp_path / "port.png")])
    out = capsys.readouterr().out
    assert "rendered 2 spp at 24^2" in out
    assert re.search(r"seconds \(cpu\): load [0-9.]+, scene [0-9.]+, frames "
                     r"[0-9.]+ \([0-9.]+ ms a frame, [0-9.e+]+ events/s\), "
                     r"display [0-9.]+, png [0-9.]+", out)
    got, want = _png(tmp_path / "port.png"), _png(tmp_path / "jax.png")
    assert got.shape == want.shape == (24, 24, 3)
    assert np.abs(got - want).max() <= 1
    assert want.max() > 0


def test_render_bvp_checkpoint_resume_and_trace(tmp_path):
    """A BVP volume, 2 frames and a checkpoint, 2 more from it, equal to
    4 frames at once; the trace file; the checkpoint's meta."""
    write_bvp(tmp_path / "v.bvp", tvolume.blobs_volume(12, seed=1,
                                                       device="cpu"))
    argv = ["render", "--platform", "cpu", "--volume", str(tmp_path /
                                                           "v.bvp"),
            "--renderer", "mcm", "--resolution", "16", "--mcm-steps", "4",
            "--tf-srgb", "--precision", "exact"]
    tcli.main(argv + ["--spp", "4", "-o", str(tmp_path / "whole.png")])
    tcli.main(argv + ["--spp", "2", "-o", str(tmp_path / "a.png"),
                      "--checkpoint", str(tmp_path / "c.npz")])
    tcli.main(argv + ["--spp", "2", "-o", str(tmp_path / "b.png"),
                      "--resume", str(tmp_path / "c.npz"),
                      "--checkpoint", str(tmp_path / "d.npz"),
                      "--trace", str(tmp_path / "trace")])
    assert np.array_equal(_png(tmp_path / "b.png"),
                          _png(tmp_path / "whole.png"))
    meta = json.loads(str(np.load(tmp_path / "d.npz")["__meta__"]))
    assert meta["renderer"] == "mcm" and meta["frame_number"] == 4
    assert meta["params"]["steps"] == 4
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())


def test_info_lists_renderers_and_tone_mappers_without_times(tmp_path,
                                                             capsys):
    tcli.main(["info"])
    out = capsys.readouterr().out
    for key in factory.MODULES:
        assert re.search(rf"^  {key}\s", out, re.M), key
    for name in ttonemap.TONE_MAPPERS:
        assert name in out
    assert not re.search(r"\bms\b|v5e|~", out), out
    write_bvp(tmp_path / "m.bvp", {"ct": tvolume.sphere_volume(
        4, device="cpu"), "pet": tvolume.shell_volume(4, device="cpu")})
    tcli.main(["info", "--volume", str(tmp_path / "m.bvp")])
    out = capsys.readouterr().out
    assert "ct" in out and "pet" in out and "4x4x4" in out


def test_render_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["render", "--volume", "sphere:8", "-o",
                   str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["render", "--volume", "sphere:8", "--platform", "cuda"])
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("command,item", [("animate", "item 15, rest"),
                                          ("view", "item 15, rest")])
def test_unported_subcommands_raise(command, item, monkeypatch):
    """``animate`` and ``view`` were the subcommands that raised
    NotImplementedError for ROADMAP item 15, rest; both are ported now, so
    without a card they reach the device and raise as ``render`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [command, "--volume", "sphere:8"]
    if command == "animate":
        argv += ["--frames", "3"]
    with pytest.raises(RuntimeError, match="no CUDA device") as err:
        tcli.main(argv)
    assert item not in str(err.value)
