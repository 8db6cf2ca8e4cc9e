"""The port's animation output against ``vpt_tpu``'s, on the CPU.

- ``io.video.write_video``: a ``.gif`` is byte for byte ``vpt_tpu``'s; an
  ``.avi``, ``.mp4`` and ``.webm`` (OpenCV, which this environment has)
  decode to the same frames as ``vpt_tpu``'s files; the fallbacks (an
  unknown extension, no OpenCV, a codec that does not open) print the same
  message and write the same GIF path; no frames raise.
- ``RenderingContext.record_animation(video=)`` on both packages' contexts
  (``tests/test_torch_runtime.py``'s: ``blobs_volume(24, seed=7)``, sRGB
  ``gray_ramp(0.9)``, 32², float32 tables), 3 orbit frames of 2 spp: EAM's
  PNG frames within 1 uint8 level in every pixel (measured: equal), MCM's
  within 1 level in at least 97% of the pixels (the runtime test's MCM
  bound; measured: equal), and the GIF's frames are the PNGs'.
- ``cli animate`` end to end, orbit and circle paths, with ``--video``;
  the ``animate`` and ``view`` parsers take ``vpt_tpu``'s options, with the
  same defaults and choices.
"""

import argparse
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from vpt_tpu import cli as jcli
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.io import video as jvideo
from vpt_tpu.runtime import RenderingContext as JContext
from vpt_tpu_torch import cli as tcli
from vpt_tpu_torch import transfer as ttransfer
from vpt_tpu_torch import volume as tvolume
from vpt_tpu_torch.io import video as tvideo
from vpt_tpu_torch.runtime import RenderingContext as TContext


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n=4, h=24, w=32, channels=3):
    r = np.random.default_rng(5)
    base = r.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(n)]


def test_gif_bytes_equal(tmp_path):
    frames = _frames(channels=4)
    for mod, name in ((jvideo, "j.gif"), (tvideo, "t.gif")):
        assert mod.write_video(tmp_path / name, frames, fps=10) \
            == tmp_path / name
    assert (tmp_path / "t.gif").read_bytes() \
        == (tmp_path / "j.gif").read_bytes()
    assert Image.open(tmp_path / "t.gif").n_frames == 4


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


@pytest.mark.parametrize("ext", [".avi", ".mp4", ".webm"])
def test_opencv_videos_decode_equal(tmp_path, ext, capsys):
    pytest.importorskip("cv2")
    frames = _frames()
    written = [mod.write_video(tmp_path / f"{name}{ext}", frames, fps=12)
               for mod, name in ((jvideo, "j"), (tvideo, "t"))]
    said = capsys.readouterr().out
    assert [p.suffix for p in written] == [written[0].suffix] * 2
    if written[0].suffix == ".gif":        # the codec did not open here
        assert said.count("falling back to animated GIF") == 2
        assert written[1].read_bytes() == written[0].read_bytes()
        return
    jf, tf = (_decode(p) for p in written)
    assert len(tf) == len(jf) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(tf, jf))


def _fake_cv2(opens):
    class Writer:
        def __init__(self, *args):
            pass

        def isOpened(self):
            return opens

        def release(self):
            pass

    return types.SimpleNamespace(VideoWriter_fourcc=lambda *c: 0,
                                 VideoWriter=Writer)


@pytest.mark.parametrize("case", ["unknown", "no_cv2", "codec"])
def test_fallbacks_print_and_write_the_same(tmp_path, monkeypatch, capsys,
                                            case):
    frames = _frames(n=2)
    ext = ".mkv" if case == "unknown" else ".mp4"
    if case == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    elif case == "codec":
        monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(False))
    out = []
    for mod, name in ((jvideo, "j"), (tvideo, "t")):
        path = mod.write_video(tmp_path / f"{name}{ext}", frames, fps=5)
        out.append((path, capsys.readouterr().out))
    (jpath, jsaid), (tpath, tsaid) = out
    assert tpath == tmp_path / "t.gif" and jpath == tmp_path / "j.gif"
    assert tsaid.replace("t.", "j.") == jsaid and "GIF" in tsaid
    assert tpath.read_bytes() == jpath.read_bytes()
    with pytest.raises(ValueError, match="at least one frame"):
        tvideo.write_video(tmp_path / "x.gif", [])


def _contexts(renderer):
    j = JContext(resolution=32, precision="exact", tf_srgb=True)
    j.set_volume(jvolume.blobs_volume(24, seed=7))
    j.set_transfer_function(jtransfer.gray_ramp(alpha_scale=0.9))
    j.choose_renderer(renderer)
    j.choose_tone_mapper("reinhard")
    t = TContext(resolution=32, precision="exact", tf_srgb=True,
                 device="cpu")
    t.set_volume(tvolume.blobs_volume(24, seed=7, device="cpu"))
    t.set_transfer_function(ttransfer.gray_ramp(alpha_scale=0.9,
                                                device="cpu"))
    t.choose_renderer(renderer)
    t.choose_tone_mapper("reinhard")
    return j, t


def _pngs(folder):
    return [np.asarray(Image.open(p)).astype(int)
            for p in sorted(folder.glob("frame_*.png"))]


@pytest.mark.parametrize("renderer,share", [("eam", 1.0), ("mcm", 0.97)])
def test_record_animation_matches_jax(tmp_path, renderer, share, capsys):
    for ctx, name in zip(_contexts(renderer), ("j", "t")):
        ctx.record_animation(tmp_path / name, frames=3, spp=2,
                             video=tmp_path / f"{name}.gif", fps=10)
        assert f"wrote video {tmp_path / f'{name}.gif'}" \
            in capsys.readouterr().out
    jp, tp = _pngs(tmp_path / "j"), _pngs(tmp_path / "t")
    assert len(tp) == len(jp) == 3
    for got, want in zip(tp, jp):
        assert got.shape == want.shape == (32, 32, 3) and want.max() > 0
        near = (np.abs(got - want) <= 1).all(-1)
        assert near.mean() >= share, near.mean()
    # consecutive frames differ: the orbit moved the camera
    assert not np.array_equal(tp[0], tp[1])
    gif = Image.open(tmp_path / "t.gif")
    assert gif.n_frames == 3
    for i, png in enumerate(tp):
        gif.seek(i)
        assert np.array_equal(np.asarray(gif.convert("RGB")), png)


@pytest.mark.parametrize("path", ["orbit", "circle"])
def test_animate_cli_matches_vpt_tpu(tmp_path, capsys, path):
    argv = ["animate", "--platform", "cpu", "--volume", "sphere:16",
            "--renderer", "eam", "--precision", "exact", "--resolution",
            "24", "--spp", "2", "--frames", "3", "--path", path, "--fps",
            "8"]
    for mod, name in ((jcli, "j"), (tcli, "t")):
        mod.main(argv + ["-o", str(tmp_path / name), "--video",
                         str(tmp_path / f"{name}.gif")])
    out = capsys.readouterr().out
    assert f"wrote 3 frames to {tmp_path / 't'}" in out
    jp, tp = _pngs(tmp_path / "j"), _pngs(tmp_path / "t")
    assert len(tp) == len(jp) == 3
    for got, want in zip(tp, jp):
        assert np.abs(got - want).max() <= 1
    assert Image.open(tmp_path / "t.gif").n_frames == 3


class _Parsed(Exception):
    pass


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.metavar) for a in parser._actions if a.option_strings}


def test_animate_and_view_parsers_match_vpt_tpu(monkeypatch):
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        jcli.main(["info"])
    monkeypatch.undo()
    jsub = seen["parser"]._subparsers._group_actions[0].choices
    tsub = tcli.build_parser()._subparsers._group_actions[0].choices
    for name in ("animate", "view"):
        assert [a.option_strings for a in tsub[name]._actions] \
            == [a.option_strings for a in jsub[name]._actions]
        assert _options(tsub[name]) == _options(jsub[name])
