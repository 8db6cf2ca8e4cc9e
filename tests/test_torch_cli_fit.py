"""The port's ``cli fit`` against ``vpt_tpu.cli fit`` on the CPU, on the
same target files: each method's ``.npy`` within the bounds of the
functions it drives (tests/test_torch_fit_eam.py, test_torch_diff_iso.py,
test_torch_inpaint.py, test_torch_train.py), its messages, and the
parser's options.

- eam, 3 orbit views of a 10³ blobs volume at 16², ``--inpaint-blind``:
  the fit's printed final loss within 1e-4 relative (or a unit of its
  last printed digit), the same chosen tau and
  filled fractions (tau 4.0 chosen, 12.5% filled), the volume within 1e-4
  (the fit's bound after 3 steps; measured 1.7e-5), the ``.png`` within
  1/255 in every pixel;
- mcm with ``--inpaint`` and mcs, one Adam step from the flat 0.1 init on
  an 8³ grid: the volume within 2e-5 (the first update's bound,
  tests/test_torch_train.py; measured 4.3e-7 and 3.4e-7), the same
  inpainted share;
- iso-depth on a 16² depth map of a 12³ sphere, 3 Adam steps: the
  volume within 1e-5 (measured 2.0e-6).
"""

import argparse
import math
import re

import numpy as np
import pytest
import torch
from PIL import Image

from vpt_tpu import cli as jcli
from vpt_tpu_torch import cli as tcli
from vpt_tpu_torch import train, transfer, volume
from vpt_tpu_torch.io.image import write_png
from vpt_tpu_torch.renderers import diff_iso, eam, make_scene
from vpt_tpu_torch.runtime.animators import OrbitCameraAnimator
from vpt_tpu_torch.scene import CameraState, default_camera


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def targets(tmp_path_factory):
    """Three orbit views (yaw 0/120/240) of ``blobs_volume(10)`` at 16²
    as PNGs, and a 16² diff_iso depth map of ``sphere_volume(12)``."""
    root = tmp_path_factory.mktemp("fit")
    truth = volume.blobs_volume(10, seed=4, device="cpu").data
    tf = transfer.gray_ramp(alpha_scale=1.0, device="cpu")
    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    params = eam.Params(slices=16, random=False)
    pngs = []
    for i, yaw in enumerate((0.0, 120.0, 240.0)):
        orbit.yaw = math.radians(yaw)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        with torch.no_grad():
            img = train.render_eam(truth, tf, (cs.mvp_inverse, cs.model_view,
                                               cs.projection), params,
                                   np.float32(0.0), 16, 16)
        write_png(root / f"view{i}.png", img)
        pngs.append(str(root / f"view{i}.png"))
    scene = make_scene(volume.sphere_volume(12, device="cpu"), tf,
                       pack=False, device="cpu")
    with torch.no_grad():
        depth = diff_iso.render(scene, diff_iso.Params(), 16, 16)["depth"]
    np.save(root / "depth.npy", depth.numpy())
    return root, pngs, str(root / "depth.npy")


def _both(argv, root, capsys):
    """Run both CLIs on ``argv``; their outputs and printed lines."""
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        cli.main(argv + ["--platform", "cpu", "-o", str(root / name)])
        out[name] = capsys.readouterr().out
    return out


def _float(pattern, text):
    return float(re.search(pattern, text).group(1))


def _printed(got, want, rel):
    """Two losses as the CLIs print them (6 decimals): within ``rel`` of
    each other, or one unit of the last printed digit apart."""
    return got == pytest.approx(want, rel=rel, abs=1.01e-6)


def test_fit_eam_inpaint_blind_matches_vpt_tpu(targets, capsys):
    root, pngs, _ = targets
    out = _both(["fit", "--target", *pngs, "--grid", "10", "--steps", "3",
                 "--eam-slices", "16", "--inpaint-blind",
                 "--blind-taus", "0.25,1.0,4.0"], root, capsys)
    pattern = r"final loss ([0-9.]+) over 3 view\(s\)"
    want, got = _float(pattern, out["jax"]), _float(pattern, out["port"])
    assert _printed(got, want, 1e-4)
    for key in ("chosen tau = ", "blind tau selection: "):
        lines = [next(ln for ln in out[k].splitlines() if key in ln)
                 for k in ("jax", "port")]
        if key.startswith("chosen"):
            assert lines[0] == lines[1]
        else:
            fills = [re.findall(r"fill=([0-9.]+)", ln) for ln in lines]
            assert fills[0] == fills[1] and len(fills[0]) == 4
    vol = np.load(root / "port.npy")
    assert vol.shape == (10, 10, 10, 1)
    assert np.abs(vol - np.load(root / "jax.npy")).max() <= 1e-4
    got = np.asarray(Image.open(root / "port.png"), np.int64)
    want = np.asarray(Image.open(root / "jax.png"), np.int64)
    assert got.shape == want.shape == (16, 16, 3)
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("method", ["mcm", "mcs"])
def test_fit_mc_matches_vpt_tpu(targets, capsys, method):
    root, pngs, _ = targets
    extra = ["--inpaint"] if method == "mcm" else []
    out = _both(["fit", "--target", pngs[0], "--method", method, "--grid",
                 "8", "--steps", "1", "--mc-frames", "2", *extra], root,
                capsys)
    pattern = r"final loss ([0-9.]+); wrote"
    assert _printed(_float(pattern, out["port"]), _float(pattern,
                                                         out["jax"]), 1e-5)
    got, want = np.load(root / "port.npy"), np.load(root / "jax.npy")
    assert got.shape == want.shape == (8, 8, 8, 1)
    assert np.abs(got - want).max() <= 2e-5
    if extra:
        share = [re.search(r"inpainted ([0-9.]+)% of voxels", out[k]).group(1)
                 for k in ("jax", "port")]
        assert share[0] == share[1]


def test_fit_iso_depth_matches_vpt_tpu(targets, capsys):
    root, _, depth = targets
    out = _both(["fit", "--target", depth, "--method", "iso-depth",
                 "--grid", "12", "--steps", "3", "--inpaint"], root, capsys)
    for text in out.values():
        assert "warning: --inpaint applies to the density-fitting" in text
    pattern = r"final depth MSE ([0-9.]+); wrote"
    assert _printed(_float(pattern, out["port"]), _float(pattern,
                                                         out["jax"]), 1e-4)
    got, want = np.load(root / "port.npy"), np.load(root / "jax.npy")
    assert got.shape == (12, 12, 12, 1)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("argv,message", [
    (["--method", "mcm", "--inpaint-blind"], "--inpaint-blind is eam-only"),
    (["--method", "mcs", "--target", "b.png"], "takes a single --target"),
    (["--method", "iso-depth"], "expects an .npy depth map"),
    (["--inpaint-blind"], "needs at least 3 --target views"),
    (["--view-yaw", "0", "90"], "must match the number of --target")])
def test_fit_messages_match_vpt_tpu(targets, argv, message):
    root, pngs, _ = targets
    full = ["fit", "--platform", "cpu", "--target", pngs[0]]
    if "--target" in argv:
        full = full + [pngs[1]] + [a for a in argv if a not in
                                   ("--target", "b.png")]
    else:
        full = full + argv
    texts = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(full + ["--steps", "0", "-o", str(root / "x")])
        texts.append(str(exc.value))
    assert texts[0] == texts[1] and message in texts[1]


def test_fit_parser_matches_vpt_tpu(monkeypatch):
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise RuntimeError("parsed")

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(RuntimeError, match="parsed"):
        jcli.main(["info"])
    monkeypatch.undo()

    def fit_options(parser):
        sub = parser._subparsers._group_actions[0].choices["fit"]
        return [(tuple(a.option_strings), a.default, a.choices, a.nargs,
                 a.metavar) for a in sub._actions]

    assert fit_options(tcli.build_parser()) == fit_options(seen["parser"])
