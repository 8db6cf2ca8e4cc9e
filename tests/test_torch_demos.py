"""The three small demos of ``vpt_tpu_torch/examples`` against
``examples/`` (vpt_tpu's, imported from their files) at small sizes.

- ``render_demo``: the montage of the eight renderers at 32² (the demo's
  own ``main`` on both sides).
- ``inverse_demo``: the EAM fit from three orbit views on an 8³ grid, 3
  Adam steps (vpt_tpu's ``main`` with its ``fit`` wrapped to keep what it
  returns).
- ``depth_fit_demo``: vpt_tpu's Adam loop over ``diff_iso.depth_loss``,
  transcribed at a 12³ grid and 16², against the port's ``run``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import diff_iso as jdiff_iso
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch.examples import depth_fit_demo, inverse_demo, render_demo

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_render_demo_montage_matches_vpt_tpu(tmp_path, monkeypatch):
    """Both demos' montages at 32², as 8-bit pixels: in every panel at
    least 97% of the pixels within 1 level, and the montages' means within
    0.5 levels (measured: every pixel within 1 level, 72-99% equal, the
    means 0.15 apart)."""
    from PIL import Image

    out = tmp_path / "jax.png"
    monkeypatch.setattr("sys.argv", ["render_demo.py", "--out", str(out),
                                     "--resolution", "32"])
    _jax_example("render_demo").main()
    want = np.asarray(Image.open(out).convert("RGB")).astype(np.int32)
    sheet = render_demo.main(["--platform", "cpu", "--resolution", "32",
                              "--out", str(tmp_path / "port.png")])
    got = np.asarray(Image.open(tmp_path / "port.png").convert("RGB"))
    assert got.shape == want.shape == (64, 128, 3)
    assert sheet.shape == (64, 128, 3)
    diff = np.abs(got.astype(np.int32) - want)
    for row in range(2):
        for col in range(4):
            panel = diff[32 * row:32 * (row + 1), 32 * col:32 * (col + 1)]
            share = (panel.max(-1) <= 1).mean()
            assert share >= 0.97, (row, col, share)
    assert abs(got.mean() - want.mean()) <= 0.5


def test_inverse_demo_matches_vpt_tpu(monkeypatch):
    """vpt_tpu's demo at ``--grid 8 --steps 3``: each Adam step's loss
    within 1e-4 relative (``test_torch_fit_eam.py``'s bound for ``fit``;
    measured 2.1e-5) and the printed mean voxel error within 1e-5.  Adam
    amplifies last-bit gradient differences where a voxel's gradient is
    near 0 (ROADMAP queue 3): 95% of the fitted voxels within 1e-5 and all
    within 1e-3 (measured: 98.4%, 80.1% within 1e-6, at most 2.9e-4)."""
    import vpt_tpu.train as jtrain

    kept = {}
    fit = jtrain.fit

    def keep(*args, **kwargs):
        kept["out"] = fit(*args, **kwargs)
        return kept["out"]

    monkeypatch.setattr(jtrain, "fit", keep)
    monkeypatch.setattr("sys.argv", ["inverse_demo.py", "--grid", "8",
                                     "--steps", "3"])
    _jax_example("inverse_demo").main()
    jvol, _, jlosses = kept["out"]
    vol, losses, err = inverse_demo.run(grid=8, steps=3, device="cpu",
                                        verbose=False)
    assert len(losses) == len(jlosses) == 3
    assert np.allclose(losses, jlosses, rtol=1e-4, atol=0)
    assert losses[-1] < losses[0]
    diff = np.abs(vol.numpy() - np.asarray(jvol))
    assert (diff <= 1e-5).mean() >= 0.95, (diff <= 1e-5).mean()
    assert diff.max() <= 1e-3, diff.max()
    truth = np.asarray(jvolume.blobs_volume(8, seed=9).data)
    assert abs(err - float(np.mean(np.abs(np.asarray(jvol) - truth)))) \
        <= 1e-5
    assert 0.0 < err < 0.5


def test_depth_fit_demo_matches_vpt_tpu():
    """vpt_tpu's loop (``examples/depth_fit_demo.py:31-58``) at a 12³
    sphere, 16², 11 steps: the losses before, at step 0 and step 10 and
    after within 1e-5 relative."""
    grid, h, steps = 12, 16, 11
    params = jdiff_iso.Params(isovalue=0.4, tau=0.03, steps=64)
    truth = jvolume.sphere_volume(grid).data
    scene = jmake_scene(truth, jtransfer.gray_ramp(alpha_scale=1.0),
                        pack=False)
    target = jdiff_iso.render(scene, params, h, h)["depth"]
    guess = jnp.asarray(np.asarray(jvolume.sphere_volume(grid).data) * 0.6)
    loss_fn = jax.jit(lambda v: jdiff_iso.depth_loss(
        v, scene, params, target, h, h))
    grad_fn = jax.jit(jax.grad(lambda v: jdiff_iso.depth_loss(
        v, scene, params, target, h, h)))
    opt = optax.adam(0.05)
    opt_state = opt.init(guess)
    want = [float(loss_fn(guess))]
    for i in range(steps):
        g = grad_fn(guess)
        updates, opt_state = opt.update(g, opt_state, guess)
        guess = jnp.clip(optax.apply_updates(guess, updates), 0.0, 1.0)
        if i % 10 == 0:
            want.append(float(loss_fn(guess)))
    want.append(float(loss_fn(guess)))

    l0, l1, logged = depth_fit_demo.run(grid, h, steps, device="cpu",
                                        verbose=False, check=False)
    got = [l0] + logged + [l1]
    assert len(got) == len(want) == 4
    assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)
    assert got[-1] < got[0]


def test_demos_take_the_card_by_default(monkeypatch):
    """Without ``--platform cpu`` each demo asks for the card (none
    here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for demo in (render_demo, inverse_demo, depth_fit_demo):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main([])
