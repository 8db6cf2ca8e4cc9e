"""The port's differentiable ISO (``renderers/diff_iso.py``) against
``vpt_tpu.renderers.diff_iso`` on the CPU, on tests/test_diff_iso.py's
sphere (24³ there, 16³ here) at 24² and 12², with the bounds of its
claims:

- ``render``'s ``depth``, ``hit``, ``image`` and ``position`` within 1e-5
  (measured 1.4e-6), its ``normal`` within 1e-4 (measured 3.9e-6: the
  central difference divides the positions' last-bit differences by 2h =
  0.01), on the rendering scene and on the differentiable scene that
  ``depth_loss`` builds (``base.fit_scene``), its 48 steps sampled in
  three fetches;
- ``depth_loss`` within 1e-6 relative (measured equal) and its voxel
  gradient within 1e-4 relative L2 (measured 9.2e-6; the per-step
  fetches through ``CornerFetch``, the hit's through the plain gather,
  whose gradient reaches the positions);
- the gradient of the mean depth with respect to a tensor isovalue
  (measured equal), and the voxel gradient of the shaded image (the
  normals; measured 1.5e-5), within 1e-4 relative L2;
- at small τ the soft depth lies within 2.5 steps of the port's hard ISO
  march, as in tests/test_diff_iso.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import diff_iso as jdiff_iso
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop
from vpt_tpu_torch.renderers import diff_iso, iso
from vpt_tpu_torch.renderers.base import fit_scene


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
def scenes():
    jscene = jmake_scene(jvolume.sphere_volume(16),
                         jtransfer.gray_ramp(alpha_scale=1.0), pack=False)
    tscene = interop.scene_from_numpy(interop.scene_fields(jscene),
                                      device="cpu")
    return jscene, tscene


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_render_matches_jax(scenes, monkeypatch):
    jscene, tscene = scenes
    monkeypatch.setattr(diff_iso, "_STEPS_PER_FETCH", 16)   # 3 fetches
    h = w = 24
    jp = jdiff_iso.Params(isovalue=0.45, tau=0.05, steps=48)
    tp = diff_iso.Params(isovalue=0.45, tau=0.05, steps=48)
    want = jax.jit(lambda: jdiff_iso.render(jscene, jp, h, w))()
    diff = fit_scene(tscene, volume=tscene.volume.clone().requires_grad_())
    for scene in (tscene, diff):
        got = diff_iso.render(scene, tp, h, w)
        for key in ("depth", "hit", "image", "position", "normal"):
            err = np.abs(got[key].detach().numpy() - np.asarray(want[key]))
            assert err.max() <= (1e-4 if key == "normal" else 1e-5), key
    hit = np.asarray(want["hit"])
    assert (hit > 0.5).sum() >= 30 and (np.asarray(want["depth"]) < 0).any()


def test_depth_loss_and_voxel_gradient_match_jax(scenes):
    jscene, tscene = scenes
    h = w = 12
    jp = jdiff_iso.Params(isovalue=0.45, tau=0.05, steps=40)
    tp = diff_iso.Params(isovalue=0.45, tau=0.05, steps=40)
    target = np.full((h, w), 0.5, np.float32)
    target[:2] = -1.0                       # invalid rows are left out
    jl, jg = jax.jit(jax.value_and_grad(lambda v: jdiff_iso.depth_loss(
        v, jscene, jp, jnp.asarray(target), h, w)))(jscene.volume)
    vol = tscene.volume.clone().requires_grad_(True)
    loss = diff_iso.depth_loss(vol, tscene, tp, torch.from_numpy(target),
                               h, w)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * float(jl)
    g = vol.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert _rel_l2(g, np.asarray(jg)) <= 1e-4


def test_isovalue_and_normal_gradients_match_jax(scenes):
    jscene, tscene = scenes
    h = w = 12
    base = dict(tau=0.05, steps=40)

    def jmean_depth(iso_value):
        out = jdiff_iso.render(jscene, jdiff_iso.Params(isovalue=iso_value,
                                                        **base), h, w)
        return jnp.mean(out["depth"] * (out["hit"] > 0.5))

    def jimage(vol):
        sc = dataclasses.replace(jscene, volume=vol)
        out = jdiff_iso.render(sc, jdiff_iso.Params(**base), h, w)
        return jnp.sum(out["image"][..., :3] * out["hit"][..., None])

    jgi = float(jax.jit(jax.grad(jmean_depth))(jnp.float32(0.45)))
    jgv = np.asarray(jax.jit(jax.grad(jimage))(jscene.volume))

    isovalue = torch.tensor(0.45, requires_grad=True)
    out = diff_iso.render(tscene, diff_iso.Params(isovalue=isovalue, **base),
                          h, w)
    torch.mean(out["depth"] * (out["hit"] > 0.5)).backward()
    assert np.isfinite(jgi) and abs(jgi) > 0
    assert abs(isovalue.grad.item() - jgi) <= 1e-4 * abs(jgi)

    vol = tscene.volume.clone().requires_grad_(True)
    out = diff_iso.render(fit_scene(tscene, volume=vol),
                          diff_iso.Params(**base), h, w)
    torch.sum(out["image"][..., :3] * out["hit"][..., None]).backward()
    assert np.abs(jgv).max() > 0
    assert _rel_l2(vol.grad.numpy(), jgv) <= 1e-4


def test_soft_depth_converges_to_hard_iso(scenes):
    _, tscene = scenes
    h = w = 24
    hard = iso.Params(isovalue=0.4, steps=200)
    state = iso.reset(hard, h, w, tscene)
    for i in range(4):
        state = iso.render_frame(state, tscene, hard, np.float32(0.1 * i),
                                 i + 1)
    hard_t = state[..., 3].numpy()
    with torch.no_grad():
        soft = diff_iso.render(tscene, diff_iso.Params(isovalue=0.4,
                                                       tau=0.004, steps=200),
                               h, w)
    both = (hard_t > 0) & (soft["hit"].numpy() > 0.9)
    assert both.sum() >= 20
    assert np.abs(soft["depth"].numpy()[both] - hard_t[both]).max() \
        < 2.5 / 200
