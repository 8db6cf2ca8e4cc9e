"""The port's differentiable MCS estimator (``renderers/diff_mc``:
``mcs_generate``, ``mcs_expected_image``) and ``train.fit_mc(renderer=
"mcs")`` against vpt_tpu's, on the CPU.

- ``mcs_generate`` at 12², blobs 12³, extinction 5: the same RNG streams as
  the port's analog ``mcs.generate``, so the value equals it bit for bit;
  against vpt_tpu's within 1e-6 (measured: 1.5e-8, the resets' log and the
  sphere sample's sin/cos differ in the last bit between the libraries).
- The gradient of an image MSE through the fit's scene (both tables packed
  in the graph) at 8², 2 frames, for ``score_floor`` None and 1 (the
  pathwise gradient alone), against ``jax.grad``: the port sums the
  scattered cotangents in another order, so the gradients agree to a
  relative L2 error of 1e-4 (measured: 5.6e-7 and 7.2e-7), the MCM half's
  bound, and the losses to 1e-6 relative; the two floors' gradients
  differ.
- The early exit (the port leaves a tracking scan once every pixel is
  done; JAX runs all ``track_steps``): values and gradients equal to the
  full budget's bit for bit, with ``diff_mc._EXIT_EARLY`` switched off.
- ``fit_mc(renderer="mcs")``: one Adam step of a TF fit from the same
  leaves, loss within 1e-6 relative of vpt_tpu's, the updated TF within
  2e-5 (``tests/test_torch_train.py``'s bound for the first update).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as js
from vpt_tpu import train as jtrain
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import diff_mc as jdiff
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcs as jmcs
from vpt_tpu_torch import interop, train
from vpt_tpu_torch.renderers import diff_mc, mcs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JPARAMS = jmcs.Params(extinction=5.0)
TPARAMS = mcs.Params(extinction=5.0)


@pytest.fixture(scope="module")
def scenes():
    jscene = jmake_scene(jvolume.blobs_volume(12, seed=1),
                         jtransfer.gray_ramp(alpha_scale=0.8))
    return jscene, interop.scene_from_numpy(interop.scene_fields(jscene),
                                            device="cpu")


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_mcs_generate_is_the_analog_frame_and_matches_jax(scenes):
    jscene, tscene = scenes
    seed = np.float32(0.37)
    got = diff_mc.mcs_generate(tscene, TPARAMS, seed, 12, 12)
    assert got.shape == (12, 12, 4)
    assert torch.equal(got, mcs.generate(tscene, TPARAMS, seed, 12, 12))
    want = np.asarray(jdiff.mcs_generate(jscene, JPARAMS, jnp.float32(seed),
                                         12, 12))
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # some paths scatter, some escape
    assert 0.0 < float(got[..., 3].min()) and len(np.unique(want)) > 4


def _fit_leaves(tscene):
    return {"volume": tscene.volume.clone().requires_grad_(True),
            "tf": tscene.transfer.clone().requires_grad_(True)}


def _port_loss(tscene, leaves, target, score_floor=None):
    sc = train.fit_scene(tscene, leaves["volume"], leaves["tf"])
    img = diff_mc.mcs_expected_image(sc, TPARAMS, 8, 8, 2, seed0=0.3,
                                     score_floor=score_floor)
    loss = torch.mean((img[..., :3] - torch.from_numpy(target)) ** 2)
    loss.backward()
    return loss, img


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(0).uniform(0, 1, (8, 8, 3)).astype(
        np.float32)


@pytest.mark.parametrize("score_floor", [None, 1.0])
def test_expected_image_gradients_match_jax(scenes, target, score_floor):
    jscene, tscene = scenes

    def jloss(leaves):
        sc = dataclasses.replace(
            jscene, volume=leaves["volume"], transfer=leaves["tf"],
            volume_packed=js.pack_corner_volume(leaves["volume"]),
            transfer_packed=js.pack_corner_texture2d(leaves["tf"]),
            transfer_banks=None, transfer_mxu=None)
        img = jdiff.mcs_expected_image(sc, JPARAMS, 8, 8, 2, seed0=0.3,
                                       score_floor=score_floor)
        return jnp.mean((img[..., :3] - target) ** 2), img

    (jl, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(
        {"volume": jscene.volume, "tf": jscene.transfer})
    leaves = _fit_leaves(tscene)
    loss, img = _port_loss(tscene, leaves, target, score_floor)
    assert np.allclose(img.detach().numpy(), np.asarray(jimg), rtol=0,
                       atol=1e-6)
    assert abs(loss.item() - float(jl)) <= 1e-6 * float(jl)
    for name in ("volume", "tf"):
        got, want = leaves[name].grad.numpy(), np.asarray(jg[name])
        assert np.isfinite(got).all(), name
        assert np.abs(want).max() > 0.0, name
        assert _rel_l2(got, want) <= 1e-4, (name, _rel_l2(got, want))


def test_score_floor_one_drops_the_score_term(scenes, target):
    """score_floor >= 1 leaves the pathwise gradient only: the volume
    gradients of the two floors differ, their images do not."""
    _, tscene = scenes
    out = []
    for floor in (None, 1.0):
        leaves = _fit_leaves(tscene)
        _, img = _port_loss(tscene, leaves, target, floor)
        out.append((img.detach(), leaves["volume"].grad))
    assert torch.equal(out[0][0], out[1][0])
    assert not torch.allclose(out[0][1], out[1][1])


def test_exit_early_equals_the_full_budget(scenes, target, monkeypatch):
    """Leaving a tracking scan once every pixel is done gives the full
    128-step budget's values and gradients bit for bit."""
    _, tscene = scenes
    out = []
    for exit_early in (True, False):
        monkeypatch.setattr(diff_mc, "_EXIT_EARLY", exit_early)
        leaves = _fit_leaves(tscene)
        loss, img = _port_loss(tscene, leaves, target)
        out.append((loss.detach(), img.detach(), leaves["volume"].grad,
                    leaves["tf"].grad))
    for early, full in zip(*out):
        assert torch.equal(early, full)


def test_fit_mc_mcs_first_step_matches_jax(scenes):
    """One Adam step of a TF fit from a flat TF through
    ``fit_mc(renderer="mcs")`` with its default Params (extinction 5)."""
    jscene, tscene = scenes
    target = np.random.default_rng(1).uniform(0, 1, (8, 8, 3)).astype(
        np.float32)
    init = np.full(np.asarray(jscene.transfer).shape, 0.3, np.float32)
    _, jtf, jlosses = jtrain.fit_mc(target, jscene, init_tf=init,
                                    renderer="mcs", frames=2, steps=1)
    vol, tf, losses = train.fit_mc(target, tscene, init_tf=init,
                                   renderer="mcs", frames=2, steps=1)
    assert vol is None and tf.shape == init.shape
    assert abs(losses[0] - jlosses[0]) <= 1e-6 * jlosses[0]
    assert np.allclose(tf.numpy(), np.asarray(jtf), rtol=0, atol=2e-5)
    assert not np.array_equal(tf.numpy(), init)
