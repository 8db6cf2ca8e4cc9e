"""The port's differentiable MCM estimator (``renderers/diff_mc``) against
``vpt_tpu.renderers.diff_mc`` on the CPU.

- Frames and the expected image at 32² (where the jitted and the eager
  ``pixel_ndc`` agree, so every pixel hashes to the same stream): ``samples``
  and ``bounces`` agree in every pixel, ``logw`` is 0 in value on both
  sides, radiance within 1e-6 (measured: 1.2e-7; the resets pass through
  log/sin/cos, which differ in the last bit between the libraries).
- Gradients of an image MSE w.r.t. the volume and the TF texture, for each
  ``score_floor`` mode, against ``jax.grad``: the port sums the scattered
  cotangents in another order, so the gradients agree to a relative L2
  error of 1e-4 (measured: 1.3e-6 to 6.6e-6) and the losses to 1e-6
  relative.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import rng as jrng
from vpt_tpu import sampling as js
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import diff_mc as jdiff
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import interop, train
from vpt_tpu_torch.renderers import diff_mc, mcm

JPARAMS = jmcm.Params(extinction=10.0, anisotropy=0.3, steps=8)
TPARAMS = mcm.Params(extinction=10.0, anisotropy=0.3, steps=8)


def _scenes(n=16, tracking="none"):
    jscene = jmake_scene(jvolume.blobs_volume(n, seed=1),
                         jtransfer.gray_ramp(alpha_scale=0.8),
                         tracking=tracking)
    return jscene, interop.scene_from_numpy(interop.scene_fields(jscene))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _assert_states_agree(got, want):
    assert sorted(got) == sorted(want)
    for key in ("samples", "bounces", "logw"):
        assert np.array_equal(got[key], want[key]), key
    assert not want["logw"].any()
    assert np.allclose(got["radiance"], want["radiance"], rtol=0, atol=1e-6)
    assert np.allclose(got["position"], want["position"], rtol=0, atol=1e-5)


def test_render_frame_matches_jax():
    """One differentiable frame from JAX's own reset state, 32², blobs 16³,
    steps 8; the state passed in is left unchanged."""
    jscene, tscene = _scenes(tracking="auto")
    jstate = jdiff.mcm_reset(JPARAMS, 32, 32, jscene, seed=0.2)
    assert "cheb" not in jstate
    tstate = diff_mc.mcm_reset(TPARAMS, 32, 32, tscene, seed=0.2)
    assert sorted(tstate) == sorted(jstate)
    for key, value in _np(jstate).items():
        assert np.allclose(tstate[key].numpy(), value, rtol=0, atol=1e-5)
    start = interop.state_from_numpy(_np(jstate))
    before = {k: v.clone() for k, v in start.items()}
    want = _np(jax.jit(jdiff.mcm_render_frame, static_argnums=(2,))(
        jstate, jscene, JPARAMS, jnp.float32(0.61), 1))
    out = diff_mc.mcm_render_frame(start, tscene, TPARAMS, 0.61, 1)
    assert all(torch.equal(start[k], before[k]) for k in start)
    _assert_states_agree(interop.state_to_numpy(out), want)
    assert want["samples"].mean() > 1.0


def test_render_frame_value_is_the_analog_frame():
    """Ratio weights are 1 in value: the differentiable frame deposits what
    the analog frame deposits (tests/test_diff_mc.py's check, in the
    port)."""
    _, tscene = _scenes()
    analog = mcm.reset(TPARAMS, 16, 16, tscene, seed=0.2)
    diff = diff_mc.mcm_reset(TPARAMS, 16, 16, tscene, seed=0.2)
    mcm.render_frame(analog, tscene, TPARAMS, 0.6)
    out = diff_mc.mcm_render_frame(diff, tscene, TPARAMS, 0.6)
    assert torch.equal(out["samples"], analog["samples"])
    assert torch.equal(out["radiance"], analog["radiance"])


def test_frame_seeds_match_jax():
    for seed0 in (0.0, 0.3, 0.1 + 0.013 * 7):
        for i in (0, 1, 5, 63):
            want = np.asarray(jrng.pcg(jnp.uint32(i) + jrng.float_bits_to_uint(
                jnp.float32(seed0))).astype(jnp.float32)
                / jnp.float32(2 ** 32))
            assert diff_mc.frame_seed(i, seed0) == want


def test_expected_image_matches_jax():
    jscene, tscene = _scenes()
    want = np.asarray(jdiff.mcm_expected_image(jscene, JPARAMS, 32, 32, 3,
                                               seed0=0.3))
    got = diff_mc.mcm_expected_image(tscene, TPARAMS, 32, 32, 3, seed0=0.3)
    assert got.shape == (32, 32, 3)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("score_floor", [None, 0.05, 1.0])
def test_gradients_match_jax(score_floor):
    """value_and_grad of an image MSE through the fit's scene (both tables
    packed in the graph), 16², blobs 16³, 2 frames of 8 steps."""
    jscene, tscene = _scenes()
    res, frames = 16, 2
    target = np.random.default_rng(0).uniform(0, 1, (res, res, 3)).astype(
        np.float32)

    def jloss(leaves):
        sc = dataclasses.replace(
            jscene, volume=leaves["volume"], transfer=leaves["tf"],
            volume_packed=js.pack_corner_volume(leaves["volume"]),
            transfer_packed=js.pack_corner_texture2d(leaves["tf"]))
        img = jdiff.mcm_expected_image(sc, JPARAMS, res, res, frames,
                                       seed0=0.3, score_floor=score_floor)
        return jnp.mean((img - target) ** 2), img

    (jl, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(
        {"volume": jscene.volume, "tf": jscene.transfer})

    leaves = {"volume": tscene.volume.clone().requires_grad_(True),
              "tf": tscene.transfer.clone().requires_grad_(True)}
    sc = train.fit_scene(tscene, leaves["volume"], leaves["tf"])
    img = diff_mc.mcm_expected_image(sc, TPARAMS, res, res, frames,
                                     seed0=0.3, score_floor=score_floor)
    loss = torch.mean((img - torch.from_numpy(target)) ** 2)
    loss.backward()

    assert np.allclose(img.detach().numpy(), np.asarray(jimg), rtol=0,
                       atol=1e-6)
    assert abs(loss.item() - float(jl)) <= 1e-6 * float(jl)
    for name in ("volume", "tf"):
        got, want = leaves[name].grad.numpy(), np.asarray(jg[name])
        assert np.isfinite(got).all(), name
        assert np.abs(want).max() > 0.0, name
        assert _rel_l2(got, want) <= 1e-4, (name, _rel_l2(got, want))


def test_score_floor_one_drops_the_score_term():
    """score_floor >= 1 leaves the pathwise gradient only; a smaller floor
    adds score terms, so the volume gradients differ."""
    _, tscene = _scenes(n=8)
    grads = []
    for floor in (None, 1.0):
        vol = tscene.volume.clone().requires_grad_(True)
        img = diff_mc.mcm_expected_image(train.fit_scene(tscene, vol),
                                         TPARAMS, 8, 8, 2, seed0=0.1,
                                         score_floor=floor)
        img.mean().backward()
        grads.append(vol.grad)
    assert not torch.allclose(grads[0], grads[1])


def test_mcs_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        diff_mc.mcs_expected_image(None, None, 8, 8, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        diff_mc.mcs_generate(None, None, 0.0, 8, 8)


def test_diff_state_crosses_interop():
    _, tscene = _scenes(n=8)
    state = diff_mc.mcm_reset(TPARAMS, 4, 6, tscene)
    back = interop.state_from_numpy(interop.state_to_numpy(state))
    assert sorted(back) == sorted(state) and "logw" in back
    assert all(torch.equal(back[k], state[k]) for k in state)
