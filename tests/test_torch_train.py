"""The port's ``train.fit_mc`` against ``vpt_tpu.train.fit_mc`` on the CPU.

- The first step from the same leaves: the losses agree to 1e-6 relative
  and the first Adam updates to 2e-5 absolute (measured: 4.2e-6, at 3 of
  4096 voxels).  Adam's first update is lr·g/(|g| + eps) for both optax and
  torch.optim, so it is ±lr wherever |g| ≫ eps, and the gradients' last-bit
  differences show only where |g| is near eps = 1e-8.
- A shortened port of tests/test_train.py's TF-alpha recovery, with its
  bounds: fewer frames and steps and a larger learning rate, so that the
  eager CPU loop stays within seconds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import train as jtrain
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import interop, sampling, train
from vpt_tpu_torch.renderers import diff_mc, make_scene, mcm


def test_first_loss_and_update_match_jax():
    jscene = jmake_scene(jvolume.blobs_volume(16, seed=1),
                         jtransfer.gray_ramp(alpha_scale=0.8))
    tscene = interop.scene_from_numpy(interop.scene_fields(jscene))
    jparams = jmcm.Params(extinction=10.0, steps=8)
    tparams = mcm.Params(extinction=10.0, steps=8)
    target = np.random.default_rng(0).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    init = np.full((16, 16, 16, 1), 0.2, np.float32)

    jvol, jtf, jlosses = jtrain.fit_mc(target, jscene, init_volume=init,
                                       params=jparams, frames=2, steps=1)
    vol, tf, losses = train.fit_mc(target, tscene, init_volume=init,
                                   params=tparams, frames=2, steps=1)
    assert jtf is None and tf is None
    assert abs(losses[0] - jlosses[0]) <= 1e-6 * jlosses[0]
    want = np.asarray(jvol) - init
    got = vol.numpy() - init
    assert np.array_equal(got != 0.0, want != 0.0)
    assert np.abs(want).max() == pytest.approx(0.02, rel=1e-4)
    assert np.allclose(got, want, rtol=0, atol=2e-5)


def test_fit_mc_recovers_tf_alpha():
    """tests/test_train.py:118-142 shortened: target 40 frames (150 there),
    fit 5 frames × 12 steps at learning rate 0.035 (60 × 40 at 0.03);
    same bounds."""
    vol = torch.ones(4, 4, 4, 1)
    target_alpha = 0.45
    tf_target = torch.zeros(2, 2, 4)
    tf_target[..., 3] = target_alpha
    sc = make_scene(vol, tf_target, pack=False)
    params = mcm.Params(extinction=4.0, steps=24)
    with torch.no_grad():
        target = diff_mc.mcm_expected_image(sc, params, 6, 6, frames=40)

    tf_init = torch.zeros(2, 2, 4)
    tf_init[..., 3] = 0.15
    _, tf_fit, losses = train.fit_mc(target, sc, init_tf=tf_init,
                                     params=params, frames=5, steps=12,
                                     learning_rate=0.035)
    assert losses[-1] < losses[0] * 0.3
    got = float(sampling.sample_texture2d(
        tf_fit, torch.tensor([[1.0, 0.0]]))[0, 3])
    assert abs(got - target_alpha) < 0.12, got
    assert float(tf_fit.min()) >= 0.0 and float(tf_fit.max()) <= 1.0


def test_fit_surface():
    assert train.MC_FIT_EXTINCTION == jtrain.MC_FIT_EXTINCTION
    sc = make_scene(torch.ones(4, 4, 4, 1), torch.zeros(2, 2, 4), pack=False)
    target = torch.zeros(4, 4, 3)
    with pytest.raises(ValueError, match="nothing to fit"):
        train.fit_mc(target, sc)
    with pytest.raises(ValueError):
        train.fit_mc(target, sc, init_tf=torch.zeros(2, 2, 4),
                     renderer="eam")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.fit_mc(target, sc, init_tf=torch.zeros(2, 2, 4),
                     renderer="mcs")
    for fn in (train.fit, train.make_train_step, train.render_eam):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()


def test_fit_leaves_cross_interop():
    r = np.random.default_rng(2)
    leaves = {"volume": r.uniform(size=(4, 4, 4, 1)).astype(np.float32),
              "tf": jnp.asarray(r.uniform(size=(2, 8, 4)), jnp.float32)}
    t = interop.state_from_numpy(dict(leaves, nothing=None))
    assert sorted(t) == ["tf", "volume"]
    back = interop.state_to_numpy(dict(t, nothing=None))
    assert all(np.array_equal(back[k], np.asarray(leaves[k]))
               for k in leaves)
