"""The port's EAM fit (``train.render_eam``, ``make_train_step``, ``fit``,
``FitState``) against ``vpt_tpu.train`` on the CPU.

Bounds, each measured on these inputs:
- ``render_eam``'s image within 1e-6 absolute (measured 1.2e-7: the
  float32 corner packing is the unpacked fetch bit for bit; the composite
  rounds as XLA's fused loop does up to an ulp);
- the volume and TF gradients of its mean within 1e-5 relative L2
  (measured 5.1e-6 and 8.0e-6: the scatter-adds sum in another order);
- one ``make_train_step`` step: the loss within 1e-6 relative, the updated
  volume and TF within 1e-6 (measured 7.0e-8 and 9.5e-7: Adam's first
  update lr·g/(|g| + eps) is sensitive only where |g| is near eps);
- a fit begun in ``vpt_tpu`` goes on in the port from the carried optax
  state (``interop.fit_state_from_numpy``): the next loss within 1e-6
  relative (measured 9.2e-7); given vpt_tpu's gradient, the next update
  within 1e-6 (measured 5.4e-7); the port's own next step agrees in at
  least 95% of the values within 1e-6 (measured 98.5%), all within 1e-4
  (measured 4.7e-5: Adam's second update amplifies the gradients'
  last-bit differences; ROADMAP.md queue 3); each package's FitState
  round-trips;
- ``fit``'s losses over 3 steps, single- and multi-view, within 1e-4
  relative (measured 1.2e-5), the volume within 1e-4 (2.2e-6).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vpt_tpu import train as jtrain
from vpt_tpu import transfer as jtransfer
from vpt_tpu.renderers import eam as jeam
from vpt_tpu.runtime.animators import OrbitCameraAnimator as JOrbit
from vpt_tpu.scene import CameraState as JCameraState
from vpt_tpu.scene import default_camera as jdefault_camera
from vpt_tpu_torch import interop, train
from vpt_tpu_torch.renderers import eam


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H = W = 16
LR = 0.05


def _views(yaws):
    cam = jdefault_camera()
    orbit = JOrbit(cam)
    out = []
    for yaw in yaws:
        orbit.yaw = yaw
        orbit._update_camera()
        cs = JCameraState.from_nodes(cam)
        out.append(tuple(np.asarray(m) for m in (cs.mvp_inverse,
                                                 cs.model_view,
                                                 cs.projection)))
    return out


def _t(mats):
    return tuple(torch.from_numpy(np.array(m)) for m in mats)


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(7)
    vol = r.uniform(0.1, 0.6, (10, 10, 10, 1)).astype(np.float32)
    tf = np.array(jtransfer.gray_ramp(alpha_scale=0.8))
    views = _views((0.0, 2.1, 4.2))
    jparams = jeam.Params(slices=16, random=False, extinction=50.0)
    tparams = eam.Params(slices=16, random=False, extinction=50.0)
    truth = r.uniform(0.0, 0.8, (10, 10, 10, 1)).astype(np.float32)
    render = jax.jit(lambda m: jtrain.render_eam(
        jnp.asarray(truth), tf, m, jparams, jnp.float32(0.0), H, W))
    targets = [np.array(render(v)) for v in views]
    return dict(vol=vol, tf=tf, views=views, jparams=jparams,
                tparams=tparams, targets=targets)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_render_eam_and_gradients_match_jax(case):
    vol, tf, mats = case["vol"], case["tf"], case["views"][0]

    def jloss(v, t):
        img = jtrain.render_eam(v, t, mats, case["jparams"],
                                jnp.float32(0.0), H, W)
        return jnp.mean(img[..., :3]), img

    (jl, jimg), (jgv, jgt) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(vol), jnp.asarray(tf))
    tv = torch.from_numpy(vol).requires_grad_(True)
    tt = torch.from_numpy(tf.copy()).requires_grad_(True)
    img = train.render_eam(tv, tt, _t(mats), case["tparams"],
                           np.float32(0.0), H, W)
    torch.mean(img[..., :3]).backward()
    assert img.shape == (H, W, 4)
    assert np.abs(img.detach().numpy() - np.asarray(jimg)).max() <= 1e-6
    assert _rel_l2(tv.grad.numpy(), np.asarray(jgv)) <= 1e-5
    assert _rel_l2(tt.grad.numpy(), np.asarray(jgt)) <= 1e-5
    # under no_grad the rendering scene's samplers give the same frame
    with torch.no_grad():
        plain = train.render_eam(torch.from_numpy(vol), torch.from_numpy(tf),
                                 _t(mats), case["tparams"], np.float32(0.0),
                                 H, W)
    assert torch.equal(plain, img.detach())


@pytest.mark.parametrize("fit_tf", [False, True])
def test_train_step_continues_a_jax_fit(case, fit_tf):
    """Step 1 in both packages from the same leaves; step 2 in the port
    from vpt_tpu's FitState after step 1, against vpt_tpu's step 2."""
    vol, tf, mats, target = (case["vol"], case["tf"], case["views"][1],
                             case["targets"][1])
    opt = optax.adam(LR)
    jstep = jax.jit(jtrain.make_train_step(opt, case["jparams"], H, W,
                                           fit_tf=fit_tf))
    tstep = train.make_train_step(lambda p: torch.optim.Adam(p, lr=LR),
                                  case["tparams"], H, W, fit_tf=fit_tf)
    leaves = {"volume": jnp.asarray(vol)}
    if fit_tf:
        leaves["tf"] = jnp.asarray(tf)
    jstate = jtrain.FitState(jnp.asarray(vol), jnp.asarray(tf),
                             opt.init(leaves))
    seed = jnp.float32(0.0)
    jl1, jv1, jt1, jo1 = jstep(jstate.volume_data, jstate.tf_texture,
                               jstate.opt_state, mats, target, seed)
    tl1, tv1, tt1, to1 = tstep(torch.from_numpy(vol), torch.from_numpy(tf),
                               None, _t(mats), torch.from_numpy(target),
                               np.float32(0.0))
    assert abs(tl1.item() - float(jl1)) <= 1e-6 * float(jl1)
    assert np.abs(tv1.numpy() - np.asarray(jv1)).max() <= 1e-6
    assert np.abs(tt1.numpy() - np.asarray(jt1)).max() <= 1e-6
    assert float(tv1.min()) >= 0.0 and float(tv1.max()) <= 1.0

    # vpt_tpu's state after step 1 → the port, and step 2 in both
    adam = jo1[0]
    fields = {"volume_data": np.asarray(jv1), "tf_texture": np.asarray(jt1),
              "count": np.asarray(adam.count),
              "mu": {k: np.asarray(v) for k, v in adam.mu.items()},
              "nu": {k: np.asarray(v) for k, v in adam.nu.items()},
              "step": 1}
    carried = interop.fit_state_from_numpy(fields, device="cpu")
    assert sorted(carried.opt_state) == sorted(leaves)
    jl2, jv2, jt2, jo2 = jstep(jv1, jt1, jo1, mats, target, seed)
    tl2, tv2, tt2, to2 = tstep(carried.volume_data, carried.tf_texture,
                               carried.opt_state, _t(mats),
                               torch.from_numpy(target), np.float32(0.0))
    assert abs(tl2.item() - float(jl2)) <= 1e-6 * float(jl2)
    # Adam's second update m̂/√v̂ amplifies the gradients' last-bit
    # differences where the two steps' gradients nearly cancel in m; given
    # vpt_tpu's gradient, the carried state drives torch.optim.Adam to
    # optax's update within 1e-6
    for got, want in ((tv2, jv2), (tt2, jt2)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= 1e-6).mean() >= 0.95 and err.max() <= 1e-4
    jgrads = jax.jit(jax.grad(lambda lv: jnp.mean((jtrain.render_eam(
        lv["volume"], lv.get("tf", jt1), mats, case["jparams"], seed, H,
        W)[..., :3] - target[..., :3]) ** 2)))(
        {k: (jv1 if k == "volume" else jt1) for k in leaves})
    updates, _ = opt.update(jgrads, jo1, {k: (jv1 if k == "volume" else jt1)
                                         for k in leaves})
    params = {k: torch.from_numpy(np.array(jv1 if k == "volume" else jt1))
              for k in leaves}
    adam = torch.optim.Adam(list(params.values()), lr=LR)
    for k, p in params.items():
        p.grad = torch.from_numpy(np.array(jgrads[k]))
        adam.state[p] = copy.deepcopy(carried.opt_state[k])
    adam.step()
    for k, p in params.items():
        want = np.asarray(optax.apply_updates(
            jv1 if k == "volume" else jt1, updates[k]))
        assert np.abs(p.numpy() - want).max() <= 1e-6
    # the step does not write the state it was given
    again = interop.fit_state_from_numpy(fields, device="cpu")
    for name, st in again.opt_state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], carried.opt_state[name][key])

    # each package's FitState round-trips through numpy
    back = interop.fit_state_to_numpy(carried)
    for key in ("volume_data", "tf_texture", "count", "step"):
        assert np.array_equal(back[key], fields[key])
    for key in ("mu", "nu"):
        assert all(np.array_equal(back[key][k], fields[key][k])
                   for k in leaves)
    port_state = train.FitState(tv2, tt2, to2, step=2)
    again = interop.fit_state_to_numpy(port_state)
    rebuilt = interop.fit_state_from_numpy(again, device="cpu")
    assert torch.equal(rebuilt.volume_data, tv2) and rebuilt.step == 2
    assert int(again["count"]) == 2
    for name in leaves:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(rebuilt.opt_state[name][key],
                               to2[name][key])


@pytest.mark.parametrize("views", [1, 3])
def test_fit_losses_match_jax(case, views):
    mats = case["views"][:views]
    targets = case["targets"][:views]
    init = np.full((10, 10, 10, 1), 0.2, np.float32)
    jv, jt, jlosses = jtrain.fit(
        targets if views > 1 else targets[0],
        mats if views > 1 else mats[0], jnp.asarray(init),
        jnp.asarray(case["tf"]), steps=3, learning_rate=0.1,
        params=case["jparams"])
    tv, tt, losses = train.fit(
        [torch.from_numpy(t) for t in targets] if views > 1
        else torch.from_numpy(targets[0]),
        [_t(m) for m in mats] if views > 1 else _t(mats[0]),
        torch.from_numpy(init), torch.from_numpy(case["tf"]), steps=3,
        learning_rate=0.1, params=case["tparams"])
    assert len(losses) == 3 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= 1e-4
    assert torch.equal(tt, torch.from_numpy(case["tf"]))
