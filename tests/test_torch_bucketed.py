"""The bucketed voxel gradient (``sampling.BucketedTable``,
``parallel.overlap``, ``parallel.halo_grad``) and the two ``sampling``
helpers ``value_gradient`` and ``mean3``, against ``vpt_tpu``.

On the CPU every kernel runs its plain version: K4's bucket instance is
``corner_scatter.corner_grad_bucket_plain``.  The inputs are made with
numpy from seeds.

- ``value_gradient`` and ``mean3`` equal vpt_tpu's within 1e-6, and the
  gradient of a ramp is the analytic one (``tests/test_sampling.py:151``);
- K4's bucket instance over ranges that cover the table equals
  ``corner_grad_plain``, and the fold of a bucket's rows is the transpose
  of ``pack_corner_volume``;
- the per-bucket gradients of ``value_and_grad_bucketed`` on
  ``tests/test_parallel.py:161-187``'s EAM loss agree with vpt_tpu's
  ``value_and_grad_bucketed`` and with the port's monolithic gradient
  within vpt_tpu's bound (5e-5);
- a recording stand-in for the group's all-reduce sees one reduction a
  bucket, bucket b's issued after b + 1 bucket scatters and before the
  (b + 2)-th, all of them before ``backward()`` returns;
- ``halo_grad.make_sharded_grad`` on a (data 2, space 2) gloo mesh
  reduces the gradient over ``data`` once a bucket: k − 1 more
  all-reduces a step with k buckets than with one, its gradient within
  ``tests/test_torch_halo_grad.py``'s bounds of vpt_tpu's replicated one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.parallel import overlap as joverlap
from vpt_tpu.renderers import eam as jeam
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, sampling, train
from vpt_tpu_torch.kernels import corner_scatter
from vpt_tpu_torch.parallel import overlap
from vpt_tpu_torch.renderers import eam

#: vpt_tpu's bound of the bucketed against the monolithic gradient
#: (``tests/test_parallel.py:186``: one scatter-add becomes four)
BUCKET_ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- sampling.value_gradient and mean3 ------------------------------------

def test_value_gradient_equals_vpt_tpu():
    rs = np.random.default_rng(11)
    vol = rs.random((12, 10, 14, 2), dtype=np.float32)
    tf = rs.random((3, 64, 4), dtype=np.float32)
    pos = rs.uniform(-0.05, 1.05, (512, 3)).astype(np.float32)
    for h in (0.01, 1.0 / 24.0):
        want = np.asarray(jsampling.value_gradient(
            jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(pos),
            jnp.float32(h)))
        got = sampling.value_gradient(_t(vol), _t(tf), _t(pos), h).numpy()
        assert got.shape == (512, 3)
        assert np.abs(got - want).max() <= 1e-6


def test_value_gradient_of_a_ramp_is_analytic():
    """alpha == x under the gray ramp: the gradient is (1, 0, 0) within
    0.05, as vpt_tpu's (``tests/test_sampling.py:151``)."""
    from vpt_tpu_torch import transfer, volume

    n = 32
    x, _, _ = volume.normalized_grid(n, n, n)
    g = sampling.value_gradient(torch.from_numpy(x[..., None]),
                                transfer.gray_ramp(device="cpu"),
                                torch.tensor([[0.5, 0.5, 0.5]]), 0.01)
    assert np.allclose(g.numpy(), [[1.0, 0.0, 0.0]], atol=0.05)


@pytest.mark.parametrize("shape", [(7, 3), (2, 5, 4)])
def test_mean3_equals_vpt_tpu(shape):
    v = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    want = np.asarray(jsampling.mean3(jnp.asarray(v)))
    got = sampling.mean3(_t(v)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


# -- K4's bucket instance and the fold -------------------------------------

def test_bucket_instance_covers_corner_grad():
    """Rows [r0, r1) of four ranges that cover a 6·5·4-cell table,
    stacked, equal ``corner_grad_plain`` bit for bit; -1 cells add
    nothing."""
    rs = np.random.default_rng(13)
    rows, c, n = 6 * 5 * 4, 2, 3000
    idx = torch.from_numpy(rs.integers(-1, rows, n))
    f = torch.from_numpy(rs.random((n, 3), dtype=np.float32))
    ct = torch.from_numpy(rs.normal(size=(n, c)).astype(np.float32))
    want = corner_scatter.corner_grad_plain(idx, f, ct, rows, c)
    cuts = [0, 20, 60, 61, rows]
    got = torch.cat([corner_scatter.corner_grad_bucket(idx, f, ct, a, b, c)
                     for a, b in zip(cuts, cuts[1:])])
    assert got.shape == (rows, 8 * c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cuts", [(0, 2, 5, 6), (0, 6), (0, 1, 2, 3, 4, 5,
                                                         6)])
def test_fold_is_the_transpose_of_the_packing(cuts):
    """Bucket by bucket in ascending z, each bucket's fold plus the carry
    of the one before equals autograd's gradient of ``pack_corner_volume``
    (a 6×5×4 volume of 2 channels, the last bucket clamped at the
    edge)."""
    rs = np.random.default_rng(14)
    vol = torch.from_numpy(rs.random((6, 5, 4, 2), dtype=np.float32))
    gt = torch.from_numpy(rs.normal(size=(6 * 5 * 4, 16)).astype(
        np.float32))
    leaf = vol.clone().requires_grad_(True)
    want, = torch.autograd.grad(
        (sampling.pack_corner_volume(leaf) * gt).sum(), leaf)
    parts, carry = [], None
    for b, (z0, z1) in enumerate(zip(cuts, cuts[1:])):
        last = b == len(cuts) - 2
        vox = sampling.fold_corner_grad(gt[z0 * 20:z1 * 20], z1 - z0, 5, 4,
                                        last)
        part = vox[:z1 - z0].clone()
        if carry is not None:
            part[0] += carry
        carry = None if last else vox[-1]
        parts.append(part)
    assert torch.allclose(torch.cat(parts), want, rtol=0, atol=1e-5)


# -- the bucketed EAM gradient against vpt_tpu and the monolithic one ------

H = W = 16
SLICES = 8
BUCKETS = 4


@pytest.fixture(scope="module")
def jscene():
    """``tests/test_parallel.py``'s scene: a 16³ sphere, the gray ramp."""
    return jmake_scene(jvolume.sphere_volume(16),
                       jtransfer.gray_ramp(alpha_scale=1.0))


@pytest.fixture(scope="module")
def jax_bucket_grads(jscene):
    """vpt_tpu's per-bucket gradients of ``tests/test_parallel.py:161-187``'s
    loss, and its monolithic one."""
    params = jeam.Params(slices=SLICES, random=False)

    def loss_of_volume(volume_data):
        sc = type(jscene)(volume=volume_data, transfer=jscene.transfer,
                          environment=jscene.environment,
                          mvp_inverse=jscene.mvp_inverse,
                          model_view=jscene.model_view,
                          projection=jscene.projection)
        img = jeam.generate(sc, params, jnp.float32(0.0), H, W)
        return jnp.sum(img[..., :3] ** 2)

    buckets = joverlap.split_volume(jscene.volume, BUCKETS)
    loss, grads = jax.jit(lambda b: joverlap.value_and_grad_bucketed(
        loss_of_volume, b))(buckets)
    whole = jax.grad(loss_of_volume)(jscene.volume)
    return float(loss), [np.asarray(g) for g in grads], np.asarray(whole)


@pytest.fixture(scope="module")
def torch_inputs(jscene):
    fields = interop.scene_fields(jscene)
    scene = interop.scene_from_numpy(fields, device="cpu")
    mats = (scene.mvp_inverse, scene.model_view, scene.projection)
    return scene.volume, scene.transfer, mats


def _loss_of_volume(tf, mats):
    params = eam.Params(slices=SLICES, random=False)

    def loss_of_volume(volume_data):
        img = train.render_eam(volume_data, tf, mats, params,
                               np.float32(0.0), H, W)
        return torch.sum(img[..., :3] ** 2)

    return loss_of_volume


@pytest.fixture(scope="module")
def port_bucket_grads(torch_inputs):
    vol, tf, mats = torch_inputs
    loss_of_volume = _loss_of_volume(tf, mats)
    loss, grads = overlap.value_and_grad_bucketed(
        loss_of_volume, overlap.split_volume(vol, BUCKETS))
    leaf = vol.clone().requires_grad_(True)
    whole, = torch.autograd.grad(loss_of_volume(leaf), leaf)
    return float(loss), [g.numpy() for g in grads], whole.numpy()


def test_bucketed_gradients_match_vpt_tpu(jax_bucket_grads,
                                          port_bucket_grads):
    jloss, jgrads, _ = jax_bucket_grads
    loss, grads, _ = port_bucket_grads
    assert abs(loss - jloss) <= 1e-6 * abs(jloss)
    assert len(grads) == BUCKETS
    assert np.abs(np.concatenate(jgrads)).max() > 1e-3
    for got, want in zip(grads, jgrads):
        assert got.shape == want.shape == (16 // BUCKETS, 16, 16, 1)
        assert np.allclose(got, want, rtol=0, atol=BUCKET_ATOL)


def test_bucketed_gradients_match_the_monolithic_gradient(
        port_bucket_grads, jax_bucket_grads):
    _, grads, whole = port_bucket_grads
    assert np.allclose(np.concatenate(grads), whole, rtol=0,
                       atol=BUCKET_ATOL)
    assert np.allclose(whole, jax_bucket_grads[2], rtol=0, atol=BUCKET_ATOL)


def test_bucketed_gradient_takes_every_route(torch_inputs, jax_bucket_grads):
    """A plain fetch of the bucketed table (``kernels=False``: its dense
    table gradient) and a read of the joined volume itself add to each
    bucket's gradient before its reduction."""
    vol, tf, mats = torch_inputs
    params = eam.Params(slices=SLICES, random=False)

    def loss_of_volume(volume_data):
        sc = dataclasses.replace(train.eam_scene(volume_data, tf, mats),
                                 kernels=False)
        img = eam.generate(sc, params, np.float32(0.0), H, W)
        return torch.sum(img[..., :3] ** 2) + 0.5 * volume_data.sum()

    _, grads = overlap.value_and_grad_bucketed(
        loss_of_volume, overlap.split_volume(vol, BUCKETS))
    want = jax_bucket_grads[2] + 0.5
    assert np.allclose(np.concatenate([g.numpy() for g in grads]), want,
                       rtol=0, atol=BUCKET_ATOL)


def test_bucketed_table_needs_its_backward(torch_inputs):
    table = sampling.BucketedTable([8, 8])
    with pytest.raises(RuntimeError, match="did not reach"):
        table.gradients()
    with pytest.raises(ValueError, match="planes"):
        table.join(overlap.split_volume(torch_inputs[0], 4))


class _Handle:
    def __init__(self, events, grad):
        self.events, self.grad = events, grad

    def wait(self):
        self.events.append(("wait", self.grad))


def test_reductions_issue_a_bucket_at_a_time(monkeypatch, torch_inputs,
                                             port_bucket_grads):
    """One reduction a bucket, in ascending z, bucket b's after b + 1
    bucket scatters and before the (b + 2)-th, all before ``backward()``
    returns and waited on after it; the stand-in doubles each gradient in
    place, and the call returns those tensors."""
    vol, tf, mats = torch_inputs
    events = []
    group = object()
    scatter = corner_scatter.corner_grad_bucket

    def recording_scatter(*args):
        events.append(("scatter", args[3]))
        return scatter(*args)

    def recording_reduce(grad, in_group):
        assert in_group is group
        events.append(("reduce", grad))
        grad.mul_(2.0)
        return _Handle(events, grad)

    backward = torch.autograd.backward

    def recording_backward(*args, **kwargs):
        backward(*args, **kwargs)
        events.append(("backward returned", None))

    monkeypatch.setattr(corner_scatter, "corner_grad_bucket",
                        recording_scatter)
    monkeypatch.setattr(overlap, "_all_reduce_async", recording_reduce)
    monkeypatch.setattr(torch.autograd, "backward", recording_backward)
    _, grads = overlap.value_and_grad_bucketed(
        _loss_of_volume(tf, mats), overlap.split_volume(vol, BUCKETS),
        group=group)
    kinds = [e[0] for e in events]
    assert kinds == ["scatter", "reduce"] * BUCKETS \
        + ["backward returned"] + ["wait"] * BUCKETS
    plane = 16 * 16
    assert [e[1] for e in events if e[0] == "scatter"] == [
        b * 4 * plane for b in range(BUCKETS)]
    reduced = [e[1] for e in events if e[0] == "reduce"]
    assert all(r is g for r, g in zip(reduced, grads))
    for got, want in zip(grads, port_bucket_grads[1]):
        assert np.allclose(got.numpy(), 2.0 * want, rtol=0, atol=1e-6)


def test_bucketed_train_step_applies_the_bucket_gradients(
        torch_inputs, port_bucket_grads):
    """One SGD step of ``bucketed_train_step``: the volume less the rate
    times the buckets' gradients, clipped to [0, 1]."""
    vol, tf, mats = torch_inputs
    step = overlap.bucketed_train_step(
        lambda p: torch.optim.SGD(p, lr=0.01), _loss_of_volume(tf, mats),
        BUCKETS)
    loss, stepped, state = step(vol, None)
    assert sorted(state) == list(range(BUCKETS))
    assert float(loss) == port_bucket_grads[0]
    want = np.clip(vol.numpy() - 0.01 * np.concatenate(
        port_bucket_grads[1]), 0.0, 1.0)
    assert np.abs(want - vol.numpy()).max() > 0
    assert np.allclose(stepped.numpy(), want, rtol=0, atol=1e-7)


# -- halo_grad with data = 2: a reduction a bucket over data ---------------

@pytest.fixture(scope="module")
def halo_jscene():
    """``tests/test_torch_halo_grad.py``'s scene."""
    return jmake_scene(jvolume.blobs_volume(16, seed=5),
                       jtransfer.gray_ramp(alpha_scale=1.0), pack=False)


@pytest.fixture(scope="module")
def data_group(halo_jscene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_halo_grad_data")
    results = ranks.spawn(ranks.halo_grad_data_everything, 4, tmp,
                          interop.scene_fields(halo_jscene))
    return results[0], results


@pytest.fixture(scope="module")
def halo_replicated(halo_jscene):
    """vpt_tpu's replicated EAM loss and gradient
    (``tests/test_halo_grad.py``'s oracle)."""
    size = ranks.GRAD_SIZE
    params = jeam.Params(slices=16, random=False, extinction=60.0)
    target = jnp.full((size, size, 3), 0.4, jnp.float32)

    def loss(voxels):
        sc = dataclasses.replace(
            halo_jscene, volume=voxels,
            volume_packed=jsampling.pack_corner_volume(voxels),
            transfer_packed=jsampling.pack_corner_texture2d(
                halo_jscene.transfer))
        img = jeam.generate(sc, params, jnp.float32(0.0), size, size)
        return jnp.mean((img[..., :3] - target) ** 2)

    value, grad = jax.value_and_grad(loss)(halo_jscene.volume)
    return float(value), np.asarray(grad)


def test_data_mesh_holds_two_rows_of_two_slabs(data_group):
    coords = sorted(r["coordinate"] for r in data_group[1])
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("num_buckets", ranks.DATA_BUCKETS)
def test_data_sharded_grad_matches_replicated(data_group, halo_replicated,
                                              num_buckets):
    """``tests/test_torch_halo_grad.py``'s bounds: the loss within 1e-6
    relative, the gradient within 1e-5 of its largest entry, the slab
    boundary plane included."""
    loss_r, ref = halo_replicated
    loss_s, joined = data_group[0][f"eam{num_buckets}"]
    assert np.isclose(loss_s, loss_r, rtol=1e-6)
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(ref[8]).max() > 0
    assert np.allclose(joined, ref, atol=1e-5 * scale)


def test_data_reductions_one_a_bucket(data_group):
    """With k buckets a step issues k − 1 more all-reduces than with one:
    k reductions of the gradient over data in place of one; the forward's
    sums over space (a fetch of 8 slices each, 2 for 16 slices) and the
    loss's reduction stay; one all-gather of the halo planes.  Every rank
    counts alike."""
    rank0, every = data_group
    fetch_sums, loss_sum = 2, 1
    for nb in ranks.DATA_BUCKETS:
        got = rank0[f"collectives{nb}"]
        assert got == {"all_reduce": fetch_sums + loss_sum + nb,
                       "all_gather": 1}, (nb, got)
    assert all(r["collectives4"] == rank0["collectives4"] for r in every)
