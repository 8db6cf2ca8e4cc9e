"""The port's ``parallel/halo_grad.py`` against ``vpt_tpu``'s replicated
gradient (``tests/test_halo_grad.py``'s oracles), on one 4-rank ``gloo``
group per module (``torch_parallel_ranks.halo_grad_everything``, ``space``
= 4, a 16³ volume in slabs of 4 planes):

- the EAM sharded gradient, 1 and 2 buckets, against ``jax.value_and_grad``
  of vpt_tpu's replicated loss: the loss within 1e-6 relative, the
  gradient within 1e-5 of its largest entry, interior slab-boundary planes
  included (the halo-plane gradient lands on its owner);
- the MCM gradient invariant under 1, 2 and 4 buckets;
- ``rehalo`` equal to ``shard_volume_with_halo``;
- a sharded EAM fit checkpointed after 3 of 6 steps and resumed, bit for
  bit, its loss descending; the config-4 recipe at vpt_tpu's reduced
  default, whose closing assertion fails as vpt_tpu's does.
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
from vpt_tpu.parallel.halo import shard_volume_with_halo as jshard
from vpt_tpu.renderers import eam as jeam
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop

NUM_SLABS = 4
H = ranks.GRAD_SIZE


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jscene():
    return jmake_scene(jvolume.blobs_volume(16, seed=5),
                       jtransfer.gray_ramp(alpha_scale=1.0), pack=False)


@pytest.fixture(scope="module")
def group(jscene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_halo_grad")
    results = ranks.spawn(ranks.halo_grad_everything, NUM_SLABS, tmp,
                          interop.scene_fields(jscene), str(tmp / "ckpt"))
    return results[0], results


@pytest.fixture(scope="module")
def replicated(jscene):
    """vpt_tpu's replicated EAM loss and volume gradient
    (``tests/test_halo_grad.py``)."""
    params = jeam.Params(slices=16, random=False, extinction=60.0)
    target = jnp.full((H, H, 3), 0.4, jnp.float32)

    def loss(voxels):
        sc = dataclasses.replace(
            jscene, volume=voxels,
            volume_packed=jsampling.pack_corner_volume(voxels),
            transfer_packed=jsampling.pack_corner_texture2d(jscene.transfer))
        img = jeam.generate(sc, params, jnp.float32(0.0), H, H)
        return jnp.mean((img[..., :3] - target) ** 2)

    value, grad = jax.value_and_grad(loss)(jscene.volume)
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("num_buckets", [1, 2])
def test_eam_sharded_grad_matches_replicated(group, replicated,
                                             num_buckets):
    loss_r, ref = replicated
    loss_s, joined = group[0][f"eam{num_buckets}"]
    assert np.isclose(loss_s, loss_r, rtol=1e-6)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.allclose(joined, ref, atol=1e-5 * scale)
    ds = 16 // NUM_SLABS
    for k in range(1, NUM_SLABS):
        assert np.abs(ref[k * ds]).max() > 0
        assert np.allclose(joined[k * ds], ref[k * ds], atol=1e-5 * scale)
    # one all-gather of the halo planes a step, and a sum a fetch
    got = group[0][f"eam{num_buckets}_collectives"]
    assert got["all_gather"] == 1 and got["all_reduce"] > 0


def test_mcm_sharded_grad_bucket_invariance(group):
    """Buckets only regroup the leaves: the paths and the gradient are
    the same for 1, 2 and 4 buckets; the gradient is finite and not 0."""
    l0, g0 = group[0]["mcm1"]
    assert np.isfinite(l0) and np.isfinite(g0).all()
    assert g0.shape == (16, 16, 16, 1) and np.abs(g0).max() > 0
    for nb in (2, 4):
        loss, g = group[0][f"mcm{nb}"]
        assert loss == l0
        assert np.allclose(g, g0, rtol=0, atol=1e-7)


def test_rehalo_matches_shard_volume_with_halo(group, jscene):
    want = np.asarray(jshard(jscene.volume, NUM_SLABS))
    assert np.array_equal(group[0]["rehalo"], want)


def test_sharded_fit_checkpoint_resume_bit_identical(group):
    """Each rank's slab state saved after 3 steps and loaded resumes to
    the uninterrupted 6-step body bit for bit; the EAM loss descends."""
    rank0, every = group
    assert all(r["resume_equal"] for r in every)
    assert rank0["ckpt"] == ("eam-fit", 3, 16)
    start, end = rank0["fit_losses"]
    assert end < start
    assert np.abs(rank0["fit_body"]).max() > 0


def test_config4_recipe_mirrors_vpt_tpu(group):
    """The config-4 recipe on 4 ranks (4 slabs) at vpt_tpu's reduced
    default (64³, 128², 32 spp, 4 fit steps, 4 buckets): the forward
    reaches its samples with one sum an event and a fit step issues a sum
    a fetch and two all-gathers (the halo planes' gradient, ``rehalo``).
    Its
    closing check mirrors vpt_tpu's: ``examples/config4_pod512.py`` on 8
    CPU devices ends ``fit: loss 0.051562 -> 0.051562`` and fails its own
    ``assert losses[-1] < losses[0]`` (at a fixed seed the MC estimator's
    value is stepwise constant in the voxels, as
    ``tests/test_halo_grad.py:150-153`` says; ROADMAP queue 3), and so
    does the port's, at the same losses to 5 digits."""
    lines = group[0]["config4"]
    assert "mesh: {'data': 1, 'space': 4}  (slabs=4)" in lines
    assert "forward-frame collectives: {'all_reduce': 8}" in lines
    # a sum a fetch of 2 frames × 8 events; the halo planes' gradient and
    # rehalo's first planes, one all-gather each
    assert "grad-step collectives (4 buckets): {'all_gather': 2, " \
           "'all_reduce': 16}" in lines
    fit = [x for x in lines if x.startswith("fit: loss ")]
    assert fit and fit[0].startswith("fit: loss 0.05156")
    first, last = (float(v) for v in fit[0].split()[2:5:2])
    assert abs(first - 0.051562) <= 5e-6 and abs(last - 0.051562) <= 5e-6
    assert group[0]["config4_raised"] == "loss must descend"
