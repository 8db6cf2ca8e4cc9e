"""The port's data-parallel half of ``parallel/`` on a 4-rank ``gloo``
group, against the single-process port and ``vpt_tpu``'s 8-way sharding
on the conftest's virtual CPU devices.

One group per module (``torch_parallel_ranks.everything``, ~15 s) renders
every case; the tests read what rank 0 gathered:

- each renderer's frame, its rows split over 4 ranks through the row
  window (``render_frame(..., window=)``) and assembled, equals the
  single-process frame bit for bit (``tests/test_parallel.py``'s
  invariance), and agrees with ``vpt_tpu``'s 8-way ``shard_render_frame``
  within the port's frame tolerances;
- the volume z-sharded over ``space`` renders the replicated image, and
  the data-parallel EAM gradient (reduce-scattered into the slabs, or
  all-reduced) and the bucketed gradient (all-reduced from the grad
  hooks) equal the single-process gradient;
- a sharded checkpoint saved from 4 ranks loads on 2 and on 1.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.parallel import make_mesh as jmake_mesh
from vpt_tpu.parallel import sharded_scene as jsharded_scene
from vpt_tpu.parallel.shard import place_state as jplace_state
from vpt_tpu.parallel.shard import shard_render_frame as jshard_render_frame
from vpt_tpu.renderers import factory as jfactory
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop, sampling, train
from vpt_tpu_torch.parallel import distributed, mesh, overlap, shard
from vpt_tpu_torch.renderers import dos, factory
from vpt_tpu_torch.runtime import checkpoint

CASES = {case[0]: case for case in ranks.cases()}


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
def jscenes():
    """vpt_tpu's scenes (a 16³ sphere, float32 tables; the cheb-skip one
    with an exactly empty TF floor)."""
    tf = np.asarray(jtransfer.gray_ramp(alpha_scale=1.0)).copy()
    plain = jmake_scene(jvolume.sphere_volume(16), jnp.asarray(tf))
    tf[:, :8, 3] = 0.0
    cheb = jmake_scene(jvolume.sphere_volume(16), jnp.asarray(tf),
                       tracking="cheb")
    return {"plain": plain, "cheb": cheb}


@pytest.fixture(scope="module")
def fields(jscenes):
    return {k: interop.scene_fields(v) for k, v in jscenes.items()}


@pytest.fixture(scope="module")
def scenes(fields):
    return {k: interop.scene_from_numpy(v, device="cpu")
            for k, v in fields.items()}


@pytest.fixture(scope="module")
def group(fields, tmp_path_factory):
    """Rank 0's results of the one 4-rank group, and every rank's."""
    tmp = tmp_path_factory.mktemp("gloo")
    results = ranks.spawn(ranks.everything, 4, tmp, fields,
                          str(tmp / "ckpt"))
    return results[0], results


def _single(name, scenes):
    _, key, kwargs, kind, height = CASES[name]
    module = factory.get_module(key)
    state = ranks.render_case(module, module.Params(**kwargs), scenes[kind],
                              height, ranks.SIZE)
    return interop.state_to_numpy(state) if isinstance(state, dict) \
        else state.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_gloo_frame_equals_the_single_process_frame(group, scenes, name):
    got, want = group[0][name], _single(name, scenes)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    else:
        assert np.array_equal(got, want)


def _jax_sharded(name, jscenes):
    """vpt_tpu's frame of the case, rows over 8 virtual devices."""
    _, key, kwargs, kind, height = CASES[name]
    module = jfactory.get_module(key)
    params = module.Params(**kwargs)
    jmesh = jmake_mesh(8, space=1, axes=("data",))
    sc = jsharded_scene(jscenes[kind], jmesh)
    state = jplace_state(module.reset(params, height, ranks.SIZE, sc), jmesh)
    frame = jshard_render_frame(module, jmesh, state, donate=False)
    out = frame(state, sc, params, jnp.float32(0.3), jnp.int32(1))
    return {k: np.asarray(v) for k, v in out.items()} \
        if isinstance(out, dict) else np.asarray(out)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n != "mcm_uneven"))
def test_gloo_frame_agrees_with_vpt_tpu_sharded(group, jscenes, name):
    """The port's frame tolerances against vpt_tpu (32², float32 tables):
    MCM ≥ 97% of the pixels with equal samples and their radiance and
    position within 1e-5 (``test_torch_mcm.py``); EAM, MIP, Depth, ISO
    every value within 1e-6 (``test_torch_march.py``); MCS ≥ 99% of the
    pixels within 1e-6 and the means within 1e-4 (``test_torch_mcs.py``);
    LAO, against a jitted frame, 93% of the pixels within 2e-5 and all
    within 2e-3 (``test_torch_lao.py``'s golden: jitted NDCs hash some
    pixels to another ``rx``)."""
    got, want = group[0][name], _jax_sharded(name, jscenes)
    key = CASES[name][1]
    if key == "mcm":
        match = got["samples"] == want["samples"]
        assert match.mean() >= 0.97, match.mean()
        assert want["samples"].mean() > 0.5
        for k in ("radiance", "position"):
            assert np.allclose(got[k][match], want[k][match], rtol=0,
                               atol=1e-5), k
    elif key == "mcs":
        close = (np.abs(got - want) <= 1e-6).all(-1)
        assert close.mean() >= 0.99, close.mean()
        assert abs(float(got.mean()) - float(want.mean())) <= 1e-4
    elif key == "lao":
        diff = np.abs(got - want).max(-1)
        assert (diff <= 2e-5).mean() >= 0.93, (diff <= 2e-5).mean()
        assert diff.max() <= 2e-3, diff.max()
    else:
        assert np.abs(got - want).max() <= 1e-6


def test_ranks_hold_their_mesh_coordinates(group):
    assert [r["coordinate"] for r in group[1]] == [(0,), (1,), (2,), (3,)]


def test_space_sharded_volume_renders_the_replicated_image(group, scenes):
    """``shard_volume=True`` on a (2, 2) mesh: each rank keeps 8 of the 16
    z slices between frames, and the frame equals the replicated one
    within 1e-6 (measured: bit for bit)."""
    from vpt_tpu_torch.renderers import eam

    params = eam.Params(slices=16, random=False)
    want = ranks.render_case(eam, params, scenes["plain"], ranks.SIZE,
                             ranks.SIZE, seed=0.0).numpy()
    assert group[0]["slab_depth"] == 8
    assert np.abs(group[0]["eam_space"] - want).max() <= 1e-6


@pytest.fixture(scope="module")
def single_grad(fields):
    """The single-process EAM fit's loss and volume gradient."""
    vol, tf, mats, target, params = ranks.eam_setup(fields["plain"])
    leaf = vol.clone().requires_grad_(True)
    loss = train.mse_rgb(train.render_eam(leaf, tf, mats, params,
                                          np.float32(0.0), 16, 16), target)
    grad, = torch.autograd.grad(loss, leaf)
    return float(loss.detach()), grad.numpy()


@pytest.mark.parametrize("which", ["space_grad", "data_grad"])
def test_data_parallel_gradient_matches_single_process(group, single_grad,
                                                       which):
    """The rows over 4 ranks: the z slabs' reduce-scattered gradient
    (``space_grad``, a (2, 2) mesh) and the all-reduced whole gradient
    (``data_grad``) equal the single-process gradient within 1e-5
    (``tests/test_parallel.py``'s bound; measured: bit for bit)."""
    loss, grad = single_grad
    assert np.abs(grad).max() > 1e-4
    assert np.allclose(group[0][which], grad, rtol=0, atol=1e-5)
    assert abs(group[0]["space_loss"] - loss) <= 1e-6


def test_data_parallel_train_step_lowers_the_loss(group, single_grad):
    first, second = group[0]["train_losses"]
    assert abs(first - single_grad[0]) <= 1e-6
    assert second < first


def test_bucketed_gradients_match_monolithic(group, single_grad, fields):
    """Per-bucket leaves: their gradients all-reduced from the grad hooks
    over 4 ranks, and one process's own, equal the monolithic gradient
    (within 1e-5 and 5e-5, ``tests/test_parallel.py``'s bounds)."""
    _, grad = single_grad
    assert np.allclose(group[0]["bucket_grad"], grad, rtol=0, atol=1e-5)
    vol, tf, mats, target, params = ranks.eam_setup(fields["plain"])

    def loss_of_volume(volume_data):
        return train.mse_rgb(train.render_eam(
            volume_data, tf, mats, params, np.float32(0.0), 16, 16), target)

    _, grads = overlap.value_and_grad_bucketed(
        loss_of_volume, overlap.split_volume(vol, 4))
    assert len(grads) == 4 and grads[0].shape == (4, 16, 16, 1)
    assert np.allclose(overlap.join_volume(grads).numpy(), grad, rtol=0,
                       atol=5e-5)


def test_bucketed_train_step_lowers_the_loss(group):
    first, second = group[0]["bucket_losses"]
    assert second < first


def test_sharded_checkpoint_from_four_ranks_loads_on_two_and_one(group,
                                                                 scenes):
    """A 30-row MCM state saved by 4 ranks (blocks of 8, 8, 8, 6 rows)
    loads on 2 ranks (15 rows each) and on one process, equal bit for bit,
    with vpt_tpu's metadata; the saved state is the single process's."""
    r0 = group[0]
    assert set(r0["loaded_rows"].values()) == {15}
    key, frame_number, extra, params = r0["loaded2_meta"]
    assert (key, frame_number, extra) == ("mcm", 7, {"seed0": 3})
    assert params["extinction"] == 20.0 and params["steps"] == 8
    want = _single("mcm_uneven", scenes)
    for k in want:
        assert np.array_equal(r0["saved"][k], want[k]), k
        assert np.array_equal(r0["loaded2"][k], want[k]), k
        assert np.array_equal(r0["loaded1"][k], want[k]), k


def test_sharded_checkpoint_of_one_process(tmp_path, scenes):
    """Without a mesh: a whole state (an EAM accumulator) written and read
    by one process, no process group."""
    from vpt_tpu_torch.renderers import eam

    params = eam.Params(slices=8)
    state = ranks.render_case(eam, params, scenes["plain"], 12, 10)
    checkpoint.save_sharded(tmp_path / "c", "eam", state, 3, params)
    key, got, frame_number, meta = checkpoint.load_sharded(tmp_path / "c",
                                                           device="cpu")
    assert (key, frame_number, meta["rows"]) == ("eam", 3, ["state"])
    assert torch.equal(got, state)


@dataclasses.dataclass(frozen=True)
class FakeRank:
    node: int
    local_rank: int


def test_device_grid_orders_by_node_and_warns():
    """vpt_tpu's topology test with rank descriptors: space rows within a
    node, a node's data rows contiguous, local ranks in order; a warning
    where space does not divide a node's rank count."""
    ranks_in = [FakeRank(p, i) for i in range(4) for p in (1, 0)]
    grid = mesh.device_grid(ranks_in, space=2)
    assert grid.shape == (4, 2)
    for row in grid:
        assert len({r.node for r in row}) == 1
    assert [row[0].node for row in grid] == [0, 0, 1, 1]
    assert [r.local_rank for r in grid[0]] == [0, 1]
    assert [r.local_rank for r in grid[1]] == [2, 3]
    three = [FakeRank(0, 0), FakeRank(0, 1), FakeRank(0, 2),
             FakeRank(1, 0), FakeRank(1, 1), FakeRank(1, 2)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert mesh.device_grid(three, space=2).shape == (3, 2)
    assert any("per-node" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="divisible"):
        mesh.device_grid(three, space=4)


class FakeMesh:
    """What the placements read of a DeviceMesh: names, sizes and this
    rank's coordinates."""

    def __init__(self, names, sizes, coordinate):
        self.mesh_dim_names, self._sizes = names, sizes
        self._coordinate = coordinate

    def size(self, dim):
        return self._sizes[dim]

    def get_coordinate(self):
        return self._coordinate


def test_placements_and_row_blocks():
    grid = FakeMesh(("data", "space"), (3, 2), (2, 1))
    assert mesh.pixel_sharding(grid).spec == ("data", None, None)
    assert mesh.replicated(grid).spec == ()
    assert shard.volume_sharding(grid).spec == ("space", None, None, None)
    assert mesh.pixel_sharding(grid).local_slice((10, 4)) == slice(8, 10)
    assert shard.volume_sharding(grid).local_slice((16,)) == slice(8, 16)
    assert mesh.replicated(grid).local_slice((5,)) == slice(None)
    assert mesh.block_of(10, grid) == (8, 10)
    assert mesh.block_of(12, grid, ("data", "space")) == (10, 12)
    assert [mesh.block(30, 4, i) for i in range(4)] == [
        (0, 8), (8, 16), (16, 24), (24, 30)]
    assert mesh.block(2, 4, 3) == (2, 2)
    state = {"samples": torch.arange(20.0).reshape(10, 2),
             "depth": torch.tensor(1.0)}
    placed = shard.place_state(state, grid)
    assert torch.equal(placed["samples"], state["samples"][8:])
    assert placed["depth"] is state["depth"]


@pytest.mark.parametrize("key", ["mcm", "eam", "mip", "depth", "iso", "mcs",
                                 "lao"])
def test_window_bands_equal_the_whole_frame(scenes, key):
    """The plain frame of 13 rows as three bands (4, 7 and 2 rows): each
    band's frame with its window stacks into the whole frame bit for bit."""
    module = factory.get_module(key)
    params = module.Params(**[c[2] for c in CASES.values()
                              if c[1] == key][0])
    whole = ranks.render_case(module, params, scenes["plain"], 13, 9)
    parts = []
    for r0, r1 in ((0, 4), (4, 11), (11, 13)):
        extra = {"window": (r0, 13)} if key == "mcm" else {}
        state = module.reset(params, r1 - r0, 9, scenes["plain"], **extra)
        parts.append(module.render_frame(state, scenes["plain"], params,
                                         np.float32(0.3), 1,
                                         window=(r0, 13)))
    if isinstance(whole, dict):
        for k in whole:
            assert torch.equal(torch.cat([p[k] for p in parts]), whole[k])
    else:
        assert torch.equal(torch.cat(parts), whole)


def test_window_rows_must_lie_in_the_image():
    assert sampling.row_window(None, 5) == (0, 5)
    with pytest.raises(ValueError, match="do not lie"):
        sampling.pixel_ndc(5, 4, window=(8, 12))
    with pytest.raises(ValueError, match="do not lie"):
        sampling.row_window((-1, 12), 5)


def test_dos_window_still_raises(scenes):
    """A DOS band of rows needs its neighbours' occlusion every slice,
    which one frame call cannot reach: a window other than the whole
    image raises, naming the sharded frames (``dos_halo`` and
    ``shard_render_frame`` render bands, ``tests/test_torch_dos_halo.py``);
    the whole image renders."""
    params = dos.Params(steps=4, slices=8)
    state = dos.reset(params, 8, 8, scenes["plain"])
    with pytest.raises(ValueError, match="shard.shard_render_frame"):
        dos.render_frame(state, scenes["plain"], params, 0.0, 1,
                         window=(0, 16))
    dos.render_frame(state, scenes["plain"], params, 0.0, 1, window=(0, 8))


def test_initialize_without_a_coordinator_is_one_process(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert "1 global" in distributed.topology_summary()
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.make_mesh(1, device="cpu")

