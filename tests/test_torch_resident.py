"""The port's ``parallel/resident.py`` against ``vpt_tpu``'s: slab
ownership, the cyclic slabs, the reset's distribution, and the resident
frames.

One 4-rank ``gloo`` group per module (``torch_parallel_ranks.
resident_everything``) renders every resident frame at 16² over 2 frames
of 8 events (``tests/test_resident.py``'s sizes).  The stall-free frames
(mesh (data 1, space 4) and (2, 2), packed and unpacked, cheb-skip,
interleave 2 and 4) equal the port's replicated frames bit for bit and
``vpt_tpu``'s replicated frames in ≥ 99.99% of the pixels' samples, their
radiance and position within 1e-6 (``tests/test_torch_halo.py``'s bounds).
The frames that stall (fanout 2, half the capacity, the amortized mode,
the mutual-full pools) start from ``vpt_tpu``'s reset pool and are held to
``vpt_tpu``'s resident machine on a 4-device mesh of the same shape:
counters and placement equal, the assembled states within those bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.parallel import make_mesh as jmake_mesh
from vpt_tpu.parallel import resident as jresident
from vpt_tpu.parallel.halo import HaloScene as JHaloScene
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import interop
from vpt_tpu_torch.kernels import corner_gather
from vpt_tpu_torch.parallel import resident
from vpt_tpu_torch.renderers import mcm

H = ranks.RESIDENT_SIZE
FRAMES = ranks.RESIDENT_FRAMES
STALL_FREE = {case[0]: case for case in ranks.RESIDENT_STALL_FREE}
JAX_CASES = {case[0]: case for case in ranks.RESIDENT_JAX}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads only spin against the
    other workers of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jscenes():
    """vpt_tpu's scenes (``tests/test_resident.py``'s): a 16³ blobs volume
    with float32 corner tables, unpacked, and with the cheb-skip table
    (its TF floor exactly empty)."""
    vol = jvolume.blobs_volume(16, seed=5)
    tf = np.asarray(jtransfer.gray_ramp(alpha_scale=1.0)).copy()
    cheb_tf = tf.copy()
    cheb_tf[:, :8, 3] = 0.0
    return {"f32": jmake_scene(vol, jnp.asarray(tf)),
            "unpacked": jmake_scene(vol, jnp.asarray(tf), pack=False),
            "cheb": jmake_scene(vol, jnp.asarray(cheb_tf), tracking="cheb")}


@pytest.fixture(scope="module")
def fields(jscenes):
    return {k: interop.scene_fields(v) for k, v in jscenes.items()}


@pytest.fixture(scope="module")
def scenes(fields):
    return {k: interop.scene_from_numpy(v, device="cpu")
            for k, v in fields.items()}


def _jax_mesh():
    return jmake_mesh(4, space=4)


@pytest.fixture(scope="module")
def jax_runs(jscenes):
    """vpt_tpu's resident machine for each case of ``RESIDENT_JAX`` on a
    (1, 4) mesh: its reset pool (numpy) and its pool after the frames."""
    params = jmcm.Params(**ranks.RESIDENT_PARAMS)
    mesh = _jax_mesh()
    out = {}
    for name, fanout, capacity, m, every in ranks.RESIDENT_JAX:
        pool = jresident.resident_reset(jscenes["f32"], params, H, H, mesh,
                                        num_slabs=4, capacity=capacity,
                                        interleave=m)
        start = {k: np.asarray(v) for k, v in pool.items()}
        frame_fn, tables = jresident.resident_render_frame(
            mesh, jscenes["f32"], 4, H, H, fanout=fanout, interleave=m,
            migrate_every=every)
        for n in range(1, FRAMES + 1):
            pool = frame_fn(pool, tables, params, jnp.float32(0.1 * n),
                            jnp.int32(n))
        out[name] = {"start": start,
                     "pool": {k: np.asarray(v) for k, v in pool.items()}}
    return out


@pytest.fixture(scope="module")
def group(fields, jax_runs, tmp_path_factory):
    """Every rank's results of the one 4-rank group."""
    tmp = tmp_path_factory.mktemp("gloo_resident")
    pools = {k: v["start"] for k, v in jax_runs.items()}
    return ranks.spawn(ranks.resident_everything, 4, tmp, fields, pools)


def _port_replicated(scene, frames=FRAMES):
    params = mcm.Params(**ranks.RESIDENT_PARAMS)
    state = mcm.reset(params, H, H, scene)
    for n in range(1, frames + 1):
        mcm.render_frame(state, scene, params, np.float32(0.1 * n), n)
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_replicated(jscenes):
    params = jmcm.Params(**ranks.RESIDENT_PARAMS)
    out = {}
    for kind, scene in jscenes.items():
        state = jmcm.reset(params, H, H, scene)
        for n in range(1, FRAMES + 1):
            state = jmcm.render_frame(state, scene, params,
                                      jnp.float32(0.1 * n), jnp.int32(n))
        out[kind] = {k: np.asarray(v) for k, v in state.items()}
    return out


def _assert_close_to(got, want, share=0.9999):
    """≥ ``share`` of the pixels' samples equal, radiance and position
    within 1e-6 where they are (``tests/test_torch_halo.py``'s bounds)."""
    match = got["samples"] == want["samples"]
    assert match.mean() >= share, match.mean()
    for k in ("radiance", "position"):
        assert np.allclose(got[k][match], want[k][match], rtol=0,
                           atol=1e-6), k


@pytest.mark.parametrize("name", sorted(STALL_FREE))
def test_stall_free_frames_equal_the_replicated_frames(group, scenes,
                                                       jax_replicated,
                                                       name):
    """The assembled state equals the port's replicated frames bit for
    bit and ``vpt_tpu``'s within the halo bounds; nothing stalls or
    drops, and photons did migrate."""
    _, kind, data, space, _ = STALL_FREE[name]
    got = group[0][name]["state"]
    want = _port_replicated(scenes[kind])
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    counters = [r[name]["counters"] for r in group]
    assert sum(c["stalled"] for c in counters) == 0
    assert sum(c["dropped"] for c in counters) == 0
    assert sum(c["migrated"] for c in counters) > 0
    assert got["samples"].mean() > 0.5
    _assert_close_to(got, jax_replicated[kind])


def test_thin_slabs_migrate_more(group):
    """Interleaved thin slabs cross more boundaries than contiguous ones
    (``tests/test_resident.py``'s check)."""
    def moved(name):
        return sum(r[name]["counters"]["migrated"] for r in group)

    assert moved("interleave4") > moved("interleave2") > moved("d1s4")


def test_one_exact_frame_issues_two_gathers_and_one_exchange_an_event(
        group):
    """8 events on 4 slabs: two all_gathers (demands, free slots) and one
    all_to_all of the granted rows an event; 2 slabs alike."""
    for name in ("d1s4", "d2s2"):
        assert group[0][name]["collectives"] == {"all_gather": 16,
                                                 "all_to_all": 8}


def _joined(group, name):
    """The port's pool blocks of one case as vpt_tpu's global pool."""
    blocks = [[None] * 4]
    for r in group:
        d, s = r[name]["index"]
        blocks[d][s] = {k: torch.from_numpy(v)
                        for k, v in r[name]["pool"].items()}
    return interop.resident_pool_to_numpy(blocks)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_frames_that_stall_match_vpt_tpu_resident(group, jax_runs, name):
    """From vpt_tpu's reset pool, the port's frames give every rank the
    counters and the slot placement (``pixel_id``, ``occupied``,
    ``pending``) of vpt_tpu's resident machine, one photon a pixel, and
    an assembled state within the halo bounds of vpt_tpu's."""
    got = _joined(group, name)
    want = jax_runs[name]["pool"]
    for k in ("migrated", "stalled", "dropped", "pixel_id", "occupied",
              "pending"):
        assert np.array_equal(got[k], want[k]), k
    occ = got["occupied"]
    assert occ.sum() == H * H
    assert sorted(got["pixel_id"][occ].tolist()) == list(range(H * H))
    assert int(got["dropped"].sum()) == 0
    stalled = int(got["stalled"].sum())
    assert stalled > 0 or name == "amortized"
    state = {k: v.numpy() for k, v in resident.assemble(
        [interop.resident_pool_from_numpy(got, 0, s, device="cpu")
         for s in range(4)], H, H).items()}
    wstate = {k: np.asarray(v) for k, v in jresident.assemble(
        {k: jnp.asarray(v) for k, v in want.items()}, H, H).items()}
    _assert_close_to(state, wstate)


def test_mutual_full_pools_stall_every_crosser_in_both_packages(group,
                                                                jax_runs):
    """capacity = group / S (the smallest the reset takes): every pool is
    full, the free slots are counted before departures vacate theirs, so
    no rank grants another anything and every crosser stalls, every event
    (``vpt_tpu/parallel/resident.py:171``, mirrored: ROADMAP queue 3)."""
    got = _joined(group, "mutual_full")
    want = jax_runs["mutual_full"]["pool"]
    for pool in (got, want):
        assert int(pool["migrated"].sum()) == 0
        assert int(pool["stalled"].sum()) > 0
        assert pool["occupied"].all()


def test_amortized_mode_refuses_steps_it_does_not_divide(group):
    assert all("not divisible by migrate_every=3" in r["not_divisible"]
               for r in group)


@pytest.mark.parametrize("every", [1, 4])
def test_one_slab_frames_are_event_exact(group, scenes, every):
    """One slab a data group (mesh (4, 1)): the exact and the amortized
    mode (``migrate_every`` 4 parks nothing) equal the replicated frames
    bit for bit (``tests/test_resident.py``'s check)."""
    want = _port_replicated(scenes["f32"])
    got = group[0][f"space1_every{every}"]
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_reset_distribution_matches_vpt_tpu(jscenes, scenes, jax_runs):
    """The port's whole reset pool places every photon where vpt_tpu's
    does (``pixel_id``, ``occupied``), the spill included, with the same
    rows (float fields within 1e-6, NDC and flags equal)."""
    params = mcm.Params(**ranks.RESIDENT_PARAMS)
    for name, _, capacity, m, _ in ranks.RESIDENT_JAX:
        got = resident.reset_pool(scenes["f32"], params, H, H, 1, 4,
                                  capacity, interleave=m)
        want = jax_runs[name]["start"]
        for k in ("pixel_id", "occupied", "pending", "ndc", "samples",
                  "bounces"):
            assert np.array_equal(got[k], want[k]), (name, k)
        for k in ("position", "direction", "transmittance", "radiance"):
            assert np.allclose(got[k], want[k], rtol=0, atol=1e-6), (name, k)


def test_reset_refusals_match_vpt_tpu(scenes):
    """The reset's ``ValueError``s (``vpt_tpu/parallel/resident.py:
    239-247``) and the majorant grid's (``:328-333``)."""
    params = mcm.Params()
    with pytest.raises(ValueError, match="cannot hold"):
        resident.reset_pool(scenes["f32"], params, 16, 16, 1, 4,
                            capacity=16)
    with pytest.raises(ValueError, match="not divisible by data=2"):
        resident.reset_pool(scenes["f32"], params, 15, 15, 2, 4)
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    grid = make_scene(volume.blobs_volume(16, seed=5, device="cpu"),
                      transfer.gray_ramp(device="cpu"), tracking="grid",
                      device="cpu")
    assert grid.majorant is not None
    with pytest.raises(ValueError, match="majorant-grid"):
        resident.resident_render_frame(None, grid, 4, 16, 16)


@pytest.mark.parametrize("num_slabs,interleave",
                         [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2), (4, 4)])
def test_slab_owner_matches_slab_cells_and_vpt_tpu(num_slabs, interleave):
    """The owner of a position is the slab whose fetch calls it local
    (``corner_gather.slab_cells``), and ``vpt_tpu``'s owner."""
    p = np.random.default_rng(0).uniform(-0.2, 1.2, (4000, 3)) \
        .astype(np.float32)
    pos = torch.from_numpy(p)
    owner = resident.slab_owner(pos, 16, num_slabs, interleave)
    for k in range(num_slabs):
        local = corner_gather.slab_cells(pos, (16, 16, 16, 1), k, num_slabs,
                                         interleave)[-1]
        assert torch.equal(local, owner == k)
    want = np.asarray(jresident.slab_owner(jnp.asarray(p), 16, num_slabs,
                                           interleave))
    assert np.array_equal(owner.numpy(), want)
    if interleave == 1:
        jh = JHaloScene(jnp.zeros((16 // num_slabs + 1, 16, 16, 1)), 0,
                        num_slabs, (16, 16, 16, 1), None, None, None, None,
                        None)
        assert np.array_equal(owner.numpy() == 0,
                              np.asarray(jh._cell_coords(jnp.asarray(p))[-1]))


@pytest.mark.parametrize("num_slabs,interleave", [(2, 2), (4, 2), (2, 4)])
def test_shard_volume_cyclic_matches_vpt_tpu(jscenes, scenes, num_slabs,
                                             interleave):
    got = resident.shard_volume_cyclic(scenes["f32"].volume, num_slabs,
                                       interleave)
    want = np.asarray(jresident.shard_volume_cyclic(
        jscenes["f32"].volume, num_slabs, interleave))
    assert np.array_equal(got.numpy(), want)


def test_pool_crosses_between_packages_bit_for_bit(jax_runs):
    """``interop.resident_pool_from_numpy`` / ``resident_pool_to_numpy``
    carry vpt_tpu's pool to each rank's block and back unchanged."""
    want = jax_runs["fanout2"]["pool"]
    blocks = [[interop.resident_pool_from_numpy(want, 0, s, device="cpu")
               for s in range(4)]]
    assert blocks[0][1]["rstate"].dtype == torch.int64
    assert blocks[0][1]["migrated"].shape == ()
    back = interop.resident_pool_to_numpy(blocks)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == want[k].dtype, k
        assert np.array_equal(back[k], want[k]), k


def test_jax_runs_on_its_own_mesh_shape():
    """The oracle's mesh is the port's (1, 4) group's shape."""
    mesh = _jax_mesh()
    assert dict(mesh.shape) == {"data": 1, "space": 4}
    assert len(jax.devices()) >= 4
