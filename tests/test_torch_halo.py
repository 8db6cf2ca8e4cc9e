"""The port's ``parallel/halo.py`` against ``vpt_tpu``'s: the slab
layout, the ownership-masked samplers and the halo frames.

One 2-rank ``gloo`` group per module (``torch_parallel_ranks.
halo_everything``, ``space`` = 2) renders every halo frame; the tests
hold what rank 0 gathered against the port's replicated frames (bit for
bit) and ``vpt_tpu``'s replicated frames (``tests/test_halo.py``'s
bounds): MCM on bf16 and float32 tables, cheb-skip and exact flights, at
16²; EAM, MIP, ISO and Depth (the plain twins over the HaloScene) within
2e-6.  The sampler checks sum each slab's masked partial in one process
(no group), contiguous and interleaved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vpt_tpu import sampling as jsampling
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.parallel.halo import shard_volume_with_halo as jshard
from vpt_tpu.renderers import factory as jfactory
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu.renderers import mcm as jmcm
from vpt_tpu_torch import interop, sampling
from vpt_tpu_torch.kernels import corner_gather
from vpt_tpu_torch.parallel import halo
from vpt_tpu_torch.renderers import factory, mcm

H = ranks.HALO_SIZE
MCM_CASES = {case[0]: case for case in ranks.HALO_MCM}


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
    """vpt_tpu's scenes: a 16³ blobs volume (``tests/test_halo.py``'s),
    float32 and bf16 tables, with and without the cheb-skip table (its TF
    floor exactly empty), and unpacked."""
    vol = jvolume.blobs_volume(16, seed=5)
    tf = np.asarray(jtransfer.gray_ramp(alpha_scale=1.0)).copy()
    cheb_tf = tf.copy()
    cheb_tf[:, :8, 3] = 0.0
    out = {}
    for dtype, name in ((None, "f32"), (jnp.bfloat16, "bf16")):
        out[name] = jmake_scene(vol, jnp.asarray(tf), pack_dtype=dtype)
        out[name + "_cheb"] = jmake_scene(vol, jnp.asarray(cheb_tf),
                                          pack_dtype=dtype, tracking="cheb")
    out["unpacked"] = jmake_scene(vol, jnp.asarray(tf), pack=False)
    return out


@pytest.fixture(scope="module")
def fields(jscenes):
    return {k: interop.scene_fields(v) for k, v in jscenes.items()}


@pytest.fixture(scope="module")
def scenes(fields):
    return {k: interop.scene_from_numpy(v, device="cpu")
            for k, v in fields.items()}


@pytest.fixture(scope="module")
def group(fields, tmp_path_factory):
    """Rank 0's results of the one 2-rank group."""
    tmp = tmp_path_factory.mktemp("gloo_halo")
    wanted = {k: fields[k] for k in ("f32", "bf16", "f32_cheb", "bf16_cheb")}
    return ranks.spawn(ranks.halo_everything, 2, tmp, wanted)[0]


def test_shard_volume_with_halo_matches_jax(jscenes, scenes):
    """The slabs of the volume and of the cheb-skip table (JAX slices the
    global table, ``vpt_tpu/parallel/halo.py:291-305``) equal JAX's; the
    corner table's slab rows equal JAX's per-slab packing on every plane
    a cell can own."""
    for num_slabs in (1, 2, 4):
        want = np.asarray(jshard(jscenes["f32"].volume, num_slabs))
        got = halo.shard_volume_with_halo(scenes["f32"].volume, num_slabs)
        assert np.array_equal(got.numpy(), want)
        jtrack = jscenes["f32_cheb"].tracking_packed
        lanes = jtrack.shape[-1]
        want = np.asarray(jshard(jtrack.reshape(16, 16, 16, lanes),
                                 num_slabs)).reshape(num_slabs, -1, lanes)
        got = torch.stack([halo.slab_table(
            scenes["f32_cheb"].tracking_packed, (16, 16, 16, 1), num_slabs,
            k) for k in range(num_slabs)])
        assert np.array_equal(got.numpy(), want)
        ds = 16 // num_slabs
        packed = np.asarray(jsampling.pack_corner_volume(
            jshard(jscenes["f32"].volume, num_slabs)[0]))
        rows = halo.slab_table(scenes["f32"].volume_packed,
                               (16, 16, 16, 1), num_slabs, 0)
        assert np.array_equal(rows.numpy()[:ds * 256], packed[:ds * 256])
    assert halo.slab_planes(16, 2, 1, interleave=2).tolist() == \
        list(range(4, 9)) + list(range(12, 16)) + [15]


@pytest.mark.parametrize("packed", ["f32", "unpacked"])
@pytest.mark.parametrize("num_slabs,interleave", [(4, 1), (2, 2)],
                         ids=["contiguous", "interleave2"])
def test_halo_scene_summed_samples_match_dense(jscenes, scenes, packed,
                                               num_slabs, interleave):
    """Each slab's masked partial, summed over the slabs, equals
    ``vpt_tpu``'s dense ``sample_volume`` within 1e-6
    (``tests/test_halo.py:74``), and the packed sum equals the port's
    whole-table fetch bit for bit."""
    rng = np.random.default_rng(0)
    p = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    pos = torch.from_numpy(p)
    total = 0
    for k in range(num_slabs):
        hs = halo.halo_scene(scenes[packed], k, num_slabs,
                             interleave=interleave)
        assert (hs.slab_packed is None) == (packed == "unpacked")
        total = total + hs._sample(pos)
    dense = np.asarray(jsampling.sample_volume(jscenes["f32"].volume,
                                               jnp.asarray(p)))
    assert np.allclose(total.numpy(), dense, rtol=0, atol=1e-6)
    if packed == "f32":
        whole = sampling.sample_volume_packed(scenes["f32"].volume_packed,
                                              (16, 16, 16, 1), pos)
        assert torch.equal(total, whole)


def test_slab_cells_own_every_cell_once():
    """Every position's cell has exactly one owner, contiguous or
    interleaved, and an owned cell's slab row holds the global row."""
    pos = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.2, 1.2, (4000, 3)).astype(np.float32))
    shape = (16, 16, 16, 1)
    table = torch.arange(16 ** 3, dtype=torch.float32)[:, None].repeat(1, 8)
    _, cells, _ = corner_gather.corner_fetch_plain(table, shape, pos,
                                                   save=True)
    for num_slabs, interleave in ((1, 1), (2, 1), (4, 1), (2, 2), (4, 2)):
        owners = torch.zeros(len(pos), dtype=torch.int64)
        for k in range(num_slabs):
            rows = halo.slab_table(table, shape, num_slabs, k, interleave)
            _, idx, _ = corner_gather.slab_fetch_plain(
                rows, shape, k, num_slabs, interleave, pos, save=True)
            mine = idx >= 0
            owners += mine
            assert torch.equal(rows[idx[mine], 0].long(), cells[mine])
        assert bool((owners == 1).all())


@pytest.mark.parametrize("name", sorted(MCM_CASES))
def test_halo_mcm_frame_equals_the_replicated_frames(group, scenes, jscenes,
                                                     name):
    """Two frames on 2 slabs equal the port's replicated frames bit for
    bit, and ``vpt_tpu``'s replicated ``mcm.render_frame`` in ≥ 99.99% of
    the pixels (samples), their radiance and position within 1e-6."""
    _, kind, kwargs = MCM_CASES[name]
    params = mcm.Params(**kwargs)
    state = mcm.reset(params, H, H, scenes[kind])
    jparams = jmcm.Params(**kwargs)
    jstate = jmcm.reset(jparams, H, H, jscenes[kind])
    for n in (1, 2):
        mcm.render_frame(state, scenes[kind], params, np.float32(0.7 * n), n)
        jstate = jmcm.render_frame(jstate, jscenes[kind], jparams,
                                   jnp.float32(0.7 * n), jnp.int32(n))
    got = group[name]
    assert sorted(got) == sorted(state)
    for k in state:
        assert np.array_equal(got[k], state[k].numpy()), k
    assert ("cheb" in got) == name.endswith("cheb")
    match = got["samples"] == np.asarray(jstate["samples"])
    assert match.mean() >= 0.9999, match.mean()
    assert got["samples"].mean() > 0.5
    for k in ("radiance", "position"):
        assert np.allclose(got[k][match], np.asarray(jstate[k])[match],
                           rtol=0, atol=1e-6), k


def test_halo_mcm_issues_one_all_reduce_an_event(group):
    """4 cases × 2 frames × 8 events, one sum a fetch."""
    assert group["mcm_collectives"] == {"all_reduce": 4 * 2 * 8}


@pytest.mark.parametrize("key", ranks.HALO_MARCH)
def test_halo_march_renderers_match(group, scenes, jscenes, key):
    """The march renderers' plain frames over the HaloScene equal the
    port's replicated frame, and ``vpt_tpu``'s within 2e-6
    (``tests/test_halo.py:116``)."""
    module = factory.get_module(key)
    params = module.Params()
    state = module.reset(params, H, H, scenes["f32"])
    want = module.render_frame(state, scenes["f32"], params,
                               np.float32(0.3), 1).numpy()
    assert np.array_equal(group[key], want)
    jmodule = jfactory.get_module(key)
    jparams = jmodule.Params()
    jstate = jmodule.render_frame(jmodule.reset(jparams, H, H,
                                                jscenes["f32"]),
                                  jscenes["f32"], jparams, jnp.float32(0.3),
                                  jnp.int32(1))
    assert np.allclose(group[key], np.asarray(jstate), rtol=0, atol=2e-6)


def test_distributed_demo_frames(group):
    """The demo's pixel-sharded and halo-sharded frames (2 ranks, space
    2) give the single-process frame's mean samples a pixel."""
    from vpt_tpu_torch import transfer, volume
    from vpt_tpu_torch.renderers import make_scene

    scene = make_scene(volume.sphere_volume(32, device="cpu"),
                       transfer.gray_ramp(alpha_scale=0.9, device="cpu"),
                       device="cpu")
    params = mcm.Params(extinction=20.0, steps=8)
    state = mcm.reset(params, 64, 64, scene)
    mcm.render_frame(state, scene, params, np.float32(0.3), 1)
    want = float(state["samples"].double().mean())
    pixel, halo_mean = group["demo"]
    assert want > 0.5
    assert abs(pixel - want) <= 1e-9 and abs(halo_mean - want) <= 1e-9
