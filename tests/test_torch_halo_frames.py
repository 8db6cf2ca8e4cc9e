"""The halo frames of the renderers whose kernels have a halo instance on
the card (EAM, ISO and its display, MCS, DOS, LAO; MCM in
``test_torch_halo.py``), through the port's ``halo.sharded_render_frame``,
against the port's replicated frames and ``vpt_tpu``'s
``halo.sharded_render_frame``.

One 2-rank ``gloo`` group per module (``torch_parallel_ranks.
halo_frames_everything``, ``space`` = 2) renders every case of
``HALO_FRAME_CASES`` at 16² on a 32³ volume with the plain twins over the
HaloScene (the CPU runs no kernel): float32 tables, the cheb-skip table,
a two-channel volume and LAO's baked gradient.  The tests hold what rank
0 gathered against the port's replicated frames bit for bit, and against
``vpt_tpu``'s sharded frames on 2 of the 8 CPU devices within the bound of
the port's existing test of that renderer against ``vpt_tpu``, named in
each test; and they pin each frame's all-reduces: one a sample call of
the replicated frame (a chunk of 8 slices of the march, each tracking
step's fetch of every pixel and the diffuse fetch of MCS, a slice of DOS,
each of the display's seven fetches, each of LAO's 28 taps a slice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.parallel import make_mesh as jmake_mesh
from vpt_tpu.parallel.halo import sharded_render_frame as jsharded_frame
from vpt_tpu.parallel.shard import place_state as jplace_state
from vpt_tpu.renderers import factory as jfactory
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop
from vpt_tpu_torch.renderers import base, factory, iso, lao

SIZE = ranks.HALO_FRAME_SIZE
CASES = {case[0]: case for case in ranks.HALO_FRAME_CASES}


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
    """vpt_tpu's scenes: a 32³ blobs volume with float32 tables, with the
    cheb-skip table (its TF floor exactly empty), its two-channel
    ``with_gradient_magnitude`` twin and its ``with_lao_gradient`` twin
    (LAO's baked gradient)."""
    vol = jvolume.blobs_volume(32, seed=5)
    tf = np.asarray(jtransfer.gray_ramp(alpha_scale=1.0)).copy()
    cheb_tf = tf.copy()
    cheb_tf[:, :8, 3] = 0.0
    return {"f32": jmake_scene(vol, jnp.asarray(tf)),
            "cheb": jmake_scene(vol, jnp.asarray(cheb_tf), tracking="cheb"),
            "rg": jmake_scene(jvolume.with_gradient_magnitude(vol),
                              jnp.asarray(tf)),
            "baked": jmake_scene(jvolume.with_lao_gradient(vol),
                                 jnp.asarray(tf))}


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
    tmp = tmp_path_factory.mktemp("gloo_halo_frames")
    return ranks.spawn(ranks.halo_frames_everything, 2, tmp, fields)[0]


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(2, space=2)


def _count_samples(monkeypatch):
    """Count the replicated Scene's sample calls (each a fetch that the
    HaloScene sums over ``space``): the outermost calls of its samplers,
    so that a sample_color that reads sample_volume_rg counts once."""
    calls = [0]
    depth = [0]
    for name in ("sample_color", "sample_color_tracking", "sample_value",
                 "sample_volume_rg"):
        method = getattr(base.Scene, name)

        def counted(self, *args, _method=method, **kwargs):
            calls[0] += depth[0] == 0
            depth[0] += 1
            try:
                return _method(self, *args, **kwargs)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(base.Scene, name, counted)
    return calls


@pytest.fixture(scope="module")
def replicated(scenes):
    """The port's replicated frames of every case, with each frame's
    sample calls; ISO's display of its last state too."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_samples(mp)
        for name, (_, key, kind, kwargs, frames) in CASES.items():
            module = factory.get_module(key)
            params = module.Params(**kwargs)
            state = module.reset(params, SIZE, SIZE, scenes[kind])
            counts = []
            for n in range(1, frames + 1):
                calls[0] = 0
                module.render_frame(state, scenes[kind], params,
                                    ranks.halo_frame_seed(n), n)
                counts.append(calls[0])
            out[name] = {"state": ranks._np(state), "samples": counts}
            if key == "iso":
                calls[0] = 0
                out[name]["display"] = ranks._np(iso.display(
                    state, scenes[kind], params))
                out[name]["display_samples"] = calls[0]
    return out


@pytest.fixture(scope="module")
def jax_frames(jscenes, jmesh):
    """vpt_tpu's frames of every case through its
    ``halo.sharded_render_frame`` on a (1, 2) mesh of the CPU devices."""
    out = {}
    for name, (_, key, kind, kwargs, frames) in CASES.items():
        jm = jfactory.get_module(key)
        params = jm.Params(**kwargs)
        state = jplace_state(jm.reset(params, SIZE, SIZE, jscenes[kind]),
                             jmesh)
        frame_fn, slabs = jsharded_frame(jm, jmesh, jscenes[kind], 2, state)
        for n in range(1, frames + 1):
            state = frame_fn(state, slabs, params,
                             jnp.float32(ranks.halo_frame_seed(n)),
                             jnp.int32(n))
        out[name] = ({k: np.asarray(v) for k, v in state.items()}
                     if isinstance(state, dict) else np.asarray(state))
    return out


def _leaves(state):
    return state if isinstance(state, dict) else {"state": state}


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_frames_equal_the_replicated_frames(group, replicated, name):
    """The plain twins over the HaloScene on 2 slabs equal the port's
    replicated frames bit for bit (the masked zeros make each sum the
    owner's value)."""
    got, want = _leaves(group[name]["state"]), _leaves(
        replicated[name]["state"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_frames_issue_an_all_reduce_a_sample_call(group, replicated,
                                                       name):
    """Each frame's all-reduces are the replicated frame's sample calls:
    the march ceil(slices / 8) (vpt_tpu's chunk of 8 slices a
    ``sample_color``, which K6's halo instance keeps), DOS one a slice
    (vpt_tpu and K9's halo instance: one a chunk of 8 active slices), MCS
    one a tracking step of every pixel and one for the diffuse fetch (K8's
    halo instance: one a fetch of the slowest pixel, never more), LAO one
    a tap a slice, as vpt_tpu: the six gradient taps and the value (the
    baked pair's one), the 20 AO taps and the shadow tap (K10's halo
    instance: one a chunk of 8 slices)."""
    _, key, _, kwargs, _ = CASES[name]
    counts = [c.get("all_reduce", 0) for c in group[name]["collectives"]]
    assert all(set(c) <= {"all_reduce"} for c in
               group[name]["collectives"])
    assert counts == replicated[name]["samples"]
    if key == "eam":
        assert counts == [-(-kwargs["slices"] // 8)] * len(counts)
    elif key == "iso":
        assert counts == [-(-kwargs["steps"] // 8)] * len(counts)
    elif key == "dos":
        assert counts == [kwargs["steps"]] * len(counts)
    elif key == "lao":
        params = lao.Params(**kwargs)
        taps = (1 if params.baked_gradient else 7) \
            + len(lao.lao_taps(params)) + 1
        assert taps == (22 if params.baked_gradient else 28)
        assert counts == [kwargs["slices"] * taps] * len(counts)
    else:
        assert min(counts) > 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_frames_match_vpt_tpu(group, jax_frames, name):
    """Against vpt_tpu's sharded frames, with the bound of the port's
    existing test of the renderer against vpt_tpu: EAM and ISO within
    2e-6 (``test_torch_halo.test_halo_march_renderers_match``); MCS 99% of
    the pixels within 1e-6 and the means within 1e-4
    (``test_torch_mcs.assert_pixels_agree``, float32 tables); DOS the
    colour and occlusion within 3e-5, 99% of the values within 1e-6 and
    within 1e-5, the depths equal (``test_torch_dos.assert_state_close``,
    float32 tables); LAO every value within 1e-5 and 99% of the pixels
    within 1e-6 (``test_torch_lao.test_generate_matches_jax``)."""
    _, key, _, _, _ = CASES[name]
    got, want = group[name]["state"], jax_frames[name]
    if key in ("eam", "iso"):
        assert np.allclose(got, want, rtol=0, atol=2e-6)
    elif key == "lao":
        diff = np.abs(got - want)
        assert diff.max() <= 1e-5, diff.max()
        assert (diff.max(-1) <= 1e-6).mean() >= 0.99, \
            (diff.max(-1) <= 1e-6).mean()
    elif key == "mcs":
        close = (np.abs(got - want) <= 1e-6).all(-1)
        assert close.mean() >= 0.99, close.mean()
        assert abs(float(got.mean()) - float(want.mean())) <= 1e-4
    else:
        for k in ("color", "occlusion"):
            diff = np.abs(got[k] - want[k])
            assert diff.max() <= 3e-5, (k, diff.max())
            assert (diff <= 1e-6).mean() >= 0.99, k
            assert (diff <= 1e-5).mean() >= 0.99, k
        for k in ("depth", "max_depth", "slice_distance", "offsets"):
            assert np.array_equal(got[k], want[k]), k
        assert got["color"][..., 3].max() > 0.0


def test_halo_iso_display(group, replicated, jscenes):
    """ISO's display over the HaloScene equals the port's replicated
    display bit for bit, in the plain twin's seven all-reduces (one a
    fetch; K7's halo instance sums the seven in one), and vpt_tpu's
    display of the same hit buffer within 1e-5
    (``test_torch_march.test_iso_display_matches_jax``; within 1e-6 on
    float32 tables, its ``assert_close``)."""
    got = group["iso"]["display"]
    assert np.array_equal(got, replicated["iso"]["display"])
    assert group["iso"]["display_collectives"] == {"all_reduce": 7}
    assert replicated["iso"]["display_samples"] == 7
    state = group["iso"]["state"]
    assert (state[..., 3] > 0).any() and (state[..., 3] <= 0).any()
    jm = jfactory.get_module("iso")
    want = np.asarray(jm.display(jnp.asarray(state), jscenes["f32"],
                                 jm.Params(**CASES["iso"][3])))
    assert np.abs(got - want).max() <= 1e-6
