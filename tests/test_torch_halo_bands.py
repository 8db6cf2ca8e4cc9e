"""The halo frames with rows over ``data`` as well as slabs over ``space``
(``data`` = 2 × ``space`` = 2), through the port's
``halo.sharded_render_frame``: DOS's band of rows (``dos.render_band``,
each slice all-gathering the occlusion over ``data``, the HaloScene's
fetch summed over ``space``) and LAO's windowed frame.

One 4-rank ``gloo`` group per module (``torch_parallel_ranks.
halo_bands_everything``) renders every case of ``HALO_BAND_CASES`` at 16²
on the 32³ volume of ``test_torch_halo_frames.py`` (float32 tables) with
the plain twins over the HaloScene (the CPU runs no kernel).  The tests
hold what rank 0 gathered against ``shard.shard_render_frame``'s frames
on the whole scene bit for bit, LAO's against the port's replicated frame
bit for bit too, DOS's against ``vpt_tpu``'s ``sharded_render_frame`` on
a (2, 2) mesh of the CPU devices (whose ``shard_map`` is manual over
``space`` only; XLA partitions ``data``), and they pin each DOS slice's
collectives: one all-gather over ``data`` and one all-reduce over
``space``.
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
from vpt_tpu.renderers import dos as jdos
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import interop
from vpt_tpu_torch.renderers import lao

SIZE = ranks.HALO_FRAME_SIZE
CASES = {case[0]: case for case in ranks.HALO_BAND_CASES}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads only spin against the
    other workers of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jscene():
    """``test_torch_halo_frames.py``'s float32 scene: a 32³ blobs volume,
    ``gray_ramp(alpha_scale=1)``."""
    return jmake_scene(jvolume.blobs_volume(32, seed=5),
                       jtransfer.gray_ramp(alpha_scale=1.0))


@pytest.fixture(scope="module")
def scene(jscene):
    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


@pytest.fixture(scope="module")
def group(jscene, tmp_path_factory):
    """Rank 0's results of the one 4-rank group."""
    tmp = tmp_path_factory.mktemp("gloo_halo_bands")
    return ranks.spawn(ranks.halo_bands_everything, 4, tmp,
                       interop.scene_fields(jscene))[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_bands_equal_the_whole_scene_bands(group, name):
    """Rows over ``data`` and slabs over ``space`` equal
    ``shard.shard_render_frame``'s frames of the same rows on the whole
    scene bit for bit, every key: the masked zeros make each sum the
    owner's value, and DOS's bands read the same gathered occlusion."""
    got, want = group[name]["state"], group[name]["whole"]
    if not isinstance(want, dict):
        got, want = {"state": got}, {"state": want}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_halo_lao_bands_equal_the_replicated_frame(group, scene):
    """LAO's windowed halo frame on 2 × 2 ranks equals the port's
    single-process frame bit for bit."""
    params = lao.Params(**CASES["lao"][2])
    want = lao.generate(scene, params, 0.0, SIZE, SIZE).numpy()
    assert np.array_equal(group["lao"]["state"], want)


def test_halo_bands_collectives(group):
    """Each DOS frame issues, a slice, one all-gather of the occlusion over
    ``data`` and one all-reduce of the sample over ``space`` (K9's halo
    band instance: one all-reduce a chunk of 8 active slices); the first
    frame's slices are all active.  LAO issues only all-reduces, one a tap
    a slice (28 × 16)."""
    steps = CASES["dos"][2]["steps"]
    active = group["dos"]["active"]
    assert active[0] == steps
    assert group["dos"]["collectives"] == [
        {"all_gather": n, "all_reduce": n} for n in active]
    assert group["lao"]["collectives"] == [{"all_reduce": 28 * 16}]


@pytest.fixture(scope="module")
def jax_dos(jscene):
    """vpt_tpu's DOS frames of the case through its
    ``halo.sharded_render_frame`` on a (2, 2) mesh of the CPU devices."""
    _, _, kwargs, frames = CASES["dos"]
    mesh = jmake_mesh(4, space=2)
    params = jdos.Params(**kwargs)
    state = jplace_state(jdos.reset(params, SIZE, SIZE, jscene), mesh)
    frame_fn, slabs = jsharded_frame(jdos, mesh, jscene, 2, state)
    for n in range(1, frames + 1):
        state = frame_fn(state, slabs, params,
                         jnp.float32(ranks.halo_frame_seed(n)),
                         jnp.int32(n))
    return {k: np.asarray(v) for k, v in state.items()}


def test_halo_dos_bands_match_vpt_tpu(group, jax_dos):
    """Against vpt_tpu's sharded frame on the (2, 2) mesh, the bound of
    ``test_torch_halo_frames.test_halo_frames_match_vpt_tpu``'s DOS (the
    port's DOS against vpt_tpu's, ``test_torch_dos.assert_state_close``,
    float32 tables): colour and occlusion within 3e-5, 99% of the values
    within 1e-6 and within 1e-5, the depths equal.  The port's bands read
    vpt_tpu's sharded taps (``dos.extended_taps``), vpt_tpu's partitioned
    sweep its shifted taps; vpt_tpu's own sharded frame lies within 1.85e-6
    of its replicated one."""
    got = group["dos"]["state"]
    for k in ("color", "occlusion"):
        diff = np.abs(got[k] - jax_dos[k])
        assert diff.max() <= 3e-5, (k, diff.max())
        assert (diff <= 1e-6).mean() >= 0.99, k
        assert (diff <= 1e-5).mean() >= 0.99, k
    for k in ("depth", "max_depth", "slice_distance", "offsets"):
        assert np.array_equal(got[k], jax_dos[k]), k
    assert got["color"][..., 3].max() > 0.0
