"""The host schedules of K8's and K9's halo frames, and their CPU path.

K8's halo frame issues its launches in batches of ``HALO_BATCH`` between
two reads of the card's count of the pixels that fetch
(``mcs_frame.halo_schedule``), each launch but the first after an
all-reduce where the group sums the values (``mcs_frame.batch_calls``).
K6's and K9's halo frames sample all of their slices in one fetch unless
their values pass ``HALO_VALUE_BYTES`` (``_build.halo_chunk``,
``halo_chunks``, the rule both share).  The
schedules are pure functions of the counts and sizes, held here against
the bounds the frames promise, with no JAX; the kernels run only on the
card (``tests/test_torch_cuda.py``).  On the CPU a halo frame runs its
plain twin and launches nothing: the last tests hold one-slab CPU frames
against ``vpt_tpu``'s ``halo.sharded_render_frame`` on 1, 2 and 4 slabs of
the CPU devices (JAX imported there alone), with the bounds of
``test_torch_halo_frames.test_halo_frames_match_vpt_tpu``; the port's own
frames on 2 ranks are held to ``vpt_tpu``'s in that file.
"""

import math

import numpy as np
import pytest
import torch

from vpt_tpu_torch import transfer, volume
from vpt_tpu_torch.kernels import _build, dos_sweep, mcs_frame
from vpt_tpu_torch.parallel import halo
from vpt_tpu_torch.renderers import dos, make_scene, mcs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads only spin against the
    other workers of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counts(seed, slowest):
    """A frame's counts of the pixels that fetch at each launch: a falling
    random sequence whose last non-zero entry is launch ``slowest`` - 1
    (L = ``slowest``, the slowest pixel's fetches)."""
    rng = np.random.default_rng(seed)
    return sorted((int(c) for c in rng.integers(1, 262144, slowest)),
                  reverse=True)


#: (label, counts): L = len(counts) fetches for the slowest pixel
COUNT_CASES = [("every pixel misses", []), ("one fetch", [7]),
               ("short", [5, 3]), ("headline-like", _counts(1, 20)),
               ("long tail", [150000, 40000] + [1] * 25),
               ("random 9", _counts(2, 9)), ("random 64", _counts(3, 64))]


def _run(counts, batch, reduces=False):
    """Run ``halo_schedule`` against a card whose launch e counts
    ``counts[e]`` (0 from launch L on): (launches, reads, the calls, in
    order, as ("launch", first, k) / ("read",) / ("run", first, launches,
    read, all-reduce before) entries)."""
    calls = []

    def launch(e, k):
        calls.append(("launch", e, k))
        calls.extend(("run",) + c for c in mcs_frame.batch_calls(
            e, k, reduces))

    def read():
        calls.append(("read",))
        last = calls[-2][1] + calls[-2][2] - 1   # the batch's last launch
        return counts[last] if last < len(counts) else 0

    launches, reads = mcs_frame.halo_schedule(launch, read, batch)
    return launches, reads, calls


@pytest.mark.parametrize("batch", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("label,counts", COUNT_CASES,
                         ids=[c[0] for c in COUNT_CASES])
def test_mcs_halo_launches_lie_in_l_plus_one_to_l_plus_b(label, counts,
                                                          batch):
    """A frame whose slowest pixel fetches L times issues between L + 1
    and L + B launches, from launch 0 on without a gap, in ceil((L + 1) /
    B) reads (the bound is that plus one), and stops at the first read of
    a count of 0; a batch may be longer than the card's three count
    slots."""
    slowest = len(counts)
    launches, reads, calls = _run(counts, batch)
    assert slowest + 1 <= launches <= slowest + batch
    assert reads == math.ceil((slowest + 1) / batch)
    assert reads <= math.ceil((slowest + 1) / batch) + 1
    issued = [e for c in calls if c[0] == "launch"
              for e in range(c[1], c[1] + c[2])]
    assert issued == list(range(launches))
    assert [c for c in calls if c[0] == "read"] == [("read",)] * reads


@pytest.mark.parametrize("label,counts", COUNT_CASES,
                         ids=[c[0] for c in COUNT_CASES])
def test_mcs_halo_schedule_depends_on_the_counts_alone(label, counts):
    """Equal counts give equal schedules, however the reads arrive: two
    ranks of a group, which read the same counts, issue the same launches
    and all-reduces, each launch but the frame's first after one (so a
    frame's all-reduces are its launches less one), the read after a
    batch's last launch; where the group sums nothing one call issues a
    batch.  Other counts than the first zero's position change nothing."""
    batch = mcs_frame.HALO_BATCH
    ranks = [_run(counts, batch, reduces=True) for _ in range(2)]
    assert ranks[0] == ranks[1]
    launches, _, calls = ranks[0]
    runs = [c for c in calls if c[0] == "run"]
    assert [c[1:3] for c in runs] == [(e, 1) for e in range(launches)]
    assert sum(c[4] for c in runs) == launches - 1
    assert [c[3] for c in runs] == [(e + 1) % batch == 0
                                    for e in range(launches)]
    # the same counts read one launch at a time or as one value: the same
    # schedule; counts of other sizes with the same first zero: the same
    alone = _run(counts, batch)
    assert alone[:2] == ranks[0][:2]
    assert all(c[2] == batch and c[3] and not c[4]
               for c in alone[2] if c[0] == "run")
    scaled = [np.int64(3 * c + 1) for c in counts]
    assert _run(scaled, batch)[:2] == alone[:2]


def test_mcs_halo_batches_are_among_the_measured():
    """The batch without a collective was chosen from 2, 4 and 8, the one
    where the group sums the values from 1, 2, 4 and 8 (PERF.md §6)."""
    assert mcs_frame.HALO_BATCH in (2, 4, 8)
    assert mcs_frame.HALO_REDUCE_BATCH in (1, 2, 4, 8)


@pytest.mark.parametrize("collective", [True, False])
def test_halo_scene_reduces_only_over_a_group(collective):
    """``HaloScene.reduces``, which picks the MCS halo frame's batch, is
    false without a group of more than one rank, masked or not, and then
    ``reduce`` and ``reduce_`` return the partial itself."""
    hs = halo.halo_scene(make_scene(
        volume.blobs_volume(8, seed=1, device="cpu"),
        transfer.gray_ramp(device="cpu"), device="cpu"), 1, 2,
        collective=collective)
    assert hs.reduces is False
    partial = torch.arange(6, dtype=torch.float32)
    assert hs.reduce(partial) is partial
    assert hs.reduce_(partial) is partial
    assert torch.equal(partial, torch.arange(6, dtype=torch.float32))


@pytest.mark.parametrize("steps,pixels,channels", [
    (50, 512 * 512, 1), (50, 1024 * 1024, 2), (200, 1024 * 1024, 1),
    (50, 4096 * 4096, 1), (50, 4096 * 4096, 2), (3, 1, 1),
    (50, 16384 * 16384, 2)])
def test_dos_halo_chunk_is_steps_under_the_cap(steps, pixels, channels):
    """A halo frame samples all of its ``steps`` in one fetch while their
    values fit in 1 GiB, else the most slices that fit (at least one), in
    chunks that cover the frame's slices in order, each 2 launches, the
    last fold advancing the depth."""
    _assert_halo_chunks(steps, pixels, channels)


def _assert_halo_chunks(steps, pixels, channels):
    """``_build.halo_chunk``'s chunk of a frame of ``steps`` slices over
    ``pixels`` pixels of ``channels`` values: every slice while they fit
    in 1 GiB, else the most that fit (at least one), in chunks that cover
    the slices in order, the last flagged."""
    chunk = _build.halo_chunk(steps, pixels, channels)
    per_slice = 4 * pixels * channels
    cap = _build.HALO_VALUE_BYTES
    assert cap == 1 << 30
    if steps * per_slice <= cap:
        assert chunk == steps
    else:
        assert chunk < steps
        assert chunk == 1 or chunk * per_slice <= cap
        assert (chunk + 1) * per_slice > cap
    chunks = _build.halo_chunks(steps, chunk)
    assert [k for k0, n, _ in chunks for k in range(k0, k0 + n)] \
        == list(range(steps))
    assert [last for *_, last in chunks] == [False] * (len(chunks) - 1) \
        + [True]
    assert all(n <= chunk for _, n, _ in chunks)


def test_dos_halo_chunk_under_a_small_cap():
    """The rule at a cap a test can reach: 12 slices of 10 pixels' values
    (40 bytes a slice) fit in 480 bytes, 13 do not."""
    assert _build.halo_chunk(20, 10, 1, cap=480) == 12
    assert _build.halo_chunk(20, 10, 1, cap=479) == 11
    assert _build.halo_chunk(20, 10, 1, cap=10**6) == 20
    assert _build.halo_chunk(20, 10**6, 2, cap=8) == 1
    assert _build.halo_chunks(20, 12) == [(0, 12, False), (12, 8, True)]


#: the march renderers' halo frames: (slices, image side, channels) of
#: EAM and Depth (64 slices), MIP (64 steps) and ISO (50 steps) at the
#: headline's 512², config 4's 1024², and past the cap at 4096² and 8192²
MARCH_SHAPES = [(s, side, c) for s in (50, 64) for side in (512, 1024)
                for c in (1, 2)] + [(64, 4096, 1), (64, 4096, 2),
                                    (50, 8192, 1), (64, 8192, 2)]


@pytest.mark.parametrize("slices,side,channels", MARCH_SHAPES,
                         ids=[f"{s}x{n}^2x{c}" for s, n, c in MARCH_SHAPES])
def test_march_halo_chunk_is_slices_under_the_cap(slices, side, channels):
    """K6's halo frame shares the rule: at the march's shapes every slice
    in one fetch up to 1024², two channels included (512 MiB of values at
    64 slices), chunks past the cap at 4096² and 8192²."""
    _assert_halo_chunks(slices, side * side, channels)
    chunk = _build.halo_chunk(slices, side * side, channels)
    assert (chunk == slices) == (side <= 1024)


#: the frames' image, height x width: ``test_torch_halo_frames``' size
HEIGHT = WIDTH = 16


def _seed(n):
    """Frame n's seed, ``torch_parallel_ranks.halo_frame_seed``'s."""
    return np.float32(0.25 + 0.3 * n)


@pytest.fixture(scope="module")
def jscene():
    """vpt_tpu's scene of ``test_torch_halo_frames``' float32 case: a 32³
    blobs volume with float32 tables."""
    import jax.numpy as jnp

    from vpt_tpu import transfer as jtransfer
    from vpt_tpu import volume as jvolume
    from vpt_tpu.renderers import make_scene as jmake_scene

    tf = np.asarray(jtransfer.gray_ramp(alpha_scale=1.0)).copy()
    return jmake_scene(jvolume.blobs_volume(32, seed=5), jnp.asarray(tf))


@pytest.fixture(scope="module")
def scene(jscene):
    from vpt_tpu_torch import interop

    return interop.scene_from_numpy(interop.scene_fields(jscene),
                                    device="cpu")


def _jax_frames(jscene, key, params, slabs, seeds):
    """vpt_tpu's frames (frame n at ``seeds[n - 1]``) of renderer ``key``
    through its ``halo.sharded_render_frame`` on a (1, ``slabs``) mesh of
    the CPU devices: (the reset state, the last state), as numpy."""
    import jax.numpy as jnp

    from vpt_tpu.parallel import make_mesh
    from vpt_tpu.parallel.halo import sharded_render_frame
    from vpt_tpu.parallel.shard import place_state
    from vpt_tpu.renderers import factory

    module = factory.get_module(key)
    jparams = module.Params(**params)
    mesh = make_mesh(slabs, space=slabs)
    reset = module.reset(jparams, HEIGHT, WIDTH, jscene)
    state = place_state(reset, mesh)
    frame_fn, tables = sharded_render_frame(module, mesh, jscene, slabs,
                                            state)
    for n, seed in enumerate(seeds, 1):
        state = frame_fn(state, tables, jparams, jnp.float32(seed),
                         jnp.int32(n))
    if isinstance(state, dict):
        return ({k: np.array(v) for k, v in reset.items()},
                {k: np.asarray(v) for k, v in state.items()})
    return np.array(reset), np.asarray(state)


@pytest.mark.parametrize("slabs", [1, 2, 4])
def test_cpu_mcs_halo_frame_matches_vpt_tpu(jscene, scene, slabs):
    """On the CPU two K8 halo frames over a one-slab HaloScene launch and
    read nothing (the plain twin) and match vpt_tpu's sharded frames on
    ``slabs`` slabs: 99% of the pixels within 1e-6 and the means within
    1e-4 (``test_torch_mcs.assert_pixels_agree``, float32 tables)."""
    seeds = [_seed(n) for n in (1, 2)]
    hs = halo.halo_scene(scene, 0, 1)
    params = mcs.Params(extinction=8.0)
    got = mcs.reset(params, HEIGHT, WIDTH, scene)
    before = (mcs_frame.HALO_LAUNCHES, mcs_frame.HALO_READS)
    for n, seed in enumerate(seeds, 1):
        assert mcs_frame.halo_mcs_frame(got, hs, params, seed, n) == 0
    assert (mcs_frame.HALO_LAUNCHES, mcs_frame.HALO_READS) == before
    got = got.numpy()
    reset, want = _jax_frames(jscene, "mcs", dict(extinction=8.0), slabs,
                              seeds)
    assert np.array_equal(mcs.reset(params, HEIGHT, WIDTH, scene).numpy(),
                          reset)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got[..., 3].max() > 0.0
    close = (np.abs(got - want) <= 1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(float(got.mean()) - float(want.mean())) <= 1e-4


@pytest.mark.parametrize("slabs", [1, 2, 4])
def test_cpu_dos_halo_frame_matches_vpt_tpu(jscene, scene, slabs):
    """On the CPU a K9 halo sweep over a one-slab HaloScene (through
    ``dos.render_frame``: two whole frames, a partly active last one and
    one after the sweep's end), from vpt_tpu's reset carried across as
    ``test_torch_dos`` starts, launches nothing and matches vpt_tpu's
    sharded sweep on ``slabs`` slabs: the colour and occlusion within
    3e-5, 99% of the values within 1e-6 and within 1e-5, the depths and
    offsets equal (``test_torch_dos.assert_state_close``, float32
    tables)."""
    kwargs = dict(extinction=80.0, steps=20, slices=50, samples=6)
    hs = halo.halo_scene(scene, 0, 1)
    params = dos.Params(**kwargs)
    reset, want = _jax_frames(jscene, "dos", kwargs, slabs, [0.0] * 4)
    got = {k: torch.from_numpy(v) for k, v in reset.items()}
    before = dos_sweep.HALO_LAUNCHES
    active = []
    for n in (1, 2, 3, 4):
        active.append(dos.active_slices(got, params))
        dos.render_frame(got, hs, params, 0.0, n)
    assert dos_sweep.HALO_LAUNCHES == before
    assert active[:2] == [20, 20] and 0 < active[2] < 20 and active[3] == 0
    assert dos.active_slices(got, params) == 0
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k in ("color", "occlusion"):
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 3e-5, (k, diff.max())
        assert (diff <= 1e-6).mean() >= 0.99, k
        assert (diff <= 1e-5).mean() >= 0.99, k
    for k in ("depth", "max_depth", "slice_distance", "offsets"):
        assert np.array_equal(got[k], want[k]), k
    assert got["color"][..., 3].max() > 0.0
