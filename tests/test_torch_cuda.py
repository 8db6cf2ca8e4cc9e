"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The file
imports no JAX, so the GPU machine, which has none, runs it without the
JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from vpt_tpu_torch import environment, rng, sampling, train
from vpt_tpu_torch import tonemap as tm
from vpt_tpu_torch import transfer, volume
from vpt_tpu_torch.kernels import _build, corner_gather, corner_scatter
from vpt_tpu_torch.kernels import dos_sweep, iso_shade, lao_march, march
from vpt_tpu_torch.kernels import mcm_event, mcs_frame, tf1d, tonemap_kernel
from vpt_tpu_torch.renderers import base as renderer_base
from vpt_tpu_torch.renderers import make_renderer, make_scene
from vpt_tpu_torch.renderers import depth, dos, eam, iso, lao, mcm, mcs, mip
from vpt_tpu_torch.runtime import RenderingContext

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tf1d_kernel_matches_plain(cuda, dtype):
    """The kernel runs the plain version's operations (-fmad=false), so
    the tolerance is only a guard: atol 1e-6."""
    g = torch.Generator().manual_seed(0)
    tf = torch.rand(2, 256, 4, generator=g).to(dtype).to(torch.float32)
    values = torch.rand(512, 512, generator=g) * 1.2 - 0.1
    table, width = tf1d.pack_table(tf)
    before = tf1d.LAUNCHES
    got = tf1d.lookup_1d(table.to(cuda), values.to(cuda), width)
    torch.cuda.synchronize()
    assert tf1d.LAUNCHES == before + 1
    want = tf1d.lookup_plain(table, values)
    assert torch.allclose(got.cpu(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mxu", [torch.float32, torch.bfloat16])
def test_tf1d_kernel_mxu_modes_match_plain(cuda, mxu):
    """The tf_mxu weights (rounded to bf16 in the bf16 mode): the kernel
    runs the plain version's operations on the same card, so the results
    are equal."""
    g = torch.Generator().manual_seed(4)
    table = torch.rand(256, 4, generator=g).to(mxu).to(torch.float32)
    values = torch.rand(512, 512, generator=g) * 1.2 - 0.1
    values[0, :4] = torch.tensor([0.0, 1.0, 0.5 / 256, 255.5 / 256])
    table, values = table.to(cuda), values.to(cuda)
    got = tf1d.lookup_1d(table, values, 256, mxu)
    want = tf1d.lookup_plain(table, values, mxu)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # float32 weights round like the bilinear ones wherever u >= 1; the
    # bf16 weights do not
    bilinear = tf1d.lookup_plain(table, values)
    assert torch.equal(got, bilinear) == (mxu == torch.float32)


@pytest.mark.parametrize("mxu", [None, torch.float32, torch.bfloat16],
                         ids=["bilinear", "mxu-f32", "mxu-bf16"])
@pytest.mark.parametrize("n", [1, 127, 128 * 1023 + 5])
@pytest.mark.parametrize("offset", [0, 1, 3], ids=["aligned", "off1",
                                                   "off3"])
def test_tf1d_kernel_sizes_views_and_modes(cuda, n, offset, mxu):
    """Ragged counts (one value, less than a warp's 128, a whole grid of
    chunks and a tail) on views that start 0, 4 or 12 bytes past a
    16-byte boundary: the vector body, the head and the tail all give the
    plain version's lookup (atol 1e-6, as the smoke holds it)."""
    g = torch.Generator().manual_seed(11)
    table = torch.rand(256, 4, generator=g).to(torch.bfloat16) \
        .to(torch.float32).to(cuda)
    base = (torch.rand(n + 3, generator=g) * 1.2 - 0.1).to(cuda)
    base[0] = float("nan")
    values = base[offset:offset + n]
    assert values.data_ptr() % 16 == 4 * offset
    before = tf1d.LAUNCHES
    got = tf1d.lookup(table, values, mxu)
    want = tf1d.lookup_plain(table, values, mxu)
    torch.cuda.synchronize()
    assert tf1d.LAUNCHES == before + 1
    assert got.shape == (n, 4)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.allclose(got.nan_to_num(), want.nan_to_num(), rtol=0,
                          atol=1e-6)


def test_tf1d_kernel_follows_the_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` the launch goes to ``s``: the values
    are written on ``s`` behind a ~10 ms sleep, so a launch on another
    stream would read them before they exist."""
    g = torch.Generator().manual_seed(12)
    table = torch.rand(256, 4, generator=g).to(cuda)
    src = torch.rand(1 << 20, generator=g).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _build.current_stream(cuda.index or 0) == side.cuda_stream
        torch.cuda._sleep(20_000_000)
        values = src * 1.0
        got = tf1d.lookup(table, values)
    side.synchronize()
    assert _build.current_stream(cuda.index or 0) \
        == torch.cuda.current_stream().cuda_stream
    assert torch.allclose(got, tf1d.lookup_plain(table, src), rtol=0,
                          atol=1e-6)


def test_tf1d_kernel_launch_shape(cuda):
    """The grid's cap: SMs × resident blocks of 256 threads; a TW-256 row
    leaves room for several blocks an SM."""
    shape = tf1d.launch_shape(256, cuda.index or 0)
    assert shape["threads_per_block"] == 256
    assert shape["sms"] == torch.cuda.get_device_properties(cuda).\
        multi_processor_count
    assert shape["blocks_per_sm"] >= 4
    assert shape["dynamic_smem_bytes"] == 256 * 16


def test_tf1d_kernel_width_cap(cuda):
    """A row of MAX_WIDTH texels fills the 48 KiB of shared memory a
    launch may take; one texel more raises before the launch."""
    g = torch.Generator().manual_seed(3)
    table = torch.rand(tf1d.MAX_WIDTH, 4, generator=g)
    values = torch.rand(4096, generator=g)
    got = tf1d.lookup(table.to(cuda), values.to(cuda))
    torch.cuda.synchronize()
    assert torch.allclose(got.cpu(), tf1d.lookup_plain(table, values),
                          rtol=0, atol=1e-6)
    wide = torch.zeros(tf1d.MAX_WIDTH + 1, 4, device=cuda)
    with pytest.raises(ValueError):
        tf1d.lookup(wide, torch.zeros(128, device=cuda))


@pytest.mark.parametrize("name", sorted(tm.RAW_CURVES))
def test_tonemap_kernel_matches_plain(cuda, name):
    """CUDA's powf/expf differ from PyTorch's by a few ulps: atol 1e-6,
    rtol 1e-6."""
    g = torch.Generator().manual_seed(1)
    img = torch.rand(64, 96, 4, generator=g) * 4.0
    before = tonemap_kernel.LAUNCHES
    got = tm.ToneMapper(name, {"exposure": 1.3})(img.to(cuda))
    torch.cuda.synchronize()
    assert tonemap_kernel.LAUNCHES == before + 1
    want = tonemap_kernel.tonemap_plain(img, name, 1.3)
    assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6)


def assert_frames_agree(state, plain):
    """Kernel against plain loop, both run on the card: the kernel runs
    the plain loop's float32 operations without contraction, so the
    bounds sit near what was measured (every pixel, radiance within
    1.2e-7).  At most one pixel in 10^4 may part on a last-bit difference
    of logf/sinf/cosf: none at the sizes here."""
    match = state["samples"] == plain["samples"]
    agree = match.float().mean().item()
    assert agree >= 0.9999, agree
    err = (state["radiance"] - plain["radiance"])[match].abs().max().item()
    assert err <= 1e-6, err
    assert torch.equal(state["bounces"][match], plain["bounces"][match])


def _headline_scene(n, cuda):
    """The headline's scene at n³: sphere, sRGB gray ramp, cheb-skip, bf16
    tables, the bf16-weight TF lookup."""
    return make_scene(volume.sphere_volume(n, device=cuda),
                      transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                      tf_srgb=True, tracking="auto",
                      pack_dtype=torch.bfloat16, tf_mxu=True, device=cuda)


def _launches():
    return (corner_gather.LAUNCHES, corner_scatter.LAUNCHES,
            mcm_event.LAUNCHES, tf1d.LAUNCHES, tonemap_kernel.LAUNCHES,
            march.LAUNCHES, iso_shade.LAUNCHES, mcs_frame.LAUNCHES,
            dos_sweep.LAUNCHES, lao_march.LAUNCHES)


def _plain_frame(plain, scene, params, seed):
    """The reference frame: the plain loop on the scene with
    ``kernels=False``, which launches no kernel."""
    before = _launches()
    mcm_event.event_frame_plain(plain, dataclasses.replace(
        scene, kernels=False), params, seed)
    assert _launches() == before


def _kernel_and_plain(scene, params, height, width, frames):
    state = mcm.reset(params, height, width, scene)
    plain = {k: v.clone() for k, v in state.items()}
    before = mcm_event.LAUNCHES
    for f in range(frames):
        mcm.render_frame(state, scene, params, 0.3 + 0.01 * f)
        _plain_frame(plain, scene, params, 0.3 + 0.01 * f)
    torch.cuda.synchronize()
    assert mcm_event.LAUNCHES == before + frames
    return state, plain


@pytest.mark.parametrize("height,width,steps,frames", [
    # a ragged last block (1961 = 15·128 + 41 photons)
    (37, 53, 8, 3),
    # 524288 photons: more than the card holds at once, several waves
    (512, 1024, 8, 2),
    # one event a frame: every photon reseeds its stream every frame
    (64, 64, 1, 6),
], ids=["37x53", "1024x512", "steps1"])
def test_event_kernel_tiles(cuda, height, width, steps, frames):
    """The headline's scene on images that fill the grid in every way: the
    kernel against the plain loop."""
    scene = _headline_scene(24, cuda)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    state, plain = _kernel_and_plain(scene, params, height, width, frames)
    assert_frames_agree(state, plain)
    assert float(state["samples"].sum()) > 0


def test_event_kernel_full_width_row_matches_plain(cuda):
    """A TF row of MAX_WIDTH texels (48 KiB) beside the MVP and the
    environment texel: the launch opts in to more than 48 KiB of shared
    memory, fits fewer blocks an SM, and still agrees with the plain
    loop."""
    scene = _headline_scene(24, cuda)
    row = scene.transfer_1d
    full = row[torch.arange(tf1d.MAX_WIDTH, device=cuda)
               * row.shape[0] // tf1d.MAX_WIDTH]
    scene = dataclasses.replace(scene, transfer_1d=full)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state, plain = _kernel_and_plain(scene, params, 96, 96, 2)
    assert_frames_agree(state, plain)
    wide = mcm_event.occupancy(torch.bfloat16, tf1d.MAX_WIDTH)
    narrow = mcm_event.occupancy(torch.bfloat16, row.shape[0])
    assert wide["dynamic_smem_bytes"] + wide["static_smem_bytes"] \
        > 48 * 1024
    assert 1 <= wide["blocks_per_sm"] < narrow["blocks_per_sm"]


def test_event_kernel_occupancy(cuda):
    """The headline's launch: 128 threads a block at 40 registers, 12
    blocks an SM (nvcc 12.8).  The 32 local bytes are the stack frame of
    sinf/cosf's large-argument reduction (ptxas: 0 bytes spilled)."""
    occ = mcm_event.occupancy(torch.bfloat16, 256)
    assert occ["threads_per_block"] == 128
    assert occ["registers"] <= 40
    assert occ["blocks_per_sm"] >= 12
    assert occ["local_bytes"] <= 32


@pytest.mark.parametrize("tracking", ["none", "auto"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_event_kernel_matches_plain_loop(cuda, tracking, dtype):
    """The kernel and the plain loop on the same card and inputs (64², 24³
    blobs, steps 8, 4 frames).  Measured on an H100: samples agree on
    every pixel, radiance within 1.2e-7 where they agree."""
    scene = make_scene(volume.blobs_volume(24, seed=1, device=cuda),
                       transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                       tf_srgb=True, tracking=tracking, pack_dtype=dtype,
                       device=cuda)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, 64, 64, scene)
    plain = {k: v.clone() for k, v in state.items()}
    before = mcm_event.LAUNCHES
    for f in range(4):
        mcm.render_frame(state, scene, params, 0.3 + 0.01 * f)
        _plain_frame(plain, scene, params, 0.3 + 0.01 * f)
    torch.cuda.synchronize()
    assert mcm_event.LAUNCHES == before + 4
    assert_frames_agree(state, plain)


def test_event_kernel_mxu_matches_plain_loop(cuda):
    """The headline's scene (bf16 tables, tf_mxu, cheb-skip): the event
    kernel's TF device function in the bf16-weight mode against the plain
    loop.  Before the plain flight divided by a tensor (rng.exponential),
    3 of these 4096 pixels parted from the plain loop's streams."""
    scene = _headline_scene(24, cuda)
    assert scene.tf_mxu == torch.bfloat16
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, 64, 64, scene)
    plain = {k: v.clone() for k, v in state.items()}
    for f in range(4):
        mcm.render_frame(state, scene, params, 0.3 + 0.01 * f)
        _plain_frame(plain, scene, params, 0.3 + 0.01 * f)
    torch.cuda.synchronize()
    assert_frames_agree(state, plain)


def test_plain_divisions_are_true_quotients(cuda):
    """CUDA divides by a Python scalar through its reciprocal; the plain
    flight distance and pixel centres divide by tensors, so they are the
    correctly rounded quotients of JAX and of the kernels (float64
    division rounded to float32 is the correctly rounded float32 one)."""
    states = torch.randint(0, 1 << 32, (1 << 20,),
                           generator=torch.Generator().manual_seed(10))
    states = states.to(cuda)
    _, x = rng.uniform(states)
    _, dist = rng.exponential(states, 40.0)
    want = ((-torch.log(torch.clamp(x, min=1e-38))).double() / 40.0).float()
    assert torch.equal(dist, want)
    assert torch.equal(sampling.pixel_ndc(48, 48, cuda).cpu(),
                       sampling.pixel_ndc(48, 48))


@pytest.mark.parametrize("params", [
    # anisotropy 0 takes the sphere-sample branch (one draw fewer)
    mcm.Params(extinction=30.0, anisotropy=0.0, steps=8),
    # depth of field and a bounce cap that binds
    mcm.Params(extinction=30.0, anisotropy=-0.5, blur=0.02, max_bounces=1,
               steps=16),
], ids=["isotropic", "blur-capped"])
def test_event_kernel_parameters(cuda, params):
    scene = make_scene(volume.sphere_volume(16, device=cuda),
                       transfer.gray_ramp(device=cuda), device=cuda)
    state = mcm.reset(params, 32, 32, scene)
    plain = {k: v.clone() for k, v in state.items()}
    mcm.render_frame(state, scene, params, 0.7)
    _plain_frame(plain, scene, params, 0.7)
    torch.cuda.synchronize()
    assert_frames_agree(state, plain)


def test_event_kernel_width_cap(cuda):
    """The TF row fills most of the event kernel's shared memory:
    MAX_WIDTH texels launch, one more raises before the launch."""
    scene = make_scene(volume.sphere_volume(8, device=cuda),
                       transfer.gray_ramp(device=cuda), device=cuda)
    params = mcm.Params(steps=2)
    row = scene.transfer_1d
    full = row[torch.arange(tf1d.MAX_WIDTH, device=cuda)
               * row.shape[0] // tf1d.MAX_WIDTH]
    state = mcm.reset(params, 8, 8, scene)
    mcm.render_frame(state, dataclasses.replace(scene, transfer_1d=full),
                     params, 0.1)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in state.values())
    wide = torch.zeros(tf1d.MAX_WIDTH + 1, 4, device=cuda)
    with pytest.raises(ValueError):
        mcm.render_frame(state, dataclasses.replace(scene, transfer_1d=wide),
                         params, 0.1)


def test_event_kernel_refuses_what_it_does_not_take(cuda):
    """An unpacked scene (``pack=False``) carries the float32 corner tables
    that ``make_scene`` gives every scene on the card: its frame launches
    K5 and equals the plain frame.  A hand-built scene without tables
    raises; nothing falls back to the plain loop."""
    params = mcm.Params()
    scene = make_scene(volume.sphere_volume(8, device=cuda),
                       transfer.gray_ramp(device=cuda), pack=False,
                       device=cuda)
    assert scene.kernel_tables and scene.volume_packed.dtype == torch.float32
    state, plain = _kernel_and_plain(scene, params, 8, 8, 1)
    assert_frames_agree(state, plain)
    bare = _tableless(cuda)
    state = mcm.reset(params, 8, 8, bare)
    before = _launches()
    with pytest.raises(NotImplementedError):
        mcm.render_frame(state, bare, params, 0.1)
    assert _launches() == before


def _maps(cuda):
    """Environment maps larger than 1×1: the smooth sky, a random map
    (every texel differs, so a wrong texel or weight shows), and a
    1024×2048 map (32 MB, read from device memory)."""
    g = torch.Generator().manual_seed(21)
    return {"sky": environment.gradient_sky(16, 32, device=cuda),
            "random": torch.rand(7, 13, 4, generator=g).to(cuda),
            "1024x2048": torch.rand(1024, 2048, 4, generator=g).to(cuda)}


@pytest.mark.parametrize("env", ["sky", "random", "1024x2048"])
@pytest.mark.parametrize("tracking", ["none", "auto"])
def test_event_kernel_environment_map_matches_plain(cuda, tracking, env):
    """K5's map instance against the plain loop on the same card: the map
    is read at an escape deposit, so the samples and bounces are those of
    the plain loop's streams and the radiance is within 1e-6."""
    scene = make_scene(volume.blobs_volume(24, seed=1, device=cuda),
                       transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                       tf_srgb=True, tracking=tracking,
                       pack_dtype=torch.bfloat16, tf_mxu=True,
                       environment=_maps(cuda)[env], device=cuda)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state, plain = _kernel_and_plain(scene, params, 64, 64, 4)
    assert_frames_agree(state, plain)
    assert int(torch.unique(state["radiance"][..., 0]).numel()) > 64


def _grid_scene(cuda, dtype=None, environment_map=None, **kw):
    return make_scene(volume.blobs_volume(32, seed=1, device=cuda),
                      transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                      tf_srgb=True, pack_dtype=dtype, tf_mxu=dtype is not None,
                      environment=environment_map, device=cuda, **kw)


@pytest.mark.parametrize("grid", [{"tracking": "grid"},
                                  {"majorant_grid": 8}],
                         ids=["grid16", "grid8"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_event_kernel_grid_matches_plain(cuda, dtype, grid):
    """K5's majorant-grid machine against the plain grid loop on the same
    card (64², blobs 32³, steps 8, 4 frames), float32 and bf16 tables;
    the frames go through hops and collisions, deposits and scatters."""
    scene = _grid_scene(cuda, dtype, **grid)
    assert scene.majorant is not None and scene.tracking_packed is None
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state, plain = _kernel_and_plain(scene, params, 64, 64, 4)
    assert "cheb" not in state
    assert_frames_agree(state, plain)
    assert float(state["samples"].sum()) > 64 * 64
    assert float(state["bounces"].max()) > 0


def test_event_kernel_grid_with_a_map_and_a_stale_carry(cuda):
    """The grid machine with an environment map (both template choices
    at once), on a state that carries a tracking-era ``cheb``: the carry
    is left as it was, the rest agrees with the plain loop."""
    scene = _grid_scene(cuda, torch.bfloat16, _maps(cuda)["random"],
                        tracking="grid")
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=16)
    state = mcm.reset(params, 48, 80, scene)
    state["cheb"] = torch.full((48, 80), 2.0, device=cuda)
    plain = {k: v.clone() for k, v in state.items()}
    for f in range(3):
        mcm.render_frame(state, scene, params, 0.6 + 0.01 * f)
        _plain_frame(plain, scene, params, 0.6 + 0.01 * f)
    torch.cuda.synchronize()
    assert torch.equal(state["cheb"], torch.full((48, 80), 2.0,
                                                 device=cuda))
    assert_frames_agree(state, plain)


def test_event_kernel_instances_launch_shapes(cuda):
    """The headline's instance keeps its 40 registers; the grid and map
    instances fit an SM with the headline's local bytes (its stack frame,
    no spills) and not one more."""
    headline = mcm_event.occupancy(torch.bfloat16, 256)
    for grid in (False, True):
        for env_map in (False, True):
            occ = mcm_event.occupancy(torch.bfloat16, 256, grid, env_map)
            assert occ["threads_per_block"] == 128
            assert occ["blocks_per_sm"] >= 1
            assert occ["local_bytes"] == headline["local_bytes"]
    assert headline["registers"] <= 40


@pytest.mark.parametrize("env", ["sky", "random", "1024x2048"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mcs_kernel_environment_map_matches_plain(cuda, kind, env):
    """K8's map instance (the light along the scatter direction, the map
    along the view ray for misses and escapes) against the plain frame,
    3 frames; its counter instance counts the same work with or without
    a map."""
    base = _scene(kind, cuda)
    scene = dataclasses.replace(base, environment=_maps(cuda)[env])
    params = mcs.Params(extinction=8.0)
    state, plain = _kernel_frames("mcs", scene, 64, 64, 3, params)
    assert_kernel_agrees("mcs", state, plain)
    assert int(torch.unique(state[..., 0]).numel()) > 64
    counts = [torch.zeros(2, dtype=torch.int64, device=cuda)
              for _ in range(2)]
    for s, c in zip((scene, base), counts):
        mcs_frame.mcs_frame(mcs.reset(params, 64, 64, s), s, params, 0.5, 1,
                            counts=c)
    torch.cuda.synchronize()
    assert torch.equal(counts[0], counts[1])


def _clamp_scene(kind, cuda, **kw):
    """blobs 24³ under the sRGB TF (alpha 0 for the low values), so the
    boxes cut the rays; float32 or bf16 tables with ``tf_mxu``."""
    dtype = torch.bfloat16 if kind == "bf16" else None
    return make_scene(volume.blobs_volume(24, seed=7, device=cuda),
                      transfer.gray_ramp(alpha_scale=0.9, device=cuda),
                      tf_srgb=True, pack_dtype=dtype, tf_mxu=dtype is not None,
                      device=cuda, **kw)


CLAMP_PARAMS = {"eam": eam.Params(), "mip": mip.Params(),
                "depth": depth.Params(threshold=0.02), "iso": iso.Params()}


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso"])
def test_march_kernel_clamp_matches_plain(cuda, key, kind):
    """K6's clamp instance (``march_clamp``, plus the ISO box of
    ``iso_clamp_min=0.1``) against the plain clamped frames, 3 frames at
    48×80; the clamped frame differs from the unclamped one."""
    scene = _clamp_scene(kind, cuda, march_clamp=True, iso_clamp_min=0.1)
    assert scene.occupied_aabb is not None and scene.iso_aabb is not None
    params = CLAMP_PARAMS[key]
    assert len(march.clamp_boxes(key, scene, params)) \
        == (2 if key == "iso" else 1)
    state, plain = _kernel_frames(key, scene, 48, 80, 3, params)
    assert_kernel_agrees(key, state, plain)
    bare = dataclasses.replace(scene, occupied_aabb=None, iso_aabb=None)
    unclamped, _ = _kernel_frames(key, bare, 48, 80, 3, params)
    assert not torch.equal(state, unclamped)


@pytest.mark.parametrize("isovalue,boxes", [(0.05, 0), (0.5, 1)])
def test_march_kernel_iso_box_by_isovalue(cuda, isovalue, boxes):
    """``iso_clamp_min=0.1`` alone: at isovalue 0.05 the box does not hold
    and the kernel runs the headline's instance, at 0.5 it clamps; both
    equal the plain frames."""
    scene = _clamp_scene("bf16", cuda, iso_clamp_min=0.1)
    params = iso.Params(isovalue=isovalue)
    assert len(march.clamp_boxes("iso", scene, params)) == boxes
    state, plain = _kernel_frames("iso", scene, 64, 64, 2, params)
    assert_kernel_agrees("iso", state, plain)
    assert bool((state[..., 3] > 0).any())


def test_march_kernel_clamp_launch_shapes(cuda):
    """The clamp instances fit an SM in every mode with the local bytes of
    the unclamped instances (ISO's bf16 instances have a 16-byte stack
    frame either way, no spills), which keep their residency."""
    for mode in march.MODES:
        for dtype in (torch.float32, torch.bfloat16):
            occ = march.occupancy(mode, dtype, 256, 2, clamp=True)
            bare = march.occupancy(mode, dtype, 256, 2)
            assert occ["blocks_per_sm"] >= 1
            assert occ["local_bytes"] == bare["local_bytes"]
            assert bare["blocks_per_sm"] >= 6


@pytest.mark.parametrize("lanes", [128, 5])
def test_gather_rows_kernel_equals_plain(cuda, lanes):
    """A gather moves values: equal, on the vector (lanes % 4 == 0) and
    the scalar path; an index outside the table gives a NaN row."""
    g = torch.Generator().manual_seed(5)
    table = torch.randn(1 << 12, lanes, generator=g).to(cuda)
    idx = torch.randint(0, 1 << 12, (3000,), generator=g).to(cuda)
    before = corner_gather.LAUNCHES
    got = corner_gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert corner_gather.LAUNCHES == before + 1
    assert torch.equal(got, corner_gather.gather_rows_plain(table, idx))
    bad = corner_gather.gather_rows(table, torch.tensor([-1, 1 << 12],
                                                        device=cuda))
    assert bool(torch.isnan(bad).all())


@pytest.mark.parametrize("save", [False, True], ids=["value", "save"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 2])
def test_corner_fetch_kernel_bitwise(cuda, channels, dtype, save):
    """The fetch computes the cells and fractions and runs the plain
    chain's float32 operations in its order without contraction: equal to
    the plain version on the same card, for float32 and bfloat16 rows,
    NaN and out-of-range positions included; the saved cells and
    fractions equal ``corner_cells``."""
    g = torch.Generator().manual_seed(6)
    vol = torch.rand(20, 24, 28, channels, generator=g).to(cuda)
    shape = tuple(vol.shape)
    table = sampling.pack_corner_volume(vol).to(dtype)
    pos = (torch.rand(100_000, 3, generator=g) * 1.4 - 0.2).to(cuda)
    pos[:3] = torch.tensor([[float("nan"), 0.5, 0.5], [0.5, float("inf"),
                            -float("inf")], [0.0, 1.0, 0.5 / 20]])
    before = corner_gather.LAUNCHES
    got = corner_gather.corner_fetch(table, shape, pos, save=save)
    want = corner_gather.corner_fetch_plain(table, shape, pos, save=save)
    torch.cuda.synchronize()
    assert corner_gather.LAUNCHES == before + 1
    if not save:
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            assert torch.equal(a.isnan(), b.isnan())
            a, b = a.nan_to_num(), b.nan_to_num()
        assert torch.equal(a, b)
    assert bool(got[0][0].isnan().all()) and not got[0][1:].isnan().any()
    if save:
        cells, f = sampling.corner_cells(pos, shape)
        assert torch.equal(got[1], cells)
        assert torch.equal(got[2].nan_to_num(), f.nan_to_num())
    if dtype == torch.float32:
        assert torch.equal(got[0][1:], sampling.sample_volume(vol, pos)[1:])


def test_differentiable_fetch_is_one_launch(cuda):
    """One differentiable ``sample_volume_packed`` call on the card runs
    exactly one kernel, the corner fetch, and copies nothing from the
    host (no per-call tensor from Python values, so no stream wait); the
    differentiable TF fetch copies nothing from the host either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(13)
    shape = (32, 32, 32, 1)
    table = sampling.pack_corner_volume(
        torch.rand(shape, generator=g).to(cuda)).requires_grad_(True)
    pos = torch.rand(64, 64, 3, generator=g).to(cuda)
    tf = torch.rand(4, 64, 4, generator=g).to(cuda)
    tf_packed = sampling.pack_corner_texture2d(tf).requires_grad_(True)

    def fetch():
        return sampling.sample_volume_packed(table, shape, pos)

    def tf_fetch():
        uv = torch.stack([pos[..., 0], torch.zeros_like(pos[..., 0])], -1)
        return sampling.sample_texture2d_packed(tf_packed, tuple(tf.shape),
                                                uv)

    for fn in (fetch, tf_fetch):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        assert out.grad_fn is not None
        events = prof.events()
        assert not [e.name for e in events if "HtoD" in e.name]
        assert not [e.name for e in events
                    if e.name == "cudaStreamSynchronize"]
        if fn is fetch:
            kernels = [e.name for e in events
                       if e.device_type == DeviceType.CUDA
                       and not e.name.startswith(("Memcpy", "Memset"))]
            assert len(kernels) == 1 and "corner_fetch" in kernels[0], \
                kernels


def test_no_grad_scene_fetch_launches_the_kernels(cuda):
    """Without autograd a ``kernels=True`` scene's ``sample_color``
    launches K3 and K1 once each, f32 and bf16 tables, and agrees with
    the same scene's plain samplers."""
    for dtype in (None, torch.bfloat16):
        scene = make_scene(volume.blobs_volume(16, seed=2, device=cuda),
                           transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                           pack_dtype=dtype, device=cuda)
        pos = torch.rand(40, 50, 3, generator=torch.Generator().manual_seed(
            14)).to(cuda)
        before = (corner_gather.LAUNCHES, tf1d.LAUNCHES)
        with torch.no_grad():
            got = scene.sample_color(pos)
        assert (corner_gather.LAUNCHES, tf1d.LAUNCHES) == (before[0] + 1,
                                                           before[1] + 1)
        want = dataclasses.replace(scene, kernels=False).sample_color(pos)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, rtol=0, atol=1e-6)


def _order_bound(counts, abs_sums):
    """|a - b| for two float32 sums of the same terms in different orders:
    each lies within (n - 1)·2^-24·Σ|x| of the exact sum of its n terms."""
    return 2.0 * counts * 2.0 ** -24 * abs_sums


def test_scatter_kernels_match_plain(cuda):
    """Atomics add in a varying order, so the kernels agree with the plain
    versions within the bound of reordering each sum; every index is drawn
    from 300 rows (~110 updates a row)."""
    g = torch.Generator().manual_seed(7)
    table = torch.randn(1 << 10, 128, generator=g).to(cuda)
    idx = (torch.randint(0, 300, (1 << 15,), generator=g) * 53).to(cuda)
    ct = torch.randn(1 << 15, 8, generator=g).to(cuda)
    got = corner_scatter.scatter_add_rows8(table.clone(), idx, ct)
    want = corner_scatter.scatter_add_rows8_plain(table.clone(), idx, ct)
    counts = torch.bincount(idx, minlength=1 << 14)[:, None] + 1
    abs_sums = corner_scatter.scatter_add_rows8_plain(table.abs(), idx,
                                                      ct.abs())
    torch.cuda.synchronize()
    assert bool(((got - want).view(-1, 8).abs()
                 <= _order_bound(counts, abs_sums.view(-1, 8))).all())

    f = torch.rand(1 << 15, 3, generator=g).to(cuda)
    cc = torch.randn(1 << 15, 1, generator=g).to(cuda)
    cells = idx % 4096
    got = corner_scatter.corner_grad(cells, f, cc, 4096, 1)
    want = corner_scatter.corner_grad_plain(cells, f, cc, 4096, 1)
    bound = _order_bound(torch.bincount(cells, minlength=4096)[:, None],
                         corner_scatter.corner_grad_plain(cells, f, cc.abs(),
                                                          4096, 1))
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= bound).all())


def test_corner_grad_bucket_kernel_matches_plain(cuda):
    """K4's bucket instance: rows [r0, r1) of the table's gradient from
    every entry (cells of other rows and -1 cells skipped), against
    ``corner_grad_bucket_plain`` within the reordering bound, one
    ``BUCKET_LAUNCHES`` a call and no ``LAUNCHES``; the ranges stacked
    cover ``corner_grad``'s whole gradient within the same bound."""
    g = torch.Generator().manual_seed(17)
    rows, c, n = 4096, 2, 1 << 16
    cells = (torch.randint(-1, 300, (n,), generator=g) * 13).clamp(
        min=-1).to(cuda)
    f = torch.rand(n, 3, generator=g).to(cuda)
    ct = torch.randn(n, c, generator=g).to(cuda)
    counts = torch.bincount(cells.clamp(min=0), minlength=rows)[:, None]
    abs_sums = corner_scatter.corner_grad_plain(cells, f, ct.abs(), rows, c)
    bound = _order_bound(counts, abs_sums)
    before = (corner_scatter.LAUNCHES, corner_scatter.BUCKET_LAUNCHES)
    cuts = [0, 1000, 1001, 2600, rows]
    parts = []
    for r0, r1 in zip(cuts, cuts[1:]):
        got = corner_scatter.corner_grad_bucket(cells, f, ct, r0, r1, c)
        want = corner_scatter.corner_grad_bucket_plain(cells, f, ct, r0, r1,
                                                       c)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (r1 - r0, 8 * c)
        assert bool(((got - want).abs() <= bound[r0:r1]).all())
        parts.append(got)
    assert (corner_scatter.LAUNCHES, corner_scatter.BUCKET_LAUNCHES) == (
        before[0], before[1] + len(cuts) - 1)
    whole = corner_scatter.corner_grad(cells, f, ct, rows, c)
    torch.cuda.synchronize()
    assert bool(((torch.cat(parts) - whole).abs() <= 2 * bound).all())


def _corner_grad_agrees(cells, f, ct, r0, r1, c, rows):
    """K4's bucket instance over rows [r0, r1) against
    ``corner_grad_bucket_plain``, and where the range is the whole table
    ``corner_grad`` against ``corner_grad_plain``, within the reordering
    bound; one ``BUCKET_LAUNCHES`` or one ``LAUNCHES`` a call, as
    before."""
    inside = (cells >= r0) & (cells < r1)
    bound = _order_bound(
        torch.bincount(cells[inside] - r0, minlength=r1 - r0)[:, None],
        corner_scatter.corner_grad_bucket_plain(cells, f, ct.abs(), r0, r1,
                                                c))
    before = (corner_scatter.LAUNCHES, corner_scatter.BUCKET_LAUNCHES)
    got = corner_scatter.corner_grad_bucket(cells, f, ct, r0, r1, c)
    want = corner_scatter.corner_grad_bucket_plain(cells, f, ct, r0, r1, c)
    torch.cuda.synchronize()
    assert (corner_scatter.LAUNCHES, corner_scatter.BUCKET_LAUNCHES) == (
        before[0], before[1] + 1)
    assert got.shape == want.shape == (r1 - r0, 8 * c)
    assert bool(((got - want).abs() <= bound).all())
    if (r0, r1) == (0, rows):
        got = corner_scatter.corner_grad(cells, f, ct, rows, c)
        want = corner_scatter.corner_grad_plain(cells, f, ct, rows, c)
        torch.cuda.synchronize()
        assert (corner_scatter.LAUNCHES, corner_scatter.BUCKET_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert bool(((got - want).abs() <= bound).all())
    return want


def _grad_inputs(cells, c, seed):
    g = torch.Generator().manual_seed(seed)
    n = cells.numel()
    return (cells.to("cuda"), torch.rand(n, 3, generator=g).to("cuda"),
            torch.randn(n, c, generator=g).to("cuda"))


@pytest.mark.parametrize("c", [1, 2])
def test_corner_grad_heavy_contention(cuda, c):
    """2^20 entries on 16 rows: every chunk's entries sum into a few
    slots of the block's table (~65 000 updates a row)."""
    g = torch.Generator().manual_seed(31)
    rows = 4096
    cells = torch.randint(0, 16, (1 << 20,), generator=g) * 251
    cells, f, ct = _grad_inputs(cells, c, 32)
    want = _corner_grad_agrees(cells, f, ct, 0, rows, c, rows)
    assert float(want.abs().max()) > 1
    _corner_grad_agrees(cells, f, ct, 1000, 3000, c, rows)


@pytest.mark.parametrize("c", [1, 2])
def test_corner_grad_rows_past_the_table(cuda, c):
    """More distinct rows in a chunk than a block's table holds: enough
    entries that every resident block takes a whole chunk
    (``occupancy``'s chunk entries a block), each a distinct row, more
    than the table's slots, so the rows that find no slot add directly;
    in order and shuffled."""
    shape = corner_scatter.occupancy(c)
    chunk, slots = shape["chunk_entries"], shape["table_slots"]
    assert chunk > slots and shape["blocks_per_sm"] >= 1
    n = shape["blocks_per_sm"] * shape["sms"] * chunk
    rows = 1 << 22
    g = torch.Generator().manual_seed(33)
    for cells in (torch.arange(n) * 3, torch.randperm(rows, generator=g)[:n]):
        cells, f, ct = _grad_inputs(cells, c, 34)
        _corner_grad_agrees(cells, f, ct, 0, rows, c, rows)
        _corner_grad_agrees(cells, f, ct, 5000, 3000000, c, rows)


@pytest.mark.parametrize("c", [1, 2])
def test_corner_grad_skips_masked_and_other_rows(cuda, c):
    """-1 cells (masked slab samples) and cells of other buckets add
    nothing; a bucket that no entry reaches is zero."""
    g = torch.Generator().manual_seed(35)
    rows = 8192
    cells = torch.randint(-1, 600, (300000,), generator=g) * 13
    cells[cells < 0] = -1
    cells, f, ct = _grad_inputs(cells, c, 36)
    for r0, r1 in ((0, rows), (0, 1000), (1000, 2600), (2600, rows)):
        _corner_grad_agrees(cells, f, ct, r0, r1, c, rows)
    assert not bool(_corner_grad_agrees(cells, f, ct, 7801, 7806, c,
                                        rows).any())


@pytest.mark.parametrize("c", [1, 2])
def test_corner_grad_edge_sizes(cuda, c):
    """One entry, entries not a multiple of the chunk (so the last chunk
    is ragged: a chunk is 128 to 512 entries, by the call's size), and an
    empty range; a channel count the kernel has no instance for raises."""
    g = torch.Generator().manual_seed(37)
    rows = 1000
    chunk = corner_scatter.occupancy(c)["chunk_entries"]
    for n in (1, 127, 129, chunk + 1, 5 * chunk + 77, 900 * chunk + 33):
        cells = torch.randint(0, rows, (n,), generator=g)
        cells, f, ct = _grad_inputs(cells, c, 38 + n)
        _corner_grad_agrees(cells, f, ct, 0, rows, c, rows)
        _corner_grad_agrees(cells, f, ct, 200, 800, c, rows)
        _corner_grad_agrees(cells, f, ct, 500, 500, c, rows)
    with pytest.raises(ValueError, match="1 or 2 channels"):
        corner_scatter.corner_grad(cells, f[:, :3], torch.zeros(
            cells.numel(), 3, device=cuda), rows, 3)


def test_bucketed_gradient_matches_monolithic(cuda):
    """``overlap.value_and_grad_bucketed`` on the card: 4 launches of K4's
    bucket instance and none of the whole-table K4 a step, one K3 a fetch
    as the monolithic step; the voxel gradient within the reordering bound
    of the monolithic one's terms (a fetch of 65536 positions weighted at
    random from a 32³ volume), then an EAM loss's within 5e-5."""
    from vpt_tpu_torch.parallel import overlap

    g = torch.Generator().manual_seed(18)
    vol = torch.rand(32, 32, 32, 1, generator=g).to(cuda)
    shape = tuple(vol.shape)
    pos = (torch.rand(65536, 3, generator=g) * 1.2 - 0.1).to(cuda)
    w = torch.randn(65536, 1, generator=g).to(cuda)

    def loss_of_volume(v):
        return (sampling.sample_volume_packed(sampling.pack_fit_table(v),
                                              shape, pos) * w).sum()

    leaf = vol.clone().requires_grad_(True)
    whole, = torch.autograd.grad(loss_of_volume(leaf), leaf)
    before = (corner_gather.LAUNCHES, corner_scatter.LAUNCHES,
              corner_scatter.BUCKET_LAUNCHES)
    _, grads = overlap.value_and_grad_bucketed(
        loss_of_volume, overlap.split_volume(vol, 4))
    torch.cuda.synchronize()
    assert (corner_gather.LAUNCHES - before[0],
            corner_scatter.LAUNCHES - before[1],
            corner_scatter.BUCKET_LAUNCHES - before[2]) == (1, 0, 4)
    cells, f = sampling.corner_cells(pos, shape)
    rows = 32 ** 3
    terms = torch.bincount(cells, minlength=rows)[:, None].expand(
        rows, 8).float().contiguous()
    counts = sampling.fold_corner_grad(terms, 32, 32, 32, True) + 8
    abs_sums = sampling.fold_corner_grad(corner_scatter.corner_grad_plain(
        cells, f, w.abs(), rows, 1), 32, 32, 32, True)
    got = torch.cat(grads)
    assert float(whole.abs().max()) > 0
    assert bool(((got - whole).abs()
                 <= _order_bound(counts, abs_sums)).all())

    tf = transfer.gray_ramp(alpha_scale=1.0, device=cuda)
    scene = make_scene(volume.blobs_volume(16, seed=2, device=cuda), tf,
                       device=cuda)
    cams = (scene.mvp_inverse, scene.model_view, scene.projection)
    ep = eam.Params(slices=16, random=False)

    def eam_loss(v):
        return torch.sum(train.render_eam(v, tf, cams, ep, np.float32(0.0),
                                          32, 32)[..., :3] ** 2)

    leaf = scene.volume.clone().requires_grad_(True)
    whole, = torch.autograd.grad(eam_loss(leaf), leaf)
    before = (corner_gather.LAUNCHES, corner_scatter.BUCKET_LAUNCHES)
    _, grads = overlap.value_and_grad_bucketed(
        eam_loss, overlap.split_volume(scene.volume, 4))
    torch.cuda.synchronize()
    assert (corner_gather.LAUNCHES - before[0],
            corner_scatter.BUCKET_LAUNCHES - before[1]) == (2, 4)
    assert float(whole.abs().max()) > 1e-3
    assert float((torch.cat(grads) - whole).abs().max()) <= 5e-5


def test_fetch_gradient_matches_plain_autograd(cuda):
    """CornerFetch (K3 forward, K4 backward) against the plain gather and
    lerp under autograd, whose backward is the index scatter-add: values
    equal, table gradients allclose."""
    g = torch.Generator().manual_seed(8)
    vol = torch.rand(32, 32, 32, 1, generator=g).to(cuda)
    pos = torch.rand(65536, 3, generator=g).to(cuda)
    w = torch.randn(65536, 1, generator=g).to(cuda)
    grads, values = [], []
    for fused in (True, False):
        table = sampling.pack_corner_volume(vol).requires_grad_(True)
        out = sampling.sample_volume_packed(table, (32, 32, 32, 1), pos,
                                            fused=fused)
        (out * w).sum().backward()
        grads.append(table.grad)
        values.append(out.detach())
    torch.cuda.synchronize()
    assert torch.equal(values[0], values[1])
    assert torch.allclose(grads[0], grads[1], rtol=0, atol=1e-5)


def test_fit_value_and_grad_kernels_match_plain(cuda):
    """One value-and-grad of the fit's loss, kernels against the plain
    versions on the card (Scene.kernels=False), 32², blobs 16³: the fetch
    is bit for bit, so the loss agrees to rounding of the backward alone;
    the volume gradients to a relative L2 error of 1e-4."""
    scene = make_scene(volume.blobs_volume(16, seed=1, device=cuda),
                       transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                       device=cuda)
    params = mcm.Params(extinction=10.0, anisotropy=0.3, steps=8)
    target = torch.rand(32, 32, 3, generator=torch.Generator().manual_seed(
        9)).to(cuda)
    out = []
    for kernels in (True, False):
        vol = torch.full((16, 16, 16, 1), 0.3, device=cuda,
                         requires_grad=True)
        before = (corner_gather.LAUNCHES, corner_scatter.LAUNCHES)
        loss = train.mc_loss({"volume": vol},
                             dataclasses.replace(scene, kernels=kernels),
                             target, params, 2, 0.1)
        loss.backward()
        launched = (corner_gather.LAUNCHES - before[0],
                    corner_scatter.LAUNCHES - before[1])
        assert launched == ((16, 16) if kernels else (0, 0))
        out.append((loss.item(), vol.grad))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert bool(torch.isfinite(g0).all()) and float(g0.abs().max()) > 0
    assert float((g0 - g1).norm() / g1.norm()) <= 1e-4


# -- the march (K6), ISO shade (K7) and MCS (K8) kernels ------------------

RENDERERS = {"eam": eam, "mip": mip, "depth": depth, "iso": iso, "mcs": mcs}


def _scene(kind, cuda):
    """float32 tables (blobs 24³), or the headline's: bf16 tables, the
    bf16-weight TF lookup, the sRGB TF and a cheb-skip table."""
    if kind == "f32":
        return make_scene(volume.blobs_volume(24, seed=3, device=cuda),
                          transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                          device=cuda)
    return _headline_scene(24, cuda)


def _kernel_frames(key, scene, height, width, frames, params=None):
    """``frames`` frames of renderer ``key`` through its kernel and
    through the plain version on the scene with ``kernels=False``, from
    one reset state; the plain frames launch no kernel."""
    module = RENDERERS[key]
    params = params or module.Params()
    state = module.reset(params, height, width, scene)
    plain = state.clone()
    counter = mcs_frame if key == "mcs" else march
    before = counter.LAUNCHES
    for n in range(1, frames + 1):
        module.render_frame(state, scene, params, 0.3 + 0.01 * n, n)
        launched = _launches()
        if key == "mcs":
            mcs_frame.mcs_frame_plain(plain, scene, params, 0.3 + 0.01 * n,
                                      n)
        else:
            march.march_frame_plain(key, plain, scene, params,
                                    0.3 + 0.01 * n, n)
        assert _launches() == launched
    torch.cuda.synchronize()
    assert counter.LAUNCHES == before + frames
    return state, plain


def assert_kernel_agrees(key, state, plain):
    """The kernels run the plain frames' float32 operations without
    contraction: at least 99.99% of the values within 1e-6 (EAM, MIP,
    MCS), and equal where the output is a hit position or a depth (ISO,
    Depth)."""
    assert bool(torch.isfinite(state).all())
    if key in ("iso", "depth"):
        assert torch.equal(state, plain)
        return
    close = ((state - plain).abs() <= 1e-6).float().mean().item()
    assert close >= 0.9999, close


@pytest.mark.parametrize("height,width", [(64, 64), (48, 80)],
                         ids=["64x64", "48x80"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso", "mcs"])
def test_frame_kernels_match_plain(cuda, key, kind, height, width):
    """K6 in each mode and K8 against the renderers' plain frames on the
    same card, 3 frames (the integrate's replace, then its mean, max or
    nearer hit), one launch a frame."""
    scene = _scene(kind, cuda)
    params = mcs.Params(extinction=8.0) if key == "mcs" else None
    state, plain = _kernel_frames(key, scene, height, width, 3, params)
    assert_kernel_agrees(key, state, plain)
    if key == "iso":
        assert bool((state[..., 3] > 0).any())


@pytest.mark.parametrize("height,width", [(64, 64), (48, 80)],
                         ids=["64x64", "48x80"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_iso_shade_kernel_matches_plain(cuda, kind, height, width):
    """K7 on an ISO state with hits and misses: equal to the plain
    shade, one launch a display."""
    scene = _scene(kind, cuda)
    state, _ = _kernel_frames("iso", scene, height, width, 2)
    before = iso_shade.LAUNCHES
    got = iso.display(state, scene, iso.Params())
    want = iso_shade.iso_shade_plain(state, scene, iso.Params())
    torch.cuda.synchronize()
    assert iso_shade.LAUNCHES == before + 1
    hit = state[..., 3] > 0
    assert bool(hit.any()) and bool((~hit).any())
    assert torch.equal(got, want)


def _assert_shade_equals_plain(state, scene, params=None):
    """K7's display of ``state`` is the plain shade's on the same card,
    one launch."""
    params = params or iso.Params()
    before = iso_shade.LAUNCHES
    got = iso.display(state, scene, params)
    want = iso_shade.iso_shade_plain(state, scene, params)
    torch.cuda.synchronize()
    assert iso_shade.LAUNCHES == before + 1
    assert got.shape == state.shape and got.data_ptr() != state.data_ptr()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("mxu", [None, torch.float32, torch.bfloat16],
                         ids=["bilinear", "mxu-f32", "mxu-bf16"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_iso_shade_kernel_in_every_tf_mode(cuda, kind, mxu):
    """Each table type in each TF lookup mode (an instantiation each),
    with hits and misses."""
    scene = dataclasses.replace(_scene(kind, cuda), tf_mxu=mxu)
    state, _ = _kernel_frames("iso", scene, 48, 80, 2)
    hit = state[..., 3] > 0
    assert bool(hit.any()) and bool((~hit).any())
    _assert_shade_equals_plain(state, scene)


@pytest.mark.parametrize("height,width", [(1, 1), (37, 53), (512, 1)],
                         ids=["1x1", "37x53", "512x1"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_iso_shade_kernel_off_the_blocks(cuda, kind, height, width):
    """Images that are no whole number of 128-pixel blocks: the threads
    past the end write nothing, every pixel is the plain shade's."""
    scene = _scene(kind, cuda)
    state, _ = _kernel_frames("iso", scene, height, width, 2)
    _assert_shade_equals_plain(state, scene)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_iso_shade_kernel_all_miss_and_all_hit(cuda, kind):
    """A state without a hit is white; a state where every pixel hit, at
    positions all over the cube and on its faces (seeded), is shaded in
    every pixel as the plain shade does, at a light and h of its own."""
    scene = _scene(kind, cuda)
    miss = torch.full((40, 56, 4), -1.0, device=cuda)
    assert torch.equal(_assert_shade_equals_plain(miss, scene),
                       torch.ones_like(miss))
    g = torch.Generator().manual_seed(21)
    pos = torch.rand(40, 56, 3, generator=g) * 1.1 - 0.05
    pos[0, :8] = torch.tensor([0.0, 1.0, 0.5])
    state = torch.cat([pos, torch.full((40, 56, 1), 0.5)], -1).to(cuda)
    params = iso.Params(light=(-1.0, 4.0, 0.5), gradient_step=0.013)
    got = _assert_shade_equals_plain(state, scene, params)
    assert not torch.equal(got[..., :3], torch.ones_like(got[..., :3]))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_iso_shade_kernel_at_the_widest_tf_row(cuda, kind):
    """A TF row of tf1d.MAX_WIDTH texels, read through the read-only
    cache."""
    base = _scene(kind, cuda)
    scene = dataclasses.replace(base, transfer_1d=transfer.gray_ramp(
        width=tf1d.MAX_WIDTH, alpha_scale=0.8, device=cuda)[0])
    assert scene.transfer_1d.shape == (tf1d.MAX_WIDTH, 4)
    state, _ = _kernel_frames("iso", scene, 48, 80, 2)
    assert bool((state[..., 3] > 0).any())
    _assert_shade_equals_plain(state, scene)


def test_iso_shade_kernel_refuses_what_it_does_not_take(cuda):
    """States of another shape, type, device, layout or alignment raise
    before any launch, as does a scene on another device; nothing falls
    back to the plain shade."""
    scene = _scene("f32", cuda)
    good = torch.full((8, 8, 4), -1.0, device=cuda)
    before = _launches()
    for state in (torch.zeros(8, 8, 3, device=cuda),
                  torch.zeros(8, 8, 4, dtype=torch.float64, device=cuda),
                  torch.zeros(8, 4, 8, device=cuda).transpose(1, 2),
                  torch.zeros(8 * 8 * 4 + 1, device=cuda)[1:].view(8, 8, 4)):
        with pytest.raises(ValueError):
            iso.display(state, scene, iso.Params())
    cpu_scene = make_scene(volume.sphere_volume(8, device="cpu"),
                           transfer.gray_ramp(device="cpu"), device="cpu")
    with pytest.raises(ValueError):
        iso.display(good, cpu_scene, iso.Params())
    assert _launches() == before


def test_iso_shade_argument_list_agrees(cuda):
    """vpt_iso_shade, the argument list every build since the port
    exports (bench_mcm_event.py drives it), writes what the prepared
    launch writes."""
    import bench_mcm_event

    scene = _scene("bf16", cuda)
    state, _ = _kernel_frames("iso", scene, 40, 56, 2)
    want = iso.display(state, scene, iso.Params())
    got = torch.empty_like(state)
    _build.check("vpt_iso_shade", _build.library().vpt_iso_shade(
        *bench_mcm_event.iso_args(state, got, scene, iso.Params())))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_march_kernel_eam_modes_on_a_random_schedule(cuda):
    """EAM with a fixed schedule (random=False) and a short one (8
    slices), and Depth with a jittered one: the kernel's exits follow the
    plain masks."""
    scene = _scene("bf16", cuda)
    for key, params in (("eam", eam.Params(slices=8, random=False)),
                        ("eam", eam.Params(extinction=20.0)),
                        ("depth", depth.Params(random=True,
                                               threshold=0.5))):
        state, plain = _kernel_frames(key, scene, 40, 40, 2, params)
        assert_kernel_agrees(key, state, plain)


@pytest.mark.parametrize("key", ["eam", "iso", "mcs"])
def test_frame_kernels_follow_the_current_stream(cuda, key):
    """Under ``torch.cuda.stream(s)`` the launch goes to ``s``: the state
    is written on ``s`` behind a ~10 ms sleep, so a launch on another
    stream would read it before it exists."""
    scene = _scene("f32", cuda)
    module = RENDERERS[key]
    params = module.Params()
    reset = module.reset(params, 64, 64, scene)
    plain = reset.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        state = reset * 1.0
        module.render_frame(state, scene, params, 0.4, 1)
        shaded = iso.display(state, scene, params) if key == "iso" else None
    side.synchronize()
    if key == "mcs":
        mcs_frame.mcs_frame_plain(plain, scene, params, 0.4, 1)
    else:
        march.march_frame_plain(key, plain, scene, params, 0.4, 1)
    torch.cuda.synchronize()
    assert_kernel_agrees(key, state, plain)
    if key == "iso":
        assert torch.equal(shaded, iso_shade.iso_shade_plain(plain, scene,
                                                             params))


def _tableless(cuda):
    """A hand-built scene without corner tables: ``make_scene`` gives
    every scene on the card its tables, a ``pack=False`` one included."""
    scene = make_scene(volume.sphere_volume(8, device=cuda),
                       transfer.gray_ramp(device=cuda), pack=False,
                       device=cuda)
    return dataclasses.replace(scene, volume_packed=None,
                               transfer_packed=None, kernel_tables=False)


def test_frame_kernels_refuse_what_they_do_not_take(cuda):
    """Scenes without corner tables (all three kernels; since
    ``pack=False`` scenes on the card carry them, a hand-built one) and
    states of another shape or device raise; nothing falls back to the
    plain versions."""
    unpacked = _tableless(cuda)
    before = _launches()
    for key in ("eam", "mip", "depth", "iso", "mcs"):
        module = RENDERERS[key]
        state = module.reset(module.Params(), 8, 8, unpacked)
        with pytest.raises(NotImplementedError):
            module.render_frame(state, unpacked, module.Params(), 0.1, 1)
    with pytest.raises(NotImplementedError):
        iso.display(torch.full((8, 8, 4), 0.5, device=cuda), unpacked,
                    iso.Params())
    scene = _scene("f32", cuda)
    with pytest.raises(ValueError):
        eam.render_frame(torch.zeros(8, 8, device=cuda), scene,
                         eam.Params(), 0.1, 1)
    with pytest.raises(ValueError):
        mip.render_frame(torch.zeros(8, 8, dtype=torch.float64,
                                     device=cuda), scene, mip.Params(),
                         0.1, 1)
    assert _launches() == before


@pytest.mark.parametrize("height,width", [(1, 1), (47, 33), (512, 1),
                                          (1, 512)],
                         ids=["1x1", "33x47", "1x512", "512x1"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso", "mcs"])
def test_frame_kernels_match_plain_off_the_tiles(cuda, key, kind, height,
                                                 width):
    """K6 in each mode and K8 on images that are no whole number of their
    16×8 pixel tiles: the threads past the edge write nothing, every pixel
    equals the plain frame's."""
    scene = _scene(kind, cuda)
    params = mcs.Params(extinction=8.0) if key == "mcs" else None
    state, plain = _kernel_frames(key, scene, height, width, 2, params)
    assert_kernel_agrees(key, state, plain)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mcs_counter_leaves_the_state_alone(cuda, kind):
    """The counting instantiation of K8 writes the same state, and counts
    draws and fetches across frames."""
    scene = _scene(kind, cuda)
    params = mcs.Params(extinction=8.0)
    plain = mcs.reset(params, 40, 56, scene)
    counted = plain.clone()
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    sums = []
    for n in range(1, 4):
        mcs_frame.mcs_frame(plain, scene, params, 0.2 + 0.1 * n, n)
        mcs_frame.mcs_frame(counted, scene, params, 0.2 + 0.1 * n, n,
                            counts=counts)
        sums.append(counts.tolist())
    assert torch.equal(plain, counted)
    assert 0 < sums[0][1] <= sums[0][0] + 40 * 56
    assert sums[0][0] < sums[1][0] < sums[2][0]


def test_mcs_counter_covers_the_plain_estimate(cuda):
    """The kernel's own fetch count is at least chip_smoke.mcs_work's lower
    estimate from the plain frame's moving positions."""
    import chip_smoke

    scene = _headline_scene(24, cuda)
    params = mcs.Params(extinction=8.0)
    state = mcs.reset(params, 48, 48, scene)
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    mcs_frame.mcs_frame(state, scene, params, 0.4, 1, counts=counts)
    estimate, rows = chip_smoke.mcs_work(scene, params, 0.4, 48, 48)
    assert 0 < estimate <= int(counts[1]) and rows > 0


@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso", "mcs"])
def test_frame_kernels_argument_lists_agree(cuda, key):
    """vpt_march_frame and vpt_mcs_frame, the argument lists every build
    since the port exports (bench_mcm_event.py drives them), write what the
    wrappers' prepared launches write."""
    import bench_mcm_event

    scene = _scene("bf16", cuda)
    module = RENDERERS[key]
    params = module.Params()
    state = module.reset(params, 40, 56, scene)
    other = state.clone()
    lib = _build.library()
    for n in range(1, 3):
        module.render_frame(state, scene, params, 0.3 * n, n)
        if key == "mcs":
            err = lib.vpt_mcs_frame(*bench_mcm_event.mcs_args(
                other, scene, params, 0.3 * n, n))
        else:
            err = lib.vpt_march_frame(*bench_mcm_event.march_args(
                key, other, scene, params, 0.3 * n, n))
        _build.check(key, err)
    torch.cuda.synchronize()
    assert torch.equal(state, other)


def test_frame_kernels_launch_shapes(cuda):
    """Each K6 mode and K8 fit an SM, on one pixel tile of a block's
    threads, which ``_build.tile_pixels`` maps onto every pixel once; K7
    fits in each TF mode without spilling."""
    tiles = set()
    for dtype in (torch.float32, torch.bfloat16):
        for tf in range(3):
            occ = iso_shade.occupancy(dtype, tf)
            assert occ["threads_per_block"] == 128
            assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
            assert occ["local_bytes"] == 0
        shapes = [march.occupancy(mode, dtype, 256) for mode in march.MODES]
        shapes.append(mcs_frame.occupancy(dtype, 256))
        for occ in shapes:
            assert occ["threads_per_block"] == 128
            assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
            assert occ["tile_width"] * occ["tile_height"] == 128
            tiles.add((occ["tile_width"], occ["tile_height"],
                       occ["warp_width"]))
        assert all(occ["chunk"] >= 1 for occ in shapes[:-1])
    assert len(tiles) == 1
    x, y, inside = _build.tile_pixels(33, 47, *tiles.pop())
    assert torch.equal(torch.from_numpy(y[inside] * 33 + x[inside]).sort()[0],
                       torch.arange(33 * 47))


# -- the DOS slice kernel (K9) and the LAO march kernel (K10) --------------

MXU = [None, torch.float32, torch.bfloat16]
MXU_IDS = ["bilinear", "mxu-f32", "mxu-bf16"]


def _dos_frames(scene, params, height, width, frames):
    """``frames`` DOS frames through K9 and through the plain sweep on the
    scene with ``kernels=False`` (which launches nothing), from one reset
    state; one launch a frame."""
    state = dos.reset(params, height, width, scene)
    plain = {k: v.clone() for k, v in state.items()}
    reference = dataclasses.replace(scene, kernels=False)
    before = dos_sweep.LAUNCHES
    for n in range(1, frames + 1):
        dos.render_frame(state, scene, params, 0.1 * n, n)
        launched = _launches()
        dos_sweep.sweep_frame_plain(plain, reference, params)
        assert _launches() == launched
    torch.cuda.synchronize()
    assert dos_sweep.LAUNCHES == before + frames
    return state, plain


def assert_dos_agrees(state, plain):
    """K9 runs the plain slices' float32 operations without contraction:
    at least 99.99% of the colour and occlusion values within 1e-6; the
    depth equal."""
    for key in ("color", "occlusion"):
        assert bool(torch.isfinite(state[key]).all()), key
        close = ((state[key] - plain[key]).abs() <= 1e-6).float().mean()
        assert float(close) >= 0.9999, (key, float(close))
    assert torch.equal(state["depth"], plain["depth"])


@pytest.mark.parametrize("mxu", MXU, ids=MXU_IDS)
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dos_kernel_matches_plain(cuda, kind, mxu):
    """Each table type in each TF lookup mode, 48×80 (the width clamp of
    the y shift), 2 frames of 50 slices."""
    scene = dataclasses.replace(_scene(kind, cuda), tf_mxu=mxu)
    state, plain = _dos_frames(scene, dos.Params(), 48, 80, 2)
    assert_dos_agrees(state, plain)
    assert float(state["color"][..., 3].max()) > 0.0
    assert float(state["occlusion"].min()) < 1.0


@pytest.mark.parametrize("height,width", [(1, 1), (37, 53), (512, 1),
                                          (1, 512), (80, 48)],
                         ids=["1x1", "37x53", "512x1", "1x512", "80x48"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dos_kernel_off_the_blocks(cuda, kind, height, width):
    """Images that are no whole number of 128-pixel blocks, and tall
    ones: every pixel is the plain sweep's."""
    state, plain = _dos_frames(_scene(kind, cuda), dos.Params(), height,
                               width, 2)
    assert_dos_agrees(state, plain)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dos_kernel_odd_steps_over_the_whole_sweep(cuda, kind):
    """An odd ``steps`` (7 of 30 slices, 3 taps, a wide aperture): the
    last slice's buffer is copied back into the state's every frame, the
    sweep ends within the 6 frames, and the frames after it change
    nothing."""
    params = dos.Params(steps=7, slices=30, samples=3, aperture=50.0)
    state, plain = _dos_frames(_scene(kind, cuda), params, 40, 56, 6)
    assert_dos_agrees(state, plain)
    assert float(state["depth"]) > float(state["max_depth"])
    done = {k: v.clone() for k, v in state.items()}
    dos.render_frame(state, _scene(kind, cuda), params, 0.9, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(done[k], state[k]) for k in state)


@pytest.mark.parametrize("steps,slices,samples", [(50, 200, 8), (7, 30, 3),
                                                   (8, 30, 5), (1, 4, 8),
                                                   (9, 20, 300)],
                         ids=["default", "odd", "even-undivided", "one",
                              "rows-in-chunks"])
def test_dos_kernel_frame_by_frame(cuda, steps, slices, samples):
    """Frame by frame over the whole sweep and two frames past it (with
    300 taps a block holds 6 rows at once, so a frame builds its rows in
    chunks): one launch a frame; the kernel's table equals
    ``dos.slice_table`` of the
    state before the frame and the scalar mirror, bit for bit; the state
    keeps its occlusion tensor, which holds the plain sweep's occlusion;
    the depth is the plain one; a frame past the far depth changes
    nothing."""
    params = dos.Params(steps=steps, slices=slices, samples=samples)
    scene = _scene("bf16", cuda)
    reference = dataclasses.replace(scene, kernels=False)
    state = dos.reset(params, 40, 56, scene)
    plain = {k: v.clone() for k, v in state.items()}
    buffer = state["occlusion"]
    tan = float(dos._tan_aperture(params, cuda))
    table = torch.full((steps, dos.TABLE_HEAD + 4 * samples), float("nan"),
                       device=cuda)
    frames = -(-slices // steps) + 3
    for n in range(frames):
        want = dos.slice_table(state, scene, params)
        mirror = dos_sweep.slice_rows_plain(
            float(state["depth"]), float(state["max_depth"]),
            float(state["slice_distance"]), scene.projection.cpu(),
            state["offsets"].cpu(), tan, steps, 40, 56)
        done = {k: v.clone() for k, v in state.items()}
        before = dos_sweep.LAUNCHES
        dos_sweep.sweep_frame(state, scene, params, table)
        torch.cuda.synchronize()
        assert dos_sweep.LAUNCHES == before + 1
        assert torch.equal(table.view(torch.int32), want.view(torch.int32))
        assert torch.equal(table.cpu(), torch.from_numpy(mirror))
        assert state["occlusion"] is buffer
        dos_sweep.sweep_frame_plain(plain, reference, params)
        assert_dos_agrees(state, plain)
        if float(want[:, 1].sum()) == 0.0:
            assert all(torch.equal(done[k], state[k]) for k in state)
    assert float(state["depth"]) > float(state["max_depth"])


def test_dos_kernel_follows_the_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` the frame's launches go to ``s``,
    behind a ~10 ms sleep that precedes the state's last write."""
    scene = _scene("f32", cuda)
    params = dos.Params()
    reset = dos.reset(params, 64, 64, scene)
    plain = {k: v.clone() for k, v in reset.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        state = {k: v * 1.0 for k, v in reset.items()}
        dos.render_frame(state, scene, params, 0.4, 1)
    side.synchronize()
    dos_sweep.sweep_frame_plain(plain, scene, params)
    torch.cuda.synchronize()
    assert_dos_agrees(state, plain)


def test_dos_kernel_refuses_what_it_does_not_take(cuda):
    """Scenes without corner tables (a hand-built one), states of another
    shape, type or device and offsets of another count raise before any
    launch."""
    unpacked = _tableless(cuda)
    params = dos.Params()
    before = _launches()
    with pytest.raises(NotImplementedError):
        dos.render_frame(dos.reset(params, 8, 8, unpacked), unpacked,
                         params, 0.1, 1)
    scene = _scene("f32", cuda)
    for key, bad in (("color", torch.zeros(8, 8, 3, device=cuda)),
                     ("occlusion", torch.ones(8, 8, dtype=torch.float64,
                                              device=cuda)),
                     ("offsets", torch.zeros(3, 2, device=cuda))):
        state = dos.reset(params, 8, 8, scene)
        state[key] = bad
        with pytest.raises(ValueError):
            dos.render_frame(state, scene, params, 0.1, 1)
    cpu_scene = make_scene(volume.sphere_volume(8, device="cpu"),
                           transfer.gray_ramp(device="cpu"), device="cpu")
    with pytest.raises(ValueError):
        dos.render_frame(dos.reset(params, 8, 8, scene), cpu_scene, params,
                         0.1, 1)
    assert _launches() == before


def _lao_frame(scene, params, height, width):
    """One LAO frame through K10 and through the plain frame on the scene
    with ``kernels=False`` (which launches nothing)."""
    state = lao.reset(params, height, width, scene)
    plain = state.clone()
    before = lao_march.LAUNCHES
    lao.render_frame(state, scene, params, 0.1, 1)
    launched = _launches()
    lao_march.lao_frame_plain(plain, scene, params)
    assert _launches() == launched
    torch.cuda.synchronize()
    assert lao_march.LAUNCHES == before + 1
    return state, plain


def assert_lao_agrees(state, plain):
    """K10 runs the plain frame's float32 operations without contraction:
    at least 99.99% of the values within 1e-6."""
    assert bool(torch.isfinite(state).all())
    close = ((state - plain).abs() <= 1e-6).float().mean()
    assert float(close) >= 0.9999, float(close)


LAO_PARAMS = [lao.Params(), lao.Params(num_lao_samples=3,
                                       light_coefficient=0.7),
              lao.Params(local_ambient_occlusion=False),
              lao.Params(soft_shadows=False, lao_step_size=0.13),
              lao.Params(slices=17, extinction=40.0,
                         light_position=(-1.0, 3.0, 0.5))]


@pytest.mark.parametrize("params", LAO_PARAMS,
                         ids=["default", "samples3", "no-ao", "no-shadow",
                              "slices17"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_lao_kernel_matches_plain(cuda, kind, params):
    """Each table type, the Params that change the kernel's path, 64×64."""
    state, plain = _lao_frame(_scene(kind, cuda), params, 64, 64)
    assert_lao_agrees(state, plain)
    assert float(state[..., :3].max()) > 0.0


@pytest.mark.parametrize("mxu", MXU, ids=MXU_IDS)
def test_lao_kernel_ignores_the_tf_lookup_mode(cuda, mxu):
    """LAO's 2D TF lookup never rounds its weights: every mode gives the
    same frame, and a float32 TF table beside bf16 corner rows takes the
    mixed instantiation."""
    scene = dataclasses.replace(_scene("bf16", cuda), tf_mxu=mxu)
    state, plain = _lao_frame(scene, lao.Params(), 40, 56)
    assert_lao_agrees(state, plain)
    mixed = dataclasses.replace(
        scene, transfer_packed=scene.transfer_packed.to(torch.float32))
    state, plain = _lao_frame(mixed, lao.Params(), 40, 56)
    assert_lao_agrees(state, plain)


@pytest.mark.parametrize("height,width", [(1, 1), (37, 53), (512, 1)],
                         ids=["1x1", "37x53", "512x1"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_lao_kernel_off_the_tiles(cuda, kind, height, width):
    state, plain = _lao_frame(_scene(kind, cuda), lao.Params(), height,
                              width)
    assert_lao_agrees(state, plain)


def test_lao_kernel_follows_the_current_stream(cuda):
    scene = _scene("f32", cuda)
    params = lao.Params()
    plain = lao.reset(params, 64, 64, scene)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        state = lao.reset(params, 64, 64, scene)
        lao.render_frame(state, scene, params, 0.4, 1)
        shown = lao.display(state, scene, params)
    side.synchronize()
    lao_march.lao_frame_plain(plain, scene, params)
    torch.cuda.synchronize()
    assert_lao_agrees(shown, plain)


def test_lao_kernel_refuses_what_it_does_not_take(cuda):
    """Scenes without tables (a hand-built one), Params the scene cannot
    take and states of another shape, type or device raise."""
    unpacked = _tableless(cuda)
    params = lao.Params()
    before = _launches()
    with pytest.raises(NotImplementedError):
        lao.render_frame(lao.reset(params, 8, 8, unpacked), unpacked,
                         params, 0.1, 1)
    scene = _scene("f32", cuda)
    with pytest.raises(ValueError, match="2-channel"):
        lao.render_frame(lao.reset(params, 8, 8, scene), scene,
                         lao.Params(baked_gradient=True), 0.1, 1)
    for state in (torch.zeros(8, 8, 3, device=cuda),
                  torch.zeros(8, 8, 4, dtype=torch.float64, device=cuda),
                  torch.zeros(8, 4, 8, device=cuda).transpose(1, 2)):
        with pytest.raises(ValueError):
            lao.render_frame(state, scene, params, 0.1, 1)
    assert _launches() == before


def _plain_lane_slices(scene, params, height, width):
    """The plain frame's active pixel-slices: the slices each hit pixel's
    loop runs."""
    reference = dataclasses.replace(scene, kernels=False)
    ctx = lao.setup(reference, params, height, width)
    acc = torch.zeros((height, width, 4), device=scene.device)
    total = 0
    for i in range(params.slices):
        _, active = lao.slice_active(ctx, acc, i)
        total += int((active & ~ctx.miss).sum())
        acc = lao.march_slice(reference, params, ctx, acc, i)
    return total


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_lao_kernel_counts_its_lane_slices(cuda, kind):
    """``counts=`` adds the frame's active lane-slices, which equal the
    plain frame's active pixel-slices, and the slices the warps step
    through, which hold them at 32 lanes a warp-slice at most."""
    scene, params = _scene(kind, cuda), lao.Params()
    state = lao.reset(params, 64, 64, scene)
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    lao_march.lao_frame(state, scene, params, counts=counts)
    lao_march.lao_frame(state, scene, params, counts=counts)
    torch.cuda.synchronize()
    lanes, warps = counts.tolist()
    want = _plain_lane_slices(scene, params, 64, 64)
    assert want > 0 and lanes == 2 * want
    assert 32 * warps >= lanes and warps > 0
    plain = state.clone()
    lao_march.lao_frame_plain(plain, scene, params)
    assert_lao_agrees(state, plain)
    with pytest.raises(ValueError):
        lao_march.lao_frame(state, scene, params,
                            counts=torch.zeros(2, device=cuda))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_lao_kernel_row_index_widths(cuda, kind, monkeypatch):
    """The 64-bit row index (taken for tables of 2^31 rows or more: here
    forced by lowering the limit) gives the 32-bit path's frame."""
    scene, params = _scene(kind, cuda), lao.Params()
    state, plain = _lao_frame(scene, params, 40, 56)
    assert lao_march._scene_cache.get(scene, (params, 40, 56)).args.rows64 \
        == 0
    monkeypatch.setattr(lao_march, "ROWS32", 0)
    wide = lao.reset(params, 40, 56, scene)
    lao_march.lao_frame(wide, dataclasses.replace(scene), params)
    torch.cuda.synchronize()
    assert torch.equal(wide, state)
    assert_lao_agrees(wide, plain)
    occ = lao_march.occupancy(scene.volume_packed.dtype, rows64=True)
    assert occ["blocks_per_sm"] >= 1


@pytest.mark.parametrize("where", ["all-miss", "all-hit"])
def test_lao_kernel_all_miss_and_all_hit(cuda, where):
    """A camera beside the cube (every pixel a miss, written at once) and
    one close in (every pixel a hit)."""
    from vpt_tpu_torch.scene import default_camera

    translation = (5.0, 0.0, 2.0) if where == "all-miss" else (0.0, 0.0, 2.0)
    scene = make_scene(volume.blobs_volume(24, seed=3, device=cuda),
                       transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                       camera=default_camera(translation, fovy=0.2),
                       device=cuda)
    params = lao.Params()
    ctx = lao.setup(dataclasses.replace(scene, kernels=False), params, 48,
                    40)
    assert bool(ctx.miss.all() if where == "all-miss"
                else (~ctx.miss).all())
    state, plain = _lao_frame(scene, params, 48, 40)
    assert_lao_agrees(state, plain)
    if where == "all-miss":
        black = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cuda)
        assert bool((state == black).all())


def test_dos_and_lao_kernels_launch_shapes(cuda):
    """K9 fits 512-thread blocks without spilling in each mode; K10 fits
    an SM on the march kernels' pixel tile."""
    for dtype in (torch.float32, torch.bfloat16):
        for tf in range(3):
            occ = dos_sweep.occupancy(dtype, tf)
            assert occ["threads_per_block"] == 512
            assert occ["blocks_per_sm"] >= 1 and occ["local_bytes"] == 0
            assert occ["dynamic_smem_bytes"] == 50 * 4 * (4 + 4 * 8)
            assert occ["rows_at_once"] == 50
        occ = lao_march.occupancy(dtype)
        assert occ["threads_per_block"] == 128 and occ["blocks_per_sm"] >= 1
        assert occ["tile_width"] * occ["tile_height"] == 128
        assert occ["group"] >= 1
        # the ext instances: two channels (baked or not) in either row
        # type, one filtered channel in float32
        for baked in (False, True):
            occ = lao_march.occupancy(dtype, channels=2, baked=baked)
            assert occ["blocks_per_sm"] >= 1
        occ = dos_sweep.occupancy(dtype, 0, channels=2)
        assert occ["blocks_per_sm"] >= 1
    for tf in range(3):
        assert dos_sweep.occupancy(torch.float32, tf,
                                   filtered=True)["blocks_per_sm"] >= 1
    assert lao_march.occupancy(torch.float32,
                               filtered=True)["blocks_per_sm"] >= 1


# -- the serving layer: the context, checkpoints, the large-volume rule ------

#: the kernel each renderer launches once a frame
FRAME_KERNEL = {"mcm": mcm_event, "eam": march, "mip": march, "depth": march,
                "iso": march, "mcs": mcs_frame, "dos": dos_sweep,
                "lao": lao_march}


def _context(cuda, key, res=64):
    """The CLI's context at ``res``²: 'fast' (bf16 tables and TF weights),
    the sRGB TF, cheb-skip auto, blobs 24³."""
    ctx = RenderingContext(resolution=res, tf_srgb=True, device=cuda)
    ctx.set_volume(volume.blobs_volume(24, seed=3, device=cuda))
    ctx.set_transfer_function(transfer.gray_ramp(alpha_scale=0.8,
                                                 device=cuda))
    ctx.choose_renderer(key)
    ctx.choose_tone_mapper("reinhard")
    return ctx


@pytest.mark.parametrize("key", ["mcm", "eam", "dos"])
def test_context_equals_the_direct_renderer(cuda, key):
    """The context's HDR image after 4 frames is the renderer's driven on
    ``ctx.get_scene()`` with ``ctx._frame_seed(1..4)``, bit for bit, one
    kernel launch a frame; a camera move gives the scene new matrices on
    the card and changes the next image."""
    ctx = _context(cuda, key)
    counter = FRAME_KERNEL[key]
    before = counter.LAUNCHES
    ctx.render(frames=4)
    hdr = ctx.get_hdr_image()
    torch.cuda.synchronize()
    assert counter.LAUNCHES == before + 4
    scene = ctx.get_scene()
    assert scene.volume_packed.dtype == torch.bfloat16
    direct = make_renderer(key, params=ctx.renderer.params, height=64,
                           width=64)
    direct.reset(scene)
    for n in range(1, 5):
        direct.render(scene, ctx._frame_seed(n))
    assert torch.equal(hdr, direct.display(scene))
    ctx.camera_animator.rotate(0.3, 0.1)
    ctx.render(frames=1)
    moved = ctx.get_scene()
    assert moved is not scene and moved.mvp_inverse.is_cuda
    assert moved.volume_packed is scene.volume_packed
    assert not torch.equal(moved.mvp_inverse, scene.mvp_inverse)
    direct.reset(scene)
    direct.render(scene, ctx._frame_seed(1))
    assert not torch.equal(ctx.get_hdr_image(), direct.display(scene))


@pytest.mark.parametrize("key", ["mcm", "dos"])
def test_context_resumes_bit_for_bit(cuda, key, tmp_path):
    """2 frames, a checkpoint, a fresh context's load, 2 more: the image
    of 4 uninterrupted frames."""
    whole = _context(cuda, key)
    whole.render(frames=4)
    part = _context(cuda, key)
    part.render(frames=2)
    part.save_checkpoint(tmp_path / "c.npz")
    resumed = _context(cuda, key)
    resumed.load_checkpoint(tmp_path / "c.npz")
    assert all(t.is_cuda for t in resumed.renderer.state.values())
    resumed.render(frames=2)
    assert torch.equal(resumed.get_hdr_image(), whole.get_hdr_image())


def test_cli_renders_on_the_card(cuda, tmp_path):
    """``cli render`` without ``--platform``: the card, one K5 launch a
    frame and one K2 launch for the display, and a PNG."""
    from vpt_tpu_torch import cli

    before = (mcm_event.LAUNCHES, tonemap_kernel.LAUNCHES)
    cli.main(["render", "--volume", "sphere:24", "--resolution", "64",
              "--spp", "3", "--tf-srgb", "-o", str(tmp_path / "r.png"),
              "--checkpoint", str(tmp_path / "r.npz")])
    assert (mcm_event.LAUNCHES, tonemap_kernel.LAUNCHES) \
        == (before[0] + 3, before[1] + 1)
    assert (tmp_path / "r.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "r.npz").exists()


def test_large_volume_rule_builds_float32_tables(cuda, monkeypatch):
    """Above the packing threshold (lowered to 24³ − 1 voxels here) a CUDA
    scene packs float32 corner tables, keeps the bf16 TF weights and
    tracking table, and every renderer renders on it through its kernel;
    MCM's and EAM's frames equal their plain versions'."""
    monkeypatch.setattr(renderer_base, "PACK_MAX_VOXELS", 24 ** 3 - 1)
    scene = _headline_scene(24, cuda)
    assert scene.volume_packed.dtype == torch.float32
    assert scene.transfer_packed.dtype == torch.float32
    assert scene.tracking_packed.dtype == torch.bfloat16
    assert scene.tf_mxu == torch.bfloat16
    for key, counter in FRAME_KERNEL.items():
        renderer = make_renderer(key, height=64, width=64)
        before = counter.LAUNCHES
        renderer.reset(scene)
        renderer.render(scene, 0.3)
        image = tm.ToneMapper("reinhard")(renderer.display(scene))
        torch.cuda.synchronize()
        assert counter.LAUNCHES == before + 1, key
        assert bool(torch.isfinite(image).all()), key
    state, plain = _kernel_and_plain(scene, mcm.Params(extinction=40.0,
                                                       steps=8), 64, 64, 2)
    assert_frames_agree(state, plain)
    state, plain = _kernel_frames("eam", scene, 64, 64, 2)
    assert_kernel_agrees("eam", state, plain)


# -- two-channel and filtered volumes: the ext instances of K5-K8 ----------

#: a 2D TF of three bumps over (value, gradient magnitude)
BUMPS = [
    {"position": {"x": 0.3, "y": 0.15}, "size": {"x": 0.25, "y": 0.3},
     "color": {"r": 0.9, "g": 0.6, "b": 0.2, "a": 0.8}},
    {"position": {"x": 0.6, "y": 0.5}, "size": {"x": 0.3, "y": 0.4},
     "color": {"r": 0.2, "g": 0.7, "b": 0.9, "a": 1.0}},
    {"position": {"x": 0.85, "y": 0.1}, "size": {"x": 0.2, "y": 0.2},
     "color": {"r": 1.0, "g": 1.0, "b": 1.0, "a": 0.6}},
]

#: the scenes: "rg" a two-channel volume (float32 or, "-bf16", bf16
#: tables), a filter alone ("nearest", "cubic"), both ("rg-nearest",
#: "rg-cubic"), the filtered headline options ("cubic-mxu": bf16 pack_dtype
#: and tf_mxu, which a filtered scene takes as float32 tables and bf16
#: weights)
EXT = ["rg", "rg-bf16", "nearest", "cubic", "rg-nearest", "rg-cubic",
       "cubic-mxu"]


def _ext_scene(kind, cuda, **kw):
    vol = volume.blobs_volume(24, seed=3, device=cuda)
    parts = kind.split("-")
    if parts[0] == "rg":
        vol = volume.with_gradient_magnitude(vol)
        tf = transfer.rasterize(transfer.TransferFunctionBumps.from_list(
            BUMPS, cuda))
        parts = parts[1:]
    else:
        tf = transfer.gray_ramp(alpha_scale=0.8, device=cuda)
    filt = next((p for p in parts if p in ("nearest", "cubic")), "linear")
    fast = "bf16" in parts or "mxu" in parts
    return make_scene(volume.Volume(vol.data, filt), tf,
                      pack_dtype=torch.bfloat16 if fast else None,
                      tf_mxu="mxu" in parts, device=cuda, **kw)


@pytest.mark.parametrize("kind", EXT)
def test_ext_scenes_pack_what_the_kernels_take(cuda, kind):
    """A two-channel scene packs (D·H·W, 16) rows and its 2D TF in
    ``pack_dtype``; a filtered one float32 tables whatever ``pack_dtype``
    is, with the ``tf_mxu`` weights in ``pack_dtype``."""
    scene = _ext_scene(kind, cuda)
    rg = kind.startswith("rg")
    assert tuple(scene.volume_packed.shape) == (24 ** 3, 16 if rg else 8)
    want = torch.bfloat16 if kind == "rg-bf16" else torch.float32
    assert scene.volume_packed.dtype == want
    assert scene.transfer_packed.dtype == want
    assert scene.tf_mxu == (torch.bfloat16 if kind == "cubic-mxu" else None)
    assert scene.tracking_packed is None and scene.majorant is None


@pytest.mark.parametrize("grid", [False, True], ids=["none", "grid"])
@pytest.mark.parametrize("kind", EXT)
def test_event_kernel_ext_matches_plain(cuda, kind, grid):
    """K5's ext instances against the plain loop on the same card (64²,
    steps 8, 4 frames), with the global majorant or an 8³ grid: samples
    equal, radiance within 1e-6.  A two-channel volume builds no grid (it
    warns), so it runs the global machine there."""
    if grid and kind.startswith("rg"):
        with pytest.warns(UserWarning, match="majorant grid"):
            scene = _ext_scene(kind, cuda, tracking="grid")
        assert scene.majorant is None
    else:
        scene = _ext_scene(kind, cuda, majorant_grid=8 if grid else None)
        assert (scene.majorant is not None) == grid
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state, plain = _kernel_and_plain(scene, params, 64, 64, 4)
    assert_frames_agree(state, plain)
    assert float(state["samples"].sum()) > 64 * 64


@pytest.mark.parametrize("kind", EXT)
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso", "mcs"])
def test_frame_kernels_ext_match_plain(cuda, key, kind):
    """K6's ext instances in each mode and K8's against the plain frames
    (48×80, 3 frames), to the headline instances' bounds."""
    scene = _ext_scene(kind, cuda)
    params = mcs.Params(extinction=8.0) if key == "mcs" else None
    state, plain = _kernel_frames(key, scene, 48, 80, 3, params)
    assert_kernel_agrees(key, state, plain)
    if key == "iso":
        assert bool((state[..., 3] > 0).any())
        _assert_shade_equals_plain(state, scene)


def test_ext_instances_launch_shapes(cuda):
    """Every ext instance fits an SM; K5's and K7's keep the headline's
    local bytes (no spills); K6's and K8's read their rows ahead as the
    headline's do, two-channel ones half as many."""
    k5 = mcm_event.occupancy(torch.bfloat16, 256)
    for dtype, grid, env_map, channels in (
            (torch.float32, False, False, 1), (torch.float32, True, True, 1),
            (torch.bfloat16, False, False, 2),
            (torch.float32, False, True, 2)):
        occ = mcm_event.occupancy(dtype, 256, grid, env_map, channels,
                                  filtered=channels == 1)
        assert occ["blocks_per_sm"] >= 1
        assert occ["local_bytes"] == k5["local_bytes"]
    assert occ["dynamic_smem_bytes"] == 0      # two channels: no TF row
    for mode in march.MODES:
        for dtype, channels in ((torch.float32, 1), (torch.bfloat16, 2),
                                (torch.float32, 2)):
            occ = march.occupancy(mode, dtype, 256, channels=channels,
                                  filtered=channels == 1)
            base = march.occupancy(mode, dtype, 256)
            assert occ["blocks_per_sm"] >= 1
            assert occ["chunk"] == base["chunk"] // channels
    for dtype, channels in ((torch.float32, 1), (torch.bfloat16, 2)):
        occ = iso_shade.occupancy(dtype, channels=channels,
                                  filtered=channels == 1)
        assert occ["blocks_per_sm"] >= 1 and occ["local_bytes"] == 0
        occ = mcs_frame.occupancy(dtype, 256, channels=channels,
                                  filtered=channels == 1)
        assert occ["blocks_per_sm"] >= 1


@pytest.mark.parametrize("kind", EXT)
@pytest.mark.parametrize("key", ["dos", "lao"])
def test_dos_and_lao_kernels_ext_match_plain(cuda, key, kind):
    """K9's and K10's ext instances against the plain frames on the same
    card, to the headline instances' bounds: DOS 2 frames of 50 slices at
    48×80, LAO one frame at 64×64 (and, on two channels, the baked
    gradient of the same rows)."""
    scene = _ext_scene(kind, cuda)
    if key == "dos":
        state, plain = _dos_frames(scene, dos.Params(), 48, 80, 2)
        assert_dos_agrees(state, plain)
        assert float(state["color"][..., 3].max()) > 0.0
        return
    for baked in (False, True) if kind.startswith("rg") else (False,):
        state, plain = _lao_frame(scene, lao.Params(baked_gradient=baked),
                                  64, 64)
        assert_lao_agrees(state, plain)
        assert float(state[..., :3].max()) > 0.0


@pytest.mark.parametrize("kind", ["f32", "bf16", "nearest", "cubic"])
def test_lao_kernel_baked_matches_plain(cuda, kind):
    """K10's baked instance on ``with_lao_gradient`` of blobs 24³ (float32
    or bf16 rows, or a filter) with the three-bump 2D TF, against the
    plain frame: 64×64, the headline's bound.  The baked image stays near
    the exact seven-tap one within tests/test_lao_baked.py's bounds (max
    |Δ| below 0.03, mean below 0.004; measured on the CPU on this scene at
    most 0.0194 and 2.0e-4, with nearest)."""
    vol = volume.with_lao_gradient(volume.blobs_volume(24, seed=3,
                                                       device=cuda))
    filt = kind if kind in ("nearest", "cubic") else "linear"
    tf = transfer.rasterize(transfer.TransferFunctionBumps.from_list(
        BUMPS, cuda))
    scene = make_scene(volume.Volume(vol.data, filt), tf,
                       pack_dtype=torch.bfloat16 if kind == "bf16" else None,
                       device=cuda)
    state, plain = _lao_frame(scene, lao.Params(baked_gradient=True), 64, 64)
    assert_lao_agrees(state, plain)
    exact, _ = _lao_frame(scene, lao.Params(), 64, 64)
    diff = (state - exact).abs()
    assert float(diff.max()) < 0.03 and float(diff.mean()) < 0.004


@pytest.mark.parametrize("kind", EXT)
def test_dos_ext_grid_fits_its_occupancy(cuda, kind):
    """The cooperative grid of an ext scene comes from the ext instance's
    own residency, which may hold fewer blocks an SM than the headline's:
    the prepared grid is exactly its blocks an SM times the SMs, and a
    frame launches."""
    scene = _ext_scene(kind, cuda)
    params = dos.Params()
    p = dos_sweep._scene_cache.get(scene, (params, 32, 32))
    occ = dos_sweep.occupancy(
        scene.volume_packed.dtype, tf1d.mode_code(scene.tf_mxu),
        params.samples, params.steps, channels=scene.channels,
        filtered=scene.filter != "linear")
    assert occ["blocks_per_sm"] >= 1
    assert p.args.blocks == occ["blocks_per_sm"] * occ["sms"]
    assert (p.args.channels, p.args.filter) == (
        scene.channels, sampling.FILTERS[scene.filter])
    state, plain = _dos_frames(scene, params, 32, 32, 1)
    assert_dos_agrees(state, plain)


def test_filtered_bf16_tables_raise_before_a_launch(cuda):
    """The kernels filter float32 rows only; a filtered scene with bf16
    rows (which make_scene never builds) raises, launching nothing."""
    scene = _ext_scene("cubic", cuda)
    scene = dataclasses.replace(
        scene, volume_packed=scene.volume_packed.to(torch.bfloat16))
    before = _launches()
    with pytest.raises(ValueError, match="float32"):
        eam.render_frame(eam.reset(eam.Params(), 8, 8, scene), scene,
                         eam.Params(), 0.1, 1)
    assert _launches() == before


def test_context_set_filter_renders_on_the_card(cuda):
    """RenderingContext.set_filter: the next frame builds the filtered
    scene and launches K5's ext instance once."""
    ctx = RenderingContext(resolution=32, device=cuda)
    ctx.set_volume(volume.blobs_volume(24, seed=3, device=cuda))
    ctx.choose_renderer("mcm")
    ctx.set_filter("cubic")
    before = mcm_event.LAUNCHES
    ctx.render(1)
    image = ctx.get_display_image()
    torch.cuda.synchronize()
    assert ctx.get_scene().filter == "cubic"
    assert mcm_event.LAUNCHES == before + 1
    assert bool(torch.isfinite(image).all())


# -- the inverse-rendering entry point: the EAM fit, diff_iso, inpaint -----

def _orbit_views(yaws):
    import math

    from vpt_tpu_torch.runtime.animators import OrbitCameraAnimator
    from vpt_tpu_torch.scene import CameraState, default_camera

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    views = []
    for yaw in yaws:
        orbit.yaw = math.radians(yaw)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        views.append((cs.mvp_inverse, cs.model_view, cs.projection))
    return views


def test_eam_fit_loss_kernels_match_plain(cuda):
    """One value-and-grad of the multi-view EAM loss (3 views at 32²,
    16³ volume and TF leaves), the kernels against kernels=False on the
    card: K3 a chunk of slices, K4 its backward, no TF-lookup launch; the
    loss within 1e-6 relative, each gradient within 1e-4 relative L2."""
    params = eam.Params(slices=32, random=False, extinction=50.0)
    views = _orbit_views((0.0, 120.0, 240.0))
    truth = volume.blobs_volume(16, seed=2, device=cuda).data
    tf = transfer.gray_ramp(alpha_scale=1.0, device=cuda)
    with torch.no_grad():
        targets = [train.render_eam(truth, tf, v, params, 0.0, 32, 32)
                   for v in views]
    out = []
    for kernels in (True, False):
        vol = torch.full((16, 16, 16, 1), 0.3, device=cuda,
                         requires_grad=True)
        tex = tf.clone().requires_grad_(True)
        before = (corner_gather.LAUNCHES, corner_scatter.LAUNCHES,
                  tf1d.LAUNCHES)
        loss = train.multiview_loss(vol, tex, views, targets, params, 0.0,
                                    kernels=kernels)
        loss.backward()
        torch.cuda.synchronize()
        launched = (corner_gather.LAUNCHES - before[0],
                    corner_scatter.LAUNCHES - before[1],
                    tf1d.LAUNCHES - before[2])
        assert launched == ((12, 12, 0) if kernels else (0, 0, 0))
        out.append((loss.item(), vol.grad, tex.grad))
    (l0, gv0, gt0), (l1, gv1, gt1) = out
    assert abs(l0 - l1) <= 1e-6 * l1 and l1 > 0
    for g0, g1 in ((gv0, gv1), (gt0, gt1)):
        assert bool(torch.isfinite(g0).all()) and float(g0.abs().max()) > 0
        assert float((g0 - g1).norm() / g1.norm()) <= 1e-4


def test_depth_loss_kernels_match_plain(cuda):
    """One value-and-grad of diff_iso.depth_loss at 32², 48 steps, the
    volume and a tensor isovalue as leaves, the kernels against
    kernels=False: one K3 launch for the steps, one K4 for their
    backward, no TF-lookup launch (its kernel has no gradient); the loss
    within 1e-6 relative, the gradients within 1e-4 relative L2."""
    from vpt_tpu_torch.renderers import diff_iso

    tf = transfer.gray_ramp(alpha_scale=1.0, device=cuda)
    template = make_scene(volume.sphere_volume(16, device=cuda), tf,
                          pack=False, device=cuda)
    with torch.no_grad():
        target = diff_iso.render(template, diff_iso.Params(), 32, 32)[
            "depth"]
    out = []
    for kernels in (True, False):
        vol = torch.full((16, 16, 16, 1), 0.45, device=cuda)
        vol = (vol + 0.1 * volume.blobs_volume(16, seed=5, device=cuda)
               .data).requires_grad_(True)
        isovalue = torch.tensor(0.45, device=cuda, requires_grad=True)
        params = diff_iso.Params(isovalue=isovalue, tau=0.05, steps=48)
        before = (corner_gather.LAUNCHES, corner_scatter.LAUNCHES,
                  tf1d.LAUNCHES)
        loss = diff_iso.depth_loss(
            vol, dataclasses.replace(template, kernels=kernels), params,
            target, 32, 32)
        loss.backward()
        torch.cuda.synchronize()
        launched = (corner_gather.LAUNCHES - before[0],
                    corner_scatter.LAUNCHES - before[1],
                    tf1d.LAUNCHES - before[2])
        assert launched == ((1, 1, 0) if kernels else (0, 0, 0))
        out.append((loss.item(), vol.grad, isovalue.grad))
    (l0, gv0, gi0), (l1, gv1, gi1) = out
    assert abs(l0 - l1) <= 1e-6 * l1 and l1 > 0
    assert bool(torch.isfinite(gv0).all()) and float(gv0.abs().max()) > 0
    assert float((gv0 - gv1).norm() / gv1.norm()) <= 1e-4
    assert abs(float(gi0 - gi1)) <= 1e-4 * abs(float(gi1))


def test_biharmonic_fill_on_the_card_matches_the_cpu(cuda):
    """inpaint.biharmonic_fill of a damaged 32³ blobs volume, coarse to
    fine from 8³ at 50 CG iterations a level, on the card and on the CPU:
    the masks equal and the fills within 1e-5 (CG's float32 dot products
    sum in another order on each)."""
    from vpt_tpu_torch import inpaint

    truth = volume.blobs_volume(32, seed=3, count=6, device="cpu").data
    mask = inpaint.unobserved_mask(truth, 25.0, 2.0)
    damaged = torch.where(mask[..., None], 0.45 * truth, truth)
    got, gmask = inpaint.complete_occluded(damaged.to(cuda), extinction=25.0,
                                           tau=2.0, coarsest=8, cg_iters=50)
    want, wmask = inpaint.complete_occluded(damaged, extinction=25.0,
                                            tau=2.0, coarsest=8, cg_iters=50)
    assert bool(wmask.any()) and torch.equal(gmask.cpu(), wmask)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


# -- the last entry points: the viewer, animate, the config-3 recipe -------

def _viewer_context(device, resolution=128):
    ctx = RenderingContext(resolution=resolution, device=device)
    ctx.set_volume(volume.blobs_volume(64, seed=2, device=device))
    ctx.set_transfer_function(transfer.gray_ramp(alpha_scale=0.9,
                                                 device=device))
    ctx.choose_renderer("mcm")
    ctx.choose_tone_mapper("reinhard")
    return ctx


def test_viewer_frame_on_the_card_equals_the_context(cuda):
    """One /frame request (4 spp at a pose) to an in-process ViewerServer
    on the card: its handler thread launches K5 once a sample and K2 once,
    and the PNG's pixels equal to_uint8 of a second context driven through
    the same calls directly."""
    import io
    import urllib.request

    Image = pytest.importorskip("PIL.Image")
    from vpt_tpu_torch.io import to_uint8
    from vpt_tpu_torch.runtime.viewer import ViewerServer

    server = ViewerServer(_viewer_context(cuda), port=0)
    port = server.serve_background()
    before = (mcm_event.LAUNCHES, tonemap_kernel.LAUNCHES)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame?yaw=0.3&pitch=0.2&spp=4"
                "&renderer=mcm&tonemap=reinhard", timeout=300) as resp:
            assert resp.status == 200
            png = resp.read()
    finally:
        server.shutdown()
    assert (mcm_event.LAUNCHES - before[0],
            tonemap_kernel.LAUNCHES - before[1]) == (4, 1)
    got = np.asarray(Image.open(io.BytesIO(png)))
    direct = _viewer_context(cuda)
    direct.camera_animator.yaw = 0.3
    direct.camera_animator.pitch = 0.2
    direct.camera_animator._update_camera()
    direct.render(frames=4)
    want = to_uint8(direct.get_display_image())
    assert got.shape == want.shape == (128, 128, 3)
    assert np.array_equal(got, want) and want.max() > 0


def test_record_animation_gif_on_the_card(cuda, tmp_path):
    """record_animation(video=".gif") of 3 EAM frames at 64², 2 spp: one
    K6 launch a sample, one K2 a frame, and the GIF's frames are the
    PNGs'."""
    Image = pytest.importorskip("PIL.Image")

    ctx = _viewer_context(cuda, resolution=64)
    ctx.choose_renderer("eam")
    before = (march.LAUNCHES, tonemap_kernel.LAUNCHES)
    ctx.record_animation(tmp_path / "frames", frames=3, spp=2,
                         video=tmp_path / "anim.gif")
    assert (march.LAUNCHES - before[0],
            tonemap_kernel.LAUNCHES - before[1]) == (6, 3)
    gif = Image.open(tmp_path / "anim.gif")
    assert gif.n_frames == 3
    pngs = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(pngs) == 3
    for i, path in enumerate(pngs):
        gif.seek(i)
        assert np.array_equal(np.asarray(gif.convert("RGB")),
                              np.asarray(Image.open(path)))


def test_config3_helpers_on_the_card_match_the_cpu(cuda):
    """The recipe's box_blur, resize_volume and priors on the card against
    the CPU's (within 1e-6 relative: reductions and contractions sum in
    another order), and one value-and-grad of its loss_fn at 16³, 16², 2
    frames, both extinctions: K3 and K4 launched, the loss within 1e-6
    relative and the gradient within 1e-4 relative L2 of the CPU's plain
    fetch."""
    from vpt_tpu_torch.examples import config3_mcm256 as c3
    from vpt_tpu_torch.scene import CameraState, default_camera

    truth = volume.blobs_volume(16, seed=3, count=6, device="cpu").data
    blurred = c3.box_blur(truth, 13)
    assert torch.allclose(c3.box_blur(truth.to(cuda), 13).cpu(), blurred,
                          rtol=1e-6, atol=0)
    up = c3.resize_volume(blurred, 32)
    got = c3.resize_volume(blurred.to(cuda), 32).cpu()
    assert float((got - up).abs().max()) <= 1e-6 * float(up.abs().max())
    init = torch.clamp(0.55 * blurred, 0.0, 1.0)
    for prior in ("tv", "curv", "logcurv", "lap", "loglap"):
        want = float(c3.prior_penalty(init, prior))
        got = float(c3.prior_penalty(init.to(cuda), prior))
        assert abs(got - want) <= 1e-6 * want, prior

    cam = CameraState.from_nodes(default_camera())
    g = torch.Generator().manual_seed(6)
    tgts = [torch.rand(16, 16, 3, generator=g) * 0.5 for _ in range(2)]
    out = []
    for dev in (cuda, torch.device("cpu")):
        tmpl = make_scene(truth.to(dev), transfer.gray_ramp(
            alpha_scale=0.9, device=dev), camera=cam, pack=False,
            device=dev)
        vox = init.to(dev).requires_grad_(True)
        before = (corner_gather.LAUNCHES, corner_scatter.LAUNCHES)
        loss = c3.loss_fn(vox, tmpl, [t.to(dev) for t in tgts],
                          0.31 + 16000.0, 2, (25.0, 5.0), 30.0,
                          c3._base_params(), 16, "lap")
        loss.backward()
        launched = (corner_gather.LAUNCHES - before[0],
                    corner_scatter.LAUNCHES - before[1])
        out.append((loss.item(), vox.grad.cpu(), launched))
    (l0, g0, n0), (l1, g1, n1) = out
    assert n0[0] > 0 and n0[1] > 0 and n1 == (0, 0)
    assert abs(l0 - l1) <= 1e-6 * abs(l1)
    assert bool(torch.isfinite(g0).all()) and float(g1.abs().max()) > 0
    assert float((g0 - g1).norm() / g1.norm()) <= 1e-4


UNPACKED = {"mcm": mcm.Params(extinction=20.0, steps=8), "eam": eam.Params(),
            "mip": mip.Params(), "depth": depth.Params(), "iso": iso.Params(),
            "mcs": mcs.Params(extinction=20.0), "dos": dos.Params(),
            "lao": lao.Params()}


@pytest.mark.parametrize("key", sorted(UNPACKED))
def test_unpacked_scene_renders_through_its_kernel(cuda, key):
    """A ``pack=False`` scene on the card: the samplers read the unpacked
    volume (``vpt_tpu``'s rule), the kernels its float32 corner tables of
    the same values; one frame through the renderer's kernel equals the
    plain frame on the scene within the packed scenes' bounds (ISO's
    display through K7 too)."""
    scene = make_scene(volume.blobs_volume(32, seed=1, device=cuda),
                       transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                       pack=False, device=cuda)
    assert scene.kernel_tables and not scene._packed_samples()
    assert scene.volume_packed.dtype == scene.transfer_packed.dtype \
        == torch.float32
    params = UNPACKED[key]
    if key == "mcm":
        state, plain = _kernel_and_plain(scene, params, 40, 48, 2)
        assert_frames_agree(state, plain)
    elif key == "dos":
        state, plain = _dos_frames(scene, params, 40, 48, 2)
        assert_dos_agrees(state, plain)
    elif key == "lao":
        state, plain = _lao_frame(scene, params, 40, 48)
        assert_lao_agrees(state, plain)
    else:
        state, plain = _kernel_frames(key, scene, 40, 48, 2, params)
        assert_kernel_agrees(key, state, plain)
    if key == "iso":
        before = iso_shade.LAUNCHES
        shown = iso.display(state, scene, params)
        torch.cuda.synchronize()
        assert iso_shade.LAUNCHES == before + 1
        assert torch.equal(shown, iso_shade.iso_shade_plain(state, scene,
                                                            params))


#: bands of a 77-row frame: two equal ones (a frame of 78 rows), and
#: three uneven ones that are no multiple of a block's rows
BANDS = {"two": (78, [(0, 39), (39, 78)]),
         "three": (77, [(0, 13), (13, 50), (50, 77)])}


def _banded(module, scene, params, height, width, bands, frames=2,
            **reset_kw):
    """The whole frame's state and the bands' states stacked, each band
    rendered with its row window (``frames`` frames)."""
    whole = module.reset(params, height, width, scene)
    parts = []
    for r0, r1 in bands:
        kw = {"window": (r0, height)} if module is mcm else {}
        parts.append(module.reset(params, r1 - r0, width, scene, **kw))
    for n in range(1, frames + 1):
        seed = np.float32(0.3 + 0.01 * n)
        module.render_frame(whole, scene, params, seed, n)
        for (r0, _), part in zip(bands, parts):
            module.render_frame(part, scene, params, seed, n,
                                window=(r0, height))
    torch.cuda.synchronize()
    if isinstance(whole, dict):
        return whole, {k: torch.cat([p[k] for p in parts]) for k in whole}
    return whole, torch.cat(parts)


@pytest.mark.parametrize("bands", sorted(BANDS))
@pytest.mark.parametrize("key", ["mcm", "eam", "mip", "depth", "iso",
                                 "mcs", "lao"])
def test_row_window_bands_equal_the_whole_frame(cuda, key, bands):
    """K5, K6 (four modes), K8 and K10 launched on bands of rows with
    their windows: the stacked bands equal the whole frame bit for bit
    (K10 within its bound: 99.99% of the values within 1e-6), one launch
    a band and frame; the headline's bf16 scene (cheb-skip for MCM)."""
    module = {"mcm": mcm, "eam": eam, "mip": mip, "depth": depth,
              "iso": iso, "mcs": mcs, "lao": lao}[key]
    params = UNPACKED[key]
    height, ranges = BANDS[bands]
    counter = {"mcm": mcm_event, "mcs": mcs_frame,
               "lao": lao_march}.get(key, march)
    frames = 1 if key == "lao" else 2
    before = counter.LAUNCHES
    whole, stacked = _banded(module, _headline_scene(24, cuda), params,
                             height, 64, ranges, frames)
    assert counter.LAUNCHES == before + frames * (1 + len(ranges))
    if key == "lao":
        assert_lao_agrees(stacked, whole)
    elif isinstance(whole, dict):
        for k in whole:
            assert torch.equal(stacked[k], whole[k]), k
    else:
        assert torch.equal(stacked, whole)


def test_row_window_refusals(cuda):
    """A window whose rows leave the image raises before any launch."""
    scene = _headline_scene(16, cuda)
    state = eam.reset(eam.Params(), 8, 8, scene)
    before = _launches()
    with pytest.raises(ValueError, match="do not lie"):
        eam.render_frame(state, scene, eam.Params(), 0.3, 1, window=(4, 10))
    assert _launches() == before


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_parallel_world_of_one_over_nccl(cuda, tmp_path):
    """``path parallel``'s steps at a small size, in a world of one over
    ``nccl``: the sharded MCM frames equal the renderer's and agree with
    the plain loop's, the display, the data-parallel EAM step (bucketed,
    and ``shard.data_parallel_train_step`` on z slabs against the
    single-process gradient) and a sharded checkpoint round trip."""
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import (distributed, gather_state,
                                        make_mesh, place_state,
                                        shard_display, shard_render_frame,
                                        sharded_scene)
    from vpt_tpu_torch.parallel import mesh as meshmod
    from vpt_tpu_torch.parallel import overlap, shard
    from vpt_tpu_torch.runtime import checkpoint

    assert distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                                  retries=1)
    try:
        assert "nccl" in dist.get_backend()
        grid = make_mesh(1)
        scene = _headline_scene(32, cuda)
        params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
        whole = mcm.reset(params, 64, 48, scene)
        want = {k: v.clone() for k, v in whole.items()}
        plain = {k: v.clone() for k, v in whole.items()}
        sc = sharded_scene(scene, grid, shard_volume=True)
        state = place_state(whole, grid)
        frame = shard_render_frame(mcm, grid, whole)
        before = mcm_event.LAUNCHES
        for n in range(1, 5):
            frame(state, sc, params, np.float32(0.1 * n), n)
            mcm.render_frame(want, scene, params, np.float32(0.1 * n), n)
            _plain_frame(plain, scene, params, np.float32(0.1 * n))
        torch.cuda.synchronize()
        assert mcm_event.LAUNCHES == before + 8
        got = gather_state(state, grid, 64)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert_frames_agree(got, plain)
        shown = shard_display(mcm, grid, whole)(state, sc, params)
        assert torch.equal(shown, mcm.display(want, scene, params))

        tf = transfer.gray_ramp(alpha_scale=1.0, device=cuda)
        vol = volume.blobs_volume(16, seed=2, device=cuda).data
        cams = (scene.mvp_inverse, scene.model_view, scene.projection)
        target = torch.zeros((32, 32, 4), device=cuda)
        ep = eam.Params(slices=8, random=False)

        def loss_of_volume(v):
            return shard.eam_loss_rows(v, tf, cams, target, ep,
                                       np.float32(0.0), grid)

        step = overlap.bucketed_train_step(
            lambda p: torch.optim.Adam(p, lr=0.05), loss_of_volume, 4,
            group=meshmod.axis_group(grid, "data"))
        l1, vol1, opt_state = step(vol, None)
        l2, _, _ = step(vol1, opt_state)
        assert float(l2) < float(l1)
        leaf = vol.clone().requires_grad_(True)
        want_loss = train.mse_rgb(train.render_eam(
            leaf, tf, cams, ep, np.float32(0.0), 32, 32), target)
        want_grad, = torch.autograd.grad(want_loss, leaf)
        want_loss = want_loss.detach()
        assert abs(float(l1) - float(want_loss)) <= 1e-6

        # the z-slab step: a frame all-gathers the slabs over space, the
        # gradient is reduce-scattered into them (tests/test_parallel.py's
        # bounds: the loss within 1e-6, the gradient within 1e-5)
        loss, grads = shard.eam_value_and_grad(
            vol, tf, cams, target, ep, np.float32(0.0), grid,
            shard_volume=True)
        assert float(want_grad.abs().max()) > 1e-4
        assert abs(float(loss) - float(want_loss)) <= 1e-6
        assert float((grads["volume"] - want_grad).abs().max()) <= 1e-5
        sgd = shard.data_parallel_train_step(
            lambda p: torch.optim.SGD(p, lr=1.0), grid, params=ep,
            shard_volume=True)
        l3, stepped, _, _ = sgd(vol, tf, None, cams, target, np.float32(0.0))
        assert abs(float(l3) - float(want_loss)) <= 1e-6
        assert float((stepped - torch.clamp(vol - want_grad, 0.0, 1.0))
                     .abs().max()) <= 1e-5

        checkpoint.save_sharded(tmp_path / "ck", "mcm", state, 4, params,
                                mesh=grid, height=64)
        _, loaded, frame_number, _ = checkpoint.load_sharded(tmp_path / "ck",
                                                             mesh=grid)
        assert frame_number == 4
        for k in want:
            assert torch.equal(loaded[k], want[k]), k
    finally:
        dist.destroy_process_group()


# -- the spatially sharded half of parallel/: K5 halo, K3 slab, K9 band ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_slabs", [4, 2, 1],
                         ids=["contiguous", "two", "one"])
def test_slab_fetch_sums_to_the_whole_fetch(cuda, dtype, num_slabs):
    """K3's slab instance: each slab's masked fetch equals its plain twin
    bit for bit (values, cells with -1 where masked, fractions), and the
    slabs' sum equals the whole table's fetch bit for bit, NaN and
    out-of-range positions included; one launch a slab."""
    from vpt_tpu_torch.parallel import halo

    scene = make_scene(volume.blobs_volume(32, seed=3, device=cuda),
                       transfer.gray_ramp(alpha_scale=0.9, device=cuda),
                       pack_dtype=dtype, device=cuda)
    shape = tuple(scene.volume.shape)
    g = torch.Generator().manual_seed(5)
    pos = torch.rand(65536, 3, generator=g) * 1.4 - 0.2
    pos[:8] = torch.tensor([float("nan"), 0.5, 0.5]).expand(8, 3)
    pos = pos.to(cuda)
    whole = corner_gather.corner_fetch(scene.volume_packed, shape, pos)
    total = torch.zeros_like(whole)
    before = corner_gather.SLAB_LAUNCHES
    for k in range(num_slabs):
        rows = halo.slab_table(scene.volume_packed, shape, num_slabs, k)
        got = corner_gather.slab_fetch(rows, shape, k, num_slabs, 1, pos,
                                       save=True)
        want = corner_gather.slab_fetch_plain(rows, shape, k, num_slabs, 1,
                                              pos, save=True)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b) or torch.equal(torch.nan_to_num(a),
                                                    torch.nan_to_num(b))
        total = total + got[0]
    assert corner_gather.SLAB_LAUNCHES == before + num_slabs
    ok = ~torch.isnan(whole)
    assert torch.equal(total[ok], whole[ok])
    assert torch.equal(torch.isnan(total), torch.isnan(whole))


def test_slab_kernels_take_thin_and_unmasked_slabs(cuda):
    """Interleaved thin slabs and an unmasked slab-local fetch
    (``HaloScene(collective=False)``, ``resident.py``'s) run on the card:
    K3's slab fetch equals its plain twin bit for bit (values, cells,
    fractions), and a halo frame over such a HaloScene equals the plain
    loop over it bit for bit; one launch a fetch, steps + 1 a frame."""
    from vpt_tpu_torch.parallel import halo

    scene = _headline_scene(16, cuda)
    shape = tuple(scene.volume.shape)
    pos = torch.rand(64, 3, generator=torch.Generator().manual_seed(2))
    pos = pos.to(cuda)
    thin = halo.slab_table(scene.volume_packed, shape, 2, 0, 2)
    rows = halo.slab_table(scene.volume_packed, shape, 2, 0)
    params = mcm.Params(steps=2)
    before = (corner_gather.SLAB_LAUNCHES, mcm_event.HALO_LAUNCHES)
    for args in ((thin, shape, 0, 2, 2, pos, True),
                 (rows, shape, 0, 2, 1, pos, False)):
        got = corner_gather.slab_fetch(*args, save=True)
        want = corner_gather.slab_fetch_plain(*args, save=True)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for hs in (halo.halo_scene(scene, 0, 2, interleave=2),
               halo.halo_scene(scene, 0, 2, collective=False)):
        state = mcm.reset(params, 8, 8, scene)
        want = {k: v.clone() for k, v in state.items()}
        mcm.render_frame(state, hs, params, 0.1, 1)
        mcm_event.event_frame_plain(want, dataclasses.replace(
            hs, kernels=False), params, np.float32(0.1))
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(state[k], want[k]), k
    assert (corner_gather.SLAB_LAUNCHES, mcm_event.HALO_LAUNCHES) == (
        before[0] + 2, before[1] + 2 * (params.steps + 1))


def test_slab_fetch_gradient_matches_plain(cuda):
    """``SlabCornerFetch``: K3's slab forward and K4's backward into the
    slab table (masked-out cells skipped) against the plain twin's
    autograd, within the float32 reordering of K4's atomics (1e-5 of the
    largest entry); the slabs' gradients sum to the whole table's."""
    from vpt_tpu_torch.parallel import halo

    vol = volume.blobs_volume(16, seed=2, device=cuda).data
    table = sampling.pack_corner_volume(vol)
    shape = tuple(vol.shape)
    pos = torch.rand(20000, 3, generator=torch.Generator().manual_seed(3))
    pos = (pos * 1.2 - 0.1).to(cuda)
    weight = torch.rand(20000, 1, generator=torch.Generator().manual_seed(4))
    weight = weight.to(cuda)
    leaf = table.clone().requires_grad_(True)
    whole, = torch.autograd.grad(
        (sampling.sample_volume_packed(leaf, shape, pos) * weight).sum(),
        leaf)
    grads = []
    for k in range(2):
        rows = halo.slab_table(table, shape, 2, k).requires_grad_(True)
        out = sampling.sample_slab_packed(rows, shape, k, 2, 1, pos)
        got, = torch.autograd.grad((out * weight).sum(), rows)
        plain = sampling.sample_slab_packed(rows, shape, k, 2, 1, pos,
                                            fused=False)
        want, = torch.autograd.grad((plain * weight).sum(), rows)
        bound = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound
        grads.append(got.reshape(-1, 256, 8))
    ds = 8
    joined = torch.cat([grads[0][:ds], grads[1][:ds]]).reshape(-1, 8)
    assert float((joined - whole).abs().max()) <= 1e-5 * float(
        whole.abs().max())


@pytest.mark.parametrize("kind", ["bf16_cheb", "f32_exact"])
def test_halo_event_frame_matches_plain_and_whole(cuda, kind):
    """K5's halo instance (steps + 1 launches a frame): on one slab it equals
    the whole-frame K5 bit for bit; on each of 2 slabs (no group: the
    rank's own masked values) it equals the plain loop over the same
    HaloScene bit for bit; a 1024-texel environment map takes the map
    instance."""
    from vpt_tpu_torch.parallel import halo

    if kind == "bf16_cheb":
        scene = _headline_scene(32, cuda)
    else:
        scene = make_scene(volume.blobs_volume(32, seed=3, device=cuda),
                           transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                           environment=environment.gradient_sky(
                               16, 64, device=cuda), device=cuda)
    params = mcm.Params(extinction=30.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, 64, 48, scene)
    whole = {k: v.clone() for k, v in state.items()}
    one = {k: v.clone() for k, v in state.items()}
    hs1 = halo.halo_scene(scene, 0, 1)
    before = mcm_event.HALO_LAUNCHES
    for n in range(1, 3):
        mcm.render_frame(whole, scene, params, np.float32(0.1 * n), n)
        mcm.render_frame(one, hs1, params, np.float32(0.1 * n), n)
    torch.cuda.synchronize()
    assert mcm_event.HALO_LAUNCHES == before + 2 * (params.steps + 1)
    for k in whole:
        assert torch.equal(one[k], whole[k]), k
    for k in range(2):
        hs = halo.halo_scene(scene, k, 2)
        got = {key: v.clone() for key, v in state.items()}
        want = {key: v.clone() for key, v in state.items()}
        for n in range(1, 3):
            mcm.render_frame(got, hs, params, np.float32(0.1 * n), n)
            mcm_event.event_frame_plain(want, dataclasses.replace(
                hs, kernels=False), params, np.float32(0.1 * n))
        torch.cuda.synchronize()
        for key in want:
            assert torch.equal(got[key], want[key]), (k, key)


@pytest.mark.parametrize("kind", ["f32", "headline"])
def test_dos_band_matches_plain_and_cooperative(cuda, kind):
    """K9's band instance (one launch a slice) on two uneven bands with
    the whole image as the extended buffer equals its plain twin bit for
    bit, and the cooperative sweep (vpt_tpu's sharded taps against the
    shifted ones) within the port's DOS bounds (``tests/
    test_torch_dos.py``): on float32 tables within 3e-5 and 99% of the
    values within 1e-6, on the headline's bf16 tables with ``tf_mxu``
    (whose lerp weights turn a one-ulp difference into a step of 2^-8,
    ROADMAP queue 3) within 5e-4."""
    scene = _scene(kind, cuda)
    params = dos.Params(extinction=80.0, steps=20, slices=40, samples=6)
    height = width = 96
    coop = dos.reset(params, height, width, scene)
    dos.render_frame(coop, scene, params, 0.0, 1)
    results = []
    for plain in (False, True):
        whole = dos.reset(params, height, width, scene)
        bands = [(r0, {k: (v[r0:r1].clone() if k in ("color", "occlusion")
                           else v.clone()) for k, v in whole.items()})
                 for r0, r1 in ((0, 37), (37, 96))]
        before = dos_sweep.BAND_LAUNCHES
        for k in range(dos.active_slices(bands[0][1], params)):
            ext = torch.cat([b["occlusion"] for _, b in bands])
            for r0, band in bands:
                run = dos_sweep.band_slice_plain if plain \
                    else dos_sweep.band_slice
                run(band, ext, 0, scene, params, k, (r0, height))
        torch.cuda.synchronize()
        if not plain:
            assert dos_sweep.BAND_LAUNCHES == before + 2 * params.steps
        results.append({key: torch.cat([b[key] for _, b in bands])
                        for key in ("color", "occlusion")})
    bound = 3e-5 if kind == "f32" else 5e-4
    for key in ("color", "occlusion"):
        assert torch.equal(results[0][key], results[1][key]), key
        diff = (results[0][key] - coop[key]).abs()
        assert float(diff.max()) <= bound
        if kind == "f32":
            assert float((diff <= 1e-6).float().mean()) >= 0.99


def test_lao_halo_frame_launches_k10_halo_instance(cuda):
    """On the card LAO's HaloScene frame launches K10's halo instance
    (``lao_march.halo_frame_launches`` launches, none of the whole-scene
    K10); besides, a HaloScene frame of a two-channel volume runs K5's
    two-channel halo instance, equal to the ext frame and the plain loop
    bit for bit on one slab, every other renderer runs its kernel's halo
    instance, and DOS's Python hooks raise, naming the sharded frame."""
    from vpt_tpu_torch.parallel import halo

    rg = make_scene(volume.with_gradient_magnitude(
        volume.blobs_volume(16, seed=1, device=cuda)),
        transfer.gray_ramp(device=cuda), device=cuda)
    params = mcm.Params(steps=2)
    # a two-channel HaloScene's frame runs K5's halo instance of two
    # channels: on one slab it equals the ext frame and the plain loop
    state = mcm.reset(params, 8, 8, rg)
    whole = {k: v.clone() for k, v in state.items()}
    plain = {k: v.clone() for k, v in state.items()}
    halo_before = mcm_event.HALO_LAUNCHES
    hs = halo.halo_scene(rg, 0, 1)
    mcm.render_frame(state, hs, params, 0.1, 1)
    mcm.render_frame(whole, rg, params, 0.1, 1)
    mcm_event.event_frame_plain(plain, dataclasses.replace(
        hs, kernels=False), params, np.float32(0.1))
    torch.cuda.synchronize()
    assert mcm_event.HALO_LAUNCHES == halo_before + params.steps + 1
    for k in whole:
        assert torch.equal(state[k], whole[k]), k
        assert torch.equal(state[k], plain[k]), k
    scene = _headline_scene(16, cuda)
    hs = halo.halo_scene(scene, 0, 1)
    for module in (eam, mip, depth, iso, mcs, dos):
        p = module.Params()
        module.render_frame(module.reset(p, 8, 8, scene), hs, p, 0.1, 1)
    before = (_launches(), lao_march.HALO_LAUNCHES)
    p = lao.Params()
    lao.render_frame(lao.reset(p, 8, 8, scene), hs, p, 0.1, 1)
    torch.cuda.synchronize()
    assert (_launches(), lao_march.HALO_LAUNCHES) == (
        before[0], before[1] + lao_march.halo_frame_launches(p))
    p = dos.Params()
    with pytest.raises(ValueError, match="dos_halo.sharded_render_frame"):
        dos.render_frame(dos.reset(p, 8, 8, scene), scene, p, 0.1, 1,
                         ndc=sampling.pixel_ndc(8, 8, device=cuda))


def _halo_launches():
    return (mcm_event.HALO_LAUNCHES, march.HALO_LAUNCHES,
            iso_shade.HALO_LAUNCHES, mcs_frame.HALO_LAUNCHES,
            dos_sweep.HALO_LAUNCHES, dos_sweep.HALO_BAND_LAUNCHES,
            lao_march.HALO_LAUNCHES)


def _halo_kind(kind, cuda):
    """The halo tests' scenes, 24³ (divisible by 2 slabs × interleave 2):
    float32 tables, the headline's (bf16 tables, ``tf_mxu``, the cheb-skip
    table) or two channels (bf16 rows, the packed 2D TF)."""
    if kind == "rg":
        return make_scene(volume.with_gradient_magnitude(
            volume.blobs_volume(24, seed=3, device=cuda)),
            transfer.gray_ramp(alpha_scale=0.8, device=cuda), device=cuda)
    return _scene(kind, cuda)


#: the halo layouts held to the plain twin: (slabs, interleave, masked)
HALO_LAYOUTS = [(2, 1, True), (2, 2, True), (2, 1, False), (2, 2, False)]


def _halo_layouts(scene):
    """(label, HaloScene) of each of :data:`HALO_LAYOUTS`' slabs, no group:
    a masked slab's values stay its own partial, as the plain twin's."""
    from vpt_tpu_torch.parallel import halo

    for count, interleave, masked in HALO_LAYOUTS:
        for k in range(count):
            yield (f"{k}/{count} m{interleave} masked {masked}",
                   halo.halo_scene(scene, k, count, interleave=interleave,
                                   collective=masked))


def _halo_state(module, params, scene, height=40, width=48):
    state = module.reset(params, height, width, scene)
    if isinstance(state, dict):
        return state, lambda: {k: v.clone() for k, v in state.items()}
    return state, state.clone


@pytest.mark.parametrize("kind", ["f32", "bf16", "rg"])
@pytest.mark.parametrize("key", ["eam", "mip", "depth", "iso"])
def test_halo_march_frames(cuda, key, kind):
    """K6's halo instance: on one slab, 2 frames equal the whole-scene
    kernel's bit for bit in 2 launches a frame, a fetch of every slice and
    a fold (the whole-scene counter still); on 2 slabs, contiguous and
    interleaved, masked and not, each slab's frame is within K6's bound of
    the plain twin over the same HaloScene (``assert_kernel_agrees``)."""
    from vpt_tpu_torch.parallel import halo

    scene = _halo_kind(kind, cuda)
    module = RENDERERS[key]
    params = module.Params()
    slices = params.slices if key in ("eam", "depth") else params.steps
    state, fresh = _halo_state(module, params, scene)
    got, want = fresh(), fresh()
    hs = halo.halo_scene(scene, 0, 1)
    before = (march.LAUNCHES, march.HALO_LAUNCHES)
    for n in (1, 2):
        module.render_frame(got, hs, params, 0.3 + 0.01 * n, n)
    launched = (march.LAUNCHES, march.HALO_LAUNCHES)
    for n in (1, 2):
        module.render_frame(want, scene, params, 0.3 + 0.01 * n, n)
    torch.cuda.synchronize()
    assert launched == (before[0], before[1] + 2 * 2)
    assert torch.equal(got, want)
    if key == "iso":
        assert bool((got[..., 3] > 0).any())
    for label, hs in _halo_layouts(scene):
        got, want = fresh(), fresh()
        module.render_frame(got, hs, params, 0.31, 1)
        march.march_frame_plain(key, want, hs, params, 0.31, 1)
        torch.cuda.synchronize()
        assert_kernel_agrees(key, got, want)


#: K6 halo frames past a small value cap: (renderer, scene kind, 64-bit
#: slab rows forced)
MARCH_CHUNK_CASES = [("eam", "bf16", False), ("mip", "f32", False),
                     ("depth", "rg", False), ("iso", "bf16", False),
                     ("eam", "f32", True), ("iso", "rg", True)]


@pytest.mark.parametrize("key,kind,rows64", MARCH_CHUNK_CASES,
                         ids=[f"{k}-{c}" + ("-rows64" if r else "")
                              for k, c, r in MARCH_CHUNK_CASES])
def test_halo_march_frames_in_chunks(cuda, key, kind, rows64, monkeypatch):
    """Past the values' cap a K6 halo frame goes in chunks of slices, a
    fetch, an all-reduce and a fold each, the carry kept between the
    folds: with the cap at 7 slices' values a frame of 64 slices (50 for
    ISO) is ceil(slices / 7) chunks, 2 launches each, and 2 frames equal
    the whole-scene K6's bit for bit; so do frames with the fetch's 64-bit
    slab rows forced (``march.ROWS32`` lowered)."""
    from vpt_tpu_torch.parallel import halo

    scene = _halo_kind(kind, cuda)
    module = RENDERERS[key]
    params = module.Params()
    slices = params.slices if key in ("eam", "depth") else params.steps
    monkeypatch.setattr(_build, "HALO_VALUE_BYTES",
                        7 * 4 * 40 * 48 * scene.channels)
    if rows64:
        monkeypatch.setattr(march, "ROWS32", 1)
    state, fresh = _halo_state(module, params, scene)
    got, want = fresh(), fresh()
    hs = halo.halo_scene(scene, 0, 1)
    for n in (1, 2):
        before = march.HALO_LAUNCHES
        module.render_frame(got, hs, params, 0.3 + 0.01 * n, n)
        assert march.HALO_LAUNCHES == before + 2 * -(-slices // 7)
        module.render_frame(want, scene, params, 0.3 + 0.01 * n, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["f32", "bf16", "rg"])
def test_halo_iso_display(cuda, kind, monkeypatch):
    """K7's halo instance: on one slab the display equals the whole-scene
    K7's bit for bit in 2 launches, and its hits' slots follow pixel order
    (the card's count is the hits); so do a display with no hit (white)
    and one where every pixel hits, and one with the fetch's 64-bit slab
    rows forced (``iso_shade.ROWS32`` lowered); on 2 slabs each slab's
    display equals the plain twin's (K7's bound)."""
    from vpt_tpu_torch.parallel import halo

    scene = _halo_kind(kind, cuda)
    params = iso.Params()
    state = iso.reset(params, 40, 48, scene)
    empty = state.clone()
    for n in (1, 2):
        iso.render_frame(state, scene, params, 0.3 + 0.01 * n, n)
    hit = state[..., 3] > 0
    assert bool(hit.any()) and bool((~hit).any())
    full = state.clone()
    full[~hit] = state[hit][0]
    hs = halo.halo_scene(scene, 0, 1)
    before = (iso_shade.LAUNCHES, iso_shade.HALO_LAUNCHES)
    got = iso.display(state, hs, params)
    assert (iso_shade.LAUNCHES, iso_shade.HALO_LAUNCHES) == (
        before[0], before[1] + 2)
    assert torch.equal(got, iso.display(state, scene, params))
    p = iso_shade._halo_cache.get(hs, (params, 40, 48, 0, 1, 1, 1))
    hits = int(hit.sum())
    assert int(p.scratch["counts"][1]) == hits
    assert torch.equal(p.pixel[:hits].long(),
                       torch.nonzero(hit.reshape(-1)).reshape(-1))
    for other in (empty, full):
        got = iso.display(other, hs, params)
        assert torch.equal(got, iso.display(other, scene, params))
        assert int(p.scratch["counts"][1]) == int((other[..., 3] > 0).sum())
    assert bool((iso.display(empty, hs, params) == 1.0).all())
    monkeypatch.setattr(iso_shade, "ROWS32", 1)
    got = iso.display(state, halo.halo_scene(scene, 0, 1), params)
    assert torch.equal(got, iso.display(state, scene, params))
    for label, hs in _halo_layouts(scene):
        got = iso.display(state, hs, params)
        want = iso_shade.iso_shade_plain(state, hs, params)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label


def _mcs_halo_slowest(state, hs, params, seed, n, monkeypatch):
    """L + 1 of a K8 halo frame from ``state``: its launches with a batch
    of one launch (a read after each), on a copy."""
    monkeypatch.setattr(mcs_frame, "HALO_BATCH", 1)
    launches = mcs_frame.halo_mcs_frame(state.clone(), hs, params, seed, n)
    monkeypatch.undo()
    return launches


@pytest.mark.parametrize("kind", ["f32", "bf16", "rg"])
def test_halo_mcs_frames(cuda, kind, monkeypatch):
    """K8's halo instance (the headline: the cheb-skip table): on one
    slab, 2 frames equal the whole-scene K8's bit for bit, each frame L + 1
    to L + HALO_BATCH launches in at most ceil((L + 1) / HALO_BATCH) + 1
    host reads, L + 1 the launches of a frame read after every launch (L
    the slowest pixel's fetches); on 2 slabs each slab's frame is within
    K8's bound of the plain twin."""
    from vpt_tpu_torch.parallel import halo

    scene = _halo_kind(kind, cuda)
    params = mcs.Params(extinction=8.0)
    state = mcs.reset(params, 40, 48, scene)
    got, want = state.clone(), state.clone()
    hs = halo.halo_scene(scene, 0, 1)
    batch = mcs_frame.HALO_BATCH
    for n in (1, 2):
        seed = 0.3 + 0.01 * n
        slowest = _mcs_halo_slowest(got, hs, params, seed, n, monkeypatch)
        before = (mcs_frame.LAUNCHES, mcs_frame.HALO_LAUNCHES,
                  mcs_frame.HALO_READS)
        launches = mcs_frame.halo_mcs_frame(got, hs, params, seed, n)
        assert (mcs_frame.LAUNCHES, mcs_frame.HALO_LAUNCHES) == (
            before[0], before[1] + launches)
        assert slowest > 2
        assert slowest <= launches <= slowest - 1 + batch
        reads = mcs_frame.HALO_READS - before[2]
        assert reads <= -(-slowest // batch) + 1
    for n in (1, 2):
        mcs.render_frame(want, scene, params, 0.3 + 0.01 * n, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for label, hs in _halo_layouts(scene):
        got, want = state.clone(), state.clone()
        mcs.render_frame(got, hs, params, 0.31, 1)
        mcs_frame.mcs_frame_plain(want, hs, params, 0.31, 1)
        torch.cuda.synchronize()
        assert_kernel_agrees("mcs", got, want)


@pytest.mark.parametrize("kind", ["bf16", "rg"])
def test_halo_mcs_surplus_launches(cuda, kind, monkeypatch):
    """Launches past a frame's end (a batch's surplus: their input count
    is 0) change neither the state nor the values: two frames in a row
    whose batches overrun L + 1 equal K8's two frames bit for bit, with
    every batch of 2, 4, 8 and 16 (longer than the card's three count
    slots) and the next frame starting clean."""
    from vpt_tpu_torch.parallel import halo

    scene = _halo_kind(kind, cuda)
    params = mcs.Params(extinction=8.0)
    start = mcs.reset(params, 40, 48, scene)
    want = start.clone()
    for n in (1, 2):
        mcs.render_frame(want, scene, params, 0.4 + 0.01 * n, n)
    hs = halo.halo_scene(scene, 0, 1)
    overran = False
    for batch in (2, 4, 8, 16):
        got = start.clone()
        for n in (1, 2):
            seed = 0.4 + 0.01 * n
            slowest = _mcs_halo_slowest(got, hs, params, seed, n,
                                        monkeypatch)
            monkeypatch.setattr(mcs_frame, "HALO_BATCH", batch)
            launches = mcs_frame.halo_mcs_frame(got, hs, params, seed, n)
            monkeypatch.undo()
            assert slowest <= launches <= slowest - 1 + batch
            overran = overran or launches > slowest
        torch.cuda.synchronize()
        assert torch.equal(got, want), batch
    assert overran


@pytest.mark.parametrize("kind", ["f32", "bf16", "rg"])
def test_halo_dos_frames(cuda, kind, monkeypatch):
    """K9's halo instance: on one slab, a sweep's 3 frames of 20 slices
    (the last one partly active) and a frame after its end (none active)
    equal the cooperative K9's bit for bit, each frame 2 launches (one
    fetch of every slice, one fold) around one all-reduce; on 2 slabs
    each slab's frame is within K9's bound of the plain twin
    (``assert_dos_agrees``)."""
    from vpt_tpu_torch.parallel import halo

    reduces = []
    reduce_ = halo.HaloScene.reduce_
    monkeypatch.setattr(halo.HaloScene, "reduce_", lambda self, partial: (
        reduces.append(partial.numel()), reduce_(self, partial))[1])
    scene = _halo_kind(kind, cuda)
    params = dos.Params(extinction=80.0, steps=20, slices=50, samples=6)
    state, fresh = _halo_state(dos, params, scene)
    got, want = fresh(), fresh()
    hs = halo.halo_scene(scene, 0, 1)
    for n in (1, 2, 3, 4):
        before = (dos_sweep.LAUNCHES, dos_sweep.HALO_LAUNCHES, len(reduces))
        dos.render_frame(got, hs, params, 0.0, n)
        assert (dos_sweep.LAUNCHES, dos_sweep.HALO_LAUNCHES,
                len(reduces)) == (before[0], before[1] + 2, before[2] + 1)
        assert reduces[-1] == params.steps * 40 * 48 * scene.channels
        dos.render_frame(want, scene, params, 0.0, n)
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), (n, k)
    assert dos.active_slices(got, params) == 0
    assert float(got["color"][..., 3].max()) > 0.0
    for label, hs in _halo_layouts(scene):
        got, want = fresh(), fresh()
        dos.render_frame(got, hs, params, 0.0, 1)
        dos_sweep.sweep_frame_plain(want, dataclasses.replace(
            hs, kernels=False), params)
        torch.cuda.synchronize()
        assert_dos_agrees(got, want)


@pytest.mark.parametrize("kind", ["bf16", "rg"])
def test_halo_dos_frames_in_chunks(cuda, kind, monkeypatch):
    """Past the values' cap a K9 halo frame goes in chunks of slices, a
    fetch, an all-reduce and a fold each: with the cap at 7 slices' values
    a sweep's frames of 20 slices (3 chunks; the last frame partly active,
    its last chunk past the far depth) and one after its end equal the
    cooperative K9's bit for bit."""
    from vpt_tpu_torch.parallel import halo

    scene = _halo_kind(kind, cuda)
    params = dos.Params(extinction=80.0, steps=20, slices=50, samples=6)
    monkeypatch.setattr(_build, "HALO_VALUE_BYTES",
                        7 * 4 * 40 * 48 * scene.channels)
    state, fresh = _halo_state(dos, params, scene)
    got, want = fresh(), fresh()
    hs = halo.halo_scene(scene, 0, 1)
    for n in (1, 2, 3, 4):
        before = dos_sweep.HALO_LAUNCHES
        dos.render_frame(got, hs, params, 0.0, n)
        assert dos_sweep.HALO_LAUNCHES == before + 2 * 3
        dos.render_frame(want, scene, params, 0.0, n)
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), (n, k)


#: K10's halo instances held to K10 on one slab: (label, scene kind,
#: Params kwargs, halo_scene kwargs, row window of a 40-row state); a label
#: "rows64..." forces the 64-bit row instance
LAO_HALO_CASES = [
    ("bf16", "bf16", {}, {}, None),
    ("f32", "f32", {}, {}, None),
    ("rg", "rg", {}, {}, None),
    ("baked", "baked", {}, {}, None),
    ("interleave2", "f32", {}, {"interleave": 2}, None),
    ("unmasked", "bf16", {}, {"collective": False}, None),
    ("window", "f32", {}, {}, (9, 56)),
    ("slices13", "f32", {"slices": 13}, {}, None),
    ("slices16", "bf16", {"slices": 16}, {}, None),
    ("all-miss", "miss", {}, {}, None),
    ("all-dark", "dark", {}, {}, None),
    ("rows64", "bf16", {}, {}, None),
    ("rows64-rg", "rg", {}, {}, None),
    ("rows64-baked", "baked", {}, {}, None),
]


def _lao_halo_scene(kind, cuda):
    """The halo tests' scenes (:func:`_halo_kind`); ``baked`` the f32
    scene's volume with LAO's baked gradient (two channels); ``miss`` the
    f32 scene seen by a camera beside the cube (every pixel a miss);
    ``dark`` a zero volume (every hit pixel marches every slice and stays
    black)."""
    from vpt_tpu_torch.scene import default_camera

    ramp = transfer.gray_ramp(alpha_scale=0.8, device=cuda)
    if kind == "baked":
        return make_scene(volume.with_lao_gradient(
            volume.blobs_volume(24, seed=3, device=cuda)), ramp, device=cuda)
    if kind == "miss":
        return make_scene(volume.blobs_volume(24, seed=3, device=cuda), ramp,
                          camera=default_camera((5.0, 0.0, 2.0), fovy=0.2),
                          device=cuda)
    if kind == "dark":
        return make_scene(volume.Volume(torch.zeros((24, 24, 24, 1),
                                                    device=cuda)), ramp,
                          device=cuda)
    return _halo_kind(kind, cuda)


@pytest.mark.parametrize("case", LAO_HALO_CASES, ids=[c[0] for c in
                                                      LAO_HALO_CASES])
def test_halo_lao_frames(cuda, case, monkeypatch):
    """K10's halo instance: on one slab, 2 frames equal K10's bit for bit,
    each in ``lao_march.halo_frame_launches`` launches (K10's own counter
    still): bf16 and float32 tables, two channels, the baked gradient,
    interleave 2, the unmasked fetch, a row window, 13 and 16 slices,
    all-miss and all-dark frames, and 64-bit slab rows (forced by lowering
    the limit) of one channel, two and the baked gradient.  On 2 slabs,
    contiguous and interleave 2, masked and not, each slab's frame is
    within K10's bound of the plain twin over the same HaloScene
    (``assert_lao_agrees``)."""
    from vpt_tpu_torch.parallel import halo

    label, kind, kwargs, halo_kwargs, window = case
    scene = _lao_halo_scene(kind, cuda)
    params = lao.Params(**{"slices": 20, "baked_gradient": kind == "baked",
                           **kwargs})
    hs = halo.halo_scene(scene, 0, 1, **halo_kwargs)
    want = lao.reset(params, 40, 48, scene)
    lao.render_frame(want, scene, params, 0.1, 1, window=window)
    if label.startswith("rows64"):
        # K10's ext instances take 32-bit rows only: the limit drops after
        # its frame
        monkeypatch.setattr(lao_march, "ROWS32", 0)
    for n in (1, 2):
        got = lao.reset(params, 40, 48, scene)
        before = (lao_march.LAUNCHES, lao_march.HALO_LAUNCHES)
        lao.render_frame(got, hs, params, 0.1, n, window=window)
        assert (lao_march.LAUNCHES, lao_march.HALO_LAUNCHES) == (
            before[0], before[1] + lao_march.halo_frame_launches(params))
        torch.cuda.synchronize()
        assert torch.equal(got, want), n
    prepared = lao_march._halo_cache.get(
        hs, (params, 40, 48) + sampling.row_window(window, 40))
    assert prepared.args.rows64 == int(label.startswith("rows64"))
    # the values between frames stay zero
    assert not bool(prepared.value.any())
    if kind == "miss":
        black = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cuda)
        assert bool((want == black).all())
    elif kind == "dark":
        assert float(want[..., :3].abs().max()) == 0.0
    else:
        assert float(want[..., :3].max()) > 0.0
    if halo_kwargs or window or kind in ("miss", "dark"):
        return
    for label, hs in _halo_layouts(scene):
        got = lao.reset(params, 40, 48, scene)
        plain = got.clone()
        lao.render_frame(got, hs, params, 0.1, 1)
        lao_march.lao_frame_plain(plain, hs, params)
        torch.cuda.synchronize()
        assert_lao_agrees(got, plain)


#: K9's halo band instance's cases: (label, scene kind, frame's slices)
DOS_BAND_CASES = [("f32", "f32", 20), ("bf16", "bf16", 20),
                  ("rg", "rg", 20), ("steps13", "f32", 13),
                  ("all-miss", "miss", 20), ("all-dark", "dark", 20)]


def _bands_frame(sc, state, run, params, windows, height):
    """A frame from ``state`` on the bands of ``windows`` of an image of
    ``height`` rows in one process, each active slice the whole image's
    previous occlusion as every band's extended buffer, ``run`` being
    ``band_slice`` or its plain twin; the frame and its active slices."""
    bands = [{k: (v[r0:r1].clone() if k in ("color", "occlusion")
                  else v.clone()) for k, v in state.items()}
             for r0, r1 in windows]
    n_active = dos.active_slices(bands[0], params)
    for k in range(n_active):
        ext = torch.cat([b["occlusion"] for b in bands])
        for (r0, _), band in zip(windows, bands):
            run(band, ext, 0, sc, params, k, (r0, height), n_active)
    out = {key: torch.cat([b[key] for b in bands])
           for key in ("color", "occlusion")}
    out["depth"] = state["depth"] + float(n_active) * state["slice_distance"]
    return {**state, **out}, n_active


@pytest.mark.parametrize("case", DOS_BAND_CASES,
                         ids=[c[0] for c in DOS_BAND_CASES])
def test_halo_dos_bands(cuda, case):
    """K9's halo band instance: on one slab, two uneven bands of a 48²
    frame (two windows, the whole image as each slice's extended buffer)
    over a sweep's 2 frames equal K9's band instance bit for bit, in
    ceil(n / 8) fetches and n folds a band for n active slices (the band
    instance's counter still): float32 and bf16 tables, two channels, 13
    slices a frame, all-miss and all-dark frames; on 2 slabs each band is
    within K9's bound of the plain band twin over the same HaloScene
    (``assert_dos_agrees``)."""
    from vpt_tpu_torch.parallel import halo

    label, kind, steps = case
    scene = _lao_halo_scene(kind, cuda)
    params = dos.Params(extinction=80.0, steps=steps, slices=30, samples=6)
    height = width = 48
    windows = ((0, 19), (19, 48))

    def plain(band, ext, ext_row0, sc, p, k, window, n_active):
        dos_sweep.band_slice_plain(band, ext, ext_row0, sc, p, k, window)

    hs = halo.halo_scene(scene, 0, 1)
    got = want = dos.reset(params, height, width, scene)
    for frame in (1, 2):
        before = (dos_sweep.BAND_LAUNCHES, dos_sweep.HALO_BAND_LAUNCHES)
        got, active = _bands_frame(hs, got, dos_sweep.band_slice, params,
                                   windows, height)
        assert (dos_sweep.BAND_LAUNCHES, dos_sweep.HALO_BAND_LAUNCHES) == (
            before[0], before[1] + 2 * (-(-active // 8) + active)), frame
        want, _ = _bands_frame(scene, want, dos_sweep.band_slice, params,
                               windows, height)
        torch.cuda.synchronize()
        for key in ("color", "occlusion", "depth"):
            assert torch.equal(got[key], want[key]), (frame, key)
    assert active == params.steps if steps == 13 else active < params.steps
    # a miss writes nothing; the zero volume's TF alpha at 0 is 1/640
    alpha = float(got["color"][..., 3].max())
    assert alpha == 0.0 if kind == "miss" else alpha > 0.0
    if kind in ("miss", "dark"):
        return
    start = dos.reset(params, height, width, scene)
    for label, hs in _halo_layouts(scene):
        got, _ = _bands_frame(hs, start, dos_sweep.band_slice, params,
                              windows, height)
        want, _ = _bands_frame(hs, start, plain, params, windows, height)
        torch.cuda.synchronize()
        assert_dos_agrees(got, want)


@pytest.mark.parametrize("kind", ["whole", "halo"])
def test_dos_band_frame_is_prepared_once(cuda, kind):
    """``dos_sweep.band_frame`` prepares a band's frame once: the same
    state tensors and active slices find it again, a new depth tensor (the
    next frame's) prepares another; ``dos.render_band`` runs its slices
    through one frame and equals ``band_slice`` a slice; a slice refuses an
    extended buffer that does not cover the band, a slice past the
    frame's, and an extended buffer of another dtype or width."""
    from vpt_tpu_torch.parallel import halo

    scene = _scene("f32", cuda)
    sc = halo.halo_scene(scene, 0, 1) if kind == "halo" else scene
    params = dos.Params(extinction=80.0, steps=20, slices=30, samples=6)
    start = dos.reset(params, 32, 32, scene)
    band = {k: (v[8:20].clone() if k in ("color", "occlusion")
                else v.clone()) for k, v in start.items()}
    n = dos.active_slices(band, params)
    frame = dos_sweep.band_frame(band, sc, params, (8, 32), n)
    assert dos_sweep.band_frame(band, sc, params, (8, 32), n) is frame
    other = dict(band, depth=band["depth"].clone())
    assert dos_sweep.band_frame(other, sc, params, (8, 32), n) is not frame
    ext = start["occlusion"].clone()
    with pytest.raises(RuntimeError, match="vpt_dos_band"):
        frame.slice(ext[10:], 10, 0)
    with pytest.raises(RuntimeError, match="vpt_dos_band"):
        frame.slice(ext, 0, params.steps if kind == "whole" else n)
    with pytest.raises(ValueError, match="extended occlusion"):
        frame.slice(ext.double(), 0, 0)
    with pytest.raises(ValueError, match="extended occlusion"):
        frame.slice(ext[:, :16].contiguous(), 0, 0)
    a = {k: v.clone() for k, v in band.items()}
    b = {k: v.clone() for k, v in band.items()}
    dos.render_band(a, sc, params, (8, 32), lambda occ: (
        torch.cat([start["occlusion"][:8], occ, start["occlusion"][20:]]),
        0))
    for k in range(n):
        ext = torch.cat([start["occlusion"][:8], b["occlusion"],
                         start["occlusion"][20:]])
        dos_sweep.band_slice(b, ext, 0, sc, params, k, (8, 32), n)
    b["depth"] = b["depth"] + float(n) * b["slice_distance"]
    torch.cuda.synchronize()
    for key in ("color", "occlusion", "depth"):
        assert torch.equal(a[key], b[key]), key


def test_halo_world_of_one_over_nccl(cuda):
    """``halo.sharded_render_frame`` on one slab in a world of one over
    ``nccl`` equals ``shard_render_frame``'s K5 frame bit for bit; the
    sharded EAM gradient on one slab equals ``train.render_eam``'s within
    1e-5 of its largest entry, the loss within 1e-6; ``dos_halo`` on one
    band equals the band path through ``shard_render_frame``."""
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import (distributed, make_mesh, place_state,
                                        shard_render_frame)
    from vpt_tpu_torch.parallel import dos_halo, halo
    from vpt_tpu_torch.parallel.halo_grad import make_sharded_grad
    from vpt_tpu_torch.parallel.halo_grad import place_slabs

    assert distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                                  retries=1)
    try:
        grid = make_mesh(1)
        scene = _headline_scene(32, cuda)
        params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)
        whole = mcm.reset(params, 64, 48, scene)
        frame_fn, slabs = halo.sharded_render_frame(mcm, grid, scene, 1,
                                                    whole)
        a, b = place_state(whole, grid), place_state(whole, grid)
        frame = shard_render_frame(mcm, grid, whole)
        for n in range(1, 3):
            frame_fn(a, slabs, params, np.float32(0.1 * n), n)
            frame(b, scene, params, np.float32(0.1 * n), n)
        torch.cuda.synchronize()
        for k in a:
            assert torch.equal(a[k], b[k]), k

        vol = volume.blobs_volume(16, seed=5, device=cuda)
        escene = make_scene(vol, transfer.gray_ramp(device=cuda),
                            pack=False, device=cuda)
        ep = eam.Params(slices=16, random=False, extinction=60.0)
        target = torch.full((12, 12, 3), 0.4, device=cuda)

        def expected(sc, p, h, w, frames, seed0=0.0, score_floor=None):
            return eam.generate(sc, p, np.float32(seed0), h, w)

        grad_fn = make_sharded_grad(grid, escene, ep, 12, 12, 1, 1,
                                    expected=expected)
        loss, body = grad_fn(place_slabs(vol.data, grid, 1), target, 0.0)
        leaf = vol.data.clone().requires_grad_(True)
        cams = (escene.mvp_inverse, escene.model_view, escene.projection)
        want = train.render_eam(leaf, escene.transfer, cams, ep,
                                np.float32(0.0), 12, 12)
        want_loss = torch.mean((want[..., :3] - target) ** 2)
        want_grad, = torch.autograd.grad(want_loss, leaf)
        assert abs(float(loss) - want_loss.detach().item()) <= 1e-6
        scale = float(want_grad.abs().max())
        assert scale > 0
        assert float((body[0] - want_grad).abs().max()) <= 1e-5 * scale

        dp = dos.Params(extinction=80.0, steps=20, slices=40, samples=6)
        dwhole = dos.reset(dp, 64, 64, scene)
        dframe, _ = dos_halo.sharded_render_frame(grid, scene, dp, 64, 64,
                                                  donate=False)
        got = dframe(place_state(dwhole, grid), scene, dp, 0.0, 1)
        plain = {k: v.clone() for k, v in dwhole.items()}
        dos.render_band(plain, scene, dp, (0, 64),
                        lambda occ: (occ.clone(), 0))
        torch.cuda.synchronize()
        for k in ("color", "occlusion", "depth"):
            assert torch.equal(got[k], plain[k]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["headline", "f32", "rg"])
def test_resident_world_of_one_over_nccl(cuda, kind):
    """``resident.resident_render_frame`` on one slab in a world of one
    over ``nccl`` (K5's resident instance: steps + 1 launches an exact
    frame, (m + 1) a round of the amortized mode): every pool field and
    counter equals the plain resident frame's (``kernels=False``) bit for
    bit, and the assembled state equals K5's frame of the whole scene."""
    import torch.distributed as dist

    from vpt_tpu_torch.parallel import distributed, make_mesh, resident

    if kind == "headline":
        scene = _headline_scene(32, cuda)
    elif kind == "f32":
        scene = make_scene(volume.blobs_volume(32, seed=3, device=cuda),
                           transfer.gray_ramp(alpha_scale=0.8, device=cuda),
                           environment=environment.gradient_sky(
                               16, 64, device=cuda), device=cuda)
    else:
        scene = make_scene(volume.with_gradient_magnitude(
            volume.blobs_volume(32, seed=1, device=cuda)),
            transfer.gray_ramp(alpha_scale=0.9, device=cuda), device=cuda)
    assert distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                                  retries=1)
    try:
        grid = make_mesh(1)
        params = mcm.Params(extinction=30.0, anisotropy=0.3, steps=8)
        plain_scene = dataclasses.replace(scene, kernels=False)
        for every, launches in ((1, params.steps + 1),
                                (2, params.steps // 2 * 3)):
            pool = resident.resident_reset(scene, params, 64, 48, grid, 1)
            plain = {k: v.clone() for k, v in pool.items()}
            fn, tables = resident.resident_render_frame(
                grid, scene, 1, 64, 48, migrate_every=every)
            pfn, ptables = resident.resident_render_frame(
                grid, plain_scene, 1, 64, 48, migrate_every=every)
            whole = mcm.reset(params, 64, 48, scene)
            before = (mcm_event.RESIDENT_LAUNCHES, _launches())
            for n in range(1, 3):
                fn(pool, tables, params, np.float32(0.1 * n), n)
            assert mcm_event.RESIDENT_LAUNCHES == before[0] + 2 * launches
            assert _launches() == before[1]
            for n in range(1, 3):
                pfn(plain, ptables, params, np.float32(0.1 * n), n)
                mcm.render_frame(whole, scene, params, np.float32(0.1 * n),
                                 n)
            torch.cuda.synchronize()
            for k in pool:
                assert torch.equal(pool[k], plain[k]), (every, k)
            got = resident.assemble(pool, 64, 48, grid)
            for k in whole:
                assert torch.equal(got[k], whole[k]), (every, k)
    finally:
        dist.destroy_process_group()
