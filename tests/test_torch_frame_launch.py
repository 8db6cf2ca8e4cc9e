"""What the CPU can check of the frame kernels' launch paths (K6
``kernels/march.py``, K7 ``kernels/iso_shade.py``, K8
``kernels/mcs_frame.py``, K9 ``kernels/dos_sweep.py``, K10
``kernels/lao_march.py``) and of what the kernels compute from the host's
numbers.

- A frame's scalars come from Python floats rounded to float32 one IEEE
  operation at a time (``_build.f32``), not from numpy: they must equal
  ``march.frame_scalars``, which the plain frames take, bit for bit; so
  must K7's h and 2h the plain gradient's, and its light the plain
  shade's.
- K9 reads the frame's per-slice constants from ``dos.slice_table``, which
  must hold, bit for bit, what vpt_tpu's frame computes in its own order;
  K10 reads ``rx``, ``rconst``, the light and the AO taps that the plain
  frame computes, prepared once.
- MIP's kernel takes ``x − floor(x)`` for ``fmod(x, 1)`` of its schedule
  value ``x = offset + s·step``; that is exact on every slice the renderer
  can make.
- The kernels map threads to 8×4 warp tiles of 16×8 block tiles
  (``csrc/ray.cuh``); the Python copy of the map, which takes the tile
  shape the kernels report, must cover every pixel once.
"""

import numpy as np
import pytest
import torch

from vpt_tpu_torch import math3d, transfer, volume
from vpt_tpu_torch.kernels import _build, dos_sweep, iso_shade, lao_march
from vpt_tpu_torch.kernels import march, mcs_frame
from vpt_tpu_torch.renderers import depth, dos, eam, iso, lao, make_scene
from vpt_tpu_torch.renderers import mcs, mip


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32
MARCH_PARAMS = [("eam", eam.Params()), ("eam", eam.Params(random=False)),
                ("eam", eam.Params(slices=7)), ("mip", mip.Params()),
                ("mip", mip.Params(steps=3)), ("depth", depth.Params()),
                ("depth", depth.Params(random=True, slices=100)),
                ("iso", iso.Params()), ("iso", iso.Params(steps=13))]


def _bits(x):
    return int(F32(x).view(np.uint32))


@pytest.mark.parametrize("mode,params", MARCH_PARAMS,
                         ids=[f"{m}-{i}" for i, (m, _) in
                              enumerate(MARCH_PARAMS)])
def test_march_frame_scalars_equal_frame_scalars(mode, params):
    """The launch path's first value and weight equal frame_scalars' for
    1000 seeds (with the edges 0 and the largest float32 below 1) and every
    frame number 1..64."""
    rs = np.random.default_rng(7)
    seeds = list(rs.random(998, dtype=np.float32)) \
        + [F32(0.0), np.nextafter(F32(1.0), F32(0.0))]
    _, step, *_ = march.frame_scalars(mode, params, 0.0, 1)
    first = march.first_of(mode, params, step)
    for k, seed in enumerate(seeds):
        n = 1 + k % 64
        _, _, want_first, _, _, want_mix = march.frame_scalars(mode, params,
                                                               seed, n)
        assert _bits(first(seed)) == _bits(want_first), (seed, n)
        assert _bits(march.frame_mix(n)) == _bits(want_mix), n


def test_mip_wrap_equals_fmod_on_every_slice():
    """fmod(x, 1) of x = offset + f32(s)·step (float32, no contraction) is
    x − floor(x), as the kernel computes it: x is never below +0, and
    floor(x) is 0 or lies in [x/2, x], where the difference is exact.
    102 400 offsets (400 for each step count, with 0 and 1), every slice
    of steps 1..256, then 10^5 float32 values up to 2^30."""
    rs = np.random.default_rng(9)

    def wrap(x):
        return x - np.floor(x)

    for steps in range(1, 257):
        offsets = rs.random(400, dtype=np.float32)
        offsets[:2] = (0.0, 1.0)
        step = F32(1.0 / steps)
        x = offsets[:, None] + np.arange(steps, dtype=F32)[None, :] * step
        assert x.dtype == F32 and bool((x >= 0.0).all())
        assert np.array_equal(wrap(x).view(np.uint32),
                              np.fmod(x, F32(1.0)).view(np.uint32))
    x = (rs.random(100_000) * 2.0 ** rs.integers(0, 31, 100_000)) \
        .astype(F32)
    assert np.array_equal(wrap(x).view(np.uint32),
                          np.fmod(x, F32(1.0)).view(np.uint32))


@pytest.mark.parametrize("tile", [(16, 8, 8), (32, 4, 8), (8, 16, 4)],
                         ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("height,width", [(1, 1), (1, 512), (512, 1),
                                          (48, 80), (511, 513), (512, 1024)],
                         ids=lambda v: None)
def test_tile_map_covers_every_pixel_once(height, width, tile):
    """Every pixel has exactly one thread; each warp's pixels lie in one
    warp tile.  ``tile`` = (block width, block height, warp width): the
    kernels' own (16, 8, 8) and two others of 128 threads."""
    tile_w, tile_h, warp_w = tile
    x, y, inside = _build.tile_pixels(width, height, tile_w, tile_h, warp_w)
    assert x.shape[0] % (tile_w * tile_h) == 0
    index = y[inside] * width + x[inside]
    assert np.array_equal(np.sort(index), np.arange(height * width))
    wx, wy = x.reshape(-1, 32), y.reshape(-1, 32)
    assert bool((wx.max(1) - wx.min(1) == warp_w - 1).all())
    assert bool((wy.max(1) - wy.min(1) == 32 // warp_w - 1).all())


def test_f32_rounds_as_numpy():
    """_build.f32 is np.float32's rounding (ties to even), and f32_bits its
    bits, on values near float32's midpoints and edges."""
    rs = np.random.default_rng(10)
    values = list(rs.random(2000) * 10.0 ** rs.integers(-40, 38, 2000)) \
        + [1.0 + 2.0 ** -24, 1.0 + 3 * 2.0 ** -24, -0.0, 0.0, 2.0 ** -149,
           3.0 * 2.0 ** -150]
    for v in values:
        assert _bits(_build.f32(v)) == _bits(v) == _build.f32_bits(v)


@pytest.fixture(scope="module")
def cpu_scene():
    return make_scene(volume.sphere_volume(8, device="cpu"),
                      transfer.gray_ramp(device="cpu"), device="cpu")


def test_launch_preparation_is_kept_per_mode_params_and_size(cpu_scene):
    """A frame's preparation is kept while the scene, mode, Params and
    resolution stay, and made anew when one changes; the prepared
    arguments carry the scene's table and the frame's static scalars."""
    cache = march._scene_cache
    key = ("depth", depth.Params(), 4, 6)
    p = cache.get(cpu_scene, key)
    assert cache.get(cpu_scene, ("depth", depth.Params(), 4, 6)) is p
    assert (p.args.table, p.args.d, p.args.width, p.args.height) == (
        cpu_scene.volume_packed.data_ptr(), 8, 6, 4)
    assert (p.args.slices, p.args.mode, tuple(p.shape)) == (64, 2, (4, 6, 4))
    assert p.args.level == pytest.approx(0.1) and p.first(0.3) == 0.0
    assert cache.get(cpu_scene, ("depth", depth.Params(), 4, 7)) is not p
    q = mcs_frame._scene_cache.get(cpu_scene, (mcs.Params(), 5, 5))
    assert (q.args.width, q.args.use_skip, q.args.extinction) == (5, 0, 1.0)


@pytest.fixture(scope="module")
def option_scene():
    """A scene with every option of the scene: both clamp boxes (the sRGB
    TF gives the low values alpha 0), a majorant grid and a sky map."""
    from vpt_tpu_torch import environment

    return make_scene(volume.sphere_volume(16, device="cpu"),
                      transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                      tf_srgb=True, march_clamp=True, iso_clamp_min=0.1,
                      majorant_grid=4,
                      environment=environment.gradient_sky(8, 16,
                                                           device="cpu"),
                      device="cpu")


@pytest.mark.parametrize("mode,params,boxes", [
    ("eam", eam.Params(), ("occupied_aabb",)),
    ("mip", mip.Params(), ("occupied_aabb",)),
    ("depth", depth.Params(), ("occupied_aabb",)),
    ("iso", iso.Params(), ("occupied_aabb", "iso_aabb")),
    ("iso", iso.Params(isovalue=0.05), ("occupied_aabb",)),
    ("iso", iso.Params(isovalue=0.0), ())])
def test_march_preparation_carries_the_boxes_that_hold(option_scene, mode,
                                                       params, boxes):
    """K6's prepared arguments list the boxes the renderer's plain interval
    clamps to, in its order, with their float32 corners (lo, then hi)."""
    p = march._scene_cache.get(option_scene, (mode, params, 4, 4))
    assert p.args.boxes == len(boxes)
    want = [v for name in boxes
            for v in getattr(option_scene, name).reshape(-1).tolist()]
    assert list(p.args.box)[:len(want)] == want
    assert [b is getattr(option_scene, n) for b, n in zip(
        march.clamp_boxes(mode, option_scene, params), boxes)] \
        == [True] * len(boxes)


def test_mc_preparations_carry_the_map_and_the_grid(option_scene):
    """K5's and K8's prepared arguments point at the whole map with its
    size (no 1×1 texel is cut from it); K5's at the (N³, 2) grid."""
    from vpt_tpu_torch.kernels import mcm_event

    p = mcm_event._scene_cache.get(option_scene, (False, 4, 4))
    env, grid = p.tensors[-2], p.tensors[-1]
    assert tuple(env.shape) == (8, 16, 4) and tuple(grid.shape) == (64, 2)
    assert torch.equal(grid.reshape(4, 4, 4, 2), option_scene.majorant)
    assert p.args[8:13] == (env.data_ptr(), 8, 16, grid.data_ptr(), 4)
    q = mcs_frame._scene_cache.get(option_scene, (mcs.Params(), 4, 4))
    assert (q.args.env, q.args.env_h, q.args.env_w) == (
        q.tensors[-1].data_ptr(), 8, 16)
    plain = make_scene(volume.sphere_volume(8, device="cpu"),
                       transfer.gray_ramp(device="cpu"), device="cpu")
    p = mcm_event._scene_cache.get(plain, (False, 4, 4))
    assert p.args[9:13] == (1, 1, None, 0)


def test_iso_shade_preparation_is_kept_per_params_and_size(cpu_scene):
    """K7's preparation is kept while the scene, Params and resolution
    stay, and made anew when the light, the gradient step or the size
    changes; it carries the scene's table, TF row and lookup mode."""
    cache = iso_shade._scene_cache
    p = cache.get(cpu_scene, (iso.Params(), 4, 6))
    assert cache.get(cpu_scene, (iso.Params(), 4, 6)) is p
    assert (p.args.table, p.args.tf_row, p.args.d, p.args.tw) == (
        cpu_scene.volume_packed.data_ptr(),
        cpu_scene.transfer_1d.data_ptr(), 8, 256)
    assert (p.args.width, p.args.height, p.args.tf_mode, p.device) == (
        6, 4, 0, -1)
    assert tuple(p.shape) == (4, 6, 4) and p.launch is None
    for key in ((iso.Params(light=(1.0, 2.0, 3.0)), 4, 6),
                (iso.Params(gradient_step=0.01), 4, 6),
                (iso.Params(), 4, 7), (iso.Params(), 5, 6)):
        q = cache.get(cpu_scene, key)
        assert q is not p and cache.get(cpu_scene, key) is q
        p = cache.get(cpu_scene, (iso.Params(), 4, 6))
    assert (q.args.width, q.args.height) == (6, 5)


@pytest.mark.parametrize("field", ["volume_packed", "transfer_1d",
                                   "model_view", "tf_mxu"])
def test_iso_shade_preparation_follows_the_scene(field):
    """A new table, TF row, camera or TF lookup mode makes a new
    preparation, with the new pointer, mode or light."""
    scene = make_scene(volume.sphere_volume(8, device="cpu"),
                       transfer.gray_ramp(device="cpu"), device="cpu")
    key = (iso.Params(), 3, 3)
    p = iso_shade._scene_cache.get(scene, key)
    if field == "tf_mxu":
        scene.tf_mxu = torch.bfloat16
    elif field == "model_view":
        scene.model_view = scene.model_view @ torch.diag(
            torch.tensor([1.0, -1.0, -1.0, 1.0]))
    else:
        setattr(scene, field, getattr(scene, field).clone())
    light = (p.args.lx, p.args.ly, p.args.lz)
    q = iso_shade._scene_cache.get(scene, key)
    assert q is not p
    assert (q.args.table, q.args.tf_row, q.args.tf_mode) == (
        scene.volume_packed.data_ptr(), scene.transfer_1d.data_ptr(),
        2 if field == "tf_mxu" else 0)
    assert (q.args.lx, q.args.ly, q.args.lz) == tuple(
        iso.light_direction(scene, iso.Params()).tolist())
    assert ((q.args.lx, q.args.ly, q.args.lz) != light) \
        == (field == "model_view")


def test_iso_shade_prepared_steps_are_float32(cpu_scene):
    """h and 2h as the plain gradient takes them: np.float32(h) and
    np.float32(2·np.float32(h)), bit for bit, in the Structure the kernel
    reads, for 300 steps across six decades and the edges of float32's
    rounding."""
    rs = np.random.default_rng(12)
    steps = list(rs.random(294) * 10.0 ** rs.integers(-6, 0, 294)) + [
        0.005, 1e-3, 0.1, 1.0 / 3.0, 1.0 + 2.0 ** -24, 3.0 * 2.0 ** -150]
    for h in steps:
        p = iso_shade._scene_cache.get(
            cpu_scene, (iso.Params(gradient_step=h), 2, 2))
        assert _bits(p.args.step) == _bits(F32(h)), h
        assert _bits(p.args.two_step) == _bits(F32(2 * F32(h))), h


@pytest.mark.parametrize("light", [(2.0, -3.0, -5.0), (0.0, 0.0, 1.0),
                                   (-1.5, 4.0, 0.25)])
def test_iso_shade_prepared_light_is_the_plain_one(cpu_scene, light):
    """The prepared light is ``iso.light_direction`` on the scene's device,
    carried unrounded by the Structure the kernel reads."""
    params = iso.Params(light=light)
    p = iso_shade._scene_cache.get(cpu_scene, (params, 2, 2))
    want = iso.light_direction(cpu_scene, params)
    assert torch.equal(torch.tensor([p.args.lx, p.args.ly, p.args.lz]),
                       want)


def test_iso_cpu_display_is_the_plain_shade(cpu_scene):
    """A CPU state takes the plain shade and launches nothing; what the
    kernel would not take raises before any launch."""
    params = iso.Params()
    state = iso.reset(params, 12, 10, cpu_scene)
    iso.render_frame(state, cpu_scene, params, 0.3, 1)
    assert bool((state[..., 3] > 0).any())
    before = iso_shade.LAUNCHES
    got = iso.display(state, cpu_scene, params)
    assert torch.equal(got, iso_shade.iso_shade_plain(state, cpu_scene,
                                                      params))
    assert iso_shade.LAUNCHES == before
    with pytest.raises(ValueError, match="32-bit"):
        iso_shade._scene_cache.get(cpu_scene, (params, 2 ** 16, 2 ** 15))
    unpacked = make_scene(volume.sphere_volume(8, device="cpu"),
                          transfer.gray_ramp(device="cpu"), pack=False,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="pack=True"):
        iso_shade._scene_cache.get(unpacked, (params, 2, 2))


def test_march_refuses_huge_tables():
    """The march kernel indexes corner rows with 32-bit integers; the
    largest volume below 2^31 cells passes."""
    with pytest.raises(ValueError, match="32-bit"):
        march.check_rows((2 ** 11, 2 ** 10, 2 ** 10))
    march.check_rows((2 ** 31 - 1, 1, 1))


def test_cpu_counts_raise(cpu_scene):
    """Only the kernel counts its steps."""
    state = mcs.reset(mcs.Params(), 4, 4, cpu_scene)
    with pytest.raises(ValueError, match="counts"):
        mcs_frame.mcs_frame(state, cpu_scene, mcs.Params(), 0.1, 1,
                            counts=torch.zeros(2, dtype=torch.int64))


# -- K9 (DOS) and K10 (LAO) ---------------------------------------------


@pytest.mark.parametrize("params,size", [
    (dos.Params(), (16, 16)), (dos.Params(steps=7, samples=3), (12, 20)),
    (dos.Params(aperture=55.0, slices=31), (20, 9))],
    ids=["default", "odd", "wide-aperture"])
def test_dos_slice_table_equals_the_plain_constants(cpu_scene, params,
                                                    size):
    """Each column of the table, after one frame moved the depth, equals
    the constant recomputed as vpt_tpu's frame computes it (depths = depth
    + i·Δ, the projected [1, 1, −depth] for the NDC depth and the
    occlusion scale, the taps' clipped floor and fraction), bit for bit."""
    h, w = size
    state = dos.reset(params, h, w, cpu_scene)
    dos.render_frame(state, cpu_scene, params, 0.2, 1)
    table = dos.slice_table(state, cpu_scene, params)
    n, taps = params.steps, params.samples
    assert table.shape == (n, dos.TABLE_HEAD + 4 * taps)
    assert table.dtype == torch.float32 and table.is_contiguous()
    sd = state["slice_distance"]
    depths = state["depth"] + torch.arange(n, dtype=torch.float32) * sd
    corr = math3d.transform_point(cpu_scene.projection, torch.stack(
        [torch.ones(n), torch.ones(n), -depths], dim=-1))
    rad = F32(F32(params.aperture) * F32(np.pi)) / F32(180.0)
    extent = sd * torch.tan(torch.tensor(rad))
    scale = corr[:, :2] * extent
    dd = state["offsets"][None] * scale[:, None, :] * torch.tensor(
        [float(w), float(h)])
    base = torch.clamp(torch.floor(dd), -(w + 1), w + 1)
    assert torch.equal(table[:, 0], corr[:, 2])
    assert torch.equal(table[:, 1], (depths <= state["max_depth"]).float())
    assert torch.equal(table[:, 2], sd.expand(n))
    rows = table[:, dos.TABLE_HEAD:].reshape(n, taps, 4)
    assert torch.equal(rows[..., :2], base)
    assert torch.equal(rows[..., 2:], dd - base)
    assert float(rows[..., :2].abs().max()) <= w + 1


def test_dos_preparation_is_kept_per_params_and_size(cpu_scene):
    """K9's preparation is kept while the scene, Params and resolution
    stay, and made anew when one changes; it carries the scene's table, TF
    row, MVP and lookup mode, the tap count and the float32 extinction."""
    cache = dos_sweep._scene_cache
    p = cache.get(cpu_scene, (dos.Params(), 4, 6))
    assert cache.get(cpu_scene, (dos.Params(), 4, 6)) is p
    assert (p.args.table, p.args.tf_row) == (
        cpu_scene.volume_packed.data_ptr(), cpu_scene.transfer_1d.data_ptr())
    assert torch.equal(p.tensors[2], cpu_scene.mvp_inverse)
    assert p.args.mvp == p.tensors[2].data_ptr()
    assert (p.args.width, p.args.height, p.args.samples, p.args.tf_mode,
            p.device, p.launch) == (6, 4, 8, 0, -1, None)
    assert tuple(p.color_shape) == (4, 6, 4)
    assert tuple(p.occlusion_shape) == (4, 6)
    for key in ((dos.Params(samples=3), 4, 6), (dos.Params(), 4, 7),
                (dos.Params(extinction=1.1), 4, 6)):
        q = cache.get(cpu_scene, key)
        assert q is not p and cache.get(cpu_scene, key) is q
        p = cache.get(cpu_scene, (dos.Params(), 4, 6))
    assert _bits(q.args.extinction) == _bits(F32(1.1))
    with pytest.raises(ValueError, match="32-bit"):
        cache.get(cpu_scene, (dos.Params(), 2 ** 16, 2 ** 15))
    unpacked = make_scene(volume.sphere_volume(8, device="cpu"),
                          transfer.gray_ramp(device="cpu"), pack=False,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="pack=True"):
        cache.get(unpacked, (dos.Params(), 2, 2))


def test_dos_cpu_frame_is_the_plain_sweep(cpu_scene):
    """A CPU state takes the plain sweep and launches nothing."""
    params = dos.Params(steps=5, slices=10, samples=4)
    state = dos.reset(params, 10, 12, cpu_scene)
    plain = {k: v.clone() for k, v in state.items()}
    before = dos_sweep.LAUNCHES
    for n in range(1, 3):
        dos.render_frame(state, cpu_scene, params, 0.1, n)
        dos_sweep.sweep_frame_plain(plain, cpu_scene, params)
    assert dos_sweep.LAUNCHES == before
    assert all(torch.equal(state[k], plain[k]) for k in state)
    assert float(state["color"][..., 3].max()) > 0.0


@pytest.mark.parametrize("size", [(16, 16), (9, 20)])
def test_lao_preparation_holds_the_plain_values(cpu_scene, size):
    """K10's prepared rx is the plain frame's (``lao.pixel_random`` on the
    scene's device), bit for bit; rconst, the light and the AO taps in the
    Structure are the plain values unrounded; the step is float32(1 /
    slices); the preparation is kept per (scene, Params, resolution)."""
    h, w = size
    params = lao.Params()
    cache = lao_march._scene_cache
    p = cache.get(cpu_scene, (params, h, w))
    assert cache.get(cpu_scene, (params, h, w)) is p
    ctx = lao.setup(cpu_scene, params, h, w)
    assert torch.equal(p.rx, lao.pixel_random(h, w, "cpu"))
    assert torch.equal(ctx.t0, torch.clamp(p.rx * float(ctx.step) * 1.5,
                                           0.0, 1.0))
    assert p.args.rx == p.rx.data_ptr() and p.rx.shape == (h, w)
    assert p.args.rconst == float(lao.random_constant("cpu"))
    assert torch.equal(torch.tensor([p.args.lx, p.args.ly, p.args.lz]),
                       lao.light_of(cpu_scene, params))
    taps = p.tensors[-1]
    assert taps.shape == (20, 4)
    assert torch.equal(taps[:, :3], torch.from_numpy(lao.lao_taps(params)))
    assert p.args.n_taps == 20 and p.args.lao_samples == 1
    assert _bits(p.args.step) == _bits(F32(1.0 / 64))
    assert (p.args.table, p.args.tf_table, p.args.tw, p.args.th) == (
        cpu_scene.volume_packed.data_ptr(),
        cpu_scene.transfer_packed.data_ptr(), 256, 2)
    assert (p.args.width, p.args.height, p.device, p.launch) == (w, h, -1,
                                                                 None)
    other = lao.Params(light_position=(1.0, 0.0, 0.0), soft_shadows=False)
    q = cache.get(cpu_scene, (other, h, w))
    assert q is not p and q.args.soft_on == 0
    assert torch.equal(torch.tensor([q.args.lx, q.args.ly, q.args.lz]),
                       lao.light_of(cpu_scene, other))


def test_lao_cpu_frame_is_the_plain_frame_and_refusals(cpu_scene):
    """A CPU state takes the plain frame and launches nothing; what the
    kernel would not take raises before any launch."""
    params = lao.Params(slices=16)
    state = lao.reset(params, 8, 10, cpu_scene)
    before = lao_march.LAUNCHES
    lao.render_frame(state, cpu_scene, params, 0.3, 1)
    plain = torch.zeros_like(state)
    lao_march.lao_frame_plain(plain, cpu_scene, params)
    assert torch.equal(state, plain) and lao_march.LAUNCHES == before
    with pytest.raises(ValueError, match="32-bit"):
        lao_march._scene_cache.get(cpu_scene, (params, 2 ** 16, 2 ** 15))
    unpacked = make_scene(volume.sphere_volume(8, device="cpu"),
                          transfer.gray_ramp(device="cpu"), pack=False,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="pack=True"):
        lao_march._scene_cache.get(unpacked, (params, 2, 2))
    # the plain frame takes the unpacked scene (the texture fetches)
    frame = lao.generate(unpacked, params, 0.0, 6, 6)
    assert bool(torch.isfinite(frame).all())
    assert torch.allclose(frame, lao.generate(cpu_scene, params, 0.0, 6, 6),
                          rtol=0, atol=1e-6)
