"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The file
imports no JAX, so the GPU machine, which has none, runs it without the
JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from vpt_tpu_torch import rng, sampling, train
from vpt_tpu_torch import tonemap as tm
from vpt_tpu_torch import transfer, volume
from vpt_tpu_torch.kernels import corner_gather, corner_scatter
from vpt_tpu_torch.kernels import mcm_event, tf1d, tonemap_kernel
from vpt_tpu_torch.renderers import make_scene
from vpt_tpu_torch.renderers import mcm

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


@pytest.mark.parametrize("tracking", ["none", "auto"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_event_kernel_matches_plain_loop(cuda, tracking, dtype):
    """The kernel and the plain loop on the same card and inputs (64², 24³
    blobs, steps 8, 4 frames).  Measured on an H100: samples agree on
    every pixel, radiance within 1.2e-7 where they agree."""
    scene = make_scene(volume.blobs_volume(24, seed=1),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking=tracking, pack_dtype=dtype, device=cuda)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, 64, 64, scene)
    plain = {k: v.clone() for k, v in state.items()}
    before = mcm_event.LAUNCHES
    for f in range(4):
        mcm.render_frame(state, scene, params, 0.3 + 0.01 * f)
        mcm_event.event_frame_plain(plain, scene, params, 0.3 + 0.01 * f)
    torch.cuda.synchronize()
    assert mcm_event.LAUNCHES == before + 4
    assert_frames_agree(state, plain)


def test_event_kernel_mxu_matches_plain_loop(cuda):
    """The headline's scene (bf16 tables, tf_mxu, cheb-skip): the event
    kernel's TF device function in the bf16-weight mode against the plain
    loop.  Before the plain flight divided by a tensor (rng.exponential),
    3 of these 4096 pixels parted from the plain loop's streams."""
    scene = make_scene(volume.sphere_volume(24),
                       transfer.gray_ramp(alpha_scale=0.8), tf_srgb=True,
                       tracking="auto", pack_dtype=torch.bfloat16,
                       tf_mxu=True, device=cuda)
    assert scene.tf_mxu == torch.bfloat16
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, 64, 64, scene)
    plain = {k: v.clone() for k, v in state.items()}
    for f in range(4):
        mcm.render_frame(state, scene, params, 0.3 + 0.01 * f)
        mcm_event.event_frame_plain(plain, scene, params, 0.3 + 0.01 * f)
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
    scene = make_scene(volume.sphere_volume(16), transfer.gray_ramp(),
                       device=cuda)
    state = mcm.reset(params, 32, 32, scene)
    plain = {k: v.clone() for k, v in state.items()}
    mcm.render_frame(state, scene, params, 0.7)
    mcm_event.event_frame_plain(plain, scene, params, 0.7)
    torch.cuda.synchronize()
    assert_frames_agree(state, plain)


def test_event_kernel_width_cap(cuda):
    """The TF row is the event kernel's only shared memory: MAX_WIDTH
    texels launch, one more raises before the launch."""
    scene = make_scene(volume.sphere_volume(8), transfer.gray_ramp(),
                       device=cuda)
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
    params = mcm.Params()
    scene = make_scene(volume.sphere_volume(8), transfer.gray_ramp(),
                       pack=False, device=cuda)
    state = mcm.reset(params, 8, 8, scene)
    with pytest.raises(NotImplementedError):
        mcm.render_frame(state, scene, params, 0.1)
    scene = make_scene(volume.sphere_volume(8), transfer.gray_ramp(),
                       environment=torch.ones(4, 8, 4), device=cuda)
    state = mcm.reset(params, 8, 8, scene)
    with pytest.raises(NotImplementedError):
        mcm.render_frame(state, scene, params, 0.1)


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


@pytest.mark.parametrize("channels", [1, 2])
def test_corner_fetch_kernel_bitwise(cuda, channels):
    """The fused gather and lerp runs the plain chain's float32 operations
    in its order without contraction: equal on the same card."""
    g = torch.Generator().manual_seed(6)
    vol = torch.rand(20, 24, 28, channels, generator=g).to(cuda)
    table = sampling.pack_corner_volume(vol)
    pos = (torch.rand(100_000, 3, generator=g) * 1.4 - 0.2).to(cuda)
    idx, f = sampling.corner_cells(pos, tuple(vol.shape))
    got = corner_gather.corner_fetch(table, idx, f)
    want = corner_gather.corner_fetch_plain(table, idx, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, sampling.sample_volume(vol, pos))


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
    scene = make_scene(volume.blobs_volume(16, seed=1),
                       transfer.gray_ramp(alpha_scale=0.8), device=cuda)
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
