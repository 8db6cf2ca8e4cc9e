"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The file
imports no JAX, so the GPU machine, which has none, runs it without the
JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from vpt_tpu_torch import tonemap as tm
from vpt_tpu_torch import transfer, volume
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
