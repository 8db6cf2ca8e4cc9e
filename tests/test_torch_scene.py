"""Scene inputs of the port against vpt_tpu: camera matrices, the scene
graph's traversal, synthetic volumes, the transfer function and the
environment.

The volumes are built with numpy by the same code on both sides and must be
equal.  The camera matrices go through tan, a 4×4 product and an inverse;
the port inverts with LAPACK's float32 LU through scipy, as jaxlib does on
the CPU, so the matrices are equal (``torch.linalg.inv`` differed by up to
8.6e-7 relative, 1.2e-5 absolute on entries near 14).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import environment as jenv
from vpt_tpu import math3d as jm4
from vpt_tpu import scene as jscene
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu_torch import environment as tenv
from vpt_tpu_torch import math3d as tm4
from vpt_tpu_torch import scene as tscene
from vpt_tpu_torch import transfer as ttransfer
from vpt_tpu_torch import volume as tvolume


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras(translation, fovy, quat):
    jcam = jscene.default_camera(translation=translation, fovy=fovy)
    tcam = tscene.default_camera(translation=translation, fovy=fovy)
    jvt = jscene.Node().transform
    tvt = tscene.Node().transform
    jvt.local_rotation = jnp.asarray(quat, jnp.float32)
    tvt.local_rotation = quat
    jvt.local_scale = jnp.asarray([1.0, 1.2, 0.8], jnp.float32)
    tvt.local_scale = [1.0, 1.2, 0.8]
    return (jscene.CameraState.from_nodes(jcam, jvt),
            tscene.CameraState.from_nodes(tcam, tvt))


@pytest.mark.parametrize("translation,fovy,quat", [
    ((0.0, 0.0, 2.0), 1.0, (0.0, 0.0, 0.0, 1.0)),
    ((0.3, -0.2, 2.5), 0.8, (0.0, 0.38268343, 0.0, 0.9238795)),
])
def test_camera_matrices_close(translation, fovy, quat):
    jcs, tcs = _cameras(translation, fovy, quat)
    for name in ("mvp_inverse", "model_view", "projection"):
        got = getattr(tcs, name)
        assert got.dtype == torch.float32 and got.shape == (4, 4)
        assert np.array_equal(got.numpy(), np.asarray(getattr(jcs, name))),\
            name


def test_camera_math_keeps_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    tscene.CameraState.from_nodes(tscene.default_camera())
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_center_matrix_equal():
    assert np.array_equal(tscene.CENTER_MATRIX, jscene.CENTER_MATRIX)


def test_apply_mat4_bitwise():
    r = np.random.default_rng(0)
    m = r.normal(size=(4, 4)).astype(np.float32)
    v = r.normal(size=(128, 4)).astype(np.float32)
    want = np.asarray(jm4.apply_mat4(jnp.asarray(m), jnp.asarray(v)))
    got = tm4.apply_mat4(torch.from_numpy(m), torch.from_numpy(v)).numpy()
    assert np.array_equal(got, want)


def test_transform_change_listener_fires():
    t = tscene.Transform()
    calls = []
    t.add_change_listener(lambda: calls.append(1))
    t.local_translation = [1.0, 2.0, 3.0]
    assert calls == [1]
    assert np.allclose(t.local_matrix[:3, 3].numpy(), [1.0, 2.0, 3.0])


def _tree(mod):
    """A root with two children, the first with two children of its own
    and the second with one: six nodes, named by the order they joined."""
    nodes = [mod.Node() for _ in range(6)]
    for parent, child in ((0, 1), (1, 2), (1, 3), (0, 4), (4, 5)):
        nodes[parent].add_child(nodes[child])
    return nodes


def test_traverse_visits_nodes_in_jax_order():
    """``Node.traverse`` calls ``before`` in pre-order and ``after`` in
    post-order, as vpt_tpu's does, with either callback left out."""
    orders = []
    for mod in (jscene, tscene):
        nodes = _tree(mod)
        name = {id(n): i for i, n in enumerate(nodes)}
        seen = []
        nodes[0].traverse(lambda n: seen.append(("in", name[id(n)])),
                          lambda n: seen.append(("out", name[id(n)])))
        nodes[0].traverse(after=lambda n: seen.append(("after", name[id(n)])))
        nodes[1].traverse(before=lambda n: seen.append(("sub", name[id(n)])))
        orders.append(seen)
    assert orders[1] == orders[0]
    assert [i for kind, i in orders[1] if kind == "in"] == [0, 1, 2, 3, 4, 5]
    assert [i for kind, i in orders[1] if kind == "out"] == [2, 3, 1, 5, 4, 0]
    assert [i for kind, i in orders[1] if kind == "sub"] == [1, 2, 3]


@pytest.mark.parametrize("n", [8, 17, 32])
def test_sphere_volume_equal(n):
    got = tvolume.sphere_volume(n, device="cpu").data.numpy()
    assert np.array_equal(got, np.asarray(jvolume.sphere_volume(n).data))


@pytest.mark.parametrize("n,seed", [(12, 0), (24, 7)])
def test_blobs_volume_equal(n, seed):
    got = tvolume.blobs_volume(n, seed=seed, device="cpu").data.numpy()
    want = np.asarray(jvolume.blobs_volume(n, seed=seed).data)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("height,width,alpha", [(2, 256, 0.8), (3, 200, 1.0)])
def test_gray_ramp_equal(height, width, alpha):
    got = ttransfer.gray_ramp(height, width, alpha_scale=alpha,
                              device="cpu").numpy()
    want = np.asarray(jtransfer.gray_ramp(height, width, alpha_scale=alpha))
    assert np.array_equal(got, want)


def test_to_gl_texture_within_one_ulp():
    """Quantize and the alpha channel are exact; the sRGB decode goes
    through pow, which may differ by one ulp."""
    r = np.random.default_rng(1)
    tex = r.uniform(-0.1, 1.1, (4, 64, 4)).astype(np.float32)
    got = ttransfer.to_gl_texture(torch.from_numpy(tex)).numpy()
    want = np.asarray(jtransfer.to_gl_texture(jnp.asarray(tex)))
    assert np.array_equal(got[..., 3], want[..., 3])
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_environment_equal():
    assert np.array_equal(tenv.white(device="cpu").numpy(), np.asarray(jenv.white()))
    assert np.array_equal(tenv.constant([0.2, 0.4, 0.6], 2, 3,
                                        device="cpu").numpy(),
                          np.asarray(jenv.constant([0.2, 0.4, 0.6], 2, 3)))


@pytest.fixture(scope="module")
def unpacked_scenes():
    """``pack=False`` scenes of a 16³ blobs volume: the CPU's (no tables)
    and one built under the card's rule (``base.kernels_sample`` True, so
    on CPU tensors), with bf16 asked for the tables."""
    from vpt_tpu_torch.renderers import base, make_scene

    def build():
        return make_scene(tvolume.blobs_volume(16, seed=7, device="cpu"),
                          ttransfer.gray_ramp(alpha_scale=0.9,
                                              device="cpu"),
                          pack=False, pack_dtype=torch.bfloat16,
                          tracking="cheb", device="cpu")

    cpu = build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(base, "kernels_sample", lambda device: True)
        card = build()
    return cpu, card


def test_unpacked_scene_on_the_card_gets_float32_kernel_tables(
        unpacked_scenes):
    """The card's ``pack=False`` scene: float32 corner tables of the
    unpacked values for the kernels (whatever ``pack_dtype``), samplers
    that read the unpacked volume and texture as the CPU's scene does, bit
    for bit; a fit scene built from it samples its own tables."""
    from vpt_tpu_torch import sampling
    from vpt_tpu_torch.renderers import base

    cpu, card = unpacked_scenes
    assert cpu.volume_packed is None and not cpu.kernel_tables
    assert card.kernel_tables and not card._packed_samples()
    assert torch.equal(card.volume_packed,
                       sampling.pack_corner_volume(card.volume[..., :2]))
    assert torch.equal(card.transfer_packed,
                       sampling.pack_corner_texture2d(card.transfer))
    assert torch.equal(card.transfer_1d, cpu.transfer_1d)
    assert torch.equal(card.tracking_packed, cpu.tracking_packed)
    pos = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.1, 1.1, (64, 3)).astype(np.float32))
    assert torch.equal(card.sample_color(pos), cpu.sample_color(pos))
    uv = torch.rand(64, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(card.sample_transfer(uv), cpu.sample_transfer(uv))
    fit = base.fit_scene(card)
    assert not fit.kernel_tables and fit._packed_samples()


@pytest.mark.parametrize("key", ["mcm", "eam", "mip", "depth", "iso", "mcs",
                                 "dos", "lao"])
def test_unpacked_scene_on_the_card_renders_the_unpacked_frame(
        unpacked_scenes, key):
    """Every renderer's plain frame on the card's ``pack=False`` scene
    equals the frame on the CPU's, bit for bit: the tables are the
    kernels' alone."""
    from vpt_tpu_torch.renderers import factory

    cpu, card = unpacked_scenes
    module = factory.get_module(key)
    params = module.Params(steps=4) if key == "mcm" else module.Params()
    got, want = (module.render_frame(module.reset(params, 12, 10, sc), sc,
                                     params, np.float32(0.3), 1)
                 for sc in (card, cpu))
    if isinstance(want, dict):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    else:
        assert torch.equal(got, want)
