"""The port's 1D TF lookup (kernels/tf1d.py) against the Pallas kernel it
replaces (vpt_tpu.pallas.tf1d.lookup_1d, interpret mode) and against the
bilinear 2D lookup at y = 0, at atol 1e-6 as tests/test_pallas.py holds the
Pallas kernel; the scene's lookup (``Scene.sample_color``, which passes the
value channel straight to it) against JAX's; the table cache that prepares
a table's launch arguments once.  The CUDA kernel against the plain version
runs on a GPU only."""

import gc

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as js
from vpt_tpu import transfer as jtransfer
from vpt_tpu import volume as jvolume
from vpt_tpu.pallas import tf1d as jtf1d
from vpt_tpu.renderers import make_scene as jmake_scene
from vpt_tpu_torch import transfer, volume
from vpt_tpu_torch.kernels import _build, tf1d
from vpt_tpu_torch.renderers import make_scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bumps_tf():
    return np.array(jtransfer.rasterize(
        jtransfer.TransferFunctionBumps.from_list([
            {"position": {"x": 0.3, "y": 0.0}, "size": {"x": 0.2, "y": 0.5},
             "color": {"r": 1, "g": 0.5, "b": 0.2, "a": 0.8}},
            {"position": {"x": 0.8, "y": 0.0}, "size": {"x": 0.1, "y": 0.4},
             "color": {"r": 0.1, "g": 0.9, "b": 1, "a": 0.5}},
        ]), 64, 256))


def _bilinear_y0(tf, values):
    uv = jnp.stack([jnp.asarray(values), jnp.zeros_like(values)], axis=-1)
    return np.asarray(js.sample_texture2d(jnp.asarray(tf), uv))


@pytest.mark.parametrize("tf_kind", ["bumps", "width200"])
def test_lookup_1d_matches_pallas_and_bilinear(tf_kind):
    r = np.random.default_rng(1)
    if tf_kind == "bumps":
        tf = _bumps_tf()
        values = r.uniform(-0.1, 1.1, (16, 128)).astype(np.float32)
    else:   # a row that is not a multiple of the TPU's 128 lanes
        tf = r.uniform(0, 1, (2, 200, 4)).astype(np.float32)
        values = np.linspace(0, 1, 256, dtype=np.float32).reshape(2, 128)
    jtable, jwidth = jtf1d.pack_table(jnp.asarray(tf))
    want = np.asarray(jtf1d.lookup_1d(jtable, jnp.asarray(values), jwidth,
                                      interpret=True))
    table, width = tf1d.pack_table(torch.from_numpy(tf))
    assert width == jwidth and table.shape == (width, 4)
    got = tf1d.lookup_1d(table, torch.from_numpy(values), width).numpy()
    assert got.shape == values.shape + (4,)
    assert np.allclose(got, want, rtol=0, atol=1e-6)
    assert np.allclose(got, _bilinear_y0(tf, values), rtol=0, atol=1e-6)


def test_lookup_any_shape_equals_bilinear_bitwise():
    """The plain lookup runs the bilinear sampler's operations at y = 0,
    so on the same float32 row it is equal, not only close."""
    r = np.random.default_rng(2)
    tf = _bumps_tf()
    values = r.uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    table, _ = tf1d.pack_table(torch.from_numpy(tf))
    got = tf1d.lookup(table, torch.from_numpy(values)).numpy()
    assert np.array_equal(got, _bilinear_y0(tf, values))


def test_lookup_1d_rejects_pixel_count():
    table, width = tf1d.pack_table(torch.zeros(2, 256, 4))
    with pytest.raises(ValueError):
        tf1d.lookup_1d(table, torch.zeros(3, 5), width)
    with pytest.raises(ValueError):
        tf1d.lookup_1d(table, torch.zeros(1, 128), width + 1)


def test_cpu_lookup_launches_nothing():
    before = tf1d.LAUNCHES
    table, _ = tf1d.pack_table(torch.rand(2, 256, 4))
    tf1d.lookup(table, torch.rand(64))
    assert tf1d.LAUNCHES == before


@pytest.mark.parametrize("pack", [(True, None), (True, "bfloat16"),
                                  (False, None)],
                         ids=["f32", "bf16", "unpacked"])
def test_scene_sample_color_matches_jax(pack):
    """``Scene.sample_color`` on a rendering scene, at a 32² grid of
    positions (inside, at and beyond the faces), against JAX's: equal."""
    packed, dtype = pack
    jscene = jmake_scene(jvolume.blobs_volume(16, seed=3),
                         jtransfer.gray_ramp(alpha_scale=0.8), pack=packed,
                         pack_dtype=None if dtype is None
                         else getattr(jnp, dtype))
    tscene = make_scene(volume.blobs_volume(16, seed=3, device="cpu"),
                        transfer.gray_ramp(alpha_scale=0.8, device="cpu"),
                        pack=packed, pack_dtype=None if dtype is None
                        else getattr(torch, dtype), device="cpu")
    pos = np.random.default_rng(4).uniform(-0.05, 1.05, (32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jscene.sample_color(jnp.asarray(pos)))
    got = tscene.sample_color(torch.from_numpy(pos)).numpy()
    assert got.shape == (32, 32, 4)
    assert np.array_equal(got, want)


def test_table_cache_prepares_once_and_lets_the_table_go():
    """A table is prepared once per key while it lives; a new storage, a
    new key or a non-contiguous table (copied, never cached) prepares
    again; the entry goes with its table."""
    calls = []

    def prepare(table, key):
        calls.append(key)
        return _build.Prepared(ptr=table.data_ptr())

    cache = _build.TableCache(prepare)
    table = torch.zeros(8, 4)
    first = cache.get(table, "a")
    assert cache.get(table, "a") is first and calls == ["a"]
    assert cache.get(table, "b") is not first and len(cache) == 2
    table.set_(torch.ones(8, 4))              # the storage moved
    assert cache.get(table, "a") is not first and len(calls) == 3
    view = torch.zeros(4, 8).t()
    copied = cache.get(view, "a")
    assert copied.ptr != view.data_ptr() and copied.table().is_contiguous()
    assert cache.get(view, "a") is not copied and len(cache) == 2
    del table, first
    gc.collect()
    assert len(cache) == 0
