"""The port's 1D TF lookup (kernels/tf1d.py) against the Pallas kernel it
replaces (vpt_tpu.pallas.tf1d.lookup_1d, interpret mode) and against the
bilinear 2D lookup at y = 0, at atol 1e-6 as tests/test_pallas.py holds the
Pallas kernel.  The CUDA kernel against the plain version runs on a GPU
only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as js
from vpt_tpu import transfer as jtransfer
from vpt_tpu.pallas import tf1d as jtf1d
from vpt_tpu_torch.kernels import tf1d


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
