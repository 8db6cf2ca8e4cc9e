"""The corner-row gather (K3, ``kernels/corner_gather.py``) and scatter-add
(K4, ``kernels/corner_scatter.py``) and the differentiable fetch built on
them (``sampling.CornerFetch``), against vpt_tpu on the CPU.

- The probes' functions against the Pallas probes in interpret mode
  (``benchmarks/pallas_gather.py``, ``benchmarks/pallas_scatter_bwd.py``)
  and the probe's XLA baseline: the gather moves values, so it is exact;
  the scatter adds in another order, so atol 1e-5 on sums of O(1) terms.
- The fused fetch against ``vpt_tpu.sampling.sample_volume_packed``, bit
  for bit: the same float32 lerp chain in the same order.
- Its gradient against ``jax.vjp`` of the packed fetch, atol 1e-6: the
  analytic ``w8 ⊗ ct`` cotangent against JAX's transposed lerp chain,
  equal up to reassociation.
"""

import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import sampling as js
from vpt_tpu import volume as jvolume
from vpt_tpu_torch import sampling as ts
from vpt_tpu_torch.kernels import corner_gather, corner_scatter

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmarks"


def _probe(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _positions(n=257, seed=0):
    """tests/test_fused_vjp.py's positions: interior, out of range (the
    clamp path) and exact voxel centres."""
    r = np.random.default_rng(seed)
    p = r.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    p[:8] = r.integers(0, 8, size=(8, 3)).astype(np.float32) / 8.0 + 1 / 16.0
    return p


def _table(n=16, seed=1, count=3):
    vol = np.asarray(jvolume.blobs_volume(n, seed=seed, count=count).data)
    return vol, np.array(js.pack_corner_volume(jnp.asarray(vol)))


def test_gather_rows_matches_the_dma_probe():
    rows, lanes, block, n = 1 << 10, 128, 32, 128
    r = np.random.default_rng(0)
    table = r.normal(size=(rows, lanes)).astype(np.float32)
    idx = r.integers(0, rows, n, dtype=np.int32)
    gather = _probe("pallas_gather").make_dma_gather(rows, lanes, block,
                                                     interpret=True)
    want = np.asarray(gather(jnp.asarray(idx), jnp.asarray(table)))
    got = corner_gather.gather_rows(torch.from_numpy(table),
                                    torch.from_numpy(idx.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(corner_gather.gather_rows_plain(
        torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64))
    ).numpy(), want)


def test_scatter_add_rows8_matches_the_probe_and_xla():
    """Fold-16 rows of the probe = 8-lane rows of the unfolded view; the
    indices crowd onto 40 cells, so most updates hit a row more than
    once."""
    rows, block, n = 1 << 8, 16, 64
    r = np.random.default_rng(1)
    table0 = r.normal(size=(rows, 128)).astype(np.float32)
    idx = r.integers(0, 40, n, dtype=np.int32) * 97 % (rows * 16)
    ct = r.normal(size=(n, 8)).astype(np.float32)
    assert len(np.unique(idx)) < n // 2
    probe = _probe("pallas_scatter_bwd")
    fused = probe.make_fused_scatter(rows, block, interpret=True)
    want = np.asarray(fused(jnp.asarray(idx), jnp.asarray(ct),
                            jnp.asarray(table0)))
    xla = np.asarray(probe.xla_baseline()(jnp.asarray(idx), jnp.asarray(ct),
                                          jnp.asarray(table0)))
    table = torch.from_numpy(table0.copy())
    out = corner_scatter.scatter_add_rows8(
        table, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(ct))
    assert out is table                              # in place
    assert np.allclose(table.numpy(), want, rtol=0, atol=1e-5)
    assert np.allclose(table.numpy(), xla, rtol=0, atol=1e-5)
    assert not np.allclose(table.numpy(), table0, atol=1e-3)


def test_corner_fetch_bitwise_against_jax():
    vol, packed = _table()
    pos = _positions()
    want = np.asarray(js.sample_volume_packed(jnp.asarray(packed), vol.shape,
                                              jnp.asarray(pos)))
    table = torch.from_numpy(packed)
    got = ts.sample_volume_packed(table, vol.shape, torch.from_numpy(pos))
    assert np.array_equal(got.numpy(), want)
    # the same through the differentiable route (corner_fetch_plain)
    table.requires_grad_(True)
    fused = ts.sample_volume_packed(table, vol.shape, torch.from_numpy(pos))
    assert fused.grad_fn is not None and "CornerFetch" in type(
        fused.grad_fn).__name__
    assert np.array_equal(fused.detach().numpy(), want)


@pytest.mark.parametrize("channels", [1, 2])
def test_corner_grad_matches_jax_vjp(channels):
    r = np.random.default_rng(4)
    vol = r.uniform(0, 1, (6, 7, 5, channels)).astype(np.float32)
    packed = np.array(js.pack_corner_volume(jnp.asarray(vol)))
    pos = _positions(seed=3)
    ct = r.normal(size=(len(pos), channels)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: js.sample_volume_packed(t, vol.shape,
                                                       jnp.asarray(pos)),
                     jnp.asarray(packed))
    want = np.asarray(vjp(jnp.asarray(ct))[0])

    table = torch.from_numpy(packed).requires_grad_(True)
    out = ts.sample_volume_packed(table, vol.shape, torch.from_numpy(pos))
    out.backward(torch.from_numpy(ct))
    assert np.allclose(table.grad.numpy(), want, rtol=0, atol=1e-6)

    # corner_grad_plain on the cells and fractions the fetch computes
    idx, f = ts.corner_cells(torch.from_numpy(pos), vol.shape)
    grad = corner_scatter.corner_grad(idx, f, torch.from_numpy(ct),
                                      len(packed), channels)
    assert np.allclose(grad.numpy(), want, rtol=0, atol=1e-6)


def test_fetch_contract():
    """Positions are detached, bf16 tables that require grad raise, and a
    table without grad (or with autograd off) takes the plain path."""
    vol, packed = _table(n=8, seed=5, count=2)
    table = torch.from_numpy(packed).requires_grad_(True)
    pos = torch.tensor([[0.31, 0.47, 0.62]], requires_grad=True)
    out = ts.sample_volume_packed(table, vol.shape, pos)
    out.sum().backward()
    assert pos.grad is None and table.grad.abs().sum() > 0
    plain = ts.sample_volume_packed(table, vol.shape, pos, fused=False)
    assert "CornerFetch" not in type(plain.grad_fn).__name__
    with torch.no_grad():
        assert ts.sample_volume_packed(table, vol.shape, pos).grad_fn is None
    bf16 = torch.from_numpy(packed).to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(ValueError, match="float32"):
        ts.sample_volume_packed(bf16, vol.shape, pos)


def test_cpu_wrappers_launch_nothing():
    before = (corner_gather.LAUNCHES, corner_scatter.LAUNCHES)
    vol, packed = _table(n=8, seed=6, count=2)
    table = torch.from_numpy(packed).requires_grad_(True)
    ts.sample_volume_packed(table, vol.shape,
                            torch.rand(64, 3)).sum().backward()
    corner_scatter.scatter_add_rows8(torch.zeros(16, 8),
                                     torch.tensor([1, 1, 3]),
                                     torch.ones(3, 8))
    assert (corner_gather.LAUNCHES, corner_scatter.LAUNCHES) == before
