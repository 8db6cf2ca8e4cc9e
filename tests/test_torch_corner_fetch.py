"""The corner-row gather (K3, ``kernels/corner_gather.py``) and scatter-add
(K4, ``kernels/corner_scatter.py``) and the differentiable fetch built on
them (``sampling.CornerFetch``), against vpt_tpu on the CPU.

- The probes' functions against the Pallas probes in interpret mode
  (``benchmarks/pallas_gather.py``, ``benchmarks/pallas_scatter_bwd.py``)
  and the probe's XLA baseline: the gather moves values, so it is exact;
  the scatter adds in another order, so atol 1e-5 on sums of O(1) terms.
- The corner fetch, which takes positions, against
  ``vpt_tpu.sampling.sample_volume_packed`` (and its ``fused_vjp=True``
  value), bit for bit, for float32 and bfloat16 tables and one or two
  channels: the same float32 filter coordinates and lerp chain in the same
  order.  Its saved cells and fractions are ``corner_cells``'; edge,
  out-of-range and NaN positions behave as the module states.
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corner_fetch_bitwise_against_jax(dtype, channels):
    r = np.random.default_rng(7)
    vol = r.uniform(0, 1, (9, 10, 11, channels)).astype(np.float32)
    jpacked = js.pack_corner_volume(jnp.asarray(vol)).astype(dtype)
    packed = torch.from_numpy(np.array(jpacked.astype(jnp.float32))).to(
        getattr(torch, dtype))
    pos = _positions()
    want = np.asarray(js.sample_volume_packed(jpacked, vol.shape,
                                              jnp.asarray(pos)))
    vjp_value = np.asarray(js.sample_volume_packed(
        jpacked, vol.shape, jnp.asarray(pos), fused_vjp=True))
    assert np.array_equal(vjp_value, want)
    got = corner_gather.corner_fetch_plain(packed, vol.shape,
                                           torch.from_numpy(pos))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the wrapper's CPU route and the sampler's, with and without the saved
    # cells and fractions
    value, cells, f = corner_gather.corner_fetch(packed, vol.shape,
                                                 torch.from_numpy(pos),
                                                 save=True)
    assert np.array_equal(value.numpy(), want)
    idx, frac = ts.corner_cells(torch.from_numpy(pos), vol.shape)
    assert torch.equal(cells, idx) and torch.equal(f, frac)
    assert np.array_equal(ts.sample_volume_packed(
        packed, vol.shape, torch.from_numpy(pos)).numpy(), want)
    if dtype == "float32":
        # the same through the differentiable route (CornerFetch)
        table = packed.clone().requires_grad_(True)
        fused = ts.sample_volume_packed(table, vol.shape,
                                        torch.from_numpy(pos))
        assert fused.grad_fn is not None and "CornerFetch" in type(
            fused.grad_fn).__name__
        assert np.array_equal(fused.detach().numpy(), want)


def test_corner_fetch_edges_and_nan():
    """A coordinate below the volume clamps to cell 0 and above it to the
    last cell, both with fraction 0 (GL CLAMP_TO_EDGE); an exact texel
    centre has fraction 0; a NaN coordinate takes index 0 on its axis and
    a NaN fraction, so the value is NaN, as in JAX."""
    vol, packed = _table(n=8, seed=8, count=2)
    shape = vol.shape
    pos = np.array([[-0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [0.5, 0.5, 0.5],
                    [1.0 / 16, 0.5, 0.5], [np.nan, 0.5, 0.5],
                    [0.5, np.inf, -np.inf]], np.float32)
    value, cells, f = corner_gather.corner_fetch_plain(
        torch.from_numpy(packed), shape, torch.from_numpy(pos), save=True)
    x = (cells % shape[2]).numpy()
    assert list(x[:5]) == [0, 7, 3, 0, 0]
    assert list(f[:4, 0].numpy()) == [0.0, 0.0, 0.5, 0.0]
    assert np.isnan(f[4, 0].item()) and np.isnan(value[4, 0].item())
    assert not np.isnan(value.numpy()[[0, 1, 2, 3, 5]]).any()
    y = (cells // shape[2] % shape[1]).numpy()
    z = (cells // (shape[2] * shape[1])).numpy()
    assert (y[5], z[5]) == (7, 0) and list(f[5, 1:].numpy()) == [0.0, 0.0]
    want = np.asarray(js.sample_volume_packed(jnp.asarray(packed), shape,
                                              jnp.asarray(pos)))
    assert np.array_equal(np.isnan(want), np.isnan(value.numpy()))
    assert np.array_equal(np.nan_to_num(want), value.nan_to_num().numpy())


@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_corner_grad_matches_jax_vjp(channels, crowded):
    """Spread positions, and (``crowded``) 128 positions in 4 cells, so
    each corner row sums ~32 entries, as a fit's entries crowd in the
    chunks the corner-gradient kernel sums on chip (128, not 257: the
    sums stay near 4, where atol 1e-6 is two float32 ulps); the whole
    table's gradient and the bucket plain version's rows, stacked over
    three buckets, against ``jax.vjp``."""
    r = np.random.default_rng(4)
    vol = r.uniform(0, 1, (6, 7, 5, channels)).astype(np.float32)
    packed = np.array(js.pack_corner_volume(jnp.asarray(vol)))
    pos = _positions(seed=3)
    if crowded:
        pos = (0.45 + 0.1 * r.uniform(size=(128, 3))).astype(np.float32)
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
    cuts = [0, 71, 100, len(packed)]
    stacked = torch.cat([corner_scatter.corner_grad_bucket_plain(
        idx, f, torch.from_numpy(ct), r0, r1, channels)
        for r0, r1 in zip(cuts, cuts[1:])])
    assert np.allclose(stacked.numpy(), want, rtol=0, atol=1e-6)
    if crowded:
        assert len(np.unique(idx.numpy())) <= 4


def test_fetch_contract():
    """Positions are detached, bf16 tables that require grad raise, a
    table without grad (or with autograd off) gives a value without a
    graph, and positions that alone require grad raise under ``fused``;
    with ``fused=False`` their gradient reaches them."""
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
    pos.grad = None
    with pytest.raises(ValueError, match="fused=False"):
        ts.sample_volume_packed(torch.from_numpy(packed), vol.shape, pos)
    ts.sample_volume_packed(torch.from_numpy(packed), vol.shape, pos,
                            fused=False).sum().backward()
    assert pos.grad is not None and pos.grad.abs().sum() > 0


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
