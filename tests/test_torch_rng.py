"""vpt_tpu_torch.rng against vpt_tpu.rng.

The hashes, the three combiners, the seeding, ``uniform``,
``uniform_cast`` and ``uint_bits_to_float`` are integer work plus one
correctly rounded division or subtraction, so they must match bit for
bit.  The
distributions call log/sqrt/cos/sin, which differ in the last bit between
JAX and PyTorch on a few percent of inputs: their RNG state must match bit
for bit, their values to 1e-6 (a few ulps of values in [-1, 1], or of
-log(u)/rate for the exponential).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vpt_tpu import rng as jrng
from vpt_tpu_torch import rng as trng


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small, and torch's intra-op threads only spin
    against the other workers of a parallel test run: one thread is
    faster there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 1 << 16


def _states(seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    # the edges and values at and above 2^31
    x[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF]
    assert (x >= 1 << 31).sum() > N // 4
    return x


def _port(x):
    return torch.from_numpy(x.astype(np.int64))


def _same_bits(jax_u32, torch_i64):
    return np.array_equal(np.asarray(jax_u32).astype(np.int64),
                          torch_i64.numpy())


@pytest.mark.parametrize("name", sorted(trng.HASHES))
def test_hash_bitwise(name):
    x = _states()
    got = trng.HASHES[name](_port(x))
    assert got.dtype == torch.int64 and int(got.max()) < 1 << 32
    assert _same_bits(getattr(jrng, name)(jnp.asarray(x)), got)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_squash_linear_bitwise(parts):
    xs = [_states(seed) for seed in range(parts)]
    want = jrng.squash_linear([jnp.asarray(x) for x in xs])
    got = trng.squash_linear([_port(x) for x in xs])
    assert _same_bits(want, got)


def test_squash_linear_rejects_one_part():
    with pytest.raises(ValueError):
        trng.squash_linear([_port(_states())])


def test_seed_pixels_bitwise():
    r = np.random.default_rng(3)
    xy = r.uniform(-1, 1, (64, 32, 2)).astype(np.float32)
    for seed in (0.0, 0.37, np.float32(0.123456)):
        want = jrng.seed_pixels(jnp.asarray(xy), jnp.float32(seed))
        got = trng.seed_pixels(torch.from_numpy(xy), seed)
        assert _same_bits(want, got)


@pytest.mark.parametrize("name", ["squash_nested", "squash_xor"])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_squash_nested_and_xor_bitwise(name, parts):
    xs = [_states(seed) for seed in range(parts)]
    want = getattr(jrng, name)([jnp.asarray(x) for x in xs])
    got = getattr(trng, name)([_port(x) for x in xs])
    assert _same_bits(want, got)
    # another hash than pcg is passed through
    want = getattr(jrng, name)([jnp.asarray(x) for x in xs], jrng.wang)
    got = getattr(trng, name)([_port(x) for x in xs], trng.wang)
    assert _same_bits(want, got)


def test_uint_bits_to_float_and_uniform_cast_bitwise():
    x = _states(5)
    want = np.asarray(jrng.uint_bits_to_float(jnp.asarray(x)))
    got = trng.uint_bits_to_float(_port(x))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    js, ju = jrng.uniform_cast(jnp.asarray(x))
    ts, tu = trng.uniform_cast(_port(x))
    assert _same_bits(js, ts)
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0


def test_btrand_matches_jax():
    """Four float32 LCG lanes over 64 chained steps from seeded starts:
    the lanes are exact float32 integers, so they must be equal; the
    combined value within 1e-6."""
    r = np.random.default_rng(11)
    jn = tn = r.integers(1, 4194000, (256, 4)).astype(np.float32)
    tn = torch.from_numpy(tn)
    for _ in range(64):
        jn, jv = jrng.btrand(jn)
        tn, tv = trng.btrand(tn)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        assert np.allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_uniform_bitwise():
    x = _states()
    js, ju = jrng.uniform(jnp.asarray(x))
    ts, tu = trng.uniform(_port(x))
    assert _same_bits(js, ts)
    assert tu.dtype == torch.float32
    assert np.array_equal(np.asarray(ju), tu.numpy())
    assert float(tu.min()) >= 0.0 and float(tu.max()) <= 1.0


#: value tolerances.  The sphere's 2·sqrt(1 − |d|²) turns a one-ulp
#: difference of |d|² near the pole into ~1e-5 (measured 3.0e-5 over 2^16
#: states); the others stay within a few ulps (measured ≤ 1.2e-7, normal's
#: sqrt(−2·log r) ≤ 4.8e-7).
ATOL = {"disk": 1e-6, "square": 1e-6, "sphere": 1e-4, "exponential": 1e-6,
        "circle": 1e-6, "hemisphere": 1e-6, "ball": 1e-6, "normal": 1e-6}


@pytest.mark.parametrize("name", sorted(ATOL))
def test_distribution_state_bitwise_values_close(name):
    x = _states(7)
    if name == "exponential":
        js, jv = jrng.exponential(jnp.asarray(x), jnp.float32(40.0))
        ts, tv = trng.exponential(_port(x), 40.0)
    else:
        js, jv = getattr(jrng, name)(jnp.asarray(x))
        ts, tv = getattr(trng, name)(_port(x))
    assert _same_bits(js, ts)
    assert tv.dtype == torch.float32 and tv.shape == np.asarray(jv).shape
    assert np.allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL[name])


def test_exponential_clamp_keeps_the_zero_uniform_finite():
    """pcg is a bijection; the one state it maps to 0 gives u = 0, where
    the float32(1e-38) clamp must keep -log(u)/rate finite.  That clamp is
    a float32 subnormal: XLA on the CPU flushes it to 0 and vpt_tpu returns
    inf here (ROADMAP queue 3); the port keeps the clamp."""
    s0 = (-2891336453 * pow(747796405, -1, 1 << 32)) % (1 << 32)
    state = torch.tensor([s0, 12345])
    assert int(trng.pcg(state)[0]) == 0
    assert int(np.asarray(jrng.pcg(jnp.uint32(s0)))) == 0
    _, tv = trng.exponential(state, 2.0)
    want = -np.log(np.float64(np.float32(1e-38))) / 2.0
    assert torch.isfinite(tv).all()
    assert abs(float(tv[0]) - want) < 1e-4
