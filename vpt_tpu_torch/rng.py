"""Counter/hash-based RNG reproducing the reference's GLSL random library.

Mirrors ``vpt_tpu/rng.py``: the seven scalar hashes, the ``squash_linear``
combiner, per-pixel seeding and the distributions the MCM renderer draws
from.  The per-pixel state is a uint32 stream threaded explicitly through the
renderer, bit for bit the same as the JAX package's.

PyTorch on the CPU has no right shift for ``torch.uint32``, so a state here
is an int64 tensor that holds a uint32 value; every operation that can carry
past bit 31 is followed by ``& 0xFFFFFFFF``.  Multiplications by 32-bit
constants are split into 16-bit halves so that no product leaves the int64
range.  The CUDA event kernel (``csrc/mcm_event.cu``) uses native
``uint32_t``.

The distributions call ``log``, ``sqrt``, ``cos`` and ``sin``, which are not
bitwise equal across frameworks: the hashed state matches exactly, the
float values closely.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
TWOPI = np.float32(6.28318530718)
# float(~0u) rounded to float32, matching GLSL's float(4294967295u).
_INV_MAX = np.float32(4294967295.0)


def u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or value as an int64 tensor holding a uint32."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
    return x.to(torch.int64) & _MASK


def _mul(x, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for a uint32 tensor ``x`` and a uint32 constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def float_bits_to_uint(x: torch.Tensor) -> torch.Tensor:
    """GLSL floatBitsToUint: the float32 bits as a uint32 value."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _MASK


# ---------------------------------------------------------------------------
# Scalar hashes (vpt_tpu/rng.py:50-104)
# ---------------------------------------------------------------------------

def pcg(x):
    """PCG output permutation, the hash of the MCM renderer."""
    x = u32(x)
    x = (_mul(x, 747796405) + 2891336453) & _MASK
    x = _mul(((x >> ((x >> 28) + 4)) ^ x), 277803737)
    return (x >> 22) ^ x


def lcg(x):
    x = u32(x)
    return (_mul(x, 1664525) + 1013904223) & _MASK


def wang(x):
    x = u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = _mul(x, 9)
    x = x ^ (x >> 4)
    x = _mul(x, 0x27D4EB2D)
    return x ^ (x >> 15)


def jenkins(x):
    x = u32(x)
    x = (x + (x << 10)) & _MASK
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _MASK
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & _MASK
    return x


def xorshift(x):
    x = u32(x)
    x = x ^ ((x << 13) & _MASK)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & _MASK)
    return x


def xxhash(x):
    x = u32(x)
    x = (x + 374761393) & _MASK
    x = _mul(((x << 17) & _MASK) | (x >> 15), 668265263)
    x = _mul(x ^ (x >> 15), 2246822519)
    x = _mul(x ^ (x >> 13), 3266489917)
    return x ^ (x >> 16)


def bbs(x):
    x = u32(x) % 65521
    x = (x * x) % 65521
    x = (x * x) % 65521
    return x


HASHES = {"pcg": pcg, "lcg": lcg, "wang": wang, "jenkins": jenkins,
          "xorshift": xorshift, "xxhash": xxhash, "bbs": bbs}


def squash_linear(parts, hash_fn=pcg):
    """hash(uvecN) of squashlinear.glsl, the MCM seeding combiner."""
    parts = [u32(p) for p in parts]
    coeffs = {2: (19, 47), 3: (19, 47, 101), 4: (19, 47, 101, 131)}
    offset = {2: 101, 3: 131, 4: 173}
    if len(parts) not in coeffs:
        raise ValueError("squash_linear takes 2-4 parts")
    acc = None
    for c, p in zip(coeffs[len(parts)], parts):
        term = _mul(p, c)
        acc = term if acc is None else (acc + term) & _MASK
    return hash_fn((acc + offset[len(parts)]) & _MASK)


def seed_pixels(ndc_xy: torch.Tensor, rand_seed, hash_fn=pcg):
    """hash(uvec3(floatBitsToUint(pos.xy), floatBitsToUint(seed))), the
    per-pixel seeding of MCMRenderer.glsl:128.  ``ndc_xy`` is (..., 2)
    float32, ``rand_seed`` a float32 scalar; returns a (...,) state."""
    px = float_bits_to_uint(ndc_xy[..., 0])
    py = float_bits_to_uint(ndc_xy[..., 1])
    seed = torch.as_tensor(np.float32(rand_seed), device=ndc_xy.device)
    ps = float_bits_to_uint(seed).expand(px.shape)
    return squash_linear([px, py, ps], hash_fn=hash_fn)


# ---------------------------------------------------------------------------
# Distributions: (state) -> (state, value)
# ---------------------------------------------------------------------------

def uniform(state, hash_fn=pcg):
    """state = hash(state); u = float(state) / float(~0u)."""
    state = hash_fn(state)
    return state, state.to(torch.float32) / float(_INV_MAX)


def square(state):
    state, x = uniform(state)
    state, y = uniform(state)
    return state, torch.stack([x, y], dim=-1)


def disk(state):
    state, r = uniform(state)
    state, a = uniform(state)
    radius = torch.sqrt(r)
    angle = float(TWOPI) * a
    return state, radius[..., None] * torch.stack(
        [torch.cos(angle), torch.sin(angle)], dim=-1)


def sphere(state):
    """Marsaglia (1972) via disk, the same draws as sphere.glsl."""
    state, d = disk(state)
    norm = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    radius = 2.0 * torch.sqrt(torch.clamp(1.0 - norm, min=0.0))
    z = 1.0 - 2.0 * norm
    return state, torch.cat([radius[..., None] * d, z[..., None]], dim=-1)


def exponential(state, rate):
    """-log(u)/rate, with u clamped away from 0 (vpt_tpu/rng.py:232-238).
    The divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by the reciprocal, which rounds unlike the true division of
    JAX and of the event kernel."""
    state, x = uniform(state)
    x = torch.clamp(x, min=float(np.float32(1e-38)))
    return state, -torch.log(x) / torch.full_like(x, rate)
