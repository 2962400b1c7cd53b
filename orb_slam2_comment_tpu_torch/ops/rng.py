"""Counter-based random numbers equal to JAX's: threefry2x32, `random_bits`,
`uniform`, `gumbel` and `categorical` of `jax.random`, on CPU and CUDA.

The RANSAC solvers draw their minimal sets from `PRNGKey(seed)`, so the
hypotheses — and the pose RANSAC picks — depend on these exact bits.
Layout: JAX's default `jax_threefry_partitionable=True`, where element i of
a `shape`-sized draw is threefry2x32(key, (hi32(i), lo32(i))) and 32-bit
draws keep `x0 ^ x1` of the two output words. uint32 words are held in
int64 tensors and masked to 32 bits after every add and shift, since
torch's uint32 arithmetic is thin.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)` as two host ints. With jax_enable_x64
    off (the reference's setting) the seed is cut to its low 32 bits, so
    the high key word is 0."""
    return 0, int(seed) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al.), as jax's
    `_threefry2x32_lowering`. x0, x1: int64 tensors of 32-bit words."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as int64 values in [0, 2^32)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, (i >> 32) & _M32, i & _M32)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled, floored at minval."""
    bits = random_bits(key, shape, device)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.gumbel` (mode "low") in float32."""
    u = uniform(key, shape, torch.finfo(torch.float32).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1, shape=shape)` with
    replacement: Gumbel-max over the last axis of logits [..., N]."""
    batch = tuple(logits.shape[:-1])
    prefix = tuple(shape[:len(shape) - len(batch)])
    g = gumbel(key, prefix + tuple(shape[len(prefix):]) + (logits.shape[-1],), logits.device)
    return torch.argmax(g + logits, dim=-1)


def masked_categorical(key, valid: torch.Tensor, shape) -> torch.Tensor:
    """`categorical` for logits 0 where valid and -inf elsewhere, over a
    1-D valid mask (the RANSAC sampler). -log(-log u) is increasing in u,
    so the Gumbel argmax is the argmax of the uniform draws over the valid
    entries; comparing the exact uniform bits keeps the index independent
    of the device's log. An all-invalid row gives index 0, as argmax over
    -inf does."""
    u = uniform(key, tuple(shape) + (valid.shape[-1],), torch.finfo(torch.float32).tiny, 1.0,
                valid.device)
    return torch.argmax(torch.where(valid, u, torch.full_like(u, -1.0)), dim=-1)
