"""Counter-based random bits: JAX's threefry2x32 in integer tensor ops.

The port's seeded sampling must draw the JAX package's bits, so that a
slot's t-th token is the same pure function of (logits, seed, t) in both
packages.  This module follows the installed ``jax/_src/prng.py`` and
``jax/_src/random.py`` with ``jax_threefry_partitionable`` on (jax 0.9's
default): ``key_from_seed`` is ``jax.random.PRNGKey``, ``fold_in`` is
``jax.random.fold_in``, ``random_bits`` draws one 32-bit word per element
from the counter pair (hi 0, lo = element index), and ``gumbel`` is
``jax.random.gumbel`` in its default low-range mode.

A uint32 lives in an int64 (numpy array or torch tensor) and is masked back
to 32 bits after every add, so the same code runs on numpy on the host and
on torch tensors on either device, and inside a CUDA graph: it has no data-
dependent control flow and no host read.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                     # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of key (k1, k2) on counters
    (x1, x2); every argument a uint32 held in int64, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key_from_seed(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a (2,) uint32 array: the seed's high
    and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & MASK, seed & MASK], np.uint32)


def fold_in(keys, data):
    """``jax.random.fold_in``: keys (..., 2) and data (...) -> (..., 2), the
    threefry block of each key on the counter pair (0, data)."""
    k1, k2 = keys[..., 0], keys[..., 1]
    o1, o2 = threefry2x32(k1, k2, k1 * 0, data & MASK)
    if isinstance(o1, torch.Tensor):
        return torch.stack([o1, o2], dim=-1)
    return np.stack([o1, o2], axis=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of ``n`` elements under each key: keys
    (B, 2) int64 -> (B, n) int64, ``jax.random.bits(key, (n,), uint32)``
    row by row (partitionable threefry: counters (0, i), the two output
    words xor-ed)."""
    k1, k2 = keys[:, :1], keys[:, 1:]
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise, (B, n) float32: ``jax.random.gumbel(key, (n,),
    float32)`` row by row.  A uniform in [tiny, 1) from the top 23 bits as a
    mantissa, then -log(-log(u))."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(floats * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))
