"""The reference's sampling keys and draws, on the host in numpy.

The JAX engine samples a token with
``jax.random.categorical(fold_in(PRNGKey(seed), position), logits / T)``
under jax's default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (the default since jax 0.5).  This module
computes the same bits in numpy ``uint32`` arithmetic, so the port's sampled
streams are the reference's token for token:

  * ``prng_key(seed)``   — ``[seed >> 32, seed & 0xFFFFFFFF]``;
  * ``fold_in(key, d)``  — ``threefry2x32(key, (0, d))``;
  * ``split(key, n)``    — key i is threefry2x32 of the 64-bit count i,
                           split into its hi and lo words;
  * ``random_bits``      — threefry2x32 over the 64-bit iota of the shape,
                           split into its hi and lo words, ``bits1 ^ bits2``;
  * ``uniform``          — ``(bits >> 9) | 0x3F800000`` viewed as float32,
                           minus 1, scaled to ``[minval, maxval)`` and
                           clamped below by ``minval``;
  * ``gumbel``           — ``-log(-log(u))`` with ``u`` uniform on
                           ``[tiny, 1)`` (jax's mode "low");
  * ``categorical``      — ``argmax(gumbel + logits)`` over the last axis.

Everything is float32 where jax computes in float32.  Keys, bits and
uniforms are the reference's bit for bit.  The logarithms are numpy's, which
differ from XLA's CPU logarithm by up to 3 units in the last place, so a
Gumbel value may differ by a few float32 steps of ``max(1, |g|)``; a draw
changes only when two perturbed logits tie to within that.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_TINY = np.finfo(np.float32).tiny


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of the count pair
    ``(x0, x1)`` (uint32 arrays of one shape) under ``key`` (2 uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: (2,) uint32."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``'s key data."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([x0[0], x1[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``'s key data: (num, 2) uint32, key i
    being ``threefry2x32(key, (hi, lo))`` of the 64-bit count i."""
    i = np.arange(int(num), dtype=np.uint64)
    b1, b2 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return np.stack([b1, b2], axis=1)


def random_bits(key, shape) -> np.ndarray:
    """32-bit ``jax.random.bits(key, shape)`` (partitionable threefry)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 ``jax.random.uniform(key, shape, minval=, maxval=)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, f * (hi - lo) + lo)


def gumbel(key, shape) -> np.ndarray:
    """float32 ``jax.random.gumbel(key, shape)`` (mode "low")."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -np.log(-np.log(u))


def categorical(key, logits) -> int | np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    index of ``max(gumbel + logits)``."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, axis=-1)
