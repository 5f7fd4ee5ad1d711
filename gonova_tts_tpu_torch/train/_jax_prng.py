"""The JAX package's GAN crop offset, computed in numpy.

The adversarial losses crop a fixed-length segment whose offset the JAX package
draws as `jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(77), step),
(), 0, n)`. The port draws the same offsets, so a cropped step trains on the same
samples in both packages. This is that computation for one scalar, with JAX's
defaults (32-bit integers, `jax_threefry_partitionable` on):

  * `PRNGKey(seed)`: the key (seed >> 32, seed & 0xffffffff) = (0, seed);
  * `fold_in(key, d)`: threefry-2x32 of the key over the counter pair (0, d);
  * `randint`: split the key in two (counters (0, 0) and (0, 1)), draw 32 random
    bits from each (the two output words of counter (0, 0), xor-ed), and reduce
    the pair modulo the span in wrapping uint32 arithmetic, as JAX does:
    ((hi % n) * m + lo % n) % n with m = ((2^16 % n)^2 mod 2^32) % n, so m is 0
    for spans above 2^16 and only the low word counts there.

Pinned against `jax.random.randint` in the port's tests.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Tuple[int, int], count: Tuple[int, int]) -> Tuple[int, int]:
    """Threefry-2x32 (20 rounds, Random123's constants) of one counter pair."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (count[0] + ks[0]) & _MASK, (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    return threefry2x32(key, (0, data & _MASK))


def _bits32(key: Tuple[int, int]) -> int:
    a, b = threefry2x32(key, (0, 0))
    return a ^ b


def randint(key: Tuple[int, int], minval: int, maxval: int) -> int:
    """One int32 draw in [minval, maxval), as `jax.random.randint(key, (), ...)`."""
    hi_key = threefry2x32(key, (0, 0))
    lo_key = threefry2x32(key, (0, 1))
    higher, lower = _bits32(hi_key), _bits32(lo_key)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span  # 2^32 wraps to 0 past 2^16
    offset = ((((higher % span) * multiplier) & _MASK) + lower % span) & _MASK
    return minval + offset % span


@lru_cache(maxsize=4096)
def crop_offset(step: int, n: int) -> int:
    """`randint(fold_in(PRNGKey(77), step), (), 0, n)`: the GAN crop's start."""
    return randint(fold_in(prng_key(77), step), 0, n)
