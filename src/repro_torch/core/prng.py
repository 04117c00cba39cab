"""JAX's threefry2x32 random keys, bit for bit, as batched torch code.

The reference draws random trace branches with ``jax.random``
(``PRNGKey(seed)``, ``split`` and ``randint(key, (), 0, n)``), whose
default generator is threefry2x32.  Matching its traces per seed needs the
same bits, so this module ports the generator as integer torch code,
batched over ``B`` keys, with the counter layout of
``jax_threefry_partitionable=True`` (the default of the jax the reference
runs on):

* a key is a ``(B, 2)`` tensor; ``PRNGKey(seed)`` of a uint32 seed is
  ``(0, seed)``;
* ``split(key)`` hashes the counters ``(0, 0)`` and ``(0, 1)``: the new
  key and the subkey;
* ``randint(key, n)`` splits the key, draws 32 bits from each half (the
  hash of counter ``(0, 0)``, its two words xor-ed), and reduces
  ``(hi % n)·(2^32 % n) + lo % n`` modulo ``n`` with uint32 wraparound.

uint32 in int64.  Every word is held in int64 lanes in ``[0, 2^32)``:
adds and the xor are masked to 32 bits, rotations shift masked,
non-negative values (so ``>>`` is logical), and products go through
:func:`~repro_torch.core.hashing.mul32` (16-bit halves), since a product
of two words could pass 2^63.
"""

from __future__ import annotations

import torch

from .hashing import M32, mul32

__all__ = ["threefry2x32", "PRNGKey", "split", "randint"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(c0,
    c1)`` under the key ``(k0, k1)``: int64 tensors holding uint32 values,
    broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for i in range(1, 6):
        for r in _ROTATIONS[(i - 1) % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[i % 3]) & M32
        x1 = (x1 + ks[(i + 1) % 3] + i) & M32
    return x0, x1


def PRNGKey(seeds: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of each uint32 seed (``seeds`` (B,) int64 in
    ``[0, 2^32)``): keys ``(B, 2)``, ``(0, seed)``."""
    return torch.stack([torch.zeros_like(seeds), seeds & M32], -1)


def _hash(keys: torch.Tensor, counter: int):
    zero = torch.zeros_like(keys[:, 0])
    return threefry2x32(keys[:, 0], keys[:, 1], zero, zero + counter)


def split(keys: torch.Tensor):
    """``jax.random.split`` of each key into two: ``(new keys, subkeys)``,
    both ``(B, 2)``."""
    a0, a1 = _hash(keys, 0)
    b0, b1 = _hash(keys, 1)
    return torch.stack([a0, a1], -1), torch.stack([b0, b1], -1)


def _bits32(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, (), uint32)``: 32 random bits per key."""
    x0, x1 = _hash(keys, 0)
    return x0 ^ x1


def randint(keys: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, n)`` (int32) for each key and
    ``n`` (B,) in ``[1, 2^31)``: int64 draws in ``[0, n)``."""
    k_hi, k_lo = split(keys)
    higher, lower = _bits32(k_hi), _bits32(k_lo)
    span = n.to(torch.int64)
    multiplier = (1 << 16) % span
    multiplier = mul32(multiplier, multiplier) % span
    offset = (mul32(higher % span, multiplier) + lower % span) & M32
    return offset % span
