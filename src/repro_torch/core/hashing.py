"""64-bit configuration hashing (2 x uint32 lanes) for on-device dedup.

The port of ``repro.core.hashing.config_hash``: a per-element multiply and
shift-xor folded by two position-salted polynomial accumulators, then a
murmur3 finalizer per lane.  It gives the reference's ``(hi, lo)`` lanes
bit for bit.

uint32 arithmetic in int64.  Torch's ``uint32`` has few operators, so
every lane value is held in int64 in ``[0, 2^32)``.  A product of two such
values could overflow int64, so :func:`_mul32` multiplies by the 16-bit
halves of one factor (each partial product < 2^48) and keeps the low 32
bits; every add is masked to 32 bits.  Values are shifted only when masked,
hence non-negative, so ``>>`` is the logical shift the reference uses.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["config_hash", "SENTINEL", "fmix32", "mul32"]

M32 = 0xFFFFFFFF
# Sorts after every real hash; used for invalid / empty slots.
SENTINEL = 0xFFFFFFFF

_GOLDEN = 0x9E3779B9
_P1 = 0x01000193  # FNV prime
_P2 = 0x85EBCA77


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` in [0, 2^32) and ``b`` a uint32
    int or an int64 tensor in [0, 2^32)."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    return (a * b_lo + ((a * b_hi) & 0xFFFF) * 65536) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _pow_vector(p: int, m: int) -> np.ndarray:
    """[p^(m-1), ..., p^1, p^0] mod 2^32 (exact in Python ints)."""
    out = np.empty(m, dtype=np.int64)
    acc = 1
    for i in range(m - 1, -1, -1):
        out[i] = acc
        acc = (acc * p) % (1 << 32)
    return out


def config_hash(configs: torch.Tensor):
    """Hash int32 configs (..., m) to two lanes ``(hi, lo)``: int64 tensors
    holding the reference's uint32 values (negative entries wrap mod 2^32
    as the reference's cast does)."""
    m = configs.shape[-1]
    dev = configs.device
    x = configs.to(torch.int64) & M32
    pos = torch.from_numpy(
        (np.arange(m, dtype=np.int64) * _GOLDEN) % (1 << 32)).to(dev)
    y = mul32((x + pos) & M32, 0x85EBCA6B)
    y = y ^ (y >> 16)
    p1 = torch.from_numpy(_pow_vector(_P1, m)).to(dev)
    p2 = torch.from_numpy(_pow_vector(_P2, m)).to(dev)
    # each term < 2^32, so the int64 sum of m < 2^31 terms cannot overflow
    h1 = mul32(y, p1).sum(-1) & M32
    h2 = mul32(y ^ _GOLDEN, p2).sum(-1) & M32
    hi = fmix32(h1 ^ m)
    lo = fmix32((h2 + (m * _GOLDEN) % (1 << 32)) & M32)
    return hi, lo
