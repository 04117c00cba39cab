"""64-bit configuration hashing (2 x uint32 lanes) for on-device dedup.

The port of ``repro.core.hashing``, bit for bit:

* :func:`config_hash` — a per-element multiply and shift-xor folded by two
  position-salted polynomial accumulators, then a murmur3 finalizer per
  lane (the single-device engine's key); on the card kernel H1's hash
  body, elsewhere its plain version :func:`config_hash_ref`;
* :func:`zobrist_hash` — each (global position, value) pair finalized on
  its own and the lanes summed mod 2^32, so the hashes of disjoint column
  slices add up to the hash of the whole row (the neuron-sharded
  frontier's key: each shard hashes its slice, one sum combines them).

uint32 arithmetic in int64.  Torch's ``uint32`` has few operators, so
every lane value is held in int64 in ``[0, 2^32)``.  A product of two such
values could overflow int64, so :func:`_mul32` multiplies by the 16-bit
halves of one factor (each partial product < 2^48) and keeps the low 32
bits; every add is masked to 32 bits.  Values are shifted only when masked,
hence non-negative, so ``>>`` is the logical shift the reference uses.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["config_hash", "config_hash_ref", "zobrist_hash", "SENTINEL",
           "fmix32", "mul32"]

M32 = 0xFFFFFFFF
# Sorts after every real hash; used for invalid / empty slots.
SENTINEL = 0xFFFFFFFF

_GOLDEN = 0x9E3779B9
_P1 = 0x01000193  # FNV prime
_P2 = 0x85EBCA77
_Z1 = 0x9E3779B1
_Z2 = 0x85EBCA77
_ZV1 = 0x27D4EB2F
_ZV2 = 0x165667B1

# Both hashes make a dozen int64 temporaries the size of their input; rows
# are hashed in blocks of at most this many entries to bound that memory.
_BLOCK_ENTRIES = 1 << 26


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


def _by_rows(fn, configs: torch.Tensor):
    """``fn(configs)`` on blocks of whole rows of at most
    :data:`_BLOCK_ENTRIES` entries, the lanes concatenated (a row's hash
    reads that row only, so the result is the same)."""
    if configs.numel() <= _BLOCK_ENTRIES:
        return fn(configs)
    k = configs.shape[-1]
    rows = configs.reshape(-1, k)
    step = max(1, _BLOCK_ENTRIES // k)
    parts = [fn(rows[i:i + step]) for i in range(0, rows.shape[0], step)]
    return tuple(torch.cat([p[j] for p in parts]).reshape(configs.shape[:-1])
                 for j in range(2))


def _pow_vector_on(p: int, m: int, dev: torch.device) -> torch.Tensor:
    """``[p^(m-1), ..., p^1, p^0] mod 2^32`` computed on ``dev`` (square
    and multiply over the exponents' bits), so no host array is copied to
    the card."""
    e = (m - 1) - torch.arange(m, dtype=torch.int64, device=dev)
    out = torch.ones(m, dtype=torch.int64, device=dev)
    base = p
    for bit in range(max(1, (m - 1).bit_length())):
        out = torch.where((e >> bit) & 1 == 1, mul32(out, base), out)
        base = (base * base) % (1 << 32)
    return out


@functools.lru_cache(maxsize=None)
def _config_consts(m: int, dev: torch.device):
    """:func:`config_hash`'s position salts and power vectors for width
    ``m``, built once per ``(m, device)`` and on it: a copy from pageable
    host memory waits on the card and cannot be captured into a CUDA
    graph, and the level loop is one."""
    pos = (torch.arange(m, dtype=torch.int64, device=dev) * _GOLDEN) & M32
    return pos, _pow_vector_on(_P1, m, dev), _pow_vector_on(_P2, m, dev)


def config_hash(configs: torch.Tensor):
    """Hash int32 configs (..., m) to two lanes ``(hi, lo)``: int64 tensors
    holding the reference's uint32 values (negative entries wrap mod 2^32
    as the reference's cast does).  On a CUDA tensor kernel H1's hash body
    (:func:`repro_torch.kernels.hashtable.ops.config_hash`) runs, one launch
    that reads each row once, or the call raises; on a CPU or meta tensor
    its plain version :func:`config_hash_ref`."""
    # imported here: the kernels package imports core modules
    from ..kernels.hashtable import ops
    return ops.config_hash(configs)


def config_hash_ref(configs: torch.Tensor):
    """:func:`config_hash`'s plain version: eager int64 passes over row
    blocks (a dozen temporaries the size of a block)."""
    m = configs.shape[-1]
    pos, p1, p2 = _config_consts(m, configs.device)

    def lanes(rows):
        x = rows.to(torch.int64) & M32
        y = mul32((x + pos) & M32, 0x85EBCA6B)
        y = y ^ (y >> 16)
        # each term < 2^32, so the int64 sum of m < 2^31 terms cannot
        # overflow
        h1 = mul32(y, p1).sum(-1) & M32
        h2 = mul32(y ^ _GOLDEN, p2).sum(-1) & M32
        hi = fmix32(h1 ^ m)
        lo = fmix32((h2 + (m * _GOLDEN) % (1 << 32)) & M32)
        return hi, lo

    return _by_rows(lanes, configs)


def _zobrist_salts(pos: torch.Tensor):
    """Each global position's two lane salts (device operations only)."""
    pos = (pos + 1) & M32
    return mul32(pos, _Z1), (mul32(pos, _Z2) + _GOLDEN) & M32


@functools.lru_cache(maxsize=None)
def _zobrist_range(k: int, offset: int, dev: torch.device):
    """The salts of the positions ``offset .. offset + k - 1``, built once
    per ``(k, offset, device)``."""
    return _zobrist_salts(
        torch.arange(k, dtype=torch.int64, device=dev) + offset)


def zobrist_hash(configs: torch.Tensor, offset=0, positions=None):
    """Sum-combinable hash of config slices (..., k): ``(hi, lo)`` int64
    lanes holding the reference's uint32 values.  Column ``c`` sits at
    global position ``offset + c``, or ``positions[c]`` when given (a
    degree partition's columns are not a contiguous range), and

        ``zobrist(c) == Σ_d zobrist(c[:, lo_d:hi_d], offset=lo_d)  (mod 2^32)``
    """
    dev = configs.device
    k = configs.shape[-1]
    if positions is not None:
        pos_hi, pos_lo = _zobrist_salts(
            torch.as_tensor(positions, device=dev).to(torch.int64))
    else:
        pos_hi, pos_lo = _zobrist_range(k, int(offset), dev)

    def lanes(rows):
        x = rows.to(torch.int64) & M32
        # each term < 2^32, so the int64 sum of k < 2^31 terms is exact
        hi = fmix32(pos_hi ^ mul32(x, _ZV1)).sum(-1) & M32
        lo = fmix32((pos_lo + mul32(x, _ZV2)) & M32).sum(-1) & M32
        return hi, lo

    return _by_rows(lanes, configs)
