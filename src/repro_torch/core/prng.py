"""JAX's threefry2x32 random keys and draws, bit for bit, as torch code.

The reference draws random trace branches with ``jax.random``
(``PRNGKey(seed)``, ``split`` and ``randint(key, (), 0, n)``), and its LM
weights and sampled tokens with ``fold_in``, ``split``, ``normal`` and
``categorical``; the default generator is threefry2x32.  Matching its
traces, weights and tokens per seed needs the same bits, so this module
ports the generator as integer torch code, with the counter layout of
``jax_threefry_partitionable=True`` (the default of the jax the reference
runs on).

Batched keys, for the SNP traces (``(B, 2)`` tensors):

* ``PRNGKey(seeds)`` of uint32 seeds is ``(0, seed)`` each;
* ``split(keys)`` hashes the counters ``(0, 0)`` and ``(0, 1)``: the new
  keys and the subkeys;
* ``randint(keys, n)`` splits each key, draws 32 bits from each half (the
  hash of counter ``(0, 0)``, its two words xor-ed), and reduces
  ``(hi % n)·(2^32 % n) + lo % n`` modulo ``n`` with uint32 wraparound.

One key, for the LM path (a ``(2,)`` tensor, on any device):

* ``split(key, num)`` is ``(num, 2)``: row ``i`` hashes counter ``(0, i)``;
  ``fold_in(key, d)`` hashes ``(0, d)``;
* ``random_bits(key, shape)``: element ``i`` (row-major) is the xor of the
  two words of counter ``(i >> 32, i & (2^32 - 1))``;
* ``uniform`` puts the top 23 bits under the exponent of 1.0 (``[1, 2)``),
  subtracts 1 and scales to ``[minval, maxval)`` in f32; ``normal`` is
  ``√2·erfinv(uniform(nextafter(-1, 0), 1))``; ``categorical`` the argmax
  of ``logits + gumbel``, ``gumbel = -log(-log(uniform(tiny, 1)))``.  The
  bits and uniforms equal jax's (the scaling is one fused multiply-add,
  as XLA's CPU compiler emits it).  ``erfinv`` is XLA's polynomial, but
  its ``log1p`` and the Gumbel noise's ``log`` are torch's, so normals and
  Gumbel noise agree with jax's to a few f32 ulps.

uint32 in int64.  Every word is held in int64 lanes in ``[0, 2^32)``:
adds and the xor are masked to 32 bits, rotations shift masked,
non-negative values (so ``>>`` is logical), and products go through
:func:`~repro_torch.core.hashing.mul32` (16-bit halves), since a product
of two words could pass 2^63.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashing import M32, mul32

__all__ = ["threefry2x32", "PRNGKey", "split", "randint", "fold_in",
           "random_bits", "uniform", "normal", "categorical"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Counters hashed at once by the single-key draws: a few int64 temporaries
# of this many elements (128 MiB each), whatever the shape drawn.
_CHUNK = 1 << 24
_ONE_F32_BITS = 0x3F800000


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


def PRNGKey(seeds) -> torch.Tensor:
    """``jax.random.PRNGKey`` of each uint32 seed (``seeds`` (B,) int64 in
    ``[0, 2^32)``): keys ``(B, 2)``, ``(0, seed)``.  An int seed gives one
    key, ``(2,)`` on the CPU."""
    if isinstance(seeds, int):
        return torch.tensor([0, seeds & M32], dtype=torch.int64)
    return torch.stack([torch.zeros_like(seeds), seeds & M32], -1)


def _hash(keys: torch.Tensor, counter: int):
    zero = torch.zeros_like(keys[:, 0])
    return threefry2x32(keys[:, 0], keys[:, 1], zero, zero + counter)


def split(keys: torch.Tensor, num: int = 2):
    """``jax.random.split``.  One key ``(2,)``: ``(num, 2)`` keys.  Keys
    ``(B, 2)`` split each into two: ``(new keys, subkeys)``, both ``(B,
    2)``."""
    if keys.dim() == 1:
        c = torch.arange(num, dtype=torch.int64, device=keys.device)
        x0, x1 = threefry2x32(keys[0], keys[1], torch.zeros_like(c), c)
        return torch.stack([x0, x1], -1)
    if num != 2:
        raise ValueError(f"batched keys split into 2, not {num}")
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


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of one key ``(2,)`` and a uint32 ``data``."""
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(key[0]),
                          torch.full_like(key[0], int(data) & M32))
    return torch.stack([x0, x1])


def _bits(key: torch.Tensor, start: int, stop: int,
          device) -> torch.Tensor:
    """32 random bits for each flat index in ``[start, stop)``."""
    k = key.to(device)
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k[0], k[1], i >> 32, i & M32)
    return x0 ^ x1


def _draw(key, shape, dtype, device, fn) -> torch.Tensor:
    """``fn(bits)`` for every element of ``shape``, in chunks of
    ``_CHUNK`` counters, on ``device`` (default: the key's)."""
    device = key.device if device is None else torch.device(device)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _CHUNK):
        e = min(s + _CHUNK, flat.numel())
        flat[s:e] = fn(_bits(key, s, e, device))
    return out


def random_bits(key: torch.Tensor, shape, *, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 values in
    ``[0, 2^32)``."""
    return _draw(key, shape, torch.int64, device, lambda b: b)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of f32 tensors rounded once, as XLA's CPU compiler
    contracts it: the product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _unit(bits: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor) -> torch.Tensor:
    """jax's ``_uniform`` in f32: the top 23 bits as the mantissa of a
    float in ``[1, 2)``, minus 1, scaled to ``[lo, hi)``, at least lo."""
    f = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32)
    return torch.maximum(lo, _fma(f - 1.0, hi - lo, lo))


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x²).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erf⁻¹ of f32 ``x`` by XLA's polynomial, its Horner steps fused as
    XLA fuses them.  ``torch.erfinv`` is exact to an ulp where this
    polynomial is not (up to 7e-5 apart near |x| = 1); the reference's
    draws follow the polynomial, to an ulp or two (``log1p`` is torch's)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, _f32(a, x.device), _f32(b, x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, *, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    dev = key.device if device is None else torch.device(device)
    lo, hi = _f32(minval, dev), _f32(maxval, dev)
    return _draw(key, shape, torch.float32, dev,
                 lambda b: _unit(b, lo, hi))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape, *, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``√2·erfinv(u)`` of
    ``u = uniform(key, shape, nextafter(-1, 0), 1)``."""
    dev = key.device if device is None else torch.device(device)
    lo, hi, sqrt2 = _f32(_NORMAL_LO, dev), _f32(1.0, dev), _f32(_SQRT2, dev)
    return _draw(key, shape, torch.float32, dev,
                 lambda b: _erfinv(_unit(b, lo, hi)) * sqrt2)


_TINY = float(np.finfo(np.float32).tiny)


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` of f32 ``logits``:
    the index of the largest ``logits + gumbel`` along ``axis`` (int64),
    ``gumbel = -log(-log(uniform(key, logits.shape, tiny, 1)))`` drawn
    over the whole of ``logits`` in row-major order."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical takes f32 logits, got {logits.dtype}")
    u = uniform(key, logits.shape, _TINY, 1.0, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=axis)
