"""Kernel B8's wrapper (``repro_torch.kernels.flash_attn.ops``) against the
JAX package's ``flash_attention``, run as its own tests run it (Pallas in
interpret mode), on the cases of ``tests/test_kernel_flash_attn.py``.

On the CPU the wrapper pads, clips ``kv_len`` and runs the kernel's plain
version, so these tests hold the padding logic and the plain version to
the reference; ``chip_smoke.py`` holds the kernel to the plain version on
the card.  On a CUDA tensor the wrapper pads nothing: the plain version on
the unpadded inputs equals the padded route, sliced, which
``test_unpadded_equals_the_padded_route`` holds.  Tolerances are the
reference tests' own: 2e-5 (f32) and 5e-2 (bf16), and 1e-4 for
gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn import (attention_ref,  # noqa: E402
                                            flash_attention)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(rng, shape, jdt, tdt):
    a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a, jdt)
    # the same values in both packages (bf16 rounded once, by JAX)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _check(B, Hq, Hkv, Sq, Skv, D, *, causal, dtype="float32", bq=32, bk=32,
           kv_len=None, seed=42):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    jq, tq = _inputs(rng, (B, Hq, Sq, D), jdt, tdt)
    jk, tk = _inputs(rng, (B, Hkv, Skv, D), jdt, tdt)
    jv, tv = _inputs(rng, (B, Hkv, Skv, D), jdt, tdt)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = jax_flash(jq, jk, jv, jl, causal=causal, block_q=bq, block_k=bk)
    calls = ops.plain_calls
    got = flash_attention(tq, tk, tv, tl, causal=causal, block_q=bq,
                          block_k=bk)
    assert ops.plain_calls == calls + 1     # the plain version, on the CPU
    assert got.dtype == tdt and tuple(got.shape) == (B, Hq, Sq, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_basic(dtype, causal):
    _check(2, 4, 2, 64, 64, 32, causal=causal, dtype=dtype)


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 2), (8, 1), (15, 5)])
def test_gqa_ratios(Hq, Hkv):
    _check(1, Hq, Hkv, 64, 64, 32, causal=True)


@pytest.mark.parametrize("Sq,Skv,bq,bk", [
    (64, 64, 64, 64),      # single tile
    (96, 96, 32, 32),      # multiple tiles
    (40, 72, 32, 32),      # padding on both axes
    (128, 256, 32, 64),    # rectangular (cross-attention style)
    (1, 128, 1, 64),       # decode-like single query
])
def test_shape_sweep(Sq, Skv, bq, bk):
    _check(2, 4, 2, Sq, Skv, 64, causal=(Sq == Skv), bq=bq, bk=bk)


def test_padding_with_causal_mask():
    """S not a multiple of the block (as the serving prefill's 1960): the
    causal mask runs on padded indices, the padded rows are sliced off."""
    _check(2, 6, 2, 50, 50, 16, causal=True, bq=32, bk=32)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_head_dims(D):
    _check(1, 4, 2, 64, 64, D, causal=True)


def test_kv_length_masking():
    _check(3, 4, 2, 32, 128, 32, causal=False, kv_len=[0, 57, 128])


def test_kv_len_past_skv_is_clipped():
    _check(2, 2, 1, 16, 40, 16, causal=False, kv_len=[40, 1000])


def test_kv_len_zero_rows_are_zero():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype("f4"))
    k = torch.from_numpy(rng.standard_normal((1, 2, 32, 16)).astype("f4"))
    v = torch.from_numpy(rng.standard_normal((1, 2, 32, 16)).astype("f4"))
    out = flash_attention(q, k, v, torch.tensor([0], dtype=torch.int32),
                          causal=False, block_q=8, block_k=16)
    assert torch.equal(out, torch.zeros_like(out))


def test_gradients_match_reference_custom_vjp():
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 2, 32, 16), (1, 1, 32, 16), (1, 1, 32, 16))]

    def loss_jax(q, k, v):
        return (jax_flash(q, k, v, block_q=16, block_k=16) ** 2).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (flash_attention(*ts, block_q=16, block_k=16) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_plain_version_matches_reference_oracle():
    """``attention_ref`` itself against the reference's oracle, GQA with
    both masks."""
    from repro.kernels.flash_attn import attention_ref as jax_ref
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 6, 24, 16), (2, 3, 24, 16), (2, 3, 24, 16)))
    kl = np.array([24, 5], np.int32)
    want = jax_ref(*map(jnp.asarray, (q, k, v, kl)), causal=True)
    got = attention_ref(*map(torch.from_numpy, (q, k, v, kl)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_wrapper_refuses_without_fallback():
    """The CUDA launcher refuses CPU and meta tensors (it never runs the
    plain version); a meta tensor (shapes only: the dry run) gets its
    output's shape from B8's custom operator, neither a launch nor the
    plain version."""
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError):
        ops.flash_attention_cuda(q, q, q, torch.zeros(1, dtype=torch.int32))
    meta = torch.zeros((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention_cuda(meta, meta, meta, torch.zeros(
            1, dtype=torch.int32, device="meta"))
    counts = (ops.kernel_launches, ops.kernel_launches_tc, ops.plain_calls)
    out = flash_attention(meta, meta, meta,
                          torch.zeros(1, dtype=torch.int32, device="meta"))
    assert out.is_meta and out.shape == meta.shape
    assert (ops.kernel_launches, ops.kernel_launches_tc,
            ops.plain_calls) == counts
    with pytest.raises(ValueError):
        flash_attention(torch.zeros((1, 3, 4, 16)), q, q)   # 3 % 2 != 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,kv_len,block", [
    (2, 4, 2, 200, 200, 64, True, None, 128),        # ragged, causal
    (2, 15, 5, 1960 // 8, 1960 // 8, 64, True, None, 128),
    (2, 4, 2, 130, 300, 64, False, None, 128),       # Sq != Skv
    (2, 4, 1, 300, 130, 128, True, None, 128),       # Sq > Skv, causal
    (3, 4, 2, 77, 201, 32, False, [0, 57, 201], 64),  # kv_len with zeros
    (2, 2, 2, 129, 129, 16, True, [0, 100], 128),
    (1, 2, 1, 1, 131, 64, False, None, 128),         # a single query
])
def test_unpadded_equals_the_padded_route(dtype, B, Hq, Hkv, Sq, Skv, D,
                                          causal, kv_len, block):
    """What the kernel's route rests on: ``attention_ref`` on the unpadded
    inputs equals the padded route (the reference's padding to block
    multiples, then slicing), on shapes that are no multiple of 128.
    Padding keys are masked (probability exactly 0) and padding queries are
    dropped; the sums may associate differently over the longer key axis,
    so f32 is held to 1e-6 and bf16 outputs (rounded once) to max |out| ·
    2^-8, under one bf16 ulp of the largest value."""
    _, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(Sq * 1000 + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype("f4")).to(tdt)
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    kl = torch.tensor(kv_len if kv_len is not None else [Skv] * B,
                      dtype=torch.int32)
    assert Sq % block or Skv % block           # the route really pads
    padded = flash_attention(q, k, v, kl, causal=causal, block_q=block,
                             block_k=block)
    plain = attention_ref(q, k, v, kl, causal=causal)
    assert padded.shape == plain.shape == (B, Hq, Sq, D)
    tol = 1e-6 if dtype == "float32" else \
        float(plain.float().abs().max()) * 2 ** -8
    np.testing.assert_allclose(padded.float().numpy(),
                               plain.float().numpy(), atol=tol, rtol=0)
    if kv_len is not None and 0 in kv_len:
        assert bool((padded[[i for i, n in enumerate(kv_len) if n == 0]]
                     == 0).all())


# --- the arithmetic of B8's split-TF32 body ----------------------------------
#
# The body runs every product on the tensor cores in TF32 (10 mantissa
# bits).  An f32 operand x goes in as two terms: hi = x rounded to nearest
# TF32 (ties away from zero: ``(bits + 0x1000) & 0xffffe000``) and lo =
# x - hi (exact in f32), of which the tensor core reads the top 19 bits; a
# product a·b is lo_a·hi_b + hi_a·lo_b + hi_a·hi_b.  bf16 values are exact
# in TF32: Q·Kᵀ then takes one product and P·V two (P's lo and hi times
# V).  The emulation below splits the products as the body does (each
# product exact, in float64, the sum rounded to f32), runs the body's
# softmax (scores times scale·log2(e), exp2) and must agree with the plain
# version within the kernel's tolerances: 2e-5 for f32 and atol 1e-3 /
# rtol 8e-3 for bf16 outputs.  One TF32 term instead misses 2e-5.

_LOG2E = 1.4426950408889634


def _tf32_rna(x):
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _terms(x, split):
    """The TF32 terms an operand enters the tensor core as: one (exact bf16
    values, or ``split=False``: one rounded term) or two (hi, lo)."""
    x = np.asarray(x, np.float32)
    hi = _tf32_rna(x)
    if not split:
        return [hi]
    return [hi, _tf32_trunc(x - hi)]


def _tc_matmul(a, b, split_a, split_b):
    """a @ b as the body's products: every pair of terms but lo·lo, each
    product exact (float64), the sum rounded to f32."""
    ta, tb = _terms(a, split_a), _terms(b, split_b)
    out = 0.0
    for i, x in enumerate(ta):
        for j, y in enumerate(tb):
            if i + j < 2:           # drop lo·lo
                out = out + np.matmul(x.astype(np.float64),
                                      y.astype(np.float64))
    return np.asarray(out, np.float32)


def _split_tf32_attention(q, k, v, kv_len, causal, wide, split=True):
    """The split-TF32 body's arithmetic on numpy f32 arrays (``wide``: f32
    inputs, every operand split; else bf16 values: Q·Kᵀ one product, P·V
    P's two terms times V); ``split=False`` runs one TF32 term each."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    k = np.repeat(k, group, axis=1)
    v = np.repeat(v, group, axis=1)
    s = _tc_matmul(q, np.swapaxes(k, -1, -2), wide and split, wide and split)
    s = (s * np.float32(_LOG2E / np.sqrt(D))).astype(np.float32)
    keys = np.arange(Skv)
    ok = keys[None, None, None, :] < np.minimum(kv_len, Skv)[:, None, None,
                                                             None]
    if causal:
        ok = ok & (keys[None, :] <= np.arange(Sq)[:, None])[None, None]
    s = np.where(ok, s, np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    p = np.where(ok, np.exp2(s - m), np.float32(0)).astype(np.float32)
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    o = _tc_matmul(p, v, split, wide and split)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(l > 0, o / l, np.float32(0)).astype(np.float32)


def _split_inputs(seed, B, Hq, Hkv, Sq, Skv, D, tdt):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(tdt) for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                               (B, Hkv, Skv, D))]


@pytest.mark.parametrize("dtype,D,causal,B,Hq,Hkv,Sq,Skv,kv_len", [
    ("float32", 16, True, 2, 15, 5, 50, 50, None),
    ("float32", 16, False, 1, 8, 1, 77, 130, [130]),
    ("float32", 32, True, 1, 15, 5, 133, 133, None),
    ("float32", 32, False, 3, 4, 2, 45, 130, [0, 130, 7]),
    ("float32", 64, True, 1, 15, 5, 200, 200, None),
    ("float32", 64, True, 2, 8, 1, 97, 97, [0, 60]),
    ("float32", 64, False, 1, 8, 1, 33, 201, None),
    ("float32", 128, True, 1, 8, 1, 150, 150, None),
    ("float32", 128, False, 2, 15, 5, 40, 72, [72, 0]),
    ("bfloat16", 16, True, 2, 15, 5, 150, 150, [0, 97]),
    ("bfloat16", 16, False, 1, 8, 1, 64, 200, None),
    ("bfloat16", 32, True, 1, 15, 5, 133, 133, None),
    ("bfloat16", 32, False, 3, 6, 2, 45, 130, [0, 130, 7]),
])
def test_split_tf32_arithmetic_meets_the_tolerance(dtype, D, causal, B, Hq,
                                                   Hkv, Sq, Skv, kv_len):
    """The split-TF32 body's products (three terms for f32, 1 + 2 for bf16)
    against the plain version: within 2e-5 (f32), or atol 1e-3 and rtol
    8e-3 (bf16); rows with kv_len 0 exactly 0."""
    tdt = getattr(torch, dtype)
    q, k, v = _split_inputs(Sq * 31 + Skv + D, B, Hq, Hkv, Sq, Skv, D, tdt)
    kl = np.array(kv_len if kv_len is not None else [Skv] * B, np.int32)
    want = attention_ref(q, k, v, torch.from_numpy(kl), causal=causal)
    got = _split_tf32_attention(*(t.float().numpy() for t in (q, k, v)), kl,
                                causal, wide=dtype == "float32")
    got = torch.from_numpy(got).to(tdt)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=0)
    else:
        assert torch.allclose(got.float(), want.float(), atol=1e-3,
                              rtol=8e-3)
    for i, n in enumerate(kl):
        if n == 0:
            assert bool((got[i] == 0).all())


def test_one_tf32_term_misses_the_f32_tolerance():
    """Why the body splits: the same products with one TF32 term each miss
    2e-5 against the plain version (f32, D 64, causal, GQA 15/5)."""
    q, k, v = _split_inputs(22, 1, 15, 5, 200, 200, 64, torch.float32)
    kl = np.array([200], np.int32)
    want = attention_ref(q, k, v, torch.from_numpy(kl), causal=True).numpy()
    args = [t.numpy() for t in (q, k, v)]
    split = _split_tf32_attention(*args, kl, True, wide=True)
    one = _split_tf32_attention(*args, kl, True, wide=True, split=False)
    assert np.abs(split - want).max() <= 2e-5
    assert np.abs(one - want).max() > 2e-5
