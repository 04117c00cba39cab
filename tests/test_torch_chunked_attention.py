"""The port's chunked attention (``kernels/flash_attn/chunked.py``) against
the JAX package's (its ``custom_vjp``: the blockwise forward and the
chunked backward) on the same inputs, numpy from a seed: the output and
the gradients of q, k and v under one random cotangent, at ragged query
lengths (padded to whole blocks), GQA, ``kv_len`` masks with an empty
row, causal and not, several blocks each way and the default blocks.

Tolerances: f32 within 2e-5 of the largest magnitude (both sum the same
products in blocks of the same size; the einsums may order them
differently); bf16 (inputs, output and gradients rounded to bf16) within
2e-2 of it, a few bf16 ulps.  Also checked: no step of the port's
forward or backward makes a tensor as large as one block panel more
than ``(B, H, block_q, block_k)``, so the ``(B, H, Sq, Skv)`` scores are
never materialised; and ``attn_impl="chunked"`` in the model equals the
plain attention."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.chunked import \
    chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attn import (attention_ref,  # noqa: E402
                                            chunked_attention)

# name, B, Hq, Hkv, Sq, Skv, D, causal, kv_len, block_q, block_k
CASES = [
    ("ragged causal GQA 4/2", 2, 4, 2, 50, 50, 16, True, None, 16, 32),
    ("not causal, kv_len 0/33/70, GQA 4/1", 3, 4, 1, 37, 70, 8, False,
     [0, 33, 70], 16, 16),
    ("causal Sq != Skv, kv_len", 2, 6, 3, 40, 64, 16, True, [17, 64], 16,
     32),
    ("default blocks", 1, 2, 2, 24, 24, 16, True, None, 512, 1024),
    ("one query block, many key blocks", 2, 2, 1, 9, 100, 16, False,
     [100, 45], 512, 16),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    g = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, g


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


# bf16 at two of the cases (the dtype handling is shared by all)
PAIRS = [(c, "float32") for c in CASES] + [(c, "bfloat16")
                                           for c in CASES[:2]]


@pytest.mark.parametrize("case,dtype", PAIRS,
                         ids=[f"{c[0]}-{d}" for c, d in PAIRS])
def test_forward_and_gradients_equal_the_reference(case, dtype):
    _, B, Hq, Hkv, Sq, Skv, D, causal, kl, bq, bk = case
    q, k, v, g = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq * 7 + Skv)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jkl = None if kl is None else jnp.asarray(kl, jnp.int32)
    want, vjp = jax.vjp(lambda a, b, c: jax_chunked(
        a, b, c, jkl, causal=causal, block_q=bq, block_k=bk), jq, jk, jv)
    wq, wk, wv = vjp(jg)

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    tkl = None if kl is None else torch.tensor(kl, dtype=torch.int32)
    got = chunked_attention(tq, tk, tv, tkl, causal=causal, block_q=bq,
                            block_k=bk)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and tq.grad.dtype == tdt
    for a, b in ((got, want), (tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        _close(a, b, TOL[dtype])
    if kl is not None and 0 in kl:
        row = kl.index(0)
        assert bool((got[row] == 0).all()) and bool((tq.grad[row] == 0).all())


def test_no_full_score_tensor(monkeypatch):
    """Every einsum of the forward and the backward makes at most one
    (B, H, block_q, block_k) panel, far below (B, H, Sq, Skv)."""
    B, H, Sq, Skv, D, bq, bk = 2, 3, 70, 90, 16, 16, 32
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(B, H, H, Sq, Skv, D,
                                                        seed=5))
    largest = [0]
    einsum = torch.einsum

    def spy(*args, **kw):
        out = einsum(*args, **kw)
        largest[0] = max(largest[0], out.numel())
        return out

    monkeypatch.setattr(torch, "einsum", spy)
    q.requires_grad_()
    out = chunked_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    out.backward(g)
    assert 0 < largest[0] <= max(B * H * bq * bk, B * H * Skv * D)
    assert largest[0] < B * H * Sq * Skv // 4
    monkeypatch.undo()
    want = attention_ref(q.detach(), k, v, causal=True)
    _close(out, want.numpy(), 2e-5)


def test_model_attention_chunked_equals_plain():
    """``attn_impl="chunked"`` in a GQA layer: output and gradients equal
    the plain attention's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import reduced
    from repro_torch.core import prng
    from repro_torch.models import layers as L

    cfg = reduced(get_config("smollm-360m"))
    p = L.init_attention(prng.PRNGKey(3), cfg, torch.float32, "cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 21, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(21).expand(2, 21)
    outs = {}
    for impl in ("chunked", "ref"):
        p.zero_grad()
        out, _ = L.attention(p, cfg, x, pos, attn_impl=impl)
        out.square().sum().backward()
        outs[impl] = (out.detach(), [t.grad.clone() for t in p.parameters()])
    _close(outs["chunked"][0], outs["ref"][0].numpy(), 2e-5)
    for a, b in zip(outs["chunked"][1], outs["ref"][1]):
        _close(a, b.numpy(), 2e-5)
