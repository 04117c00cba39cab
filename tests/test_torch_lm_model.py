"""The port's language model (``repro_torch.models``) against the JAX
package's, given the same weights: the reference's ``init_params`` tree,
carried across by ``params_from_jax``.

Setup: ``reduced(get_config("smollm-360m"))`` (2 layers, d 64, 6/2 heads,
head_dim 16, f32).  Layers are held to 1e-5, ``forward`` in prefill and
decode mode to 1e-4 against the reference's ``attn_impl="pallas"``
(Pallas in interpret mode), a bf16 variant to 5e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs.smoke import reduced as jax_reduced  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import param_count as jax_param_count  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import (LM, forward, init_cache,  # noqa: E402
                                init_params, param_count, params_from_jax)
from repro_torch.models import layers as L  # noqa: E402

TOL = 1e-4


def _cfgs(arch="smollm-360m", **over):
    jc = dataclasses.replace(jax_reduced(jax_get(arch)), **over)
    pc = dataclasses.replace(reduced(get_config(arch)), **over)
    return jc, pc


def _tree(jparams, rng=None):
    """The reference's tree as numpy; ``rng`` also randomises the zero
    biases so that they count."""
    tree = jax.tree.map(np.asarray, jparams)
    if rng is not None:
        attn = tree["stack"]["pos0"]["attn"]
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = (rng.standard_normal(attn[name].shape) * 0.1
                              ).astype(attn[name].dtype)
    return tree


def _jparams_from_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(cfg, B, S, seed=0):
    b = make_batch(cfg, DataConfig(seed=seed), step=0, shard=0, batch=B,
                   seq_len=S)
    b.pop("labels")
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol, rel=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0) if rel else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _setup(arch="smollm-360m", seed=0, rand_bias=False, **over):
    jc, pc = _cfgs(arch, **over)
    tree = _tree(jax_init(jax.random.PRNGKey(seed), jc),
                 np.random.default_rng(seed) if rand_bias else None)
    return jc, pc, _jparams_from_tree(tree), params_from_jax(
        tree, pc, device="cpu"), tree


# -- layers --------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = L.rms_norm(L.Params(scale=torch.from_numpy(scale)),
                     torch.from_numpy(x), 1e-5)
    _close(got, want, 1e-5)


def test_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2025, (2, 7)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, want, 1e-5)


def test_mrope():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 2, 5)).astype(np.int32)
    want = JL.mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = L.mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3, 3))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = JL.init_mlp(jax.random.PRNGKey(4), 64, 96, jnp.float32, act)
    want = JL.mlp(p, jnp.asarray(x), act)
    got = L.mlp(L.Params(**{k: torch.from_numpy(np.array(v))
                            for k, v in p.items()}),
                torch.from_numpy(x), act)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = JL.init_dense(jax.random.PRNGKey(6), 64, 48, jnp.float32, bias)
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(48).astype(np.float32))
    want = JL.dense(p, jnp.asarray(x))
    got = L.dense(L.Params(**{k: torch.from_numpy(np.array(v))
                              for k, v in p.items()}), torch.from_numpy(x))
    _close(got, want, 1e-5)
    mine = L.init_dense(prng.PRNGKey(6), 64, 48, torch.float32, bias)
    assert sorted(mine._parameters) == sorted(p)
    _close(mine.w, p["w"], 1e-7)            # the reference's draw


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_attention_layer(impl):
    """Without a cache, prefill into a cache, then one decode step."""
    jc, pc, jp, pp, tree = _setup(rand_bias=True, attn_bias=True)
    ja, pa = jp["stack"]["pos0"]["attn"], pp.blocks[0].attn
    ja = jax.tree.map(lambda a: a[0], ja)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    jimpl = {"cuda": "pallas", "ref": "xla"}[impl]
    with torch.no_grad():
        want, _ = JL.attention(ja, jc, jnp.asarray(x), jnp.asarray(pos),
                               attn_impl=jimpl)
        got, _ = L.attention(pa, pc, torch.from_numpy(x),
                             torch.from_numpy(pos), attn_impl=impl)
        _close(got, want, 1e-5)
        jcache = jax.tree.map(lambda a: a[0], jax_init_cache(jc, 2, 12)["pos0"])
        pcache = init_cache(pc, 2, 12, device="cpu")[0]
        want, jcache = JL.attention(ja, jc, jnp.asarray(x), jnp.asarray(pos),
                                    jcache, attn_impl=jimpl)
        got, pcache = L.attention(pa, pc, torch.from_numpy(x),
                                  torch.from_numpy(pos), pcache,
                                  attn_impl=impl)
        _close(got, want, 1e-5)
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        p1 = np.full((2, 1), 9, np.int32)
        want, jcache = JL.attention(ja, jc, jnp.asarray(x1), jnp.asarray(p1),
                                    jcache)
        got, pcache = L.attention(pa, pc, torch.from_numpy(x1),
                                  torch.from_numpy(p1), pcache)
        _close(got, want, 1e-5)
        for key in ("k", "v"):
            _close(pcache[key], jcache[key], 1e-5)
        np.testing.assert_array_equal(pcache["len"].numpy(),
                                      np.asarray(jcache["len"]))


# -- weights across ------------------------------------------------------------

KINDS = [("embed",), ("head",), ("ln_f", "scale"),
         ("ln_attn", "scale"), ("ln_mlp", "scale"),
         ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
         ("attn", "bq"), ("attn", "bk"), ("attn", "bv"),
         ("mlp", "wg"), ("mlp", "wu"), ("mlp", "wd")]


@pytest.mark.parametrize("kind", KINDS, ids="/".join)
def test_params_from_jax_tensor_kind(kind):
    """Each tensor kind lands where the port reads it, in the reference's
    layout, for every layer (qwen2-vl reduced: biases and an untied
    head)."""
    jc, pc, jp, pp, tree = _setup("qwen2-vl-7b", rand_bias=True)
    if len(kind) == 1:
        pairs = [(getattr(pp, kind[0]), tree[kind[0]])]
    elif kind[0] == "ln_f":
        pairs = [(pp.ln_f.scale, tree["ln_f"]["scale"])]
    else:
        stacked = tree["stack"]["pos0"][kind[0]][kind[1]]
        pairs = [(getattr(getattr(b, kind[0]), kind[1]), stacked[i])
                 for i, b in enumerate(pp.blocks)]
        assert len(pairs) == pc.num_layers == stacked.shape[0]
    for got, want in pairs:
        np.testing.assert_array_equal(got.detach().numpy(), want)


def test_params_from_jax_refuses_a_wrong_tree():
    jc, pc, jp, pp, tree = _setup()
    with pytest.raises(ValueError):
        params_from_jax(tree, dataclasses.replace(pc, d_ff=32),
                        device="cpu")
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tree, pc, device="cpu")


def _norms(cfg):
    """Norm scales, which the analytic ``param_count`` leaves out."""
    return (2 * cfg.num_layers + 1) * cfg.d_model


def test_param_count():
    jc, pc, jp, pp, tree = _setup()
    assert param_count(pp) == jax_param_count(jp) \
        == pc.param_count() + _norms(pc)


def test_full_width_param_count_without_allocating():
    cfg = get_config("smollm-360m")
    lm = LM(None, cfg, device="meta")
    assert cfg.param_count() == 361_758_720
    assert param_count(lm) == cfg.param_count() + _norms(cfg)
    assert len(lm.blocks) == 32
    assert lm.blocks[0].attn.wq.shape == (960, 15, 64)


def test_init_params_distribution():
    cfg = dataclasses.replace(reduced(get_config("smollm-360m")),
                              d_model=128, vocab_size=512)
    p = init_params(prng.PRNGKey(0), cfg, device="cpu")
    w = p.embed.detach()
    assert w.dtype == torch.float32
    assert abs(float(w.mean())) < 2e-3 and abs(float(w.std()) - 0.02) < 1e-3
    assert torch.equal(p.ln_f.scale.detach(), torch.ones(128))
    again = init_params(prng.PRNGKey(0), cfg, device="cpu")
    assert torch.equal(again.blocks[1].mlp.wd, p.blocks[1].mlp.wd)
    bf = init_params(prng.PRNGKey(0),
                     dataclasses.replace(cfg, dtype="bfloat16"),
                     device="cpu")
    assert bf.blocks[0].attn.wq.dtype == torch.bfloat16


@pytest.mark.parametrize("arch,seed", [
    ("smollm-360m", 0), ("smollm-360m", 3), ("smollm-360m", 2 ** 32 - 1),
    ("qwen2-vl-7b", 1),        # attention biases (zeros), untied head
    ("command-r-35b", 2),      # parallel block
    ("minicpm-2b", 4),         # MHA
    ("musicgen-medium", 5),    # GELU MLP (keys 1 and 2), codebook tables
    ("qwen2-moe-a2.7b", 6),    # MoE with the shared expert
    ("grok-1-314b", 7),        # MoE without one
    ("jamba-1.5-large-398b", 8),   # Mamba, MoE on odd positions
    ("minicpm3-4b", 9),        # MLA, tied embeddings
    ("rwkv6-7b", 10)])         # RWKV6, f32 decay and bonus
def test_init_params_equal_the_reference(arch, seed):
    """Every weight of ``init_params(PRNGKey(s), cfg)`` against the
    reference's ``init_params(jax.random.PRNGKey(s), cfg)`` at f32, for
    each of the ten archs: the same tree of split keys, normals to a few
    ulps, the same constants (norm scales, biases, Mamba's ``a_log``,
    RWKV's ``decay``)."""
    jc, pc = _cfgs(arch)
    jk = jax.random.wrap_key_data(jnp.asarray([0, seed], jnp.uint32))
    tree = jax.tree.map(np.asarray, jax_init(jk, jc))
    p = init_params(prng.PRNGKey(seed), pc, device="cpu")
    pairs = [(p.embed, tree["embed"]), (p.ln_f.scale, tree["ln_f"]["scale"])]
    if p.head is not None:
        pairs.append((p.head, tree["head"]))
    P = len(pc.layer_pattern)
    for i, block in enumerate(p.blocks):
        period, pos = divmod(i, P)
        for name, t in block.named_parameters():
            want = tree["stack"][f"pos{pos}"]
            for part in name.split("."):
                want = want[part]
            pairs.append((t, want[period]))
    assert len(pairs) == sum(1 for _ in p.parameters())
    assert len(pairs) == len(jax.tree.leaves(tree)) + (
        sum(a.shape[0] - 1 for a in jax.tree.leaves(tree["stack"])))
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-7)


# -- forward -------------------------------------------------------------------

def _prefill_decode(jc, pc, jp, pp, *, B=2, S=12, steps=3, jimpl="pallas",
                    impl="cuda", tol=TOL, rel=False):
    jb, tb = _batch(jc, B, S)
    max_len = S + steps + 1
    with torch.no_grad():
        want, jcache, _ = jax_forward(jp, jc, jb,
                                      cache=jax_init_cache(jc, B, max_len),
                                      mode="prefill", attn_impl=jimpl)
        got, pcache, _ = forward(pp, pc, tb,
                                 cache=init_cache(pc, B, max_len,
                                                  device="cpu"),
                                 mode="prefill", attn_impl=impl)
        _close(got, want, tol, rel)
        for i in range(pc.num_layers):
            _close(pcache[i]["k"], jcache["pos0"]["k"][i], tol, rel)
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        for g in range(steps):
            tokens = tok[:, None]
            pos = np.full((B, 1), S + g, np.int32)
            if jc.mrope_sections:
                pos = np.broadcast_to(pos[None], (3, B, 1)).copy()
            want, jcache, _ = jax_forward(
                jp, jc, {"tokens": jnp.asarray(tokens),
                         "positions": jnp.asarray(pos)},
                cache=jcache, mode="decode")
            got, pcache, _ = forward(
                pp, pc, {"tokens": torch.from_numpy(tokens),
                         "positions": torch.from_numpy(pos)},
                cache=pcache, mode="decode")
            _close(got, want, tol, rel)
            assert int(pcache[0]["len"][0]) == S + g + 1
            tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_forward_prefill_and_decode_match_jax(impl):
    jc, pc, jp, pp, _ = _setup()
    _prefill_decode(jc, pc, jp, pp, impl=impl)


def test_forward_without_cache_and_last_slice():
    jc, pc, jp, pp, _ = _setup()
    jb, tb = _batch(jc, 2, 10)
    with torch.no_grad():
        want, _, _ = jax_forward(jp, jc, jb, mode="train",
                                 attn_impl="pallas", remat="none")
        got, cache, aux = forward(pp, pc, tb, attn_impl="cuda")
        assert cache is None and float(aux["load_balance_loss"]) == 0.0
        _close(got, want, TOL)
        last, _, _ = forward(pp, pc, tb, attn_impl="ref",
                             logits_slice="last")
        _close(last, want[:, -1:], TOL)


def test_prefill_then_decode_equals_teacher_forcing():
    _, pc, _, pp, _ = _setup()
    _, tb = _batch(pc, 2, 11)
    S = 10
    with torch.no_grad():
        prompt = {k: v[:, :S] for k, v in tb.items()}
        _, cache, _ = forward(pp, pc, prompt,
                              cache=init_cache(pc, 2, 16, device="cpu"),
                              attn_impl="cuda")
        step = {k: v[:, S:S + 1] for k, v in tb.items()}
        dec, _, _ = forward(pp, pc, step, cache=cache, mode="decode")
        full, _, _ = forward(pp, pc, tb,
                             cache=init_cache(pc, 2, 16, device="cpu"),
                             attn_impl="cuda", logits_slice="last")
    _close(dec, full, TOL)


def test_bf16_variant():
    jc, pc, jp, pp, _ = _setup(dtype="bfloat16")
    assert pp.embed.dtype == torch.bfloat16
    _prefill_decode(jc, pc, jp, pp, steps=2, tol=5e-2, rel=True)


@pytest.mark.parametrize("flag", [{"attn_bias": True},
                                  {"parallel_block": True},
                                  {"mlp_act": "gelu"}],
                         ids=lambda f: next(iter(f)))
def test_cheap_flags(flag):
    jc, pc, jp, pp, _ = _setup(rand_bias=True, **flag)
    _prefill_decode(jc, pc, jp, pp, steps=1, jimpl="xla", impl="ref")


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "command-r-35b",
                                  "minicpm-2b"])
def test_other_dense_archs(arch):
    """M-RoPE, biases, an untied head and the frontend stub (qwen2-vl),
    the parallel block (command-r), MHA (minicpm-2b)."""
    jc, pc, jp, pp, _ = _setup(arch, rand_bias=True)
    _prefill_decode(jc, pc, jp, pp, steps=1, jimpl="xla", impl="cuda")


def test_decode_clamps_the_write_at_max_len():
    """Decode at ``len = max_len - 1`` writes the last slot; at ``len =
    max_len`` the reference's ``dynamic_update_slice`` clamps the write to
    the last slot and ``len`` still advances: the port does the same."""
    jc, pc, jp, pp, _ = _setup()
    B, S = 2, 6
    jb, tb = _batch(jc, B, S)
    with torch.no_grad():
        _, jcache, _ = jax_forward(jp, jc, jb,
                                   cache=jax_init_cache(jc, B, S + 1),
                                   mode="prefill", attn_impl="xla")
        _, pcache, _ = forward(pp, pc, tb,
                               cache=init_cache(pc, B, S + 1, device="cpu"))
        for g in range(2):          # len = max_len - 1, then max_len
            tokens = np.full((B, 1), 3 + g, np.int32)
            pos = np.full((B, 1), S + g, np.int32)
            want, jcache, _ = jax_forward(
                jp, jc, {"tokens": jnp.asarray(tokens),
                         "positions": jnp.asarray(pos)},
                cache=jcache, mode="decode")
            got, pcache, _ = forward(
                pp, pc, {"tokens": torch.from_numpy(tokens),
                         "positions": torch.from_numpy(pos)},
                cache=pcache, mode="decode")
            _close(got, want, TOL)
            for i in range(pc.num_layers):
                _close(pcache[i]["v"], jcache["pos0"]["v"][i], 1e-5)
                np.testing.assert_array_equal(
                    pcache[i]["len"].numpy(), np.asarray(jcache["pos0"]["len"][i]))
        assert int(pcache[0]["len"][0]) == S + 2


def test_train_mode_and_chunked_raise():
    """Since the training slice ``mode="train"`` and ``attn_impl=
    "chunked"`` run (equal to the cache-free plain forward); what still
    raises is a cache in train mode and an unknown impl."""
    _, pc, _, pp, _ = _setup()
    _, tb = _batch(pc, 1, 4)
    with torch.no_grad():
        want, _, _ = forward(pp, pc, tb)
        got, _, _ = forward(pp, pc, tb, mode="train", remat="none")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got, _, _ = forward(pp, pc, tb, attn_impl="chunked")
        _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="without a cache"):
        forward(pp, pc, tb, mode="train",
                cache=init_cache(pc, 1, 5, device="cpu"))
    with pytest.raises(ValueError):
        forward(pp, pc, tb, attn_impl="pallas")
