"""The port's new model modules, one by one, against the JAX package's on
the same inputs (numpy from a seed) and the same weights (the reference's
``init_*`` draws, carried across): ``models.moe.moe_layer`` (the kept
(token, k) pairs and ``drop_frac`` exactly equal, ``load_balance_loss``
within 1e-6 relative, outputs within 1e-5 in f32 and 2% of max |out| in
bf16), ``layers.mla`` with and without a cache, ``models.mamba.mamba`` and
``models.rwkv.rwkv_block`` (a chunked prefill equal to step-by-step
decode, and both equal to the reference's), and the codebook tables.

Setup: each family's ``configs.smoke.reduced`` sibling (f32), small
chunks so that every chunked path runs several chunks and a padded
tail."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs.smoke import reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import init_cache, params_from_jax  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_reduced(jax_get(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _params(jp, dtype=None):
    """A reference param dict as the port's :class:`Params` (nested dicts
    nested), optionally cast."""
    out = {}
    for k, v in jp.items():
        if isinstance(v, dict):
            out[k] = _params(v, dtype)
        else:
            t = torch.from_numpy(np.array(v, np.float32))
            out[k] = t.to(dtype or t.dtype)
    return L.Params(**out)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol=TOL, rel=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0) if rel else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _x(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- MoE -----------------------------------------------------------------------

def _jax_kept(p, cfg, xt, C):
    """The reference's kept (token, k) pairs of one chunk, by the lines of
    its ``_route_chunk`` (``moe.py:64-74``): top-k of the f32 softmax,
    positions by a cumsum over the flattened token-major pairs."""
    E_pad = JMoE._padded_experts(cfg)
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    onehot = jax.nn.one_hot(idx, E_pad, dtype=jnp.int32)
    flat = onehot.reshape(-1, E_pad)
    pos = ((jnp.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(idx.shape)
    return np.asarray(idx), np.asarray(pos < C)


MOE_CASES = {
    # name: (arch, overrides, B, S, token_chunk, exact)
    "overflow": ("qwen2-moe-a2.7b", dict(capacity_factor=0.5), 2, 24, 4096,
                 False),
    "chunks_with_pad": ("qwen2-moe-a2.7b", {}, 3, 7, 8, False),
    "expert_pad": ("grok-1-314b", dict(expert_pad_multiple=3,
                                       capacity_factor=0.75), 2, 16, 4096,
                   False),
    "exact_decode": ("qwen2-moe-a2.7b", {}, 5, 1, 4096, True),
    "jamba_top2": ("jamba-1.5-large-398b", {}, 2, 20, 16, False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_layer_matches_reference(case):
    arch, over, B, S, chunk, exact = MOE_CASES[case]
    jc, pc = _cfgs(arch, **over)
    jp = JMoE.init_moe(jax.random.PRNGKey(3), jc, jnp.float32)
    pp = _params(jp)
    x = _x(np.random.default_rng(7), B, S, jc.d_model)
    want, jaux = JMoE.moe_layer(jp, jc, jnp.asarray(x), exact=exact,
                                token_chunk=chunk)
    with torch.no_grad():
        got, paux = MoE.moe_layer(pp, pc, torch.from_numpy(x), exact=exact,
                                  token_chunk=chunk)
    _close(got, want)
    assert float(paux["drop_frac"]) == float(jaux["drop_frac"])
    np.testing.assert_allclose(float(paux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-6)
    # the kept pairs, chunk by chunk (the last padded with zero rows)
    T = B * S
    Tc = min(chunk, T)
    n = -(-T // Tc)
    E, K = jc.num_experts, jc.num_experts_per_tok
    C = Tc if exact else min(Tc, max(1, int(Tc * K * jc.capacity_factor / E
                                            + 0.999)))
    xp = np.pad(x.reshape(T, -1), ((0, n * Tc - T), (0, 0)))
    dropped = 0
    for c in range(n):
        xc = xp[c * Tc:(c + 1) * Tc]
        jidx, jkeep = _jax_kept(jp, jc, jnp.asarray(xc), C)
        _, pidx, _, pkeep, _ = MoE.route(pp, pc, torch.from_numpy(xc), C)
        np.testing.assert_array_equal(pidx.numpy(), jidx)
        np.testing.assert_array_equal(pkeep.numpy(), jkeep)
        dropped += int((~pkeep).sum())
    if case in ("overflow", "expert_pad"):
        assert dropped > 0                     # the case does drop
    if case == "chunks_with_pad":
        assert n == 3 and n * Tc > T           # several chunks, a pad tail
    if exact:
        assert dropped == 0 and float(paux["drop_frac"]) == 0.0


def test_moe_layer_bf16():
    """bf16 weights and inputs: within 2% of max |out| of the reference's,
    drop fraction equal."""
    jc, pc = _cfgs("qwen2-moe-a2.7b", dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      JMoE.init_moe(jax.random.PRNGKey(4), jc, jnp.float32))
    pp = _params(jp, torch.bfloat16)
    x = _x(np.random.default_rng(8), 2, 16, jc.d_model)
    want, jaux = JMoE.moe_layer(jp, jc, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, paux = MoE.moe_layer(pp, pc,
                                  torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2, rel=True)
    assert float(paux["drop_frac"]) == float(jaux["drop_frac"])


def test_moe_ties_go_to_the_lower_expert():
    """A zero row gives every expert the same probability: top-k takes
    experts 0..K-1, as ``lax.top_k`` does."""
    jc, pc = _cfgs("qwen2-moe-a2.7b")
    pp = _params(JMoE.init_moe(jax.random.PRNGKey(5), jc, jnp.float32))
    _, idx, _, keep, _ = MoE.route(pp, pc, torch.zeros((3, jc.d_model)), 8)
    K = jc.num_experts_per_tok
    assert idx.tolist() == [list(range(K))] * 3 and bool(keep.all())


# -- MLA -----------------------------------------------------------------------

def test_mla_matches_reference_with_and_without_cache():
    """Cache-free, then a prefill into a cache and two decode steps: the
    outputs, the latent cache and ``len``; no B8 launch (dn + dr != dv)."""
    from repro.models import init_cache as jax_init_cache
    from repro_torch.kernels.flash_attn import ops

    jc, pc = _cfgs("minicpm3-4b")
    assert pc.qk_nope_head_dim + pc.qk_rope_head_dim != pc.v_head_dim
    jp = JL.init_mla(jax.random.PRNGKey(6), jc, jnp.float32)
    pp = _params(jp)
    rng = np.random.default_rng(9)
    B, S = 2, 9
    x = _x(rng, B, S, jc.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    calls = ops.plain_calls
    with torch.no_grad():
        want, _ = JL.mla(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                         attn_impl="pallas")
        got, none = L.mla(pp, pc, torch.from_numpy(x),
                          torch.from_numpy(pos), attn_impl="cuda")
        assert none is None
        _close(got, want)
        jcache = jax.tree.map(lambda a: a[0],
                              jax_init_cache(jc, B, S + 3)["pos0"])
        pcache = init_cache(pc, B, S + 3, device="cpu")[0]
        assert sorted(pcache) == sorted(jcache) == ["ckv", "k_rope", "len"]
        want, jcache = JL.mla(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                              jcache, attn_impl="pallas")
        got, pcache = L.mla(pp, pc, torch.from_numpy(x),
                            torch.from_numpy(pos), pcache, attn_impl="cuda")
        _close(got, want)
        for g in range(2):
            x1 = _x(rng, B, 1, jc.d_model)
            p1 = np.full((B, 1), S + g, np.int32)
            want, jcache = JL.mla(jp, jc, jnp.asarray(x1), jnp.asarray(p1),
                                  jcache)
            got, pcache = L.mla(pp, pc, torch.from_numpy(x1),
                                torch.from_numpy(p1), pcache)
            _close(got, want)
        for key in ("ckv", "k_rope"):
            _close(pcache[key], jcache[key])
        np.testing.assert_array_equal(pcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
    assert ops.plain_calls == calls      # MLA here never reaches B8


def test_mla_reaches_b8_when_heads_agree():
    """With ``dn + dr == dv`` the cache-free prefill goes through B8's
    wrapper (its plain version on the CPU) and still equals the
    reference's Pallas kernel; the prefill with a cache stays plain."""
    from repro_torch.kernels.flash_attn import ops

    jc, pc = _cfgs("minicpm3-4b", qk_nope_head_dim=8, qk_rope_head_dim=8,
                   v_head_dim=16)
    jp = JL.init_mla(jax.random.PRNGKey(7), jc, jnp.float32)
    pp = _params(jp)
    x = _x(np.random.default_rng(10), 2, 6, jc.d_model)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    calls = ops.plain_calls
    with torch.no_grad():
        want, _ = JL.mla(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                         attn_impl="pallas")
        got, _ = L.mla(pp, pc, torch.from_numpy(x), torch.from_numpy(pos),
                       attn_impl="cuda")
        assert ops.plain_calls == calls + 1
        _close(got, want)
        L.mla(pp, pc, torch.from_numpy(x), torch.from_numpy(pos),
              init_cache(pc, 2, 8, device="cpu")[0], attn_impl="cuda")
    assert ops.plain_calls == calls + 1


# -- Mamba ---------------------------------------------------------------------

def _mamba_setup(seed):
    jc, pc = _cfgs("jamba-1.5-large-398b")
    jp = JM.init_mamba(jax.random.PRNGKey(seed), jc, jnp.float32)
    # a larger step size so that the state decays visibly over a chunk
    jp = dict(jp, dt_proj_b=jnp.full_like(jp["dt_proj_b"], -1.0))
    return jc, pc, jp, _params(jp)


@pytest.mark.parametrize("chunk", [4, 256])
def test_mamba_prefill_matches_reference(chunk):
    """Cache-free and with a cache (the final ``conv``/``ssm`` state),
    ``S`` = 10 over chunks of 4 (three, the last padded) and 256."""
    jc, pc, jp, pp = _mamba_setup(11)
    x = _x(np.random.default_rng(12), 2, 10, jc.d_model)
    with torch.no_grad():
        want, _ = JM.mamba(jp, jc, jnp.asarray(x), chunk=chunk)
        got, none = M.mamba(pp, pc, torch.from_numpy(x), chunk=chunk)
        assert none is None
        _close(got, want)
        jcache = JM.init_mamba_cache(jc, 2, jnp.float32)
        want, jcache = JM.mamba(jp, jc, jnp.asarray(x), jcache, chunk=chunk)
        got, pcache = M.mamba(pp, pc, torch.from_numpy(x),
                              M.init_mamba_cache(pc, 2, torch.float32),
                              chunk=chunk)
        _close(got, want)
        for key in ("conv", "ssm"):
            _close(pcache[key], jcache[key])


def test_mamba_chunked_prefill_equals_step_by_step_decode():
    """The chunked scan equals the recurrent decode run token by token,
    both in the port and against the reference's decode."""
    jc, pc, jp, pp = _mamba_setup(13)
    B, S = 2, 9
    x = _x(np.random.default_rng(14), B, S, jc.d_model)
    with torch.no_grad():
        full, fcache = M.mamba(pp, pc, torch.from_numpy(x),
                               M.init_mamba_cache(pc, B, torch.float32),
                               chunk=4)
        pcache = M.init_mamba_cache(pc, B, torch.float32)
        jcache = JM.init_mamba_cache(jc, B, jnp.float32)
        steps = []
        for t in range(S):
            xt = x[:, t:t + 1]
            out, pcache = M.mamba(pp, pc, torch.from_numpy(xt), pcache)
            want, jcache = JM.mamba(jp, jc, jnp.asarray(xt), jcache)
            _close(out, want)
            steps.append(out)
    _close(torch.cat(steps, 1), full)
    for key in ("conv", "ssm"):
        _close(pcache[key], fcache[key])


# -- RWKV6 ---------------------------------------------------------------------

def _rwkv_setup(seed, rng):
    jc, pc = _cfgs("rwkv6-7b")
    jp = JR.init_rwkv_block(jax.random.PRNGKey(seed), jc, jnp.float32)
    # the reference initialises the mixers and the bonus at zero and the
    # decay at one value: random ones exercise every term
    for name in ("maa_x", "maa_rkvwg", "cm_maa_k", "cm_maa_r", "bonus"):
        jp[name] = jnp.asarray(_x(rng, *jp[name].shape, scale=0.5))
    jp["decay"] = jnp.asarray(_x(rng, *jp["decay"].shape) - 1.0)
    return jc, pc, jp, _params(jp)


@pytest.mark.parametrize("chunk", [4, 64])
def test_rwkv_block_prefill_matches_reference(chunk):
    """Cache-free and with a cache (the chunked state and both shifts),
    ``S`` = 10 over chunks of 4 (the last padded) and 64."""
    rng = np.random.default_rng(15)
    jc, pc, jp, pp = _rwkv_setup(16, rng)
    x = _x(rng, 2, 10, jc.d_model)
    with torch.no_grad():
        want, _ = JR.rwkv_block(jp, jc, jnp.asarray(x), chunk=chunk)
        got, none = R.rwkv_block(pp, pc, torch.from_numpy(x), chunk=chunk)
        assert none is None
        _close(got, want)
        jcache = JR.init_rwkv_cache(jc, 2, jnp.float32)
        want, jcache = JR.rwkv_block(jp, jc, jnp.asarray(x), jcache,
                                     chunk=chunk)
        got, pcache = R.rwkv_block(pp, pc, torch.from_numpy(x),
                                   R.init_rwkv_cache(pc, 2, torch.float32),
                                   chunk=chunk)
        _close(got, want)
        for key in ("state", "tm_shift", "cm_shift"):
            _close(pcache[key], jcache[key])


def test_rwkv_chunked_prefill_equals_step_by_step_decode():
    rng = np.random.default_rng(17)
    jc, pc, jp, pp = _rwkv_setup(18, rng)
    B, S = 2, 9
    x = _x(rng, B, S, jc.d_model)
    with torch.no_grad():
        full, fcache = R.rwkv_block(pp, pc, torch.from_numpy(x),
                                    R.init_rwkv_cache(pc, B, torch.float32),
                                    chunk=4)
        pcache = R.init_rwkv_cache(pc, B, torch.float32)
        jcache = JR.init_rwkv_cache(jc, B, jnp.float32)
        steps = []
        for t in range(S):
            xt = x[:, t:t + 1]
            out, pcache = R.rwkv_block(pp, pc, torch.from_numpy(xt), pcache)
            want, jcache = JR.rwkv_block(jp, jc, jnp.asarray(xt), jcache)
            _close(out, want)
            steps.append(out)
    _close(torch.cat(steps, 1), full)
    for key in ("state", "tm_shift", "cm_shift"):
        _close(pcache[key], fcache[key])


# -- parallel codebooks ---------------------------------------------------------

def test_codebook_tables_and_shapes():
    """musicgen: ``embed`` (C, V, d) summed over the codebooks, ``head``
    (C, d, V), logits (B, C, S, V), equal to the reference's."""
    from repro.models.model import _embed as jax_embed
    from repro.models.model import _head as jax_head
    from repro_torch.models.model import _embed, _head

    jc, pc = _cfgs("musicgen-medium")
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1), jc))
    pp = params_from_jax(tree, pc, device="cpu")
    C, V, d = pc.codebooks, pc.vocab_size, pc.d_model
    assert pp.embed.shape == (C, V, d) and pp.head.shape == (C, d, V)
    rng = np.random.default_rng(19)
    toks = rng.integers(0, V, (2, C, 5)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        want = jax_embed(jp, jc, {"tokens": jnp.asarray(toks)},
                         lambda t, k: t)
        got = _embed(pp, pc, {"tokens": torch.from_numpy(toks)},
                     L._identity)
        _close(got, want)
        h = _x(rng, 2, 5, d)
        want = jax_head(jp, jc, jnp.asarray(h), lambda t, k: t)
        got = _head(pp, pc, torch.from_numpy(h), L._identity)
    assert tuple(got.shape) == (2, C, 5, V)
    _close(got, want)
