"""Every LM family the port newly serves, whole, against the JAX package's
model on the same weights (the reference's ``init_params`` tree carried
across by ``params_from_jax``) and the same batch (``make_batch``, numpy
from a seed): MoE (qwen2-moe, grok), the Mamba/MoE hybrid (jamba), MLA
(minicpm3), RWKV6 and musicgen's parallel codebooks, each at its
``configs.smoke.reduced`` sibling (f32).

Per family: the caches' layout; the prefill's logits within 1e-4 of max
|logit| of the reference's (the f32 bound the dense families hold), its
caches and MoE statistics; three decode steps, logits and caches, ``len``;
the cache-free forward; decode against teacher forcing (drop-free MoE
capacity, as the reference's own test sets it).  The port's prefill runs
``attn_impl="cuda"``: B8's wrapper, whose plain version runs on CPU
tensors, is counted at every attention position the reference sends to
its kernel, and at none under MLA.  The reference runs jitted with its
plain attention (``"xla"``)."""

import dataclasses
import functools

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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.models import forward, init_cache  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

TOL = 1e-4
ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b", "jamba-1.5-large-398b",
         "minicpm3-4b", "rwkv6-7b", "musicgen-medium"]
B, S, STEPS = 2, 12, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _attn_layers(cfg):
    """Layers whose prefill the reference sends to its flash kernel: the
    GQA attention positions (MLA here never: dn + dr != dv)."""
    if cfg.attention == "mla":
        return 0
    return cfg.num_periods * sum(k == "attn" for k in cfg.mixer_kinds)


@functools.lru_cache(maxsize=None)
def _setup(arch, **over):
    jc = dataclasses.replace(jax_reduced(jax_get(arch)), **over)
    pc = dataclasses.replace(reduced(get_config(arch)), **over)
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jc))
    pp = params_from_jax(tree, pc, device="cpu")
    b = make_batch(jc, DataConfig(seed=1), step=0, shard=0, batch=B,
                   seq_len=S)
    b.pop("labels")
    jp = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(lambda p, b, c: jax_forward(
        p, jc, b, cache=c, mode="prefill", attn_impl="xla"))
    decode = jax.jit(lambda p, b, c: jax_forward(
        p, jc, b, cache=c, mode="decode"))
    return jc, pc, jp, pp, b, prefill, decode


def _layer_cache(jcache, cfg, i):
    """Layer ``i``'s cache in the reference's stacked layout."""
    period, pos = divmod(i, len(cfg.layer_pattern))
    return {k: v[period] for k, v in jcache[f"pos{pos}"].items()}


def _step_batch(cfg, tok, g):
    pos = np.full((B, 1), S + g, np.int32)
    return {"tokens": tok, "positions": pos}


def _greedy(logits, cfg):
    last = np.asarray(logits)[..., -1, :]
    return last.argmax(-1).astype(np.int32)[..., None]


@functools.lru_cache(maxsize=None)
def _run(arch):
    """Prefill and three decode steps through both packages (each step
    feeding the reference's greedy token to both)."""
    jc, pc, jp, pp, b, jpre, jdec = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    max_len = S + STEPS + 1
    calls = ops.plain_calls
    with torch.no_grad():
        want, jcache, jaux = jpre(jp, jb, jax_init_cache(jc, B, max_len))
        got, pcache, paux = forward(pp, pc, tb, cache=init_cache(
            pc, B, max_len, device="cpu"), mode="prefill", attn_impl="cuda")
        launched = ops.plain_calls - calls
        steps = [(want, got, jax.tree.map(np.asarray, jcache),
                  [{k: v.clone() for k, v in c.items()} for c in pcache],
                  jaux, paux)]
        tok = _greedy(want, jc)
        for g in range(STEPS):
            sb = _step_batch(jc, tok, g)
            want, jcache, jaux = jdec(
                jp, {k: jnp.asarray(v) for k, v in sb.items()}, jcache)
            got, pcache, paux = forward(
                pp, pc, {k: torch.from_numpy(v) for k, v in sb.items()},
                cache=pcache, mode="decode")
            steps.append((want, got, jax.tree.map(np.asarray, jcache),
                          [{k: v.clone() for k, v in c.items()}
                           for c in pcache], jaux, paux))
            tok = _greedy(want, jc)
    return steps, launched


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    """Each layer's cache holds its mixer's tensors at the reference's
    shapes and types."""
    jc, pc = _setup(arch)[:2]
    jcache = jax_init_cache(jc, B, 9)
    pcache = init_cache(pc, B, 9, device="cpu")
    assert len(pcache) == pc.num_layers
    for i, c in enumerate(pcache):
        want = _layer_cache(jcache, jc, i)
        assert sorted(c) == sorted(want)
        for k, t in c.items():
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).split(".")[1] == str(want[k].dtype)
            assert not bool(t.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Logits, every layer's cache and the MoE statistics after a prefill
    through ``attn_impl="cuda"``; B8's wrapper at every attention
    position the reference routes to its kernel."""
    jc, pc = _setup(arch)[:2]
    steps, launched = _run(arch)
    want, got, jcache, pcache, jaux, paux = steps[0]
    shape = (B, pc.codebooks, S, pc.vocab_size) if pc.codebooks \
        else (B, S, pc.vocab_size)
    assert tuple(got.shape) == shape
    _close(got, want)
    for i, c in enumerate(pcache):
        for k, t in c.items():
            _close(t, _layer_cache(jcache, jc, i)[k])
    for k in ("drop_frac", "load_balance_loss"):
        np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-7)
    if pc.num_experts:
        assert float(paux["load_balance_loss"]) > 0
    assert launched == _attn_layers(pc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """Three decode steps: logits, caches (attention ``len`` advancing by
    one a step), MoE statistics (exact capacity: nothing dropped)."""
    jc, pc = _setup(arch)[:2]
    steps, _ = _run(arch)
    for g, (want, got, jcache, pcache, jaux, paux) in enumerate(steps[1:]):
        _close(got, want)
        for i, c in enumerate(pcache):
            jc_i = _layer_cache(jcache, jc, i)
            for k, t in c.items():
                _close(t, jc_i[k])
            if "len" in c:
                assert c["len"].tolist() == [S + g + 1] * B
        assert float(paux["drop_frac"]) == float(jaux["drop_frac"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_free_forward_matches_reference(arch):
    """Without a cache: the whole (B, S, V) logits against the reference's
    forward without one, and the last position under ``logits_slice``."""
    jc, pc, jp, pp, b = _setup(arch)[:5]
    want, _, jaux = jax.jit(lambda p, bb: jax_forward(
        p, jc, bb, mode="train", remat="none"))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        got, cache, aux = forward(pp, pc, tb, attn_impl="cuda")
        last, _, _ = forward(pp, pc, tb, attn_impl="ref",
                             logits_slice="last")
    assert cache is None
    _close(got, want)
    _close(last, np.asarray(want)[..., -1:, :])
    np.testing.assert_allclose(float(aux["drop_frac"]),
                               float(jaux["drop_frac"]), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Prefill of S - 1 tokens, then decode of token S, against the
    cache-free forward of all S tokens in the port and in the reference
    (MoE at a drop-free capacity factor, as the reference's own
    teacher-forcing test runs it)."""
    over = {"capacity_factor": 16.0} if "moe" in jax_reduced(
        jax_get(arch)).mlp_kinds else {}
    jc, pc, jp, pp, b = _setup(arch, **over)[:5]
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def part(d, lo, hi):
        return {k: v[..., lo:hi] for k, v in d.items()}

    with torch.no_grad():
        full, _, _ = forward(pp, pc, tb, attn_impl="cuda")
        _, cache, _ = forward(pp, pc, part(tb, 0, S - 1), cache=init_cache(
            pc, B, S + 2, device="cpu"), attn_impl="cuda")
        dec, cache, aux = forward(pp, pc, part(tb, S - 1, S), cache=cache,
                                  mode="decode")
    ref, _, _ = jax.jit(lambda p, bb: jax_forward(
        p, jc, bb, mode="train", remat="none"))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    _close(dec, full[..., -1:, :])
    _close(dec, np.asarray(ref)[..., -1:, :])
    assert float(aux["drop_frac"]) == 0.0


def test_forward_runs_the_callers_config():
    """``forward(params, cfg, ...)`` runs ``cfg`` as the reference does,
    not the config the weights were built with: a drop-free capacity
    factor on weights drawn at the published one drops nothing and
    equals the reference's forward under that config."""
    jc, pc, jp, pp, b = _setup("qwen2-moe-a2.7b")[:5]
    jc16, pc16 = (dataclasses.replace(c, capacity_factor=16.0)
                  for c in (jc, pc))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        _, _, aux = forward(pp, pc, tb)
        got, _, aux16 = forward(pp, pc16, tb)
    want, _, jaux16 = jax.jit(lambda p, bb: jax_forward(
        p, jc16, bb, mode="train", remat="none"))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    assert float(aux["drop_frac"]) > 0.0
    assert float(aux16["drop_frac"]) == 0.0
    # the reference's jitted mean rounds 1 - 1 to within an ulp of 0
    assert abs(float(jaux16["drop_frac"])) <= 1e-7
    _close(got, want)
