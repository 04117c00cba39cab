"""Serving every LM family through the port (``repro_torch.serve``,
``repro_torch.launch.serve``) against the JAX package's, at each family's
``configs.smoke.reduced`` sibling (f32) and the reference's weights:
greedy tokens identical to the reference's ``make_prefill_step`` /
``make_decode_step`` for MoE, hybrid, MLA, RWKV6 and codebook models;
musicgen's codebook tokens (B, C, 1) and its sampled tokens equal to the
reference's under the same split keys, off near-ties; the launcher
serving each family on the CPU, and printing the reference launcher's
generations for the same ``--seed``."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs.smoke import reduced as jax_reduced  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.serve import make_decode_step as jax_decode_step  # noqa: E402
from repro.serve import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import make_decode_step, make_prefill_step  # noqa

ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b", "jamba-1.5-large-398b",
         "minicpm3-4b", "rwkv6-7b", "musicgen-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, seed):
    jc, pc = jax_reduced(jax_get(arch)), reduced(get_config(arch))
    jp = jax_init(jax.random.PRNGKey(seed), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    return jc, pc, jp, pp


def _last(logits, cfg):
    return logits[:, :, -1] if cfg.codebooks else logits[:, -1]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_identical_to_jax(arch):
    """Prefill through ``attn_impl="cuda"`` (B8's wrapper once a GQA
    attention layer), then greedy decode: every token equal to the
    reference's, every attention cache's ``len`` at S + G."""
    B, S, G = 3, 10, 4
    jc, pc, jp, pp = _models(arch, 0)
    b = make_batch(jc, DataConfig(seed=1), step=0, shard=0, batch=B,
                   seq_len=S)
    max_len = S + G + 1
    jpre = jax.jit(jax_prefill_step(jc, max_len=max_len))
    jdec = jax.jit(jax_decode_step(jc))
    logits, cache = jpre(jp, {k: jnp.asarray(b[k])
                              for k in ("tokens", "positions")})
    tok = jnp.argmax(_last(logits, jc), -1).astype(jnp.int32)[..., None]
    want = [np.asarray(tok)]
    key = jax.random.PRNGKey(0)
    for g in range(G):
        key, sub = jax.random.split(key)
        tok, _, cache = jdec(jp, cache, tok,
                             jnp.full((B, 1), S + g, jnp.int32), sub)
        want.append(np.asarray(tok))

    calls = ops.plain_calls
    logits, pcache = make_prefill_step(pc, max_len=max_len,
                                       attn_impl="cuda")(
        pp, {k: torch.from_numpy(b[k]) for k in ("tokens", "positions")})
    attn = 0 if pc.attention == "mla" else pc.num_periods * sum(
        k == "attn" for k in pc.mixer_kinds)
    assert ops.plain_calls - calls == attn
    dec = make_decode_step(pc)
    tok = _last(logits, pc).argmax(-1).to(torch.int32)[..., None]
    got = [tok.numpy()]
    for g in range(G):
        tok, _, pcache = dec(pp, pcache, tok,
                             torch.full((B, 1), S + g, dtype=torch.int32))
        got.append(tok.numpy())
    assert ops.plain_calls - calls == attn          # decode: no B8
    assert got[-1].shape == ((B, pc.codebooks, 1) if pc.codebooks
                             else (B, 1))
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    for c in pcache:
        if "len" in c:
            assert c["len"].tolist() == [S + G] * B


def test_codebook_tokens_sampled_as_the_reference_samples():
    """musicgen at temperature 0.8: each step's (B, C, 1) tokens equal the
    reference's under the same split keys, except where a codebook's top
    two perturbed logits lie within 1e-5; both sides take the reference's
    tokens as the next input."""
    B, S, G, T = 3, 8, 6, 0.8
    jc, pc, jp, pp = _models("musicgen-medium", 2)
    C, V = pc.codebooks, pc.vocab_size
    b = make_batch(jc, DataConfig(seed=2), step=0, shard=0, batch=B,
                   seq_len=S)
    max_len = S + G + 1
    jlogits, jcache = jax.jit(jax_prefill_step(jc, max_len=max_len))(
        jp, {k: jnp.asarray(b[k]) for k in ("tokens", "positions")})
    _, pcache = make_prefill_step(pc, max_len=max_len)(
        pp, {k: torch.from_numpy(b[k]) for k in ("tokens", "positions")})
    jdec = jax.jit(jax_decode_step(jc, temperature=T))
    pdec = make_decode_step(pc, temperature=T)
    tok = jnp.argmax(jlogits[:, :, -1], -1).astype(jnp.int32)[..., None]
    jkey, pkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    compared = 0
    for g in range(G):
        jkey, jsub = jax.random.split(jkey)
        pkey, psub = prng.split(pkey)
        pos = np.full((B, 1), S + g, np.int32)
        want, jl, jcache = jdec(jp, jcache, tok, jnp.asarray(pos), jsub)
        got, pl, pcache = pdec(pp, pcache, torch.from_numpy(np.array(tok)),
                               torch.from_numpy(pos), psub)
        assert tuple(got.shape) == (B, C, 1) and got.dtype == torch.int32
        assert tuple(pl.shape) == (B, C, 1, V)
        assert bool(((got >= 0) & (got < V)).all())
        pert = np.asarray(jax.random.gumbel(jsub, (B, C, V))) \
            + np.asarray(jl[:, :, -1], np.float32) / T
        top2 = np.sort(pert, -1)[..., -2:]
        far = (top2[..., 1] - top2[..., 0]) >= 1e-5
        np.testing.assert_array_equal(got[..., 0].numpy()[far],
                                      np.asarray(want)[..., 0][far])
        compared += int(far.sum())
        tok = want
    assert compared >= B * C * G - 2


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_every_family_on_cpu(arch):
    """``--arch <family> --smoke --device cpu``: prefill and decode run,
    the tokens lie in the vocabulary, (B, gen) or (B, C, gen) for
    codebooks, and a second run gives the same tokens."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "4"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = main(args)
    cfg = reduced(get_config(arch))
    assert gen.shape == ((2, cfg.codebooks, 4) if cfg.codebooks else (2, 4))
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    text = out.getvalue()
    assert "[serve] prefill 2x12" in text and "[serve] decode 4 steps" in text
    with contextlib.redirect_stdout(io.StringIO()):
        again = main(args)
    np.testing.assert_array_equal(gen, again)


def _reference_launcher(monkeypatch):
    """The reference's ``launch.serve`` with its mesh set-up replaced by a
    single device (under the installed jax its ``make_plan`` constrains
    on an Explicit-axes mesh, which ``with_sharding_constraint``
    refuses); the body of its ``serve_lm`` runs as written."""
    import types

    import repro.launch.serve as ref_serve
    monkeypatch.setattr(ref_serve, "build_mesh_for_available",
                        contextlib.nullcontext)
    monkeypatch.setattr(ref_serve, "make_plan", lambda mesh: types.
                        SimpleNamespace(constrain=lambda t, kind: t))
    return ref_serve.main


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-moe-a2.7b"])
def test_launcher_matches_the_reference_launcher(monkeypatch, arch):
    """The same ``--seed`` and sampling: the same generated tokens and the
    same printed generations (codebook 0 of each request for musicgen)."""
    args = ["--arch", arch, "--smoke", "--temperature", "0.8", "--seed",
            "3", "--batch", "3", "--prompt-len", "10", "--gen", "6"]
    ref_main = _reference_launcher(monkeypatch)
    outs = []
    for run, extra in ((ref_main, []), (main, ["--device", "cpu"])):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            outs.append((np.asarray(run(args + extra)),
                         text.getvalue().split("sample generations")[1]))
    (want, want_text), (got, got_text) = outs
    cfg = reduced(get_config(arch))
    assert got.shape == ((3, cfg.codebooks, 6) if cfg.codebooks else (3, 6))
    np.testing.assert_array_equal(got, want)
    assert got_text == want_text
