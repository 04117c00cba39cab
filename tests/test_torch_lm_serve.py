"""The port's LM serving path (``repro_torch.serve``, ``repro_torch.launch.
serve``) against the JAX package's: greedy tokens identical to the
reference's ``make_prefill_step``/``make_decode_step`` given the same
weights (f32 reduced); sampled tokens equal to the reference's under the
same split keys, off near-ties (top two perturbed logits within 1e-5);
the launcher on the CPU printing the reference launcher's generations for
the same ``--seed``; and the card as the default device."""

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
from repro_torch.core.engine import run_traces  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import (make_decode_step,  # noqa: E402
                               make_prefill_step, make_trace_runner,
                               sample_token)


def _greedy(arch, impl, B=3, S=10, G=5):
    jc, pc = jax_reduced(jax_get(arch)), reduced(get_config(arch))
    jp = jax_init(jax.random.PRNGKey(0), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    b = make_batch(jc, DataConfig(seed=1), step=0, shard=0, batch=B,
                   seq_len=S)
    max_len = S + G + 1

    jpre = jax.jit(jax_prefill_step(jc, max_len=max_len))
    jdec = jax.jit(jax_decode_step(jc))
    logits, cache = jpre(jp, {k: jnp.asarray(b[k])
                              for k in ("tokens", "positions")})
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)[:, 0]]
    key = jax.random.PRNGKey(0)
    for g in range(G):
        key, sub = jax.random.split(key)
        tok, _, cache = jdec(jp, cache, tok,
                             jnp.full((B, 1), S + g, jnp.int32), sub)
        want.append(np.asarray(tok)[:, 0])

    pre = make_prefill_step(pc, max_len=max_len, attn_impl=impl)
    dec = make_decode_step(pc)
    calls = ops.plain_calls
    logits, pcache = pre(pp, {k: torch.from_numpy(b[k])
                              for k in ("tokens", "positions")})
    assert ops.plain_calls - calls == (pc.num_layers if impl == "cuda"
                                       else 0)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    got = [tok[:, 0].numpy()]
    for g in range(G):
        tok, _, pcache = dec(pp, pcache, tok,
                             torch.full((B, 1), S + g, dtype=torch.int32))
        got.append(tok[:, 0].numpy())
    assert ops.plain_calls - calls == (pc.num_layers if impl == "cuda"
                                       else 0)      # decode: no B8
    assert [int(c["len"][0]) for c in pcache] == [S + G] * pc.num_layers
    return np.stack(got, 1), np.stack(want, 1)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_greedy_tokens_identical_to_jax(impl):
    got, want = _greedy("smollm-360m", impl)
    np.testing.assert_array_equal(got, want)


def test_greedy_tokens_identical_to_jax_gqa_bias_mrope():
    got, want = _greedy("qwen2-vl-7b", "cuda", G=3)
    np.testing.assert_array_equal(got, want)


def test_sample_token_greedy_and_seeded():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 3, 50)).astype("f4"))
    greedy = sample_token(logits)
    assert greedy.dtype == torch.int32
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))
    a = sample_token(logits, prng.PRNGKey(5), 0.8)
    b = sample_token(logits, prng.PRNGKey(5), 0.8)
    assert a.shape == (4, 3) and a.dtype == torch.int32
    assert torch.equal(a, b)
    draws = torch.stack([sample_token(logits, prng.PRNGKey(s), 1.0)
                         for s in range(20)])
    assert len(torch.unique(draws)) > 1       # it does sample
    want = jax.random.categorical(
        jax.random.PRNGKey(5), jnp.asarray(logits.numpy()) / 0.8, axis=-1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


def test_sample_token_never_draws_probability_zero():
    logits = torch.full((64, 10), float("-inf"))
    logits[:, 3] = 0.0
    logits[:, 7] = 1.0
    key = prng.PRNGKey(0)
    for temp in (0.5, 1.0, 4.0):
        key, sub = prng.split(key)
        tok = sample_token(logits, sub, temp)
        assert set(tok.tolist()) <= {3, 7}


def test_decode_step_samples_with_its_generator():
    """The same key draws the same token; the step samples with it."""
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(prng.PRNGKey(0), cfg, device="cpu")
    b = make_batch(cfg, DataConfig(), step=0, shard=0, batch=2, seq_len=6)
    batch = {k: torch.from_numpy(b[k]) for k in ("tokens", "positions")}
    outs = []
    for _ in range(2):
        _, cache = make_prefill_step(cfg, max_len=8)(params, batch)
        dec = make_decode_step(cfg, temperature=1.0)
        tok, logits, cache = dec(params, cache, batch["tokens"][:, -1:],
                                 torch.full((2, 1), 6, dtype=torch.int32),
                                 prng.PRNGKey(3))
        assert logits.shape == (2, 1, cfg.vocab_size)
        outs.append(tok)
    assert torch.equal(outs[0], outs[1])
    want = sample_token(logits[:, -1], prng.PRNGKey(3), 1.0)
    assert torch.equal(outs[0][:, 0], want)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-vl-7b"])
def test_sampled_tokens_equal_the_reference(arch):
    """8 decode steps at temperature 0.8 from the reference's weights and
    the reference launcher's keys (``key, sub = split(key)`` a step): each
    step's sampled tokens equal the reference's ``decode_step``'s, except
    where its top two perturbed logits lie within 1e-5.  Both sides take
    the reference's token as the next input, so a near-tie cannot
    cascade."""
    B, S, G, T = 4, 10, 8, 0.8
    jc, pc = jax_reduced(jax_get(arch)), reduced(get_config(arch))
    jp = jax_init(jax.random.PRNGKey(2), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pc, device="cpu")
    b = make_batch(jc, DataConfig(seed=2), step=0, shard=0, batch=B,
                   seq_len=S)
    max_len = S + G + 1
    jlogits, jcache = jax.jit(jax_prefill_step(jc, max_len=max_len))(
        jp, {k: jnp.asarray(b[k]) for k in ("tokens", "positions")})
    _, pcache = make_prefill_step(pc, max_len=max_len)(
        pp, {k: torch.from_numpy(b[k]) for k in ("tokens", "positions")})
    jdec = jax.jit(jax_decode_step(jc, temperature=T))
    pdec = make_decode_step(pc, temperature=T)
    tok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    jkey, pkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    compared = 0
    for g in range(G):
        jkey, jsub = jax.random.split(jkey)
        pkey, psub = prng.split(pkey)
        pos = np.full((B, 1), S + g, np.int32)
        want, jl, jcache = jdec(jp, jcache, tok, jnp.asarray(pos), jsub)
        got, _, pcache = pdec(pp, pcache, torch.from_numpy(np.asarray(tok)),
                              torch.from_numpy(pos), psub)
        pert = np.asarray(jax.random.gumbel(jsub, (B, pc.vocab_size))) \
            + np.asarray(jl[:, -1], np.float32) / T
        top2 = np.sort(pert, -1)[:, -2:]
        far = (top2[:, 1] - top2[:, 0]) >= 1e-5
        np.testing.assert_array_equal(got[:, 0].numpy()[far],
                                      np.asarray(want)[:, 0][far])
        compared += int(far.sum())
        tok = want
    assert compared >= B * G - 2


def _reference_launcher(monkeypatch):
    """The reference's ``launch.serve`` with its mesh set-up replaced by a
    single device: under the installed jax its ``make_plan`` constrains on
    an Explicit-axes mesh, which ``with_sharding_constraint`` refuses.  The
    body of its ``serve_lm`` (seeding, prefill, the split-key decode loop,
    the printout) runs as written."""
    import contextlib
    import types

    import repro.launch.serve as ref_serve
    monkeypatch.setattr(ref_serve, "build_mesh_for_available",
                        contextlib.nullcontext)
    monkeypatch.setattr(ref_serve, "make_plan", lambda mesh: types.
                        SimpleNamespace(constrain=lambda t, kind: t))
    return ref_serve.main


def test_launcher_matches_the_reference_launcher(monkeypatch):
    args = ["--arch", "smollm-360m", "--smoke", "--temperature", "0.8",
            "--seed", "3", "--batch", "4", "--prompt-len", "16", "--gen",
            "12"]
    ref_main = _reference_launcher(monkeypatch)
    outs = []
    for run, extra in ((ref_main, []), (main, ["--device", "cpu"])):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            outs.append((np.asarray(run(args + extra)),
                         text.getvalue().split("sample generations")[1]))
    (want, want_text), (got, got_text) = outs
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got, want)
    assert got_text == want_text             # the same printed generations


def test_launcher_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    assert gen.shape == (2, 4)
    text = out.getvalue()
    assert "[serve] prefill 2x12" in text and "[serve] decode 4 steps" in text
    with contextlib.redirect_stdout(io.StringIO()):
        again = main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "4"])
        sampled = main(["--arch", "smollm-360m", "--smoke", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "12",
                        "--gen", "4", "--temperature", "0.7"])
    np.testing.assert_array_equal(gen, again)       # seeded weights
    assert sampled.shape == (2, 4)


def test_launcher_refusals():
    with pytest.raises(SystemExit, match="unknown --inject term"):
        main(["--snp", "--device", "cpu", "--inject", "bogus=1"])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            main(["--smoke", "--device", "cpu"])


def test_trace_runner():
    assert make_trace_runner() is run_traces
    from repro_torch.core.distributed import run_traces_distributed
    mesh = ["cpu"] * 2
    runner = make_trace_runner(mesh=mesh)
    assert runner.func is run_traces_distributed
    assert runner.keywords == {"mesh": mesh}


def test_device_none_is_the_card():
    """Without a card, every entry point's default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    cfg = reduced(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(prng.PRNGKey(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 4)
    jc = jax_reduced(jax_get("smollm-360m"))
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jc))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "smollm-360m", "--smoke"])
