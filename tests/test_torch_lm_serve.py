"""The port's LM serving path (``repro_torch.serve``, ``repro_torch.launch.
serve``) against the JAX package's: greedy tokens identical to the
reference's ``make_prefill_step``/``make_decode_step`` given the same
weights (f32 reduced), sampling, the launcher on the CPU, and the card as
the default device."""

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
    a = sample_token(logits, torch.Generator().manual_seed(5), 0.8)
    b = sample_token(logits, torch.Generator().manual_seed(5), 0.8)
    assert a.shape == (4, 3) and a.dtype == torch.int32
    assert torch.equal(a, b)
    draws = torch.stack([sample_token(logits, torch.Generator()
                                      .manual_seed(s), 1.0)
                         for s in range(20)])
    assert len(torch.unique(draws)) > 1       # it does sample


def test_sample_token_never_draws_probability_zero():
    logits = torch.full((64, 10), float("-inf"))
    logits[:, 3] = 0.0
    logits[:, 7] = 1.0
    gen = torch.Generator().manual_seed(0)
    for temp in (0.5, 1.0, 4.0):
        tok = sample_token(logits, gen, temp)
        assert set(tok.tolist()) <= {3, 7}


def test_decode_step_samples_with_its_generator():
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = make_batch(cfg, DataConfig(), step=0, shard=0, batch=2, seq_len=6)
    batch = {k: torch.from_numpy(b[k]) for k in ("tokens", "positions")}
    outs = []
    for _ in range(2):
        _, cache = make_prefill_step(cfg, max_len=8)(params, batch)
        dec = make_decode_step(cfg, temperature=1.0)
        tok, logits, cache = dec(params, cache, batch["tokens"][:, -1:],
                                 torch.full((2, 1), 6, dtype=torch.int32),
                                 torch.Generator().manual_seed(3))
        assert logits.shape == (2, 1, cfg.vocab_size)
        outs.append(tok)
    assert torch.equal(outs[0], outs[1])


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
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        main(["--snp"])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            main(["--smoke", "--device", "cpu"])


def test_trace_runner():
    assert make_trace_runner() is run_traces
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        make_trace_runner(mesh=object())


def test_device_none_is_the_card():
    """Without a card, every entry point's default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    cfg = reduced(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 4)
    jc = jax_reduced(jax_get("smollm-360m"))
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jc))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "smollm-360m", "--smoke"])
