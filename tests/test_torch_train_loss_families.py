"""The training loss of the port against the JAX package's, part two:
the dense archs (smollm, minicpm), the MoE (qwen2-moe, grok), MLA
(minicpm3), RWKV6, M-RoPE with frontend embeddings (qwen2-vl), parallel
codebooks (musicgen) and command-r's parallel block, at their reduced
f32 siblings: the loss, its statistics
and every gradient leaf within 1e-4 of each tensor's largest magnitude
of ``jax.value_and_grad`` of the reference's ``loss_fn``.

And the twin of the reference's ``test_arch_smoke.py::
test_one_train_step_improves_loss`` for all ten archs: on random tokens
the loss and every gradient are finite and one plain gradient step
``p - 0.01·g`` lowers the loss."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from torch_train_support import (check_against_reference,  # noqa: E402,F401
                                 one_thread)

ARCHS = ["smollm-360m", "minicpm-2b", "qwen2-moe-a2.7b", "grok-1-314b",
         "minicpm3-4b", "rwkv6-7b", "qwen2-vl-7b", "musicgen-medium",
         "command-r-35b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_equal_the_reference(arch):
    check_against_reference(arch)


def _random_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.codebooks, S) if cfg.codebooks else (B, S)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                              .astype(np.int32))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, B, S)
    batch = {"tokens": tokens, "positions": pos, "labels": tokens}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
        batch["embed_mask"] = (torch.arange(S)[None, :] < S // 4).expand(B,
                                                                        S)
    return batch


@pytest.mark.parametrize("arch", list_archs())
def test_one_train_step_improves_loss(arch):
    cfg = reduced(get_config(arch))
    params = init_params(prng.PRNGKey(0), cfg, device="cpu")
    batch = _random_batch(cfg, 2, 16, seed=2)
    l0, _ = loss_fn(params, cfg, batch, remat="none")
    l0.backward()
    l0 = float(l0.detach())
    assert np.isfinite(l0)
    with torch.no_grad():
        for p in params.parameters():
            if p.grad is None:      # e.g. command-r's unused ln_mlp
                continue
            assert bool(torch.isfinite(p.grad).all())
            p -= 0.01 * p.grad.to(p.dtype)
        l1, _ = loss_fn(params, cfg, batch, remat="none")
    assert float(l1) < l0, (l0, float(l1))


def test_train_mode_needs_no_cache_and_codebook_labels():
    """``mode="train"`` refuses a cache; musicgen's loss averages over
    every codebook's positions (labels (B, C, S), logits (B, C, S, V))."""
    from repro_torch.models import forward, init_cache
    cfg = reduced(get_config("musicgen-medium"))
    params = init_params(prng.PRNGKey(1), cfg, device="cpu")
    batch = _random_batch(cfg, 2, 8, seed=4)
    with pytest.raises(ValueError, match="without a cache"):
        forward(params, cfg, batch, mode="train",
                cache=init_cache(cfg, 2, 9, device="cpu"))
    labels = batch["labels"].clone()
    labels[:, :, -1] = -1
    with torch.no_grad():
        logits, _, _ = forward(params, cfg, batch, mode="train",
                               remat="none")
    assert logits.shape == (2, cfg.codebooks, 8, cfg.vocab_size)
    lf = logits.float()
    nll = torch.logsumexp(lf, -1) - lf.gather(
        -1, labels.clamp_min(0).long()[..., None])[..., 0]
    keep = labels >= 0
    want = nll[keep].mean()
    with torch.no_grad():
        got, m = loss_fn(params, cfg, dict(batch, labels=labels),
                         remat="none", aux_loss_weight=0.0)
    assert abs(float(got) - float(want)) < 1e-5
    assert float(m["ce"]) == float(got)
