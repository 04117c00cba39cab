"""Public model API: embeddings, the stack and the head, with the prefill
and decode entry points (the port of the JAX package's
``repro.models.model``).

Batch dict conventions (tensors on the model's device):

* ``tokens``          (B, S) int, or (B, C, S) for parallel codebooks
                      (musicgen: C EnCodec streams, embeddings summed)
* ``positions``       (B, S) int, or (3, B, S) for M-RoPE (qwen2-vl)
* ``frontend_embeds`` (B, S, D) optional: precomputed patch/frame
                      embeddings (the modality frontend is a stub, as in
                      the reference), substituted where ``embed_mask``
* ``embed_mask``      (B, S) bool optional
* ``labels``          like tokens (training); a label below 0 has no
                      target

Every family of the reference serves and trains: dense, MoE, MLA, Mamba
hybrids, RWKV6 and parallel codebooks, whose logits are (B, C, S, V),
one head per codebook.  :func:`loss_fn` is the training objective; its
gradients reach every parameter through autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..sharding.placement import matmul, meshed, replicated, unsharded
from . import layers as L
from .transformer import apply_stack, dtype_of, init_stack, init_stack_cache

__all__ = ["LM", "init_params", "forward", "init_cache", "loss_fn",
           "param_count"]

_MODES = ("train", "prefill", "decode")


class LM(nn.Module):
    """Parameters of one language model: ``embed`` (V, d), ``blocks`` (one
    per layer), ``ln_f`` and, for untied embeddings, ``head`` (d, V); with
    ``cfg.codebooks`` = C, ``embed`` (C, V, d) and ``head`` (C, d, V).
    ``key=None`` leaves the weights unset (see :func:`init_params`)."""

    def __init__(self, key, cfg: ArchConfig, device=None):
        super().__init__()
        dt = dtype_of(cfg)
        self.cfg = cfg
        k_embed, k_stack, k_head = L._split(key, 3)
        books = (cfg.codebooks,) if cfg.codebooks else ()
        self.embed = nn.Parameter(L._normal(
            k_embed, books + (cfg.vocab_size, cfg.d_model), dt, device))
        self.blocks = init_stack(k_stack, cfg, device)
        self.ln_f = L.init_rms_norm(cfg.d_model, dt, device)
        self.head = None if cfg.tie_embeddings else nn.Parameter(L._normal(
            k_head, books + (cfg.d_model, cfg.vocab_size), dt, device))

    def forward(self, batch: Dict, **kw):
        return forward(self, self.cfg, batch, **kw)


def init_params(key: torch.Tensor, cfg: ArchConfig, *,
                device=None) -> LM:
    """Randomly initialised parameters, the reference's ``init_params(key,
    cfg)``: ``normal · 0.02`` drawn in f32 under the same tree of split
    keys and cast to the config dtype, norm scales 1, biases 0.  ``key``
    is a threefry key (:func:`repro_torch.core.prng.PRNGKey`; the keys are
    split where it lies, the weights drawn on ``device``).  ``device=None``
    is the card."""
    return LM(key, cfg, resolve_device(device))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None,
               plan=None):
    """One zero cache per layer, of its mixer's kind (``device=None`` is
    the card); with a :class:`~repro_torch.sharding.ShardingPlan`,
    DTensors on its mesh laid out by ``plan.cache_specs`` (the KV
    sequence over ``model`` by default)."""
    cache = init_stack_cache(cfg, batch, max_len, resolve_device(device))
    if plan is None:
        return cache
    from torch.distributed.tensor import distribute_tensor
    return [{name: distribute_tensor(t, plan.mesh, plan.named(spec))
             for (name, t), spec in zip(layer.items(), specs.values())}
            for layer, specs in zip(cache, plan.cache_specs(cfg, cache))]


def _embed(params: LM, cfg: ArchConfig, batch, constrain):
    tokens = batch["tokens"].long()
    # F.embedding's rows and gradient are the indexing's; on a mesh the
    # table is gathered whole first (DTensor's lookups on a vocab-sharded
    # table leave a masked partial sum that its redistributions mishandle,
    # and indexing's backward has no rule on torch 2.11)
    table = replicated(params.embed)
    if cfg.codebooks:   # (B, C, S): the codebooks' embeddings summed
        x = torch.stack([F.embedding(tokens[:, c], table[c])
                         for c in range(cfg.codebooks)], 1).sum(dim=1)
    else:
        x = F.embedding(tokens, table)                        # (B, S, D)
    if "frontend_embeds" in batch:
        mask = batch["embed_mask"][..., None]
        x = torch.where(mask, batch["frontend_embeds"].to(x.dtype), x)
    return constrain(x, "hidden")


def _head(params: LM, cfg: ArchConfig, x, constrain):
    if cfg.codebooks:   # (B, C, S, V)
        logits = x[:, None] @ params.head
    elif cfg.tie_embeddings:
        logits = matmul(x, params.embed.t())
    else:
        logits = matmul(x, params.head)
    return constrain(logits, "logits")


def forward(
    params: LM, cfg: ArchConfig, batch: Dict, *,
    cache=None, mode: str = "prefill", attn_impl: str = "ref",
    constrain=L._identity, remat: str = "full",
    logits_slice: Optional[str] = None,
):
    """mode: train | prefill | decode.  ``train`` runs without a cache
    under ``remat`` (:func:`~.transformer.apply_stack`; the other modes
    ignore it, as the reference does); prefill and decode with ``cache``
    fill it and append one token; without, a plain causal forward.
    Returns logits (B, S, V), or (B, C, S, V) with codebooks.

    ``logits_slice='last'`` returns logits only for the final position
    (serving: avoids materialising (B, S, V)).  The cache's tensors are
    written in place.  Returns (logits, new_cache, aux).
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; the port takes {_MODES}")
    if mode == "train" and cache is not None:
        raise ValueError("mode='train' runs without a cache")
    with meshed(params.embed):
        x = _embed(params, cfg, batch, constrain)
        x, new_cache, aux = apply_stack(
            params.blocks, cfg, x, batch["positions"], cache,
            attn_impl=attn_impl, constrain=constrain,
            remat=remat if mode == "train" else "none")
        x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
        if logits_slice == "last":
            x = x[:, -1:]
        return _head(params, cfg, x, constrain), new_cache, aux


def loss_fn(
    params: LM, cfg: ArchConfig, batch: Dict, *,
    attn_impl: str = "ref", constrain=L._identity, remat: str = "full",
    aux_loss_weight: float = 0.01,
):
    """Next-token cross-entropy over f32 logits, averaged over the
    positions whose label is at least 0 (codebooks: over every codebook's
    positions), plus ``aux_loss_weight`` times the MoE load-balance loss.
    Returns (loss, {"ce", "load_balance_loss", "drop_frac"}), 0-dim f32
    tensors; ``loss.backward()`` fills every parameter's gradient."""
    logits, _, aux = forward(params, cfg, batch, mode="train",
                             attn_impl=attn_impl, constrain=constrain,
                             remat=remat)
    with meshed(params.embed):
        labels = batch["labels"].long()
        # the gather below reads any vocab entry: the vocab dim whole
        logits = unsharded(logits.float(), -1)
        logz = torch.logsumexp(logits, dim=-1)
        # a label below 0 gathers a real entry and is masked out after
        gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
        loss = ce + aux_loss_weight * aux["load_balance_loss"]
    return loss, {"ce": ce, **aux}


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
