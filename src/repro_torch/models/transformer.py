"""Backbone assembly: one :class:`Block` per layer in an ``nn.ModuleList``
(the port of the JAX package's ``repro.models.transformer``, which scans
one compiled period body over stacked parameters).

Layer ``l`` is position ``l % P`` of the pattern (``P =
len(cfg.layer_pattern)``), period ``l // P``.  Its kind ``"mixer:mlp"``
names the mixer (``"attn"``: GQA or, under ``cfg.attention == "mla"``,
MLA; ``"mamba"``; ``"rwkv6"``, which owns its whole block) and the MLP
(``"dense"``: SwiGLU/GELU; ``"moe"``: routed experts and an optional
shared one; ``"none"``).  A layer's cache is its mixer's: the KV cache
(``k``, ``v``, ``len``), MLA's latent cache (``ckv``, ``k_rope``,
``len``), Mamba's ``(conv, ssm)`` or RWKV's shifts and state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..core import prng
from . import layers as L
from .mamba import init_mamba, init_mamba_cache, mamba
from .moe import init_moe, mean, moe_layer
from .rwkv import init_rwkv_block, init_rwkv_cache, rwkv_block

__all__ = ["Block", "init_stack", "apply_stack", "init_stack_cache",
           "dtype_of", "REMATS"]


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Block(nn.Module):
    """One layer of kind ``"mixer:mlp"`` (the reference's
    ``_init_position``/``_apply_position``): pre-norm mixer and MLP,
    sequential or (``cfg.parallel_block``, command-r) both reading the same
    normed input.  Its children carry the reference's names (``ln_attn``,
    ``attn``/``mamba``/``rwkv``, ``ln_mlp``, ``mlp``/``moe``)."""

    def __init__(self, key, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        mixer, mlp_kind = kind.split(":")
        dt = dtype_of(cfg)
        self.cfg, self.mixer, self.mlp_kind = cfg, mixer, mlp_kind
        ks = L._split(key, 4)          # as the reference's _init_position
        if mixer == "attn":
            self.ln_attn = L.init_rms_norm(cfg.d_model, dt, device)
            self.attn = (L.init_mla(ks[0], cfg, dt, device)
                         if cfg.attention == "mla"
                         else L.init_attention(ks[0], cfg, dt, device))
        elif mixer == "mamba":
            self.ln_attn = L.init_rms_norm(cfg.d_model, dt, device)
            self.mamba = init_mamba(ks[0], cfg, dt, device)
        elif mixer == "rwkv6":
            self.rwkv = init_rwkv_block(ks[0], cfg, dt, device)
        else:
            raise ValueError(f"unknown mixer {mixer!r}")
        if mlp_kind == "dense":
            self.ln_mlp = L.init_rms_norm(cfg.d_model, dt, device)
            self.mlp = L.init_mlp(ks[1], cfg.d_model, cfg.d_ff, dt,
                                  cfg.mlp_act, device)
        elif mlp_kind == "moe":
            self.ln_mlp = L.init_rms_norm(cfg.d_model, dt, device)
            self.moe = init_moe(ks[1], cfg, dt, device)
        elif mlp_kind != "none":
            raise ValueError(f"unknown mlp kind {mlp_kind!r}")

    def _mlp(self, cfg, h, exact: bool, constrain):
        if self.mlp_kind == "dense":
            return L.mlp(self.mlp, h, cfg.mlp_act), None
        return moe_layer(self.moe, cfg, h, constrain=constrain, exact=exact)

    def forward(self, x, positions, cache: Optional[Dict] = None, *,
                cfg: Optional[ArchConfig] = None, attn_impl: str = "ref",
                constrain=L._identity):
        """Returns (x, new_cache, aux); ``aux`` is the MoE statistics, or
        ``None`` for a layer without experts.  ``cfg`` (default: the one
        the block was built with) is the config the caller runs, as the
        reference's functions take it: e.g. another capacity factor."""
        cfg = self.cfg if cfg is None else cfg
        if self.mixer == "rwkv6":
            x, new_cache = rwkv_block(self.rwkv, cfg, x, cache,
                                      constrain=constrain)
            return constrain(x, "hidden"), new_cache, None
        h = L.rms_norm(self.ln_attn, x, cfg.norm_eps)
        if self.mixer == "attn":
            fn = L.mla if cfg.attention == "mla" else L.attention
            mix_out, new_cache = fn(self.attn, cfg, h, positions, cache,
                                    attn_impl=attn_impl, constrain=constrain)
        else:
            mix_out, new_cache = mamba(self.mamba, cfg, h, cache,
                                       constrain=constrain)
        # MoE decode routes at exact capacity (no drops)
        exact = cache is not None and x.shape[1] == 1
        aux = None
        if cfg.parallel_block and self.mlp_kind != "none":
            mlp_out, aux = self._mlp(cfg, h, exact, constrain)
            x = constrain(x + mix_out + mlp_out, "hidden")
            return x, new_cache, aux
        x = constrain(x + mix_out, "hidden")
        if self.mlp_kind != "none":
            h2 = L.rms_norm(self.ln_mlp, x, cfg.norm_eps)
            out, aux = self._mlp(cfg, h2, exact, constrain)
            x = constrain(x + out, "hidden")
        return x, new_cache, aux


def init_stack(key, cfg: ArchConfig, device=None) -> nn.ModuleList:
    """One block per layer.  Layer ``period·P + pos`` of a pattern of
    length ``P`` takes ``split(fold_in(key, pos), num_periods)[period]``,
    the key the reference's ``init_stack`` vmaps that position over."""
    pattern = cfg.layer_pattern
    P = len(pattern)
    keys = [L._split(None if key is None else prng.fold_in(key, pos),
                    cfg.num_periods) for pos in range(P)]
    return nn.ModuleList(
        Block(keys[i % P][i // P], cfg, pattern[i % P], device)
        for i in range(cfg.num_layers))


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                 device) -> Dict[str, torch.Tensor]:
    """One zero cache of a layer of ``kind`` (the reference's
    ``_position_cache``)."""
    mixer = kind.split(":")[0]
    dt = dtype_of(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if mixer == "attn":
        if cfg.attention == "mla":
            return {"ckv": zeros(batch, max_len, cfg.kv_lora_rank),
                    "k_rope": zeros(batch, max_len, 1, cfg.qk_rope_head_dim),
                    "len": zeros(batch, dtype=torch.int32)}
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape),
                "len": zeros(batch, dtype=torch.int32)}
    if mixer == "mamba":
        return init_mamba_cache(cfg, batch, dt, device)
    if mixer == "rwkv6":
        return init_rwkv_cache(cfg, batch, dt, device)
    raise ValueError(f"unknown mixer {mixer!r}")


def init_stack_cache(cfg: ArchConfig, batch: int, max_len: int,
                     device=None) -> List[Dict[str, torch.Tensor]]:
    """One zero cache per layer, of its mixer's kind."""
    P = len(cfg.layer_pattern)
    return [_layer_cache(cfg, cfg.layer_pattern[i % P], batch, max_len,
                         device) for i in range(cfg.num_layers)]


#: activation recomputation of the training stack (the reference's names)
REMATS = ("none", "full", "dots")

# The matmuls without batch dims: the weight GEMMs (``x @ w``, which torch
# lowers to ``mm``/``addmm`` on the flattened rows), the outputs the
# reference's ``dots_with_no_batch_dims_saveable`` keeps.
_SAVEABLE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVEABLE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def apply_stack(blocks: nn.ModuleList, cfg: ArchConfig, x: torch.Tensor,
                positions, cache=None, *, attn_impl: str = "ref",
                constrain=L._identity, remat: str = "none"):
    """Run the whole stack.  Returns (x, new_cache, aux): ``aux`` holds the
    MoE statistics as the reference reduces them, the mean over a period's
    positions (a layer without experts counts as 0), then over periods.

    ``remat`` (training, without a cache, as the reference applies it):
    ``"full"`` checkpoints each period (its ``P`` layers; only its input
    is kept and the period runs again in the backward), ``"dots"`` keeps
    the weight GEMMs' outputs of a period and recomputes the rest,
    ``"none"`` keeps everything.  Gradients are the same under each.
    """
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; the port takes {REMATS}")
    P = len(cfg.layer_pattern)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    zero = {"load_balance_loss": z, "drop_frac": z}

    def period(x, first):
        auxes, caches = [], []
        for i in range(first, first + P):
            x, c, aux = blocks[i](
                x, positions, None if cache is None else cache[i], cfg=cfg,
                attn_impl=attn_impl, constrain=constrain)
            auxes.append(zero if aux is None else aux)
            caches.append(c)
        return x, caches, {k: mean(torch.stack([a[k] for a in auxes]))
                           for k in zero}

    new_cache = None if cache is None else []
    per_period = []
    for first in range(0, len(blocks), P):
        if remat == "none" or cache is not None:
            x, caches, aux = period(x, first)
        else:
            x, caches, aux = checkpoint(
                period, x, first, use_reentrant=False,
                **({"context_fn": _dots_context} if remat == "dots"
                   else {}))
        if cache is not None:
            new_cache.extend(caches)
        per_period.append(aux)
    aux = {k: mean(torch.stack([a[k] for a in per_period])) for k in zero}
    return x, new_cache, aux
