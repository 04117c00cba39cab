"""Backbone assembly: one :class:`Block` per layer in an ``nn.ModuleList``
(the port of the JAX package's ``repro.models.transformer``, which scans
one compiled period body over stacked parameters).

Layer ``l`` is position ``l % len(cfg.layer_pattern)`` of the pattern.
The port builds the ``"attn:dense"`` kind: GQA attention and a dense
SwiGLU/GELU MLP, with the cheap flags ``attn_bias``, ``parallel_block``
and ``mlp_act``.  Mamba, RWKV6, MoE and MLA layers raise
``NotImplementedError`` naming ROADMAP item 9.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import prng
from . import layers as L

__all__ = ["Block", "init_stack", "apply_stack", "init_stack_cache",
           "dtype_of"]


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_kind(cfg: ArchConfig, kind: str) -> None:
    mixer, mlp_kind = kind.split(":")
    if mixer != "attn":
        raise NotImplementedError(
            f"{cfg.name}: {mixer!r} layers are not ported yet (ROADMAP "
            f"item 9); the port builds 'attn:dense' stacks")
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention (MLA) is not ported "
            f"yet (ROADMAP item 9)")
    if mlp_kind != "dense":
        raise NotImplementedError(
            f"{cfg.name}: {mlp_kind!r} MLP layers are not ported yet "
            f"(ROADMAP item 9); the port builds 'attn:dense' stacks")


class Block(nn.Module):
    """One ``"attn:dense"`` layer: pre-norm attention and MLP, sequential or
    (``cfg.parallel_block``, command-r) both reading the same normed
    input."""

    def __init__(self, key, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        _check_kind(cfg, kind)
        dt = dtype_of(cfg)
        self.cfg = cfg
        ks = L._split(key, 4)          # as the reference's _init_position
        self.ln_attn = L.init_rms_norm(cfg.d_model, dt, device)
        self.attn = L.init_attention(ks[0], cfg, dt, device)
        self.ln_mlp = L.init_rms_norm(cfg.d_model, dt, device)
        self.mlp = L.init_mlp(ks[1], cfg.d_model, cfg.d_ff, dt, cfg.mlp_act,
                              device)

    def forward(self, x, positions, cache: Optional[Dict] = None, *,
                attn_impl: str = "ref", constrain=L._identity):
        """Returns (x, new_cache)."""
        cfg = self.cfg
        h = L.rms_norm(self.ln_attn, x, cfg.norm_eps)
        mix_out, new_cache = L.attention(self.attn, cfg, h, positions, cache,
                                         attn_impl=attn_impl,
                                         constrain=constrain)
        if cfg.parallel_block:
            x = x + mix_out + L.mlp(self.mlp, h, cfg.mlp_act)
            return constrain(x, "hidden"), new_cache
        x = constrain(x + mix_out, "hidden")
        h2 = L.rms_norm(self.ln_mlp, x, cfg.norm_eps)
        x = constrain(x + L.mlp(self.mlp, h2, cfg.mlp_act), "hidden")
        return x, new_cache


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


def init_stack_cache(cfg: ArchConfig, batch: int, max_len: int,
                     device=None) -> List[Dict[str, torch.Tensor]]:
    """One zero KV cache per layer: {"k", "v": (batch, max_len, Hk, hd),
    "len": (batch,) int32}."""
    for kind in cfg.layer_pattern:
        _check_kind(cfg, kind)
    dt = dtype_of(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
            for _ in range(cfg.num_layers)]


def apply_stack(blocks: nn.ModuleList, cfg: ArchConfig, x: torch.Tensor,
                positions, cache=None, *, attn_impl: str = "ref",
                constrain=L._identity):
    """Run the whole stack.  Returns (x, new_cache, aux); ``aux`` holds the
    reference's MoE statistics, zero for dense stacks."""
    new_cache = None if cache is None else []
    for i, block in enumerate(blocks):
        x, c = block(x, positions, None if cache is None else cache[i],
                     attn_impl=attn_impl, constrain=constrain)
        if cache is not None:
            new_cache.append(c)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, {"load_balance_loss": zero, "drop_frac": zero}
