"""Reduced same-family configs for CPU tests (a copy of the JAX package's
``repro.configs.smoke``).

Every assigned architecture gets a tiny sibling that preserves its
*structural* features (GQA ratio, MLA ranks, MoE top-k, hybrid pattern,
M-RoPE sections, codebooks) while shrinking widths/depths so a forward
runs on the CPU in well under a second.
"""

from __future__ import annotations

import dataclasses

from .base import ArchConfig

__all__ = ["reduced"]


def reduced(cfg: ArchConfig) -> ArchConfig:
    r = dict(
        num_layers=2 * len(cfg.layer_pattern),
        d_model=64,
        vocab_size=128,
        d_ff=96,
        dtype="float32",
    )
    if cfg.num_heads:
        # keep the GQA ratio
        group = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = 2 if cfg.num_kv_heads > 1 else 1
        r["num_heads"] = kv * group
        r["num_kv_heads"] = kv
        r["head_dim"] = 16
    if cfg.mrope_sections:
        r["mrope_sections"] = (2, 3, 3)     # sums to head_dim/2 = 8
    if cfg.attention == "mla":
        r.update(q_lora_rank=24, kv_lora_rank=16,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                 num_heads=4, num_kv_heads=4, head_dim=16)
    if cfg.num_experts:
        r.update(num_experts=4,
                 num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                 moe_d_ff=32)
        if cfg.shared_expert_d_ff:
            r["shared_expert_d_ff"] = 64
    if cfg.family in ("hybrid",):
        r.update(mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
                 mamba_dt_rank=8)
    if cfg.attention == "none":
        r.update(num_heads=0, num_kv_heads=0, rwkv_head_size=16)
    name = cfg.name + "-smoke"
    return dataclasses.replace(cfg, **r, name=name)
