"""Grok-1 314B [hf:xai-org/grok-1; unverified].

64L, d_model 6144, 48 heads (GQA kv=8), MoE 8 experts top-2 with expert
d_ff 32768, vocab 131072.
"""

from .base import ArchConfig, register


@register("grok-1-314b")
def config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        rope_theta=1e4,
        layer_pattern=("attn:moe",),
        num_experts=8,
        num_experts_per_tok=2,
        moe_d_ff=32768,
    )
