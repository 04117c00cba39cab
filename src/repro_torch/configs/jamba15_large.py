"""Jamba-1.5-Large 398B [arXiv:2403.19887 / 2408.12570].

72L, d_model 8192, 64 heads (GQA kv=8), vocab 65536; hybrid Mamba+attention
at 1:7 per 8-layer period (attention at period position 4), MoE 16 experts
top-2 (d_ff 24576) on every other layer (odd positions).  Mamba: d_state 16,
d_conv 4, expand 2.

Supports long_500k: SSM state is O(1) in sequence length and only 9 of 72
layers hold KV caches.
"""

from .base import ArchConfig, register

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba") + ":" + ("moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


@register("jamba-1.5-large-398b")
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        rope_theta=1e4,
        layer_pattern=_PATTERN,
        num_experts=16,
        num_experts_per_tok=2,
        moe_d_ff=24576,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        supports_long_context=True,
    )
