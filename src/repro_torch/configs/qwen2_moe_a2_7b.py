"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 heads (kv=16 — MHA), vocab 151936.
MoE every layer: 60 routed experts top-4 with per-expert d_ff 1408, plus a
shared expert (d_ff 5632, the "4 shared" merged into one wide always-on
expert of equal FLOPs — 4 x 1408 = 5632).
"""

from .base import ArchConfig, register


@register("qwen2-moe-a2.7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5632,                  # dense-equivalent (shared expert width)
        vocab_size=151936,
        attn_bias=True,
        rope_theta=1e6,
        layer_pattern=("attn:moe",),
        num_experts=60,
        num_experts_per_tok=4,
        moe_d_ff=1408,
        shared_expert_d_ff=5632,
    )
