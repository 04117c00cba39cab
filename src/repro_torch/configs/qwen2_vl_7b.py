"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L, d_model 3584, 28 heads (GQA kv=4), d_ff 18944, vocab 152064.
M-RoPE with (temporal, height, width) half-dim sections (16, 24, 24);
dynamic-resolution vision tower is a stub: ``input_specs`` supplies
precomputed patch embeddings + 3-plane position ids (assignment brief).
Qwen2 uses QKV biases.
"""

from .base import ArchConfig, register


@register("qwen2-vl-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        attn_bias=True,
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),   # sums to head_dim/2 = 64
        frontend="vision_stub",
        tie_embeddings=False,
    )
