"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B].

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448 — multi-head latent
attention (MLA): q LoRA rank 768, kv LoRA rank 256, qk nope/rope head dims
64/32, v head dim 64.  The KV cache stores the 256-d latent + shared 32-d
rope key: ~10x smaller than the GQA-equivalent cache.
"""

from .base import ArchConfig, register


@register("minicpm3-4b")
def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab_size=73448,
        attention="mla",
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        rope_theta=1e4,
        tie_embeddings=True,
    )
