"""MiniCPM-2B [arXiv:2404.06395].

40L, d_model 2304, 36 heads (MHA kv=36), d_ff 5760, vocab 122753.
Llama-like architecture; trains with the WSD (warmup-stable-decay)
schedule — wired to the optimizer via ``schedule='wsd'``.
"""

from .base import ArchConfig, register


@register("minicpm-2b")
def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab_size=122753,
        rope_theta=1e4,
        tie_embeddings=True,
        schedule="wsd",
    )
