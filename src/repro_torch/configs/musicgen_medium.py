"""MusicGen-medium [arXiv:2306.05284].

48L, d_model 1536, 24 heads (MHA kv=24), d_ff 6144 — decoder-only over
EnCodec tokens: 4 parallel codebooks of vocab 2048 (delay-pattern streams
summed at the embedding, one LM head per codebook).  The EnCodec audio
frontend is a stub per the assignment: ``input_specs`` provides the token
streams directly.  GELU MLP (no gating).
"""

from .base import ArchConfig, register


@register("musicgen-medium")
def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        mlp_act="gelu",
        rope_theta=1e4,
        codebooks=4,
        frontend="audio_stub",
    )
