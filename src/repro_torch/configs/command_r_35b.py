"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000.
No biases; Cohere-style parallel attention+MLP block; tied embeddings.
"""

from .base import ArchConfig, register


@register("command-r-35b")
def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        rope_theta=8e6,
        parallel_block=True,
        tie_embeddings=True,
    )
