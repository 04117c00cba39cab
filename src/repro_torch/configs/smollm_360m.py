"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M].

32L, d_model 960, 15 heads (GQA kv=5), d_ff 2560, vocab 49152 — llama-style
small model; the end-to-end training example uses a reduced variant of this
family.
"""

from .base import ArchConfig, register


@register("smollm-360m")
def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=1e4,
        tie_embeddings=True,
    )
