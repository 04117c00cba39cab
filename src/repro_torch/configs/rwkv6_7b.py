"""RWKV-6 (Finch) 7B [arXiv:2404.05892].

32L, d_model 4096, attention-free (WKV6 data-dependent-decay linear
recurrence, head size 64 -> 64 heads), channel-mix d_ff 14336, vocab 65536.
Supports long_500k: recurrent state is O(1) in sequence length.
"""

from .base import ArchConfig, register


@register("rwkv6-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        d_ff=14336,
        vocab_size=65536,
        attention="none",
        layer_pattern=("rwkv6:none",),
        rwkv_head_size=64,
        supports_long_context=True,
    )
