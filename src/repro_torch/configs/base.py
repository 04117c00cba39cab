"""Architecture configuration system (a copy of the JAX package's
``repro.configs.base``, pure Python, field for field the same).

One frozen dataclass describes every supported backbone; per-arch modules in
this package instantiate it with published numbers (``--arch <id>`` in the
launchers).  Heterogeneous stacks (hybrid attention/SSM, periodic MoE) are
expressed as a *layer pattern*: the stack is ``num_periods`` repetitions of
``layer_pattern``.  The port builds one block per layer
(:mod:`repro_torch.models.transformer`); the reference scans over periods.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Tuple

__all__ = ["ArchConfig", "register", "get_config", "list_archs", "SHAPES",
           "ShapeSpec", "shape_for"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # layer pattern: kinds per position within one period.  Kinds:
    #   "attn" | "mamba" | "rwkv6"  x  mlp kind "dense" | "moe" | "shared_moe"
    # encoded as f"{mixer}:{mlp}".
    layer_pattern: Tuple[str, ...] = ("attn:dense",)

    # attention
    attention: str = "gqa"          # gqa | mla | none
    attn_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim sections
    parallel_block: bool = False    # command-r style parallel attn+mlp
    mlp_act: str = "silu"           # silu | gelu

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0     # always-on shared expert (qwen2-moe)
    capacity_factor: float = 1.25
    # pad the expert dim to a multiple of this (0 = off) so it shards over
    # the model axis (expert parallelism); padded experts are never routed
    # to.  §Perf optimization, off in the paper-faithful baseline.
    expert_pad_multiple: int = 0

    # mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0          # 0 -> ceil(d_model / 16)

    # rwkv6
    rwkv_head_size: int = 64

    # io / misc
    tie_embeddings: bool = False
    codebooks: int = 0              # musicgen: parallel EnCodec codebooks
    frontend: str = "none"          # none | vision_stub | audio_stub
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    schedule: str = "cosine"        # cosine | wsd (minicpm)

    # which attention shapes this arch supports (long_500k needs
    # sub-quadratic state — DESIGN.md §5)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern length {len(self.layer_pattern)}")
        if self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def mixer_kinds(self) -> Tuple[str, ...]:
        return tuple(p.split(":")[0] for p in self.layer_pattern)

    @property
    def mlp_kinds(self) -> Tuple[str, ...]:
        return tuple(p.split(":")[1] for p in self.layer_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline numbers)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d * max(1, self.codebooks or 1) if self.codebooks \
                else v * d
        if self.codebooks:
            total += (self.codebooks - 1) * v * d  # extra codebook embeds
        for mixer, mlp in zip(self.mixer_kinds, self.mlp_kinds):
            n_pos = self.num_periods
            if mixer == "attn":
                if self.attention == "mla":
                    qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
                    per = (d * self.q_lora_rank
                           + self.q_lora_rank * self.num_heads * qk_head
                           + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                           + self.kv_lora_rank * self.num_heads
                           * (self.qk_nope_head_dim + self.v_head_dim)
                           + self.num_heads * self.v_head_dim * d)
                else:
                    per = (d * self.num_heads * self.head_dim
                           + 2 * d * self.num_kv_heads * self.head_dim
                           + self.num_heads * self.head_dim * d)
            elif mixer == "mamba":
                d_in = self.mamba_expand * d
                dt_rank = self.mamba_dt_rank or -(-d // 16)
                per = (d * 2 * d_in + self.mamba_d_conv * d_in
                       + d_in * (dt_rank + 2 * self.mamba_d_state)
                       + dt_rank * d_in + d_in * self.mamba_d_state
                       + d_in + d_in * d)
            else:  # rwkv6: 5 tm mats + cm_wr + channel mix + shift/decay loras
                per = (6 * d * d + 2 * d * ff
                       + d * (5 * 32) + 5 * 32 * d       # maa lora
                       + 2 * d * 64)                     # decay lora
            if mlp == "dense":
                per += 3 * d * ff if mixer != "rwkv6" else 0
            elif mlp == "moe":
                per += (self.num_experts * 3 * d * self.moe_d_ff
                        + d * self.num_experts)
                if self.shared_expert_d_ff:
                    per += 3 * d * self.shared_expert_d_ff
            total += per * n_pos
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-to experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_positions = sum(1 for k in self.mlp_kinds if k == "moe")
        all_experts = (moe_positions * self.num_periods
                       * self.num_experts * 3 * self.d_model * self.moe_d_ff)
        active = (moe_positions * self.num_periods
                  * self.num_experts_per_tok * 3 * self.d_model
                  * self.moe_d_ff)
        return full - all_experts + active


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_for(arch: "ArchConfig", shape_name: str) -> ShapeSpec:
    spec = SHAPES[shape_name]
    if shape_name == "long_500k" and not arch.supports_long_context:
        raise ValueError(
            f"{arch.name} is pure full-attention; long_500k is skipped "
            "(DESIGN.md §5)")
    return spec


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    # import side-effect registration
    from . import _load_all  # noqa
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    from . import _load_all  # noqa
    _load_all()
    return sorted(_REGISTRY)
