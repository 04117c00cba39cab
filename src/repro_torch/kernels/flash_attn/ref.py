"""Plain PyTorch version of kernel B8: softmax attention with GQA, causal
masking and per-row KV length masking, with the scores materialised.

The counterpart of the JAX package's ``kernels/flash_attn/ref.py``: the
same operations in the same order (f32 scores divided by ``√D``, masked
scores ``-1e30``, masked probabilities exactly 0, rows without a valid key
0).  The wrapper (:mod:`.ops`) runs it on CPU tensors, ``chip_smoke.py``
holds the kernel to it on the card, and the models' ``attn_impl="ref"``
calls it directly.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref"]


def _safe_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    return torch.where(denom > 0, p / denom.clamp_min(1e-30), 0.0)


def attention_ref(
    q: torch.Tensor,                        # (B, Hq, Sq, D)
    k: torch.Tensor,                        # (B, Hkv, Skv, D)
    v: torch.Tensor,                        # (B, Hkv, Skv, D)
    kv_len: Optional[torch.Tensor] = None,  # (B,) int32
    *,
    causal: bool = True,
) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    k = k.repeat_interleave(group, dim=1)   # kv head of q head h: h // group
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (D ** 0.5)
    mask = torch.ones((B, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        iq = torch.arange(Sq, device=q.device)[:, None]
        jk = torch.arange(Skv, device=q.device)[None, :]
        mask = mask & (jk <= iq)
    if kv_len is not None:
        mask = mask & (torch.arange(Skv, device=q.device)
                       < kv_len.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, -1e30)
    p = _safe_softmax(s, mask)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
