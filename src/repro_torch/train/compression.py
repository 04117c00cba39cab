"""Gradient compression with error feedback, the port of the JAX package's
``repro.train.compression``: block-wise symmetric int8 quantization of
the gradients (blocks of 256, scale ``max|x| / 127``, round half to
even, clip to ±127) with a residual that re-injects the quantization
error next step.  Bit for bit the reference's on the same f32 input.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..sharding.placement import replicated

__all__ = ["ef_init", "compress_grads", "quantize_int8", "dequantize_int8"]

_BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization.  Returns (q (N, 256) int8,
    scales (N,) f32).  A DTensor is quantized whole (its blocks run across
    the shards), so the result is replicated."""
    flat = replicated(x).float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.view(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    out = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return out[:n].reshape(shape).to(dtype)


def ef_init(params) -> List[torch.Tensor]:
    """A zero f32 residual a parameter (a module's, in order)."""
    ps = params.parameters() if isinstance(params, torch.nn.Module) \
        else params
    return [torch.zeros_like(p, dtype=torch.float32,
                             memory_format=torch.contiguous_format)
            for p in ps]


def compress_grads(grads: Sequence[torch.Tensor],
                   ef_state: Sequence[torch.Tensor]):
    """Quantize (grad + residual) to the int8 wire format; return the
    dequantized gradients actually applied and the new residuals."""
    out, res = [], []
    for g, e in zip(grads, ef_state):
        target = g.float() + e
        q, s = quantize_int8(target)
        deq = dequantize_int8(q, s, g.shape)
        out.append(deq)
        res.append(target - deq)
    return out, res
