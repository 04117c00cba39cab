"""Memory-light attention in plain torch: flash-style chunking with an
autograd function whose backward is chunked too (the port of the JAX
package's ``kernels/flash_attn/chunked.py``).

The plain attention (:func:`.ref.attention_ref`) materialises the
``(B, H, Sq, Skv)`` score tensor in f32; at long sequences that one
tensor dominates the memory of a training step.  This implementation
never holds more than one ``(block_q, block_k)`` panel a head:

* forward: a loop over query blocks, and inside it one pass over the
  key/value blocks with a running (max, sum of exponentials, accumulator),
  the online softmax; it saves only the output and the log-sum-exp rows;
* backward: recomputes each score panel from ``(q, k, lse)`` and
  accumulates ``dq``, ``dk`` and ``dv`` per block: O(S·d) saved tensors
  instead of O(S²).

The reference writes both passes as ``lax.scan``s inside a ``custom_vjp``
(no Pallas kernel), so torch loops over the same blocks, in the same
order and with the same masks, are its port.  Under ``causal`` a key
block that lies wholly after a query block's last row is skipped: every
entry of it is masked, so the reference's pass over it adds exact zeros
and rescales by exactly 1, and skipping it changes no number.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["chunked_attention"]

_NEG = -1e30


def _masked(kv_mask, causal, q0, bq, k0, bk, device):
    """The (B, 1, bq, bk) mask of one panel: keys below ``kv_len`` and,
    under ``causal``, at or before the query."""
    msk = kv_mask[:, None, None, k0:k0 + bk]
    if causal:
        iq = q0 + torch.arange(bq, device=device)
        jk = k0 + torch.arange(bk, device=device)
        msk = msk & (jk[None, None, None, :] <= iq[None, None, :, None])
    return msk


def _blocks(causal, q0, bq, nk, bk):
    """The key blocks a query block at ``q0`` visits (causal: none wholly
    after its last row)."""
    if not causal:
        return range(nk)
    return range(min(nk, (q0 + bq - 1) // bk + 1))


def _blockwise_fwd(q, k, v, kv_len, causal, block_q, block_k, scale):
    """Returns (out (B, H, Sq, Dv) in q's dtype, lse (B, H, Sq) f32) over
    inputs padded to whole blocks."""
    B, H, Sq, _ = q.shape
    Dv = v.shape[-1]
    Skv = k.shape[2]
    nq, nk = Sq // block_q, Skv // block_k
    kv_mask = torch.arange(Skv, device=q.device)[None, :] < kv_len[:, None]
    outs, lses = [], []
    for qi in range(nq):
        q0 = qi * block_q
        q_blk = q[:, :, q0:q0 + block_q].float() * scale
        m = torch.full((B, H, block_q), _NEG, device=q.device)
        l = torch.zeros((B, H, block_q), device=q.device)
        acc = torch.zeros((B, H, block_q, Dv), device=q.device)
        for ki in _blocks(causal, q0, block_q, nk, block_k):
            k0 = ki * block_k
            k_blk = k[:, :, k0:k0 + block_k].float()
            v_blk = v[:, :, k0:k0 + block_k].float()
            msk = _masked(kv_mask, causal, q0, block_q, k0, block_k,
                          q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk, k_blk)
            s = torch.where(msk, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v_blk)
            m = m_new
        out = torch.where(l[..., None] > 0,
                          acc / l.clamp_min(1e-30)[..., None], 0.0)
        outs.append(out.to(q.dtype))
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    return torch.cat(outs, 2), torch.cat(lses, 2)


def _pad_to(x, target, dim=2):
    pad = target - x.shape[dim]
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def _padded_sizes(Sq, Skv, block_q, block_k):
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    return bq, bk, -(-Sq // bq) * bq, -(-Skv // bk) * bk


def _fwd_padded(q, k, v, kv_len, causal, block_q, block_k):
    Sq, D, Skv = q.shape[2], q.shape[3], k.shape[2]
    bq, bk, Sq_p, Skv_p = _padded_sizes(Sq, Skv, block_q, block_k)
    out, lse = _blockwise_fwd(
        _pad_to(q, Sq_p), _pad_to(k, Skv_p), _pad_to(v, Skv_p),
        kv_len.clamp(max=Skv), causal, bq, bk, 1.0 / (D ** 0.5))
    return out[:, :, :Sq], lse[:, :, :Sq]


def _chunked_bwd(causal, block_q, block_k, q, k, v, kv_len, out, lse, g):
    B, H, Sq, D = q.shape
    Dv = v.shape[-1]
    Skv = k.shape[2]
    bq, bk, Sq_p, Skv_p = _padded_sizes(Sq, Skv, block_q, block_k)
    scale = 1.0 / (D ** 0.5)
    qp, gp, op = (_pad_to(t, Sq_p).float() for t in (q, g, out))
    kp, vp = (_pad_to(t, Skv_p).float() for t in (k, v))
    lsep = _pad_to(lse, Sq_p)
    if Sq_p != Sq:   # rows past Sq: p = 0 through an lse of +1e30
        pad_rows = torch.arange(Sq_p, device=q.device) >= Sq
        lsep = torch.where(pad_rows[None, None, :], 1e30, lsep)
    delta = (gp * op).sum(-1)                            # (B, H, Sq_p)
    kv_mask = torch.arange(Skv_p, device=q.device)[None, :] \
        < kv_len.clamp(max=Skv)[:, None]
    nq, nk = Sq_p // bq, Skv_p // bk
    dk = torch.zeros((B, H, Skv_p, D), device=q.device)
    dv = torch.zeros((B, H, Skv_p, Dv), device=q.device)
    dqs = []
    for qi in range(nq):
        q0 = qi * bq
        q_blk = qp[:, :, q0:q0 + bq] * scale
        g_blk = gp[:, :, q0:q0 + bq]
        lse_blk, d_blk = lsep[:, :, q0:q0 + bq], delta[:, :, q0:q0 + bq]
        dq_blk = torch.zeros((B, H, bq, D), device=q.device)
        for ki in _blocks(causal, q0, bq, nk, bk):
            k0 = ki * bk
            k_blk, v_blk = kp[:, :, k0:k0 + bk], vp[:, :, k0:k0 + bk]
            msk = _masked(kv_mask, causal, q0, bq, k0, bk, q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk, k_blk)
            p = torch.where(msk, torch.exp(s - lse_blk[..., None]), 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", g_blk, v_blk)
            ds = p * (dp - d_blk[..., None])
            dq_blk = dq_blk + torch.einsum("bhqk,bhkd->bhqd", ds, k_blk)
            dk[:, :, k0:k0 + bk] += torch.einsum("bhqk,bhqd->bhkd", ds,
                                                 q_blk)
            dv[:, :, k0:k0 + bk] += torch.einsum("bhqk,bhqd->bhkd", p,
                                                 g_blk)
        dqs.append(dq_blk * scale)
    dq = torch.cat(dqs, 2)[:, :, :Sq]
    return (dq.to(q.dtype), dk[:, :, :Skv].to(k.dtype),
            dv[:, :, :Skv].to(v.dtype))


class _Chunked(torch.autograd.Function):
    """Forward: the blockwise online softmax, saving ``(q, k, v, kv_len,
    out, lse)``; backward: the chunked recompute (the reference's
    ``_chunked_fwd``/``_chunked_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, block_q, block_k):
        out, lse = _fwd_padded(q, k, v, kv_len, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        ctx.blocks = (causal, block_q, block_k)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dq, dk, dv = _chunked_bwd(*ctx.blocks, *ctx.saved_tensors, g)
        return dq, dk, dv, None, None, None, None


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None, *, causal: bool = True,
    block_q: int = 512, block_k: int = 1024,
) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, Dv); GQA by
    repeating each kv head over its group of query heads (head ``h`` reads
    kv head ``h // (Hq / Hkv)``).  ``kv_len`` (B,) masks trailing keys
    (default: all).  Differentiable in q, k and v."""
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    if kv_len is None:
        kv_len = torch.full((B,), k.shape[2], dtype=torch.int32,
                            device=q.device)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32)
    if Hq != Hkv:
        group = Hq // Hkv
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return _Chunked.apply(q, k, v, kv_len, causal, block_q, block_k)
