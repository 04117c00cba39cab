"""Core neural layers: norms, RoPE/M-RoPE, GQA and MLA attention,
SwiGLU/GELU MLPs (the port of the JAX package's ``repro.models.layers``).

Parameters keep the reference's layouts, so weights carry across tensor
for tensor (:mod:`.convert`): ``dense`` weights are ``(d_in, d_out)`` (the
transpose of ``nn.Linear``'s), ``wq``/``wk``/``wv`` are ``(d, H, hd)`` and
``wo`` is ``(H, hd, d)``.  Each layer's parameters are a :class:`Params`
module (the counterpart of the reference's param dict, nested where the
reference nests one, e.g. the MoE's ``shared`` expert); the functions
here apply them.  Matmuls run in the config dtype; ``rms_norm``, ``rope``
and the decode attention compute in f32 and cast back at the points the
reference does.

``attn_impl`` selects the training and prefill attention: ``"cuda"``
runs kernel B8 through
:func:`repro_torch.kernels.flash_attn.flash_attention` (on a CPU tensor,
its plain version), ``"ref"`` the plain
:func:`~repro_torch.kernels.flash_attn.attention_ref`, ``"chunked"`` the
memory-light :func:`~repro_torch.kernels.flash_attn.chunked_attention`:
the counterparts of the reference's ``"pallas"``, ``"xla"`` and
``"chunked"``.  MLA routes as the reference does: B8 only in the
cache-free forward and only where the query/key head (``dn + dr``) equals
the value head, the chunked attention in the cache-free forward; its
prefill with a cache is always plain.  Decode attention
(:func:`_decode_attend`) is plain torch in both packages.  Every layer
is differentiable (training, :func:`repro_torch.models.loss_fn`); the
caches' in-place writes happen only when serving.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..core import prng
from ..kernels.flash_attn import (attention_ref, chunked_attention,
                                   flash_attention)
from ..sharding.placement import matmul, on_mesh, reshape, shard_offset

__all__ = [
    "Params", "rms_norm", "init_rms_norm", "init_dense", "dense",
    "rope", "mrope", "init_attention", "attention",
    "init_mla", "mla", "init_mlp", "mlp", "ATTN_IMPLS",
]

#: attention implementations (reference names: "pallas", "xla",
#: "chunked")
ATTN_IMPLS = ("cuda", "ref", "chunked")

Constrain = Callable[[torch.Tensor, str], torch.Tensor]


def _identity(t, kind):
    return t


class Params(nn.Module):
    """A named set of parameters: the port's counterpart of one of the
    reference's param dicts (``p.wq`` for ``p["wq"]``, ``"b" in p``).  A
    value that is itself a :class:`Params` is a nested dict (the MoE's
    ``shared`` expert)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, Params):
                self.add_module(name, t)
            else:
                self.register_parameter(name, nn.Parameter(t))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# -- initializers ------------------------------------------------------------

def _normal(key: Optional[torch.Tensor], shape, dtype, device,
            scale: float = 0.02) -> torch.Tensor:
    """``normal(key) · scale`` drawn in f32 and cast to ``dtype``, as the
    reference's ``_normal`` draws (:func:`repro_torch.core.prng.normal`:
    jax's values).  ``key=None`` leaves the tensor unset, for weights
    carried across from the reference
    (:func:`repro_torch.models.convert.params_from_jax`)."""
    if key is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (prng.normal(key, shape, device=device) * scale).to(dtype)


def _split(key: Optional[torch.Tensor], num: int):
    """``jax.random.split(key, num)``, or ``num`` unset keys."""
    return [None] * num if key is None else list(prng.split(key, num))


def init_rms_norm(d: int, dtype, device=None) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device))


def rms_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return _rms(x, p.scale, eps)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rms_norm` by a bare ``scale`` tensor (the reference's
    ``rms_norm({"scale": ...}, ...)``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def init_dense(key, d_in: int, d_out: int, dtype, bias: bool = False,
               device=None) -> Params:
    t = {"w": _normal(key, (d_in, d_out), dtype, device)}
    if bias:
        t["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return Params(**t)


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p.w)
    if "b" in p:
        y = y + p.b
    return y


# -- rotary position embeddings ----------------------------------------------

def _freqs(half_dim: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half_dim, dtype=torch.float32,
                                   device=device) / half_dim)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x`` (B, S, H, D) by ``ang`` (B, S, D/2),
    in f32 (``x`` is promoted), cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Standard rotary embedding.  x (B, S, H, D), positions (B, S)."""
    freqs = _freqs(x.shape[-1] // 2, theta, x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: ``positions`` (3, B, S) carries
    (temporal, height, width) ids; the rotary half-dim is split into
    ``sections`` (summing to D/2), section i rotating with positions[i]."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
    freqs = _freqs(half, theta, x.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(positions[i].float()[..., None]
                     * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


def _apply_rope(cfg: ArchConfig, x: torch.Tensor, positions) -> torch.Tensor:
    if cfg.mrope_sections:
        if positions.dim() == 2:   # plain text positions -> all three planes
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return rope(x, positions, cfg.rope_theta)


# -- grouped-query attention ---------------------------------------------------

def init_attention(key, cfg: ArchConfig, dtype, device=None) -> Params:
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = _split(key, 4)
    t = {"wq": _normal(ks[0], (d, h, hd), dtype, device),
         "wk": _normal(ks[1], (d, hk, hd), dtype, device),
         "wv": _normal(ks[2], (d, hk, hd), dtype, device),
         "wo": _normal(ks[3], (h, hd, d), dtype, device)}
    if cfg.attn_bias:
        for name, heads in (("bq", h), ("bk", hk), ("bv", hk)):
            t[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return Params(**t)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``: one matmul over the flattened
    heads."""
    d, h, k = w.shape
    y = matmul(x, reshape(w, (d, h * k)))
    return reshape(y, tuple(y.shape[:-1]) + (h, k))


def _attend(q, k, v, attn_impl: str) -> torch.Tensor:
    """Causal attention over (B, S, H, hd) q and (B, S, Hk, hd) k/v; on
    DTensors, on each rank's shard (:func:`_attend_sharded`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _attend_sharded(q, k, v, attn_impl)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
    if attn_impl == "cuda":
        out = flash_attention(qh, kh, vh, causal=True)
    elif attn_impl == "ref":
        out = attention_ref(qh, kh, vh, causal=True)
    elif attn_impl == "chunked":
        out = chunked_attention(qh, kh, vh, causal=True)
    else:
        raise ValueError(f"unknown attention impl {attn_impl!r}; the port "
                         f"takes {ATTN_IMPLS}")
    return out.transpose(1, 2)                            # (B, S, H, hd)


def _attend_sharded(q, k, v, attn_impl: str):
    """:func:`_attend` on DTensors: the attention runs on each rank's
    local shard through ``local_map`` (so B8 launches unchanged on a
    card's shard), which attention allows since it is independent over
    batch and heads.  q keeps its batch shards and its head shards on one
    mesh dim, k/v the same batch shards; the sequence and head dim are
    whole on every rank (an all-gather where they were not).  Where q's
    heads are sharded and k/v's cannot be (fewer kv heads than ranks), k/v
    are whole on that mesh dim and each rank takes the kv heads of its q
    heads from its global head offset (GQA: q head h reads kv head h //
    group), their gradients summed over the dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, Hk = q.shape[2], k.shape[2]
    group = H // Hk
    qp, kp, kgrad = [], [], []
    head_dim = None          # the mesh dim sharding q's heads
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(p)
            kp.append(p)
            kgrad.append(p)
        elif isinstance(p, Shard) and p.dim == 2 and head_dim is None:
            head_dim = i
            qp.append(p)
            whole = Hk % mesh.size(i) != 0
            kp.append(Replicate() if whole else p)
            kgrad.append(Partial() if whole else p)
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    offset = None
    if head_dim is not None and isinstance(kp[head_dim], Replicate):
        offset = mesh.get_local_rank(head_dim) * (H // mesh.size(head_dim))

    def local(ql, kl, vl):
        if offset is not None:       # a kv head for each local q head
            idx = (offset + torch.arange(ql.shape[2], device=kl.device)) \
                // group
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return _attend(ql, kl, vl, attn_impl)

    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kgrad, kgrad),
                     device_mesh=mesh)(q, k, v)


def attention(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions,
    cache: Optional[Dict] = None, *, attn_impl: str = "ref",
    constrain: Constrain = _identity,
):
    """GQA attention.  x (B, S, D).

    ``cache``: None without serving; {"k": (B, Smax, Hk, hd), "v": ...,
    "len": (B,) int32} for serving.  Prefill (S > 1) zeroes the cache and
    writes positions [0, S); decode (S == 1) writes at ``len``, clamped to
    ``Smax - 1`` as the reference's ``dynamic_update_slice`` clamps.  Both
    write the cache's tensors in place (the reference returns new arrays;
    the port saves the copy) and return the cache with the new ``len``.
    Returns (out, new_cache).
    """
    B, S, D = x.shape
    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if cfg.attn_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = constrain(q, "heads")
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)

    new_cache = None
    if cache is None:
        out = _attend(q, k, v, attn_impl)
    elif S == 1:   # decode: append and attend over the whole cache
        idx = cache["len"]                                  # (B,)
        ck, cv = cache["k"], cache["v"]
        _append(ck, k[:, 0], idx)
        _append(cv, v[:, 0], idx)
        new_cache = {"k": ck, "v": cv, "len": idx + 1}
        out = _decode_attend(q, ck, cv, idx + 1, constrain)
    else:          # prefill: a zero cache holding [0, S)
        ck, cv = cache["k"], cache["v"]
        _fill(ck, k)
        _fill(cv, v)
        new_cache = {"k": ck, "v": cv,
                     "len": torch.full_like(cache["len"], S)}
        out = _attend(q, k, v, attn_impl)
    out = constrain(out, "heads")
    h, hd, d = p.wo.shape
    return matmul(reshape(out, (B, S, h * hd)),
                  reshape(p.wo, (h * hd, d))), new_cache


def _decode_attend(q, ck, cv, kv_len, constrain: Constrain = _identity,
                   *, lo: int = 0, groups=()):
    """Single-token attention over the KV cache, as the reference's
    ``_decode_attend``: f32 scores from the cache's dtype (exact products,
    f32 sums), masked softmax numerators rounded to the cache's dtype before
    the ``P·V`` product, f32 accumulation.  On a DTensor cache, on each
    rank's shard (:func:`_decode_attend_sharded`).

    q (B, 1, H, hd); ck/cv (B, Smax, Hk, hd); kv_len (B,).  ``ck``/``cv``
    may be a slice of the sequence starting at slot ``lo``, the rest held
    by the ranks of ``groups`` (process groups): the softmax's max, then
    its numerator and denominator, are all-reduced over them, so every
    slot's numerator is the one the whole cache gives.
    """
    from torch.distributed.tensor import DTensor
    if isinstance(ck, DTensor):
        return _decode_attend_sharded(q, ck, cv, kv_len)
    B, Smax, Hk, hd = ck.shape
    H = q.shape[2]
    group = H // Hk
    qg = q.reshape(B, 1, Hk, group, hd)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                     ck.float()) / (hd ** 0.5)
    mask = (lo + torch.arange(Smax, device=ck.device)
            < kv_len[:, None])[:, None, None, None, :]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True) if Smax else \
        s.new_full(s.shape[:-1] + (1,), -1e30)
    for g in groups:
        dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    num = torch.einsum("bhgqs,bshd->bqhgd", e.to(cv.dtype).float(),
                       cv.float())
    den = e.sum(dim=-1)[..., None].permute(0, 3, 1, 2, 4)
    if groups:                  # one all-reduce of [num | den] a group
        both = torch.cat([num, den], -1)
        for g in groups:
            dist.all_reduce(both, group=g)
        num, den = both[..., :-1], both[..., -1:]
    out = num / den.clamp_min(1e-30)
    return out.reshape(B, 1, H, cv.shape[-1]).to(q.dtype)


def _decode_attend_sharded(q, ck, cv, kv_len):
    """:func:`_decode_attend` on DTensors through ``local_map``, as GSPMD
    splits the softmax over a sharded sequence: the cache keeps its batch
    shards and its sequence shards (the plan's ``cache_specs`` put the
    sequence over ``model``), q and ``kv_len`` come to the same batch
    shards whole along the rest, and each rank attends over the slots it
    holds, the softmax's statistics all-reduced over the mesh dims that
    shard the sequence (the cache itself never moves).  Any other shard
    of the cache (its heads) is gathered first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ck.device_mesh
    cp = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
          for p in ck.placements]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cp]
    groups = [mesh.get_group(i) for i, p in enumerate(cp)
              if isinstance(p, Shard) and p.dim == 1]
    lo = shard_offset(ck.shape, mesh, cp, 1)

    def local(ql, kl, vl, nl):
        return _decode_attend(ql, kl, vl, nl, lo=lo, groups=groups)

    return local_map(local, out_placements=rows,
                     in_placements=(rows, cp, cp, rows), device_mesh=mesh)(
        on_mesh(q, mesh, rows), on_mesh(ck, mesh, cp), on_mesh(cv, mesh, cp),
        on_mesh(kv_len, mesh, rows))


def _append(cache_t: torch.Tensor, row: torch.Tensor,
            idx: torch.Tensor) -> None:
    """Write ``row`` (B, ...) at slot ``idx`` (B,) of ``cache_t`` (B, Smax,
    ...), in place, the slot clamped to ``Smax - 1`` as the reference's
    ``dynamic_update_slice`` clamps."""
    from torch.distributed.tensor import DTensor
    if isinstance(cache_t, DTensor):
        return _write_sharded(cache_t, row[:, None], idx)
    at = idx.clamp(0, cache_t.shape[1] - 1).long()
    cache_t[torch.arange(cache_t.shape[0], device=cache_t.device), at] = row


def _fill(cache_t: torch.Tensor, rows: torch.Tensor) -> None:
    """A prefill's write: ``cache_t`` (B, Smax, ...) zeroed, ``rows`` (B,
    S, ...) in its slots [0, S), in place."""
    from torch.distributed.tensor import DTensor
    cache_t.zero_()
    if isinstance(cache_t, DTensor):
        return _write_sharded(cache_t, rows, None)
    cache_t[:, :rows.shape[1]] = rows


def _write_sharded(cache_t, rows, idx) -> None:
    """:func:`_fill` (``idx`` None: slots [0, n)) or :func:`_append`
    (slot ``idx`` (B,), n = 1) into a DTensor cache, in place on each
    rank's shard, as GSPMD writes a ``dynamic_update_slice`` into a
    sharded operand: ``rows`` (B, n, ...) and ``idx`` are brought to the
    cache's batch placements, whole along the sequence, and each rank
    writes the slots its shard of the sequence holds."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_t.device_mesh
    cp = list(cache_t.placements)
    rows = on_mesh(rows, mesh, [Replicate() if isinstance(p, Shard)
                                and p.dim == 1 else p
                                for p in cp]).to_local()
    local = cache_t.to_local()
    lo, n = shard_offset(cache_t.shape, mesh, cp, 1), local.shape[1]
    if idx is None:
        a, b = max(lo, 0), min(lo + n, rows.shape[1])
        if a < b:
            local[:, a - lo:b - lo] = rows[:, a:b]
        return
    at = on_mesh(idx, mesh, [p if isinstance(p, Shard) and p.dim == 0
                             else Replicate() for p in cp]).to_local()
    at = at.clamp(0, cache_t.shape[1] - 1).long() - lo
    mine = ((at >= 0) & (at < n)).reshape((-1,) + (1,) * (local.dim() - 2))
    slot = at.clamp(0, n - 1)
    rows_b = torch.arange(local.shape[0], device=local.device)
    local[rows_b, slot] = torch.where(mine, rows[:, 0], local[rows_b, slot])


# -- multi-head latent attention (MiniCPM3 / DeepSeek-style MLA) -------------

def init_mla(key, cfg: ArchConfig, dtype, device=None) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    ks = _split(key, 6)
    return Params(
        wdq=_normal(ks[0], (d, cfg.q_lora_rank), dtype, device),
        wuq=_normal(ks[1], (cfg.q_lora_rank, h, qk_head), dtype, device),
        wdkv=_normal(ks[2], (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                     dtype, device),
        wuk=_normal(ks[3], (cfg.kv_lora_rank, h, cfg.qk_nope_head_dim),
                    dtype, device),
        wuv=_normal(ks[4], (cfg.kv_lora_rank, h, cfg.v_head_dim), dtype,
                    device),
        wo=_normal(ks[5], (h, cfg.v_head_dim, d), dtype, device),
        q_norm=torch.ones((cfg.q_lora_rank,), dtype=dtype, device=device),
        kv_norm=torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=device))


def mla(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions,
    cache: Optional[Dict] = None, *, attn_impl: str = "ref",
    constrain: Constrain = _identity,
):
    """MLA: queries and keys split into nope and rope parts, K/V compressed
    into a ``kv_lora_rank`` latent.  The cache holds the latent ``ckv``
    (B, Smax, rank) and the shared rope key ``k_rope`` (B, Smax, 1, dr)
    with ``len`` (B,); decode writes both at ``len`` in place and expands
    the whole cache into keys and values every step.  Returns (out,
    new_cache)."""
    B, S, D = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rank, eps = cfg.kv_lora_rank, cfg.norm_eps

    cq = _rms(matmul(x, p.wdq), p.q_norm, eps)
    q = _project(cq, p.wuq)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = _apply_rope(cfg, q_rope, positions)

    ckv_full = matmul(x, p.wdkv)                          # (B, S, rank+dr)
    ckv = _rms(ckv_full[..., :rank], p.kv_norm, eps)
    k_rope = _apply_rope(cfg, ckv_full[..., rank:][:, :, None, :],
                         positions)                       # (B, S, 1, dr)

    def expand(ckv, k_rope):
        k_nope = _project(ckv, p.wuk)
        v = _project(ckv, p.wuv)
        k = torch.cat([k_nope, k_rope.expand(k_nope.shape[:3] + (dr,))],
                      dim=-1)
        return k, v

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    new_cache = None
    if cache is None:
        k, v = expand(ckv, k_rope)
        # B8 takes one head dim for q, k and v
        out = _attend(q_full, k, v, "ref" if attn_impl == "cuda"
                      and dn + dr != dv else attn_impl)
    elif S == 1:
        idx = cache["len"]
        cc, cr = cache["ckv"], cache["k_rope"]
        _append(cc, ckv[:, 0], idx)
        _append(cr, k_rope[:, 0], idx)
        new_cache = {"ckv": cc, "k_rope": cr, "len": idx + 1}
        k, v = expand(cc, cr)
        out = _decode_attend(q_full, k, v, idx + 1)
    else:
        cc, cr = cache["ckv"], cache["k_rope"]
        _fill(cc, ckv)
        _fill(cr, k_rope)
        new_cache = {"ckv": cc, "k_rope": cr,
                     "len": torch.full_like(cache["len"], S)}
        k, v = expand(ckv, k_rope)
        # the reference's prefill with a cache is always the plain one
        out = _attend(q_full, k, v, "ref")
    out = constrain(out, "heads_v")
    h, hv, d = p.wo.shape
    return matmul(reshape(out, (B, S, h * hv)),
                  reshape(p.wo, (h * hv, d))), new_cache


# -- MLPs ---------------------------------------------------------------------

def init_mlp(key, d: int, ff: int, dtype, act: str = "silu",
             device=None) -> Params:
    ks = _split(key, 3)
    if act == "silu":   # SwiGLU
        return Params(wg=_normal(ks[0], (d, ff), dtype, device),
                      wu=_normal(ks[1], (d, ff), dtype, device),
                      wd=_normal(ks[2], (ff, d), dtype, device))
    return Params(wu=_normal(ks[1], (d, ff), dtype, device),
                  wd=_normal(ks[2], (ff, d), dtype, device))


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if act == "silu":
        return matmul(F.silu(matmul(x, p.wg)) * matmul(x, p.wu), p.wd)
    # jax.nn.gelu's default is the tanh approximation
    return matmul(F.gelu(matmul(x, p.wu), approximate="tanh"), p.wd)
