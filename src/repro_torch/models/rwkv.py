"""RWKV-6 (Finch) block: data-dependent-decay linear attention (the port of
the JAX package's ``repro.models.rwkv``).

Time mixing runs the WKV6 recurrence per ``rwkv_head_size``-wide head

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

with data-dependent ``w_t`` (token shift + LoRA).  A prefill runs it in
chunks of ``chunk`` (64) steps in log space (within a chunk the pairwise
decay ``exp(Λ_{t-1} - Λ_s)``, s < t, is at most 1), the state carried from
chunk to chunk; a prefill with a cache returns that final state.  Decode
is the recurrent step with the bonus ``u``.  Channel mixing is the
squared-ReLU gated FFN with its own token shift.  The cache holds the two
token-shift rows (``tm_shift``, ``cm_shift``) and the f32 state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding.placement import matmul, on_mesh, reshape
from .layers import Params, _identity, _normal, _rms, _split

__all__ = ["init_rwkv_block", "rwkv_block", "init_rwkv_cache"]

_LORA = 32          # token-shift mixer LoRA dim
_DECAY_LORA = 64


def init_rwkv_block(key, cfg: ArchConfig, dtype, device=None) -> Params:
    d, ff, hs = cfg.d_model, cfg.d_ff, cfg.rwkv_head_size
    ks = _split(key, 14)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return Params(
        # time mixing
        maa_x=zeros(d), maa_rkvwg=zeros(5, d),
        maa_w1=_normal(ks[0], (d, 5 * _LORA), dtype, device),
        maa_w2=_normal(ks[1], (5, _LORA, d), dtype, device),
        decay=torch.full((d,), -4.0, dtype=torch.float32, device=device),
        decay_w1=_normal(ks[2], (d, _DECAY_LORA), dtype, device),
        decay_w2=_normal(ks[3], (_DECAY_LORA, d), dtype, device),
        bonus=zeros(d // hs, hs, dt=torch.float32),          # u, per head
        wr=_normal(ks[4], (d, d), dtype, device),
        wk=_normal(ks[5], (d, d), dtype, device),
        wv=_normal(ks[6], (d, d), dtype, device),
        wg=_normal(ks[7], (d, d), dtype, device),
        wo=_normal(ks[8], (d, d), dtype, device),
        ln_x=ones(d),
        # channel mixing
        cm_maa_k=zeros(d), cm_maa_r=zeros(d),
        cm_wk=_normal(ks[9], (d, ff), dtype, device),
        cm_wv=_normal(ks[10], (ff, d), dtype, device),
        cm_wr=_normal(ks[11], (d, d), dtype, device),
        # the two norms before time and channel mixing
        ln1=ones(d), ln2=ones(d))


def init_rwkv_cache(cfg: ArchConfig, batch: int, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return {"tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "state": torch.zeros((batch, d // hs, hs, hs),
                                 dtype=torch.float32, device=device)}


def _token_shift(x: torch.Tensor, shift: Optional[torch.Tensor]):
    """x (B, S, D) -> x_{t-1}; position 0 takes ``shift`` (or zeros)."""
    prev = torch.zeros_like(x[:, :1]) if shift is None \
        else shift[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, w, u, chunk: int):
    """WKV6 over whole sequences from a zero state.  r, k, v (B, S, H, hs);
    w (B, S, H, hs) in (0, 1); u (H, hs).  Returns y (B, S, H, hs) f32 and
    the final state (B, H, hs, hs).  On DTensors, on each rank's shard
    (:func:`_wkv_sharded`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(r, DTensor):
        return _wkv_sharded(r, k, v, w, u, chunk)
    B, S, H, hs = r.shape
    c = min(chunk, S)
    S_pad = -(-S // c) * c
    nc = S_pad // c

    def blocks(t, fill=0.0):     # (B, S, H, hs) -> (nc, B, H, c, hs) f32
        t = F.pad(t.float(), (0, 0, 0, 0, 0, S_pad - S), value=fill)
        return t.view(B, nc, c, H, hs).permute(1, 0, 3, 2, 4)

    rf, kf, vf = blocks(r), blocks(k), blocks(v)
    logw = torch.log(blocks(w, 1.0).clamp_min(1e-38))
    lam = logw.cumsum(dim=3)                             # Λ_t (inclusive)
    tri_low = torch.ones((c, c), device=r.device).tril(-1)   # s < t

    state = r.new_zeros((B, H, hs, hs), dtype=torch.float32)
    ys = []
    for i in range(nc):
        rr, kk, vv, ll, lw = rf[i], kf[i], vf[i], lam[i], logw[i]
        lam_prev = ll - lw                               # Λ_{t-1}
        # pairwise stable decay exp(Λ_{t-1} - Λ_s) for s < t (<= 1)
        e = torch.exp(torch.clamp_max(
            lam_prev[:, :, :, None, :] - ll[:, :, None, :, :], 0.0))
        a = torch.einsum("bhti,bhtsi,bhsi->bhts", rr, e, kk) * tri_low
        diag = (rr * kk * u[None, :, None, :]).sum(-1)   # r_t·(u ⊙ k_t)
        y = torch.einsum("bhts,bhsj->bhtj", a, vv) + diag[..., None] * vv
        # the inbound state's contribution
        y = y + torch.einsum("bhti,bhij->bhtj", rr * torch.exp(lam_prev),
                             state)
        # S' = diag(exp(Λ_c)) S + Σ_s exp(Λ_c - Λ_s) k_s v_sᵀ
        carry_k = kk * torch.exp(ll[:, :, -1:, :] - ll)
        state = state * torch.exp(ll[:, :, -1, :])[..., None] + torch.einsum(
            "bhsi,bhsj->bhij", carry_k, vv)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S_pad, H, hs)
    return y[:, :S], state


def _head_placements(r):
    """The placements of :func:`_wkv_sharded` and of the recurrent step's
    local map, from r's (B, S, H, hs): (r/k/v/w's, u's, u's gradient's,
    the state's)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    xp, up, ug, sp = [], [], [], []
    for p in r.placements:
        if isinstance(p, Shard) and p.dim == 0:          # batch
            xp.append(p), up.append(Replicate()), ug.append(Partial())
            sp.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2:        # heads
            xp.append(p), up.append(Shard(0)), ug.append(Shard(0))
            sp.append(Shard(1))
        else:
            xp.append(Replicate()), up.append(Replicate())
            ug.append(Replicate()), sp.append(Replicate())
    return xp, up, ug, sp


def _wkv_sharded(r, k, v, w, u, chunk: int):
    """:func:`_wkv_chunked` on DTensors through ``local_map``: the WKV is
    independent over batch and heads, so each rank runs it on its batch
    and head shards, the sequence and head size whole (DTensor's einsums
    over the chunks would merge the batch and head shards into a strided
    shard, whose offsets it reads from a tensor: no value on the dry
    run's fake tensors).  ``u``'s gradient is summed over the batch
    shards."""
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    xp, up, ug, sp = _head_placements(r)

    def local(rl, kl, vl, wl, ul):
        return _wkv_chunked(rl, kl, vl, wl, ul, chunk)

    return local_map(local, out_placements=(xp, sp),
                     in_placements=(xp, xp, xp, xp, up),
                     in_grad_placements=(xp, xp, xp, xp, ug),
                     device_mesh=mesh)(
        *(on_mesh(t, mesh, xp) for t in (r, k, v, w)), on_mesh(u, mesh, up))


def _wkv_recurrent(r, k, v, w, u, state):
    """One decode step.  r, k, v, w (B, 1, H, hs); state (B, H, hs, hs)
    f32.  On DTensors, on each rank's batch and head shards through
    ``local_map`` (torch 2.11's DTensor cannot flatten the batch and head
    shards its einsum merges)."""
    from torch.distributed.tensor import DTensor
    if isinstance(r, DTensor):
        from torch.distributed.tensor.experimental import local_map
        mesh = r.device_mesh
        xp, up, _, sp = _head_placements(r)
        return local_map(_wkv_step, out_placements=(xp, sp),
                         in_placements=(xp, xp, xp, xp, up, sp),
                         device_mesh=mesh)(
            *(on_mesh(t, mesh, xp) for t in (r, k, v, w)),
            on_mesh(u, mesh, up), on_mesh(state, mesh, sp))
    return _wkv_step(r, k, v, w, u, state)


def _wkv_step(r, k, v, w, u, state):
    rf, kf, vf, wf = (t[:, 0].float() for t in (r, k, v, w))
    at = kf[..., :, None] * vf[..., None, :]             # (B, H, hs, hs)
    y = torch.einsum("bhi,bhij->bhj", rf, state + u[..., None] * at)
    return y[:, None], state * wf[..., None] + at


def rwkv_block(
    p: Params, cfg: ArchConfig, x: torch.Tensor,
    cache: Optional[Dict] = None, *, chunk: int = 64,
    constrain=_identity,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The whole RWKV6 block (time mix, then channel mix).  x (B, S, D).
    Returns (out, new_cache); a prefill with a cache shifts in its
    ``tm_shift``/``cm_shift`` rows and starts the WKV from a zero state,
    as the reference does."""
    B, S, D = x.shape
    hs = cfg.rwkv_head_size
    H = D // hs
    eps = cfg.norm_eps

    # ---- time mixing ----
    xn = _rms(x, p.ln1, eps)
    xx = _token_shift(xn, None if cache is None else cache["tm_shift"]) - xn
    mix = xn + xx * p.maa_x
    # on a mesh the LoRA dim is made whole where DTensor cannot split its
    # shards in five (and its gradient where it cannot merge them back)
    lora = reshape(torch.tanh(matmul(mix, p.maa_w1)), (B, S, 5, _LORA))
    deltas = torch.einsum("bsfl,fld->fbsd", lora, p.maa_w2)
    xr, xk, xv, xw, xg = (xn + xx * (p.maa_rkvwg[i] + deltas[i])
                          for i in range(5))

    r = constrain(matmul(xr, p.wr).view(B, S, H, hs), "heads")
    k = matmul(xk, p.wk).view(B, S, H, hs)
    v = matmul(xv, p.wv).view(B, S, H, hs)
    g = F.silu(matmul(xg, p.wg))
    dlog = p.decay + matmul(torch.tanh(matmul(xw, p.decay_w1)),
                            p.decay_w2).float()
    w = torch.exp(-torch.exp(dlog)).view(B, S, H, hs)    # in (0, 1)

    new_cache = None
    if cache is not None and S == 1:
        y, state = _wkv_recurrent(r, k, v, w, p.bonus, cache["state"])
    else:
        y, state = _wkv_chunked(r, k, v, w, p.bonus, chunk)

    y = y.reshape(B, S, D).to(x.dtype)
    y = _rms(y, p.ln_x, eps) * g
    x = x + matmul(y, p.wo)

    # ---- channel mixing ----
    xn2 = _rms(x, p.ln2, eps)
    xx2 = _token_shift(xn2, None if cache is None
                       else cache["cm_shift"]) - xn2
    xk2 = xn2 + xx2 * p.cm_maa_k
    xr2 = xn2 + xx2 * p.cm_maa_r
    kk = torch.square(torch.relu(matmul(xk2, p.cm_wk)))
    out = x + torch.sigmoid(matmul(xr2, p.cm_wr)) * matmul(kk, p.cm_wv)

    if cache is not None:
        new_cache = {"state": state, "tm_shift": xn[:, -1],
                     "cm_shift": xn2[:, -1]}
    return out, new_cache
