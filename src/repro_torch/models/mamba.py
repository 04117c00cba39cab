"""Mamba (selective SSM) mixer, the state-space half of Jamba (the port of
the JAX package's ``repro.models.mamba``).

The recurrence (diagonal A), per channel and state:

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + Δ_t ⊙ B_t · x_t
    y_t = C_t · h_t + D ⊙ x_t

A prefill runs it over chunks of ``chunk`` (256) steps: each chunk's
decays and inputs ``(B, c, din, N)`` are formed and composed by an
associative scan (:func:`_prefix`, log2(chunk) doubling steps, as the
reference scans each chunk with ``lax.associative_scan``; it pads the
last chunk with steps of decay 1 and input 0, which change nothing),
applied to the carried state, and only the chunk's outputs leave it, so
memory is O(B·chunk·din·N) whatever the sequence length.  Decode is the
one-step update on the carried ``(conv, ssm)`` cache: the causal
depthwise conv's last ``d_conv - 1`` inputs and the f32 state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding.placement import matmul, on_mesh
from .layers import Params, _identity, _normal, _split

__all__ = ["init_mamba", "mamba", "init_mamba_cache"]


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.mamba_dt_rank or -(-cfg.d_model // 16)


def init_mamba(key, cfg: ArchConfig, dtype, device=None) -> Params:
    d = cfg.d_model
    din = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    r = _dt_rank(cfg)
    ks = _split(key, 6)
    # S4D-real A (negative reals), stored as log
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device).expand(din, n)
    return Params(
        in_proj=_normal(ks[0], (d, 2 * din), dtype, device),
        conv_w=_normal(ks[1], (cfg.mamba_d_conv, din), dtype, device,
                       scale=0.1),
        conv_b=torch.zeros((din,), dtype=dtype, device=device),
        x_proj=_normal(ks[2], (din, r + 2 * n), dtype, device),
        dt_proj_w=_normal(ks[3], (r, din), dtype, device, scale=r ** -0.5),
        dt_proj_b=torch.full((din,), -4.6, dtype=dtype, device=device),
        a_log=torch.log(a).contiguous(),
        d_skip=torch.ones((din,), dtype=torch.float32, device=device),
        out_proj=_normal(ks[4], (din, d), dtype, device))


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    din = cfg.mamba_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, din),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, din, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}


def _prefix(a, b):
    """The inclusive prefix compositions of ``h_t = a_t·h_{t-1} + b_t``
    along dim 1: ``(A_t, B_t)`` with ``h_t = A_t·h_0 + B_t``, in log2(c)
    doubling steps (Hillis-Steele; the reference's
    ``lax.associative_scan`` composes the same pairs, in another tree)."""
    c, d = a.shape[1], 1
    while d < c:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return a, b


def _scan(dt, xf, bmat, cmat, a, h, chunk: int):
    """Run the recurrence over ``S`` steps from state ``h`` (B, din, N):
    dt, xf (B, S, din), bmat, cmat (B, S, N) f32; a (din, N).  Returns
    (y (B, S, din) without the skip term, the last state).  On DTensors,
    on each rank's shard (:func:`_scan_sharded`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(dt, DTensor):
        return _scan_sharded(dt, xf, bmat, cmat, a, h, chunk)
    S = dt.shape[1]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        da = torch.exp(dt[:, sl, :, None] * a)               # (B, c, din, N)
        db = (dt[:, sl] * xf[:, sl])[..., None] * bmat[:, sl, None, :]
        aa, bb = _prefix(da, db)
        hs = aa * h[:, None] + bb                            # every step's h
        h = hs[:, -1]
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cmat[:, sl]))
    return torch.cat(ys, 1), h


def _conv(xs, w, b, prev):
    """The causal depthwise conv of ``xs`` (B, S, din) by ``w`` (d_conv,
    din) and ``b``, its inputs before the first step ``prev`` (B, d_conv -
    1, din) or zeros: (silu(conv + b), the last d_conv - 1 inputs)."""
    S, k = xs.shape[1], w.shape[0]
    conv_in = F.pad(xs, (0, 0, k - 1, 0)) if prev is None \
        else torch.cat([prev.to(xs.dtype), xs], 1)
    xc = conv_in[:, 0:S] * w[0]
    for i in range(1, k):
        xc = xc + conv_in[:, i:i + S] * w[i]
    return F.silu(xc + b), conv_in[:, conv_in.shape[1] - (k - 1):]


def _causal_conv(xs, w, b, prev=None):
    """:func:`_conv`; on DTensors, on each rank's batch and channel shards
    through ``local_map`` (the conv is independent over both; on torch
    2.11 DTensor's pad and slices of a sequence left a tensor whose
    matmul it could not place), ``w``'s and ``b``'s gradients summed over
    the batch shards."""
    from torch.distributed.tensor import DTensor
    if not isinstance(xs, DTensor):
        return _conv(xs, w, b, prev)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs.device_mesh
    xp, wp, bp, wg = [], [], [], []
    for p in xs.placements:
        if isinstance(p, Shard) and p.dim == 0:          # batch
            xp.append(p), wp.append(Replicate()), bp.append(Replicate())
            wg.append(Partial())
        elif isinstance(p, Shard) and p.dim == 2:        # channels
            xp.append(p), wp.append(Shard(1)), bp.append(Shard(0))
            wg.append(None)
        else:
            for lst in (xp, wp, bp, wg):
                lst.append(Replicate())
    bg = [Shard(0) if g is None else g for g in wg]
    wg = [Shard(1) if g is None else g for g in wg]
    ins = [on_mesh(xs, mesh, xp), on_mesh(w, mesh, wp), on_mesh(b, mesh, bp)]
    if prev is None:
        return local_map(lambda xl, wl, bl: _conv(xl, wl, bl, None),
                         out_placements=(xp, xp), in_placements=(xp, wp, bp),
                         in_grad_placements=(xp, wg, bg),
                         device_mesh=mesh)(*ins)
    return local_map(_conv, out_placements=(xp, xp),
                     in_placements=(xp, wp, bp, xp), device_mesh=mesh)(
        *ins, on_mesh(prev, mesh, xp))


def _scan_sharded(dt, xf, bmat, cmat, a, h, chunk: int):
    """:func:`_scan` on DTensors through ``local_map``: the recurrence is
    independent over batch and channels, so each rank steps its batch and
    channel shards, with ``B``/``C`` whole along the state (their
    gradients summed over the channel shards, ``a``'s over the batch
    shards).  DTensor's einsum over a chunk would merge the batch and
    sequence shards into a strided shard, whose offsets it reads from a
    tensor: no value on the dry run's fake tensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = dt.device_mesh
    xp, np_, ng, ap, ag, hp = [], [], [], [], [], []
    for p in dt.placements:
        if isinstance(p, Shard) and p.dim == 0:          # batch
            xp.append(p), np_.append(Shard(0)), ng.append(Shard(0))
            ap.append(Replicate()), ag.append(Partial()), hp.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2:        # channels
            xp.append(p), np_.append(Replicate()), ng.append(Partial())
            ap.append(Shard(0)), ag.append(Shard(0)), hp.append(Shard(1))
        else:
            for lst in (xp, np_, ng, ap, ag, hp):
                lst.append(Replicate())

    def local(dtl, xl, bl, cl, al, hl):
        return _scan(dtl, xl, bl, cl, al, hl, chunk)

    return local_map(local, out_placements=(xp, hp),
                     in_placements=(xp, xp, np_, np_, ap, hp),
                     in_grad_placements=(xp, xp, ng, ng, ag, hp),
                     device_mesh=mesh)(
        on_mesh(dt, mesh, xp), on_mesh(xf, mesh, xp),
        on_mesh(bmat, mesh, np_), on_mesh(cmat, mesh, np_),
        on_mesh(a, mesh, ap), on_mesh(h, mesh, hp))


def mamba(
    p: Params, cfg: ArchConfig, x: torch.Tensor,
    cache: Optional[Dict] = None, *, chunk: int = 256,
    constrain=_identity,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, D) -> (y (B, S, D), new_cache).  A prefill with a cache
    takes the conv inputs from it and starts the scan from a zero state,
    as the reference does."""
    B, S, D = x.shape
    n, r = cfg.mamba_d_state, _dt_rank(cfg)

    xs, z = matmul(x, p.in_proj).chunk(2, dim=-1)      # (B, S, din) each
    xs = constrain(xs, "mamba_inner")

    xc, conv_tail = _causal_conv(xs, p.conv_w, p.conv_b,
                                 None if cache is None else cache["conv"])

    proj = matmul(xc, p.x_proj)                         # (B, S, r+2n)
    dt = F.softplus(matmul(proj[..., :r], p.dt_proj_w)
                    + p.dt_proj_b).float()
    bmat = proj[..., r:r + n].float()
    cmat = proj[..., r + n:].float()
    a = -torch.exp(p.a_log)                             # (din, n)
    xf = xc.float()

    if cache is None or S > 1:
        h0 = xf.new_zeros((B, xf.shape[-1], n))
        y, h_last = _scan(dt, xf, bmat, cmat, a, h0, chunk)
    else:
        da = torch.exp(dt[:, 0, :, None] * a)
        db = (dt[:, 0] * xf[:, 0])[..., None] * bmat[:, 0, None, :]
        h_last = da * cache["ssm"] + db
        y = torch.einsum("bdn,bn->bd", h_last, cmat[:, 0])[:, None]

    y = y + xf * p.d_skip
    y = y.to(x.dtype) * F.silu(z)
    out = matmul(y, p.out_proj)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": conv_tail, "ssm": h_last}
    return out, new_cache
