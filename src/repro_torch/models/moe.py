"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch (the
port of the JAX package's ``repro.models.moe``).

The reference dispatches through one-hot ``(tokens, experts, capacity)``
tensors and einsums.  The port computes the same function with gathers and
scatters: each kept (token, k) pair owns one slot ``expert · C + position``
of a ``(E·C, D)`` buffer, the experts run as one ``torch.bmm`` over the
expert axis, and each token gathers its K outputs back.  What is kept is
the reference's:

* router logits in the model dtype, probabilities and top-k in f32, ties
  to the lower expert index (as ``lax.top_k``; a stable sort);
* a pair's position in its expert's buffer counts the earlier pairs in
  token-major, then-k order; pairs at or past the capacity ``C`` are
  dropped and counted in ``drop_frac``;
* tokens run in chunks of ``token_chunk`` (4096), the capacity
  ``C = ceil(Tc·K·capacity_factor/E)`` per chunk (``C = Tc`` under
  ``exact``, the decode path: no drops), the last chunk padded with zero
  rows, which take capacity and count in ``drop_frac`` as in the
  reference;
* gates rounded to the model dtype before the combine; expert GEMMs on
  model-dtype operands accumulated in f32 (operands widened to f32, whose
  products of bf16 values are exact), ``silu(hg)·hu`` in f32, then cast;
* padded experts (``expert_pad_multiple``) hold weights but never receive
  a token, so they are not run;
* the always-on shared expert (Qwen2-MoE) is a dense MLP beside them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import Params, _identity, _normal, _split, init_mlp, mlp

__all__ = ["init_moe", "moe_layer", "route", "positions", "padded_experts",
           "mean", "TOKEN_CHUNK"]

#: tokens a chunk of the MoE dispatch, as the reference's default
TOKEN_CHUNK = 4096


def mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.mean`` as the reference's statistics round it: the f32 sum
    times the f32 reciprocal of the count (not a division)."""
    n = x.numel() if dim is None else x.shape[dim]
    total = x.float().sum() if dim is None else x.float().sum(dim)
    return total * (torch.ones((), device=x.device) / n)


def padded_experts(cfg: ArchConfig) -> int:
    e, m = cfg.num_experts, cfg.expert_pad_multiple
    return e if m <= 0 else -(-e // m) * m


def init_moe(key, cfg: ArchConfig, dtype, device=None) -> Params:
    d, ff = cfg.d_model, cfg.moe_d_ff
    e = padded_experts(cfg)
    ks = _split(key, 5)
    t = {"router": _normal(ks[0], (d, cfg.num_experts), dtype, device),
         "wg": _normal(ks[1], (e, d, ff), dtype, device),
         "wu": _normal(ks[2], (e, d, ff), dtype, device),
         "wd": _normal(ks[3], (e, ff, d), dtype, device)}
    if cfg.shared_expert_d_ff:
        t["shared"] = init_mlp(ks[4], d, cfg.shared_expert_d_ff, dtype,
                               cfg.mlp_act, device)
    return Params(**t)


def positions(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, k) pair's position in its expert's buffer: the number
    of pairs before it, token-major then k, that picked the same expert.
    idx (T, K) -> (T, K) int32."""
    flat = idx.reshape(1, -1)
    # (E, T·K): the scan runs along each expert's row
    onehot = F.one_hot(flat[0], num_experts).to(torch.int32).t().contiguous()
    return (onehot.cumsum(1, dtype=torch.int32) - onehot).gather(
        0, flat).reshape(idx.shape)


def route(p: Params, cfg: ArchConfig, xt: torch.Tensor, C: int):
    """The routing of one chunk ``xt`` (T, D) at capacity ``C``: (gates
    (T, K) f32, expert ids (T, K), buffer positions (T, K), kept (T, K)
    bool, probabilities (T, E) f32)."""
    K = cfg.num_experts_per_tok
    probs = torch.softmax((xt @ p.router).float(), dim=-1)    # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :K], idx[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    pos = positions(idx, probs.shape[-1])
    return gates, idx, pos, pos < C, probs


def _route_chunk(p: Params, cfg: ArchConfig, xt: torch.Tensor, C: int,
                 constrain):
    """Dispatch, compute and combine one chunk ``xt`` (T, D).  Returns
    (out (T, D), load-balance loss, drop fraction)."""
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    dt = xt.dtype
    gates, idx, pos, keep, probs = route(p, cfg, xt, C)
    dropped = 1.0 - mean(keep)

    # slot of each kept pair; dropped pairs go to the spare row E·C (no
    # expert reads it; on the way back it is a zero row)
    slot = torch.where(keep, idx * C + pos, E * C)            # (T, K)
    xin = xt.new_zeros((E * C + 1, D))
    xin[slot] = xt[:, None].expand(T, K, D)
    xin = constrain(xin[:E * C].view(E, C, D), "expert_in")
    hg = torch.bmm(xin.float(), p.wg[:E].float())
    hu = torch.bmm(xin.float(), p.wu[:E].float())
    h = (F.silu(hg) * hu).to(dt)
    xout = torch.bmm(h.float(), p.wd[:E].float()).to(dt)     # (E, C, D)
    xout = constrain(xout, "expert_in")
    rows = torch.cat([xout.reshape(E * C, D), xout.new_zeros((1, D))])
    picked = rows[slot]                                       # (T, K, D)
    g = torch.where(keep, gates.to(dt), 0).float()
    out = (g[..., None] * picked.float()).sum(1).to(dt)

    f = mean(F.one_hot(idx, probs.shape[-1]).sum(1), 0)
    lb = cfg.num_experts * (f * mean(probs, 0)).sum()
    return out, lb, dropped


def moe_layer(
    p: Params, cfg: ArchConfig, x: torch.Tensor,
    constrain=_identity, exact: bool = False,
    token_chunk: int = TOKEN_CHUNK,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), aux {load_balance_loss, drop_frac}).

    Capacity ``C = ceil(Tc/E · k · capacity_factor)`` per chunk of ``Tc``
    tokens; ``exact=True`` (decode) uses ``C = Tc``: no token is dropped,
    so decode agrees with teacher forcing.
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xt = x.reshape(T, D)
    Tc = min(token_chunk, T)
    n_chunks = -(-T // Tc)
    C = Tc if exact else max(1, int(Tc * K * cfg.capacity_factor / E
                                    + 0.999))
    C = min(C, Tc)

    if n_chunks == 1:
        out, lb, drop = _route_chunk(p, cfg, xt, C, constrain)
    else:
        chunks = F.pad(xt, (0, 0, 0, n_chunks * Tc - T)).view(n_chunks, Tc,
                                                                D)
        chunks = constrain(chunks, "moe_chunks")
        outs, lbs, drops = zip(*(_route_chunk(p, cfg, c, C, constrain)
                                 for c in chunks))
        out = constrain(torch.cat(outs)[:T], "moe_tokens")
        lb, drop = mean(torch.stack(lbs)), mean(torch.stack(drops))

    if "shared" in p:
        out = out + mlp(p.shared, xt, cfg.mlp_act)
    aux = {"load_balance_loss": lb, "drop_frac": drop}
    return out.reshape(B, S, D), aux
