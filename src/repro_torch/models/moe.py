"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch (the
port of the JAX package's ``repro.models.moe``).

The reference dispatches through one-hot ``(tokens, experts, capacity)``
tensors and einsums.  The port computes the same function with gathers and
scatters: each kept (token, k) pair owns one slot ``expert · C + position``
of its chunk's ``(E·C, D)`` buffer, the experts run as one ``torch.bmm``
over the expert axis (every chunk's buffer at once: the reference scans
the chunks one by one, which bounds its dispatch memory by a chunk; the
port's is the tokens', as an activation's), and each token gathers its K
outputs back.  What is kept is
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

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding.placement import matmul, on_mesh, reshape
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
    idx (..., T, K) -> (..., T, K) int32, each leading index a chunk of
    its own."""
    flat = idx.reshape(*idx.shape[:-2], -1)                  # (..., T·K)
    # (..., E, T·K): the scan runs along each expert's row, contiguous
    onehot = F.one_hot(flat, num_experts).to(torch.int32).transpose(
        -1, -2).contiguous()
    before = onehot.cumsum(-1, dtype=torch.int32) - onehot
    return before.gather(-2, flat[..., None, :]).reshape(idx.shape)


def route(p: Params, cfg: ArchConfig, xt: torch.Tensor, C: int):
    """The routing of chunks ``xt`` (..., T, D) at capacity ``C``: (gates
    (..., T, K) f32, expert ids (..., T, K), buffer positions (..., T, K),
    kept (..., T, K) bool, probabilities (..., T, E) f32)."""
    return _on_chunks(functools.partial(
        _pick, K=cfg.num_experts_per_tok, C=C), matmul(xt, p.router),
        outs=5)


def _pick(logits: torch.Tensor, K: int, C: int):
    """:func:`route` from the router logits of whole chunks."""
    probs = torch.softmax(logits.float(), dim=-1)             # (..., T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :K], idx[..., :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    pos = positions(idx, probs.shape[-1])
    return gates, idx, pos, pos < C, probs


def _chunk_index(slot: torch.Tensor) -> torch.Tensor:
    n, T, K = slot.shape
    return torch.arange(n, device=slot.device)[:, None, None].expand(n, T,
                                                                      K)


def _dispatch(xc: torch.Tensor, slot: torch.Tensor, slots: int
              ) -> torch.Tensor:
    """Each chunk's buffer (n, slots, D): token ``t``'s row at every slot
    its kept pairs own, zeros elsewhere."""
    n, T, D = xc.shape
    xin = xc.new_zeros((n, slots, D))
    xin[_chunk_index(slot), slot] = xc[:, :, None].expand(n, T,
                                                          slot.shape[-1], D)
    return xin


def _combine(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each pair's expert output row (n, T, K, D) from its chunk's rows."""
    return rows[_chunk_index(slot), slot]


def _on_chunks(fn, *xs: torch.Tensor, outs: int = 1):
    """``fn(*xs)`` of tensors whose dim 0 is the chunk (``outs``
    outputs, each chunk-major too); on DTensors, on each rank's chunks
    through ``local_map``: the chunk dim keeps the first input's shards,
    every other dim is whole.  A chunk's routing, dispatch and combine
    read its own tokens and slots only; DTensor's ``cumsum`` over a
    sharded dim scans each shard alone (the buffer positions), and torch
    2.11's has no rule for ``index_put_`` (the dispatch)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    from torch.distributed.tensor.experimental import local_map
    mesh = xs[0].device_mesh
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in xs[0].placements]
    return local_map(fn, out_placements=pl if outs == 1 else (pl,) * outs,
                     in_placements=(pl,) * len(xs), device_mesh=mesh)(
        *(on_mesh(x, mesh, pl) for x in xs))


def _route_chunks(p: Params, cfg: ArchConfig, xc: torch.Tensor, C: int,
                  constrain):
    """Dispatch, compute and combine the chunks ``xc`` (n, T, D), each
    routed on its own at capacity ``C``, all at once: the experts run as
    one ``bmm`` over every chunk's buffer.  Returns (out (n, T, D), each
    chunk's load-balance loss (n,), each chunk's drop fraction (n,))."""
    n, T, D = xc.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    dt = xc.dtype
    gates, idx, pos, keep, probs = route(p, cfg, xc, C)
    dropped = 1.0 - mean(keep.reshape(n, T * K), 1)

    # slot of each kept pair in its chunk's buffer; dropped pairs go to the
    # spare row E·C (no expert reads it; on the way back it is a zero row)
    slot = torch.where(keep, idx * C + pos, E * C)            # (n, T, K)
    xin = _on_chunks(functools.partial(_dispatch, slots=E * C + 1), xc,
                     slot)                                    # (n, E·C+1, D)
    # (E, n·C, D): each expert's rows of every chunk
    xin = xin[:, :E * C].reshape(n, E, C, D).transpose(0, 1)
    xin = constrain(xin.reshape(E, n * C, D), "expert_in")
    hg = torch.bmm(xin.float(), p.wg[:E].float())
    hu = torch.bmm(xin.float(), p.wu[:E].float())
    h = (F.silu(hg) * hu).to(dt)
    xout = torch.bmm(h.float(), p.wd[:E].float()).to(dt)     # (E, n·C, D)
    xout = constrain(xout, "expert_in")
    xout = xout.reshape(E, n, C, D).transpose(0, 1).reshape(n, E * C, D)
    rows = torch.cat([xout, xout.new_zeros((n, 1, D))], 1)
    picked = _on_chunks(_combine, rows, slot)                 # (n, T, K, D)
    g = torch.where(keep, gates.to(dt), 0).float()
    out = (g[..., None] * picked.float()).sum(2).to(dt)

    f = mean(_on_chunks(lambda i: F.one_hot(i, E).sum(2), idx), 1)  # (n, E)
    lb = cfg.num_experts * (f * mean(probs, 1)).sum(-1)
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
        out, lb, drop = _route_chunks(p, cfg, xt[None], C, constrain)
        out, lb, drop = out[0], lb[0], drop[0]
    else:
        # the chunks keep the tokens' sharding on their chunk axis (the
        # reference pins it within a chunk, whose axis it scans; the port
        # runs every chunk at once, and a sharded within-chunk axis would
        # merge into a strided shard in the router's matmul)
        chunks = reshape(F.pad(xt, (0, 0, 0, n_chunks * Tc - T)),
                         (n_chunks, Tc, D))
        out, lbs, drops = _route_chunks(p, cfg, chunks, C, constrain)
        out = constrain(out.reshape(n_chunks * Tc, D)[:T], "moe_tokens")
        lb, drop = mean(lbs), mean(drops)

    if "shared" in p:
        out = out + mlp(p.shared, xt, cfg.mlp_act)
    aux = {"load_balance_loss": lb, "drop_frac": drop}
    return reshape(out, (B, S, D)), aux
