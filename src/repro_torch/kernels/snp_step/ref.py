"""Plain PyTorch versions of the dense step kernels.

Each takes exactly its kernel's inputs (the branch bookkeeping already
done) and computes its three outputs with the reference semantics' own
decode (:mod:`repro_torch.core.semantics`), so the kernel is held against
the math the rest of the port runs on:

* :func:`snp_step_dense_ref` — B1, ``C + S·M``;
* :func:`snp_step_dense_delay_ref` — B4, the delayed step;
* :func:`snp_step_dense_shard_ref` — B6, ``C + halo·hadj + S·M_local``
  for one neuron shard;
* :func:`snp_step_ref` — the whole step's oracle, the reference's
  ``repro.kernels.snp_step.snp_step_ref``: it takes what
  :func:`~.ops.snp_step` takes and delegates to
  :func:`repro_torch.core.semantics.next_configs`.

The wrapper uses them for tensors on the CPU; ``chip_smoke.py`` compares
the kernels with them on the card.
"""

from __future__ import annotations

import torch

from ...core.semantics import decode_spiking, next_configs, transition

__all__ = ["snp_step_ref", "snp_step_dense_ref", "snp_step_dense_delay_ref",
           "snp_step_dense_shard_ref"]


def snp_step_ref(configs, comp, max_branches: int):
    """``(successors (B,T,m) int32, valid (B,T) bool, emissions (B,T)
    int32, overflow (B,) bool)`` of the dense encoding ``comp``, from the
    semantics the rest of the port runs on."""
    out = next_configs(configs, comp, max_branches)
    return out.configs, out.valid, out.emissions, out.overflow


def snp_step_dense_ref(configs, rank, app, stride, choices, psi,
                       rule_neuron, M, env, max_branches: int):
    """``(out (B,T,m) int32, valid (B,T) bool, emis (B,T) int32)`` with
    ``out = C + S·M``, ``emis = S·env`` and ``valid = t < psi``, for every
    branch ``t < max_branches`` (``valid`` is not masked by ``alive``)."""
    S = decode_spiking(app, rank, stride, choices, rule_neuron, max_branches)
    out, emis = transition(configs, S, M, env)
    t = torch.arange(max_branches, device=configs.device).to(torch.float32)
    return out, t < psi.unsqueeze(-1), emis


def snp_step_dense_delay_ref(spikes, cd, pd, rank, app, stride, choices,
                             psi, rule_bounds, consume, produce, delay,
                             adj_in, out_neuron, max_branches: int):
    """``(out (B,T,3m) int32, valid (B,T) bool, emis (B,T) int32)`` of the
    delayed step for every branch ``t < max_branches``, valid or not.
    Neuron μ owns rules ``rule_bounds[μ]:rule_bounds[μ+1]``.  With ``S``
    decoded as for B1, each neuron's fired ``consume``, ``produce·(d=0)``,
    ``d`` and ``produce·(d>0)`` are ``S`` summed over its rules; ``emit =
    produce·(d=0) + (cd == 1 ? pd : 0)`` rides ``adj_in`` (in-neighbours,
    padded with ``m``) to each neuron, gated on the new countdown
    (:func:`~repro_torch.core.semantics.delayed_next_configs` gives the
    algebra); ``emis = emit[out_neuron]`` (0 when it is ``m``) and
    ``valid = t < psi`` (not masked by ``alive``)."""
    B, m = spikes.shape
    n = rank.shape[-1]
    T = max_branches
    dev = spikes.device
    rule_neuron = torch.repeat_interleave(
        torch.arange(m, device=dev, dtype=torch.int32),
        (rule_bounds[1:] - rule_bounds[:-1]).to(torch.int64), output_size=n)
    S = decode_spiking(app, rank, stride, choices, rule_neuron, T)
    nodelay = delay == 0

    def fired(per_rule):                      # Σ over each neuron's rules
        acc = torch.zeros((B, T, m), dtype=torch.int32, device=dev)
        return acc.index_add_(-1, rule_neuron, S * per_rule)

    cons = fired(consume)
    emit = fired(torch.where(nodelay, produce, 0))
    dd = fired(delay)
    pend = fired(torch.where(nodelay, 0, produce))
    reopen = (cd == 1)[:, None, :]
    emit += torch.where(reopen, pd[:, None, :], 0)
    emit_pad = torch.cat([emit, torch.zeros(
        (B, T, 1), dtype=torch.int32, device=dev)], -1)          # (B,T,m+1)
    incoming = torch.zeros((B, T, m), dtype=torch.int32, device=dev)
    for k in range(adj_in.shape[1]):
        incoming.add_(emit_pad.index_select(-1, adj_in[:, k]))
    fired_del = dd > 0
    cd_next = torch.where(fired_del, dd, (cd[:, None, :] - 1).clamp(min=0))
    spikes_next = spikes[:, None, :] - cons \
        + torch.where(cd_next == 0, incoming, 0)
    pd_next = torch.where(fired_del, pend,
                          torch.where(reopen, 0, pd[:, None, :]))
    t = torch.arange(T, device=dev).to(torch.float32)
    emis = emit_pad.index_select(-1, out_neuron)[..., 0]
    return (torch.cat([spikes_next, cd_next, pd_next], -1),
            t < psi.unsqueeze(-1), emis)


def snp_step_dense_shard_ref(configs, rank, app, stride, choices, psi,
                             rule_neuron, M_local, hadj, halo,
                             max_branches: int):
    """``out (B,T,mloc) int32 = C + halo·hadj + S·M_local`` for one shard
    and every branch ``t < max_branches``: ``S`` decoded as for B1 from the
    shard's local rules (``rule_neuron`` maps them to its columns, strides
    already combined across shards and clamped), ``halo`` (B,T,H) the
    remote produce and ``hadj`` (H,mloc) its 0/1 in-adjacency.  The halo
    term adds each halo slot into the columns it feeds, in int32, as a
    product with ``hadj`` over blocks of halo slots (no shape depends on
    the data, so nothing waits on the card)."""
    S = decode_spiking(app, rank, stride, choices, rule_neuron, max_branches)
    out, _ = transition(configs, S, M_local,
                        torch.zeros_like(rule_neuron))
    B, T, H = halo.shape
    w = hadj.to(torch.int32)
    # a block's product holds B·T·slots·mloc int32: at most 2^26 of them
    slots = max(1, (1 << 26) // max(1, B * T * w.shape[1]))
    for s0 in range(0, H, slots):
        s1 = min(H, s0 + slots)
        out += (halo[..., s0:s1, None] * w[s0:s1]).sum(-2, dtype=torch.int32)
    return out
