"""Plain PyTorch reference semantics for batched SNP simulation.

The port of ``repro.core.semantics``'s delay-free half, vectorized over
a frontier of ``B`` configurations:

* applicability mask over rules            (paper Alg. 2, step II-1)
* mixed-radix rank-decode of every valid
  spiking vector                           (paper Alg. 2, steps II-2/II-3)
* the affine transition ``C' = C + S·M``   (paper eq. 2)

and the same step on the sparse encoding (:func:`sparse_next_configs`,
the plain ``"sparse"`` backend): per-neuron digit decode, a fired-rule
lookup in a packed per-config table, and a gather over the in-adjacency,
whose body is the sparse kernel's plain version.  It runs on any device
and is the plain version the hand-written step kernels
(:mod:`repro_torch.kernels.snp_step`) are held against.

Enumeration order.  Neuron 0 is the most-significant mixed-radix digit:
branch ``t ∈ [0, Ψ)`` decodes to ``digit_i = (t // stride_i) % k_i`` with
``stride_i = Π_{j>i} k_j`` and ``k_i = max(1, #applicable rules in neuron
i)``; within a neuron, digit ``d`` selects the ``d``-th applicable rule.

Overflow discipline.  Radix products are taken in float32, which is exact
below 2^24 and saturates monotonically beyond.  Torch's ``cumprod`` and
XLA's may round products past 2^24 differently, but no result can tell:
every ``T`` in use is below 2^23, so a stride past 2^24 decodes every
``t < T`` to digit 0 either way (it is clamped to 2^30 before the integer
decode), and a Ψ past 2^24 exceeds ``T`` either way (every branch valid,
overflow flagged).  Below 2^24 each partial product is an exact integer,
whatever order the scan multiplies in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .matrix import CompiledSNP, CompiledSparseSNP

__all__ = ["applicability", "branch_info", "BranchInfo", "clamp_stride",
           "decode_spiking", "spiking_vectors", "transition", "next_configs",
           "StepOut", "sparse_branch_info", "packed_rule_table",
           "sparse_next_configs"]

# Strides are clamped here before the int32 decode: saturated strides stay
# valid int32 and decode every t < T to digit 0 (a legal choice).
STRIDE_CLAMP = 2.0 ** 30


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(-1, idx)


def applicability(config: torch.Tensor, comp: CompiledSNP) -> torch.Tensor:
    """Boolean mask (..., n): which rules may fire at ``config`` (..., m).

    Exact mode: ``s >= b`` and (``p == 0`` ? ``s == b`` : ``(s - b) % p ==
    0``); covering mode: ``s >= b``; always ``s >= consume``."""
    s = _gather(config, comp.rule_neuron)        # (..., n) spikes at owner
    ge_base = s >= comp.regex_base
    on_progression = torch.where(
        comp.regex_period > 0,
        torch.remainder(s - comp.regex_base,
                        comp.regex_period.clamp(min=1)) == 0,
        s == comp.regex_base)
    member = torch.where(comp.covering, ge_base, ge_base & on_progression)
    return member & (s >= comp.consume)


class BranchInfo(NamedTuple):
    app: torch.Tensor      # (..., n) bool
    rank: torch.Tensor     # (..., n) int32 — index among applicable in neuron
    choices: torch.Tensor  # (..., m) int32 — max(1, #applicable)
    stride: torch.Tensor   # (..., m) float32 — Π_{j>i} choices_j (exact < 2^24)
    psi: torch.Tensor      # (...,)  float32 — Ψ (saturating)
    alive: torch.Tensor    # (...,)  bool — any rule applicable at all


def branch_info(config: torch.Tensor, comp: CompiledSNP) -> BranchInfo:
    app = applicability(config, comp)
    app_i = app.to(torch.int32)
    m = comp.num_neurons
    # #applicable per neuron.  The reference multiplies by the (n, m)
    # one-hot in int32; torch has no integer CUDA matmul, so the port adds
    # over rule_neuron instead (integer adds: the result does not depend
    # on the order the card performs them in).
    k = torch.zeros(app.shape[:-1] + (m,), dtype=torch.int32,
                    device=app.device)
    k.index_add_(-1, comp.rule_neuron, app_i)
    # Rules are neuron-sorted, so the inclusive cumsum minus the neuron's
    # exclusive prefix gives each rule's rank among its neuron's
    # applicable rules.
    incl = torch.cumsum(app_i, -1, dtype=torch.int32)
    k_prefix = torch.cumsum(k, -1, dtype=torch.int32) - k
    rank = incl - _gather(k_prefix, comp.rule_neuron) - 1  # valid where app
    return _radix(app, rank, k)


def _radix(app, rank, k) -> BranchInfo:
    """Choices, strides and Ψ from the per-neuron applicable counts ``k``
    — the same float32 operations for both encodings."""
    choices = k.clamp(min=1)
    cf = choices.to(torch.float32)
    suffix = torch.cumprod(cf.flip(-1), -1).flip(-1)     # Π_{j >= i}
    psi = suffix[..., 0]
    stride = torch.cat([suffix[..., 1:], torch.ones_like(cf[..., :1])], -1)
    return BranchInfo(app=app, rank=rank, choices=choices, stride=stride,
                      psi=psi, alive=app.any(-1))


def clamp_stride(stride: torch.Tensor) -> torch.Tensor:
    """float32 strides (+inf allowed) as the int32 the decode divides by."""
    return stride.clamp(max=STRIDE_CLAMP).to(torch.int32)


def decode_spiking(app: torch.Tensor, rank: torch.Tensor,
                   stride: torch.Tensor, choices: torch.Tensor,
                   rule_neuron: torch.Tensor, max_branches: int
                   ) -> torch.Tensor:
    """Spiking vectors ``S`` (..., T, n) int32 for branches ``t < T``,
    decoded directly in rule space from int32 ``stride``/``choices``
    (..., m): ``S[t, i] = app[i] & ((t // stride[μ]) % choices[μ] ==
    rank[i])`` with ``μ`` the neuron of rule ``i``."""
    t = torch.arange(max_branches, dtype=torch.int32, device=app.device)
    stride_r = _gather(stride, rule_neuron).unsqueeze(-2)    # (..., 1, n)
    choices_r = _gather(choices, rule_neuron).unsqueeze(-2)
    digits = torch.remainder(
        torch.div(t[:, None], stride_r, rounding_mode="floor"), choices_r)
    return (app.unsqueeze(-2) & (digits == rank.unsqueeze(-2))) \
        .to(torch.int32)


def transition(config: torch.Tensor, S: torch.Tensor, M: torch.Tensor,
               env: torch.Tensor):
    """``(C + S·M, S·env)`` for ``S`` (..., T, n): the f32 products are
    exact for |values| < 2^24 (TF32 must be off on the card, which is
    PyTorch's default for matmul)."""
    Sf = S.to(torch.float32)
    delta = torch.matmul(Sf, M.to(torch.float32)).to(torch.int32)
    emissions = torch.matmul(Sf, env.to(torch.float32)).to(torch.int32)
    return config.unsqueeze(-2) + delta, emissions


def spiking_vectors(config: torch.Tensor, comp: CompiledSNP,
                    max_branches: int):
    """All valid spiking vectors at ``config``: ``(S, valid, overflow)``
    with ``S`` (..., T, n) int32 in **neuron-sorted rule order**, ``valid``
    (..., T) bool, ``overflow`` (...,) bool."""
    return _decode_spiking(branch_info(config, comp), comp, max_branches)


def _decode_spiking(info: BranchInfo, comp: CompiledSNP, max_branches: int):
    S = decode_spiking(info.app, info.rank, clamp_stride(info.stride),
                       info.choices, comp.rule_neuron, max_branches)
    t = torch.arange(max_branches, device=S.device).to(torch.float32)
    valid = (t < info.psi.unsqueeze(-1)) & info.alive.unsqueeze(-1)
    return S, valid, info.psi > float(max_branches)


class StepOut(NamedTuple):
    configs: torch.Tensor    # (..., T, m) int32 — successor configurations
    valid: torch.Tensor      # (..., T) bool
    emissions: torch.Tensor  # (..., T) int32 — spikes sent to the environment
    overflow: torch.Tensor   # (...,) bool — Ψ exceeded max_branches
    spiking: Optional[torch.Tensor]  # (..., T, n) int32, or None


def next_configs(config: torch.Tensor, comp: CompiledSNP,
                 max_branches: int) -> StepOut:
    """One synchronous SNP step: every successor of every config,
    ``C' = C + S·M_Π`` (paper eq. 2) over ``T = max_branches`` branches."""
    S, valid, overflow = spiking_vectors(config, comp, max_branches)
    out, emissions = transition(config, S, comp.M, comp.env_produce)
    return StepOut(configs=out, valid=valid, emissions=emissions,
                   overflow=overflow, spiking=S)


# ---------------------------------------------------------------------------
# Sparse path: the same step on the ELL/segment encoding, O(B·T·m·degree)
# ---------------------------------------------------------------------------


def sparse_branch_info(config: torch.Tensor,
                       comp: CompiledSparseSNP) -> BranchInfo:
    """:func:`branch_info` on the sparse encoding, with identical outputs:
    per-neuron applicable counts and ranks come from one inclusive cumsum
    over the neuron-sorted rule axis, read at the segment bounds."""
    app = applicability(config, comp)
    incl = torch.cumsum(app.to(torch.int32), -1, dtype=torch.int32)
    cum0 = torch.cat([torch.zeros_like(incl[..., :1]), incl], -1)
    start = _gather(cum0, comp.seg_start)                       # (..., m)
    k = _gather(cum0, comp.seg_start + comp.seg_count) - start
    rank = incl - _gather(start, comp.rule_neuron) - 1
    return _radix(app, rank, k)


def packed_rule_table(info: BranchInfo,
                      comp: CompiledSparseSNP) -> torch.Tensor:
    """``tab`` (..., m, R) int32: ``produce | consume << 16`` of the d-th
    applicable rule of neuron μ at ``[..., μ, d]``, 0 where there is none.
    Each applicable rule lands at its neuron and its rank (``info.rank``)
    by one scatter; the slots are distinct, and non-applicable rules go to
    a spare column that is dropped (the copy makes the table contiguous,
    as the kernel takes it)."""
    m, R = comp.num_neurons, comp.rule_slots.shape[0]
    batch = info.app.shape[:-1]
    app = info.app.reshape(-1, info.app.shape[-1])
    packed = comp.produce | (comp.consume << 16)                 # (n,)
    slot = torch.where(app, comp.rule_neuron * R + info.rank.reshape(
        app.shape), m * R).to(torch.int64)
    tab = torch.zeros((app.shape[0], m * R + 1), dtype=torch.int32,
                      device=app.device)
    tab.scatter_(-1, slot, packed.expand(app.shape))
    return tab[:, :m * R].reshape(*batch, m, R).contiguous()


def sparse_next_configs(config: torch.Tensor, comp: CompiledSparseSNP,
                        max_branches: int) -> StepOut:
    """One synchronous SNP step on the sparse encoding, equal to
    :func:`next_configs` on valid entries, without the ``(..., T, n)``
    spiking tensor or any ``O(n·m)`` matrix:

    1. the mixed-radix digit per (branch, neuron);
    2. the fired rule's ``produce | consume << 16`` from the packed table;
    3. ``ΔC[j] = Σ_{i ∈ in(j)} produce_fired[i] − consume_fired[j]`` over
       the ELL in-adjacency, plus each hub's COO tail summed over its run;
    4. the emission is the fired produce at the output neuron.

    The body is the sparse step kernel's plain version
    (:mod:`repro_torch.kernels.snp_step.sparse_ref`), so the plain backend
    and the kernel's oracle are one function.
    """
    # Imported here: the kernels package imports this module.
    from ..kernels.snp_step.sparse_ref import sparse_step
    m = config.shape[-1]
    batch = config.shape[:-1]
    T = max_branches
    out, valid, emis, overflow = sparse_step(config.reshape(-1, m), comp,
                                             max_branches=T)
    return StepOut(configs=out.reshape(*batch, T, m),
                   valid=valid.reshape(*batch, T),
                   emissions=emis.reshape(*batch, T),
                   overflow=overflow.reshape(batch), spiking=None)
