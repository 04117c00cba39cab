"""Plain PyTorch reference semantics for batched SNP simulation.

The port of ``repro.core.semantics``, vectorized over a frontier of ``B``
configurations:

* applicability mask over rules            (paper Alg. 2, step II-1)
* mixed-radix rank-decode of every valid
  spiking vector                           (paper Alg. 2, steps II-2/II-3)
* the affine transition ``C' = C + S·M``   (paper eq. 2)

and the same step on the sparse encoding (:func:`sparse_next_configs`,
the plain ``"sparse"`` backend): per-neuron digit decode, a fired-rule
lookup in a packed per-config table, and a gather over the in-adjacency,
whose body is the sparse kernel's plain version.  The delayed tier
(rules with a firing delay, ``3m``-wide state rows) has the same two
steps, :func:`delayed_next_configs` and
:func:`sparse_delayed_next_configs` (see the section comment below).  It
runs on any device and is the plain version the hand-written step kernels
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
           "sparse_next_configs", "split_state", "delayed_branch_info",
           "sparse_delayed_branch_info", "delayed_weight_matrix",
           "delayed_packed_actions", "delayed_next_configs",
           "sparse_delayed_next_configs"]

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
    return _branch_info_from_app(applicability(config, comp), comp)


def _branch_info_from_app(app: torch.Tensor, comp: CompiledSNP) -> BranchInfo:
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
    return _sparse_info_from_app(applicability(config, comp), comp)


def _sparse_info_from_app(app: torch.Tensor,
                          comp: CompiledSparseSNP) -> BranchInfo:
    incl = torch.cumsum(app.to(torch.int32), -1, dtype=torch.int32)
    cum0 = torch.cat([torch.zeros_like(incl[..., :1]), incl], -1)
    start = _gather(cum0, comp.seg_start)                       # (..., m)
    k = _gather(cum0, comp.seg_start + comp.seg_count) - start
    rank = incl - _gather(start, comp.rule_neuron) - 1
    return _radix(app, rank, k)


def packed_rule_table(info: BranchInfo, comp: CompiledSparseSNP,
                      packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tab`` (..., m, R) int32: ``produce | consume << 16`` of the d-th
    applicable rule of neuron μ at ``[..., μ, d]``, 0 where there is none.
    Each applicable rule lands at its neuron and its rank (``info.rank``)
    by one scatter; the slots are distinct, and non-applicable rules go to
    a spare column that is dropped (the copy makes the table contiguous,
    as the kernel takes it).  ``packed`` (n,) int32 replaces the per-rule
    payload (the delayed tier's two tables,
    :func:`delayed_packed_actions`)."""
    m, R = comp.num_neurons, comp.rule_slots.shape[0]
    batch = info.app.shape[:-1]
    app = info.app.reshape(-1, info.app.shape[-1])
    if packed is None:
        packed = comp.produce | (comp.consume << 16)             # (n,)
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
    and the kernel's oracle are one function.  It runs the tier ``comp``
    was compiled under, so a delayed encoding takes the delayed step
    (:func:`sparse_delayed_next_configs`).
    """
    # Imported here: the kernels package imports this module.
    from ..kernels.snp_step.sparse_ref import sparse_step
    w = config.shape[-1]       # m, or 3m under delays
    batch = config.shape[:-1]
    T = max_branches
    out, valid, emis, overflow = sparse_step(config.reshape(-1, w), comp,
                                             max_branches=T)
    return StepOut(configs=out.reshape(*batch, T, w),
                   valid=valid.reshape(*batch, T),
                   emissions=emis.reshape(*batch, T),
                   overflow=overflow.reshape(batch), spiking=None)


# ---------------------------------------------------------------------------
# Delayed semantics (SystemPlan(semantics="delays")): rules carry a firing
# delay d (arXiv 1212.2529 / 2211.15156).  A state row widens to 3m —
# [spikes | countdown | pending]:
#
#   countdown[j] > 0  — neuron j is closed: its rules are inapplicable and
#                       incoming spikes are lost;
#   countdown[j] == 1 — j reopens this step: pending[j] (the produce of the
#                       delayed rule it fired d steps ago) lands on its
#                       out-neighbours (and the environment, if j is the
#                       output neuron) at the end of the step;
#   firing a rule with d > 0 consumes at once and sets countdown := d,
#   pending := produce; firing with d == 0 emits at once.
#
# Neuron j receives iff its post-step countdown is 0.  All-zero delays
# give the paper's C' = C + S·M on the spikes slice exactly.
# ---------------------------------------------------------------------------


def split_state(config: torch.Tensor):
    """``(spikes, countdown, pending)``, each (..., m), of state rows
    (..., 3m)."""
    m = config.shape[-1] // 3
    return config[..., :m], config[..., m:2 * m], config[..., 2 * m:]


def _delayed_alive(info: BranchInfo, cd: torch.Tensor) -> BranchInfo:
    """A config with a running countdown stays alive: it takes its
    deterministic (Ψ = 1) countdown step even when no rule applies, or its
    pending spikes would never land."""
    return info._replace(alive=info.alive | (cd > 0).any(-1))


def _open_app(config: torch.Tensor, comp) -> torch.Tensor:
    spikes, cd, _ = split_state(config)
    return applicability(spikes, comp) & (_gather(cd, comp.rule_neuron) == 0)


def delayed_branch_info(config: torch.Tensor,
                        comp: CompiledSNP) -> BranchInfo:
    """:func:`branch_info` under delays: a rule applies only while its
    neuron is open, and a running countdown keeps a config alive."""
    return _delayed_alive(_branch_info_from_app(_open_app(config, comp),
                                                comp),
                          split_state(config)[1])


def sparse_delayed_branch_info(config: torch.Tensor,
                               comp: CompiledSparseSNP) -> BranchInfo:
    """:func:`sparse_branch_info` under delays."""
    return _delayed_alive(_sparse_info_from_app(_open_app(config, comp),
                                                comp),
                          split_state(config)[1])


def delayed_weight_matrix(comp: CompiledSNP) -> torch.Tensor:
    """``W`` (n, 4m) float32: row ``i`` holds rule i's ``[consume |
    produce·(d=0) | d | produce·(d>0)]`` at its neuron's column of each
    block, so ``S·W`` gives the fired rule's four attributes per neuron
    (at most one rule fires per neuron).  Built through ``rule_neuron``;
    equal to the reference's one-hot product entry for entry."""
    n, m = comp.num_rules, comp.num_neurons
    nodelay = comp.delay == 0
    W = torch.zeros((n, 4 * m), dtype=torch.float32, device=comp.M.device)
    rows = torch.arange(n, device=W.device)
    cols = comp.rule_neuron.to(torch.int64)
    for blk, v in enumerate((comp.consume,
                             torch.where(nodelay, comp.produce, 0),
                             comp.delay,
                             torch.where(nodelay, 0, comp.produce))):
        W[rows, blk * m + cols] = v.to(torch.float32)
    return W


def delayed_packed_actions(comp: CompiledSparseSNP):
    """The sparse delayed step's two per-rule payloads for
    :func:`packed_rule_table`:

    * ``packed_e = produce·(d=0) | consume << 16`` — the emit-now table (a
      delayed rule's produce is withheld from the wire);
    * ``packed_d = produce | d << 16`` where ``d > 0``, else 0 — the
      delayed action, nonzero iff the fired rule has a delay (``d >= 1``
      sets bit 16 or above; ``produce < 2^16`` and ``d < 2^15``)."""
    nodelay = comp.delay == 0
    packed_e = torch.where(nodelay, comp.produce, 0) | (comp.consume << 16)
    packed_d = torch.where(nodelay, 0, comp.produce | (comp.delay << 16))
    return packed_e, packed_d


def delayed_next_configs(config: torch.Tensor, comp: CompiledSNP,
                         max_branches: int) -> StepOut:
    """One delayed step, dense encoding: every successor (..., T, 3m) of
    every state row (..., 3m).  The fired rule's attributes come from one
    f32 product ``S·W`` (:func:`delayed_weight_matrix`, exact below
    2^24); the pending spikes of reopening neurons and the gated incoming
    spikes ride the 0/1 ``comp.adjacency``."""
    spikes, cd, pd = split_state(config)
    m = spikes.shape[-1]
    info = delayed_branch_info(config, comp)
    S, valid, overflow = _decode_spiking(info, comp, max_branches)
    acc = torch.matmul(S.to(torch.float32),
                       delayed_weight_matrix(comp)).to(torch.int32)
    cons_f, emit_fired = acc[..., :m], acc[..., m:2 * m]
    d_f, prod_pend = acc[..., 2 * m:3 * m], acc[..., 3 * m:]

    cd1, pd1 = cd.unsqueeze(-2), pd.unsqueeze(-2)        # (..., 1, m)
    reopen = cd1 == 1
    emit = emit_fired + torch.where(reopen, pd1, 0)
    incoming = torch.matmul(emit.to(torch.float32),
                            comp.adjacency.to(torch.float32)
                            ).to(torch.int32)
    fired_del = d_f > 0
    cd_next = torch.where(fired_del, d_f, (cd1 - 1).clamp(min=0))
    spikes_next = spikes.unsqueeze(-2) - cons_f \
        + torch.where(cd_next == 0, incoming, 0)
    pd_next = torch.where(fired_del, prod_pend,
                          torch.where(reopen, 0, pd1))
    emit_pad = torch.cat([emit, torch.zeros_like(emit[..., :1])], -1)
    emissions = emit_pad.index_select(
        -1, comp.out_neuron.reshape(1).to(torch.int64))[..., 0]
    out = torch.cat([spikes_next, cd_next, pd_next], -1)
    return StepOut(configs=out, valid=valid, emissions=emissions,
                   overflow=overflow, spiking=S)


def sparse_delayed_next_configs(config: torch.Tensor,
                                comp: CompiledSparseSNP,
                                max_branches: int) -> StepOut:
    """One delayed step on the sparse encoding, equal to
    :func:`delayed_next_configs` on valid entries: the vector riding the
    in-adjacency is the emit-now vector (fired ``d = 0`` produce plus
    reopening neurons' pending spikes), and a second rank table gives the
    fired delayed action (``produce | d << 16``).  The body is the sparse
    step kernel's plain version, as for :func:`sparse_next_configs`."""
    return sparse_next_configs(config, comp, max_branches)
