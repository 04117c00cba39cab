"""Plain PyTorch version of the sparse step kernel — the port's one plain
body of the sparse step.

* :func:`kernel_inputs` does the per-config bookkeeping (branch info and
  the packed fired-rule table; under delays the emit-now table, the
  delayed-action table and the countdown and pending slices) that the
  kernel takes as input;
* :func:`snp_step_sparse_ref` computes the kernel's three outputs from
  exactly those inputs, reading the in-adjacency through ``in_idx`` and
  the COO tail through the per-hub runs ``coo_bounds`` and the
  neuron→hub map ``hub_slot`` (the sliced-list kernel, which runs every
  body, reads the same entries through the sliced lists and
  ``hub_neuron``: ``kernel_inputs(..., lists=True)``); with ``dtab``/
  ``cd``/``pd`` it is the delayed step (the plain version of B5), with
  ``halo`` one neuron shard's step over the extended space ``[local |
  halo | zero]`` (the plain version of B7);
* :func:`sparse_step` chains the two, masks ``valid`` with ``alive`` and
  flags overflow (the wrapper does the same around the kernel).

The plain ``"sparse"`` backend
(:func:`~repro_torch.core.semantics.sparse_next_configs`) and the
wrapper's CPU path run it; ``chip_smoke.py`` compares the kernel with it
on the card.
"""

from __future__ import annotations

import torch

from ...core.matrix import (CompiledSparseSNP, check_coo_metadata,
                             check_sliced_lists, is_delayed)
from ...core.semantics import (delayed_packed_actions, packed_rule_table,
                               sparse_branch_info,
                               sparse_delayed_branch_info, split_state)

__all__ = ["kernel_inputs", "snp_step_sparse_ref", "sparse_step",
           "decode_digits", "fired_packed"]


def decode_digits(max_branches: int, stride: torch.Tensor,
                  choices: torch.Tensor) -> torch.Tensor:
    """Mixed-radix digit per (branch, neuron), ``(t // stride) % choices``,
    as (B, T, m) int32 from (B, m) float32 ``stride`` (+inf allowed) and
    int32 ``choices``, computed in float32.

    Exact: with ``j = floor(t/stride)``, a wrong floor needs the true
    quotient within ulp(j)/2 <= 2^-23·j of an integer from below, but it
    sits at least ``1/stride >= j/T`` away — impossible for ``T < 2^23``.
    A +inf stride quotients to 0, the dense path's clamped-int answer.
    The modulus is the same argument on integers below 2^23, where
    ``c·floor(q/c)`` is exact."""
    t = torch.arange(max_branches, device=stride.device).to(torch.float32)
    s = stride.unsqueeze(-2)                                     # (B, 1, m)
    c = choices.to(torch.float32).unsqueeze(-2)
    q = torch.floor(t[:, None] / s)
    return (q - c * torch.floor(q / c)).to(torch.int32)


def fired_packed(digits: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Fired-rule lookup ``tab[b, μ, digits[b, t, μ]]`` as (B, T, m): one
    direct gather (digits are below choices <= R; slot 0 of a neuron with
    no applicable rule is 0)."""
    B, T, m = digits.shape
    R = tab.shape[-1]
    offs = torch.arange(m, device=digits.device, dtype=torch.int64) * R
    flat = (digits.to(torch.int64) + offs).reshape(B, T * m)
    return tab.reshape(B, m * R).gather(-1, flat).reshape(B, T, m)


def kernel_inputs(configs: torch.Tensor, comp: CompiledSparseSNP, *,
                  lists: bool = False):
    """The kernel's inputs for ``configs`` (B, m), or (B, 3m) state rows
    for a delayed encoding, and the branch info they came from: ``(args,
    extra, info)`` with ``extra`` the COO stage's three tensors for a
    hybrid encoding and the delay stage's ``dtab``/``cd``/``pd`` for a
    delayed one (``{}`` for neither).  With ``lists`` (what the kernel
    reads; every body) the encoding's sliced in-lists ``sell_start,
    sell_src`` stand in ``in_idx``'s place in ``args``, two for one (and
    ``hub_neuron`` takes ``hub_slot``'s place in ``extra``), and an
    encoding without them raises; the plain version reads ``in_idx`` and
    ``hub_slot``."""
    check_coo_metadata(comp, "sparse step")
    adj, extra = (comp.in_idx,), {}
    if lists:
        check_sliced_lists(comp, "sparse step kernel")
        adj = (comp.sell_start, comp.sell_src)
    if comp.is_hybrid:
        extra.update(coo_src=comp.coo_src, coo_bounds=comp.coo_bounds)
        if lists:
            extra["hub_neuron"] = comp.hub_neuron
        else:
            extra["hub_slot"] = comp.hub_slot
    if is_delayed(comp):
        spikes, cd, pd = split_state(configs)
        info = sparse_delayed_branch_info(configs, comp)
        packed_e, packed_d = delayed_packed_actions(comp)
        tab = packed_rule_table(info, comp, packed_e)
        extra.update(dtab=packed_rule_table(info, comp, packed_d),
                     cd=cd.contiguous(), pd=pd.contiguous())
    else:
        spikes = configs
        info = sparse_branch_info(configs, comp)
        tab = packed_rule_table(info, comp)
    args = (spikes.contiguous(), info.stride.contiguous(),
            info.choices.contiguous(), info.psi.contiguous(), tab,
            *adj, comp.out_neuron.reshape(1))
    return args, extra, info


def snp_step_sparse_ref(configs, stride, choices, psi, tab, in_idx,
                        out_neuron, coo_src=None, coo_bounds=None,
                        hub_slot=None, dtab=None, cd=None, pd=None,
                        halo=None, *, max_branches: int):
    """``(out (B,T,m) int32, valid (B,T) bool, emis (B,T) int32)`` for
    every branch ``t < max_branches``, valid or not:

    * ``out[b,t,j] = C[b,j] − consume_fired[j] + incoming[j]``, where
      ``incoming[j] = Σ_k produce_fired[in_idx[j,k]] + tail[hub_slot[j]]``
      and ``tail[h]`` is the fired produce summed over
      ``coo_src[coo_bounds[h]:coo_bounds[h+1]]`` (0 for ``hub_slot = Hn``);
    * ``emis[b,t] = produce_fired[out_neuron]`` (0 when it is ``m``);
    * ``valid[b,t] = t < psi[b]`` (not masked by ``alive``).

    With ``dtab``, ``cd`` and ``pd`` (the delayed step; ``configs`` is the
    spikes slice and ``tab`` the emit-now table) the vector riding the
    in-adjacency and the emission is ``emit = produce_fired + (cd == 1 ?
    pd : 0)``; with ``(p, d) = dtab`` fired (``d = 0``: no delayed rule
    fired), ``out`` is ``(B, T, 3m)``: ``cd' = d > 0 ? d : max(cd − 1,
    0)``, spikes ``C − consume + (cd' == 0 ? incoming : 0)``, ``pd' = d >
    0 ? p : (cd == 1 ? 0 : pd)``.

    With ``halo`` (B, T, H) (one neuron shard; neither the COO nor the
    delay stage) ``in_idx`` indexes ``[local (m) | halo (H) | zero]``: the
    fired produce, then the remote produce, then the zero slot ``m + H``,
    which is also what ``out_neuron`` names.

    Padding indices (``m``, or ``m + H`` for a shard, in ``in_idx``;
    ``Hn`` in ``hub_slot``) read a zero slot; the ELL sum takes one gather
    per column to bound the working set."""
    B, m = configs.shape
    T = max_branches
    dev = configs.device
    if halo is not None and (coo_src is not None or dtab is not None):
        raise ValueError("the shard step (halo) has neither a COO nor a "
                         "delay stage")
    digits = decode_digits(T, stride, choices)
    packed_f = fired_packed(digits, tab)
    emit = packed_f & 0xFFFF
    delayed = dtab is not None
    if delayed:
        reopen = (cd == 1)[:, None, :]
        emit = emit + torch.where(reopen, pd[:, None, :], 0)
    parts = [emit] if halo is None else [emit, halo]
    prod_pad = torch.cat(parts + [torch.zeros(
        (B, T, 1), dtype=torch.int32, device=dev)], -1)     # (B,T,m[+H]+1)
    incoming = torch.zeros((B, T, m), dtype=torch.int32, device=dev)
    for k in range(in_idx.shape[1]):
        incoming.add_(prod_pad.index_select(-1, in_idx[:, k]))
    if coo_src is not None:
        hn = coo_bounds.shape[0] - 1
        # the runs cover coo_src exactly: its length sizes the result, so
        # nothing waits on the card for the sum of the run lengths
        hub_of_entry = torch.repeat_interleave(
            torch.arange(hn, device=dev),
            (coo_bounds[1:] - coo_bounds[:-1]).to(torch.int64),
            output_size=coo_src.shape[0])
        tail = torch.zeros((B, T, hn + 1), dtype=torch.int32, device=dev)
        tail.index_add_(-1, hub_of_entry, prod_pad.index_select(-1, coo_src))
        incoming.add_(tail.index_select(-1, hub_slot))
    spikes = configs[:, None, :] - (packed_f >> 16)
    if delayed:
        packed_d = fired_packed(digits, dtab)
        fired_del = packed_d != 0
        cd_next = torch.where(fired_del, packed_d >> 16,
                              (cd[:, None, :] - 1).clamp(min=0))
        spikes = spikes + torch.where(cd_next == 0, incoming, 0)
        pd_next = torch.where(fired_del, packed_d & 0xFFFF,
                              torch.where(reopen, 0, pd[:, None, :]))
        out = torch.cat([spikes, cd_next, pd_next], -1)
    else:
        out = spikes + incoming
    t = torch.arange(T, device=dev).to(torch.float32)
    emis = prod_pad.index_select(-1, out_neuron)[..., 0]
    return out, t < psi[:, None], emis


def sparse_step(configs: torch.Tensor, comp: CompiledSparseSNP, *,
                max_branches: int):
    """One plain sparse step of ``configs`` (B, m), or (B, 3m) under
    delays: ``(successors (B,T,m|3m) int32, valid (B,T) bool, emissions
    (B,T) int32, overflow (B,) bool)``."""
    args, extra, info = kernel_inputs(configs, comp)
    out, valid, emis = snp_step_sparse_ref(*args, **extra,
                                           max_branches=max_branches)
    return (out, valid & info.alive[:, None], emis,
            info.psi > float(max_branches))
