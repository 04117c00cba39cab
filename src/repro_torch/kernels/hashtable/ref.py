"""Plain PyTorch versions of the hash-table kernels H1 and H2.

The reference's probe ``while_loop``s (``repro.core.hashtable``) as
PyTorch loops over the same rounds, and its ``config_hash``
(:func:`config_hash_ref`, the plain version of H1's rows and hash bodies,
which lives in :mod:`repro_torch.core.hashing`); ``csrc/hashtable.cu``
equals them bit for bit.  They run on CPU tensors (the wrappers in
:mod:`.ops` call them there); on the card only a check of the kernels
calls them, since each round's test of the pending mask is a host read.  Keys arrive canonical
(:func:`repro_torch.core.hashtable._canonical`): int64 tensors holding
uint32 lanes, the empty marker ``SENTINEL`` in both lanes only for
invalid ones.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.hashing import SENTINEL, config_hash_ref, fmix32, mul32

__all__ = ["base_slot", "lookup_ref", "claim_ref", "config_hash_ref"]

_MIX = 0x9E3779B1


def base_slot(hi, lo, num_slots: int) -> torch.Tensor:
    """Both lanes avalanched together, so probe chains of distinct keys
    decorrelate even when one lane collides."""
    return fmix32(hi ^ mul32(lo, _MIX)) & (num_slots - 1)


def lookup_ref(s_hi, s_lo, s_pay, hi, lo, valid, max_probes: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H1's contract: ``(found (K,) bool, payload (K,) int32)``; each valid
    key walks its chain from its base slot until it meets its key, an
    empty slot or ``max_probes`` probes (absent, payload -1)."""
    S = s_hi.shape[0]
    base = base_slot(hi, lo, S)
    pending = valid.clone()
    found = torch.zeros_like(valid)
    payload = torch.full(hi.shape, -1, dtype=torch.int32, device=hi.device)
    p = 0
    while p < max_probes and bool(pending.any()):
        slot = (base + p) & (S - 1)
        cur_hi, cur_lo = s_hi[slot], s_lo[slot]
        match = pending & (cur_hi == hi) & (cur_lo == lo)
        empty = (cur_hi == SENTINEL) & (cur_lo == SENTINEL)
        found |= match
        payload = torch.where(match, s_pay[slot], payload)
        pending &= ~match & ~empty
        p += 1
    return found, payload


def claim_ref(s_hi, s_lo, s_pay, hi, lo, pending, payload, max_probes: int):
    """H2's contract: the batched claim-insert rounds.  Each round every
    pending candidate reads its current slot and either (a) matches the
    stored key — a duplicate, (b) wins an empty-slot claim (the lowest
    candidate index) — inserted with its payload, (c) loses a claim —
    re-reads the same slot next round, or (d) sees a foreign key —
    advances one probe, overflowing at ``max_probes``.  Every advance or
    claim loss takes a round and a loss is followed by a resolution or an
    advance, so ``2·max_probes + 1`` rounds bound the loop.  Returns
    ``(s_hi, s_lo, s_pay, won, dup, overflow ())``; the inputs are not
    written to."""
    S = s_hi.shape[0]
    K = hi.shape[0]
    dev = hi.device
    base = base_slot(hi, lo, S)
    idx = torch.arange(K, dtype=torch.int64, device=dev)
    probe = torch.zeros(K, dtype=torch.int64, device=dev)
    won = torch.zeros(K, dtype=torch.bool, device=dev)
    dup = torch.zeros_like(won)
    ovf = torch.zeros_like(won)
    pending = pending.clone()
    it = 0
    while it < 2 * max_probes + 1 and bool(pending.any()):
        slot = (base + probe) & (S - 1)
        cur_hi, cur_lo = s_hi[slot], s_lo[slot]
        match = pending & (cur_hi == hi) & (cur_lo == lo)
        empty = (cur_hi == SENTINEL) & (cur_lo == SENTINEL)
        try_claim = pending & ~match & empty
        # claim[s] = lowest index claiming empty slot s this round (K: none)
        claim = torch.full((S,), K, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, slot, torch.where(try_claim, idx, K),
                              reduce="amin")
        win = try_claim & (claim[slot] == idx)
        # each claimed slot was empty and has exactly one winner: write it
        claimed = claim < K
        winner = claim.clamp(max=max(K - 1, 0))
        s_hi = torch.where(claimed, hi[winner], s_hi)
        s_lo = torch.where(claimed, lo[winner], s_lo)
        s_pay = torch.where(claimed, payload[winner], s_pay)
        # occupied by a foreign key -> advance; claim losers hold position
        advance = pending & ~match & ~empty
        probe = probe + advance
        out = probe >= max_probes
        ovf |= pending & out
        won |= win
        dup |= match
        pending = pending & ~match & ~win & ~out
        it += 1
    return s_hi, s_lo, s_pay, won, dup, ovf.any()
