"""Device-resident open-addressing hash table for BFS frontier dedup.

The port of ``repro.core.hashtable``: a power-of-two table of ``S`` slots
with linear probing from a mixed base slot, bounded by 64 probes.  Three
parallel tensors hold the two hash lanes (int64 holding uint32 values,
``SENTINEL`` in both when empty) and an int32 payload (the engine stores
the archive row).  A real key equal to the empty marker is remapped to
``(SENTINEL, SENTINEL - 1)`` on both the insert and the lookup side.

Claims.  Within one batch only the *lowest-indexed* candidate of an
equal-key group counts as new: that rule fixes the archive order.  Claim
races are resolved by ``scatter_reduce_(reduce="amin")`` on the candidate
index, which gives the same winner whatever order the card applies the
updates in (a plain atomic compare-and-swap would let any racer win); a
claim loser re-checks the slot it lost before probing on.

Host reads.  The reference's probe ``while_loop``s become Python loops
that read ``any(pending)`` once per iteration (counted by
:func:`repro_torch.core.device.host_read`); a probe chain is a few steps
long at load <= 0.5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, host_read, resolve_device
from .hashing import SENTINEL, fmix32, mul32

__all__ = ["HashTable", "table_slots", "make_table", "lookup",
           "first_occurrence", "insert_unique", "insert_if_absent"]

_MIX = 0x9E3779B1


class HashTable(NamedTuple):
    slots_hi: torch.Tensor      # (S,) int64 in [0, 2^32) — SENTINEL when empty
    slots_lo: torch.Tensor      # (S,) int64
    slot_payload: torch.Tensor  # (S,) int32 — caller payload (-1 when empty)
    count: torch.Tensor         # () int32 — live keys

    @property
    def num_slots(self) -> int:
        return self.slots_hi.shape[0]


def table_slots(capacity: int) -> int:
    """Power-of-two slot count for ``capacity`` keys at load <= 0.5."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    return max(16, 1 << (2 * capacity - 1).bit_length())


def _empty(s: int, payload_fill: int, dev) -> Tuple[torch.Tensor, ...]:
    return (torch.full((s,), SENTINEL, dtype=torch.int64, device=dev),
            torch.full((s,), SENTINEL, dtype=torch.int64, device=dev),
            torch.full((s,), payload_fill, dtype=torch.int32, device=dev))


def make_table(capacity: int, device: DeviceLike = None) -> HashTable:
    """An empty table sized for ``capacity`` keys (``table_slots`` slots)."""
    dev = resolve_device(device)
    hi, lo, pay = _empty(table_slots(capacity), -1, dev)
    return HashTable(hi, lo, pay, torch.zeros((), dtype=torch.int32,
                                              device=dev))


def _probes(num_slots: int, max_probes: Optional[int]) -> int:
    # Expected probe length at load 0.5 is ~2.5; 64 covers pathological
    # clustering with margin while keeping the worst case bounded.
    return min(num_slots, 64 if max_probes is None else max_probes)


def _lane(x, device) -> torch.Tensor:
    """A hash lane (tensor, or numpy/sequence of uint32) as int64."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
    return x.to(device=device, dtype=torch.int64)


def _mask(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=bool))
    return x.to(device=device, dtype=torch.bool)


def _canonical(hi, lo, valid):
    """Invalid lanes -> the empty marker; a real key equal to the empty
    marker -> ``(SENTINEL, SENTINEL - 1)``."""
    collide = (hi == SENTINEL) & (lo == SENTINEL)
    lo = torch.where(valid & collide, lo - 1, lo)
    return (torch.where(valid, hi, SENTINEL),
            torch.where(valid, lo, SENTINEL))


def _base_slot(hi, lo, num_slots: int) -> torch.Tensor:
    """Both lanes avalanched together, so probe chains of distinct keys
    decorrelate even when one lane collides."""
    return fmix32(hi ^ mul32(lo, _MIX)) & (num_slots - 1)


def lookup(table: HashTable, hi, lo, valid,
           max_probes: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched membership probe (no writes): ``(found, payload)``.  A chain
    that exhausts ``max_probes`` occupied, non-matching slots resolves as
    absent — sound, because inserts bound their probes identically."""
    S = table.num_slots
    D = _probes(S, max_probes)
    dev = table.slots_hi.device
    hi, lo, valid = _lane(hi, dev), _lane(lo, dev), _mask(valid, dev)
    hi, lo = _canonical(hi, lo, valid)
    base = _base_slot(hi, lo, S)
    pending = valid.clone()
    found = torch.zeros_like(valid)
    payload = torch.full(hi.shape, -1, dtype=torch.int32, device=hi.device)
    p = 0
    while p < D and host_read(pending.any()):
        slot = (base + p) & (S - 1)
        cur_hi, cur_lo = table.slots_hi[slot], table.slots_lo[slot]
        match = pending & (cur_hi == hi) & (cur_lo == lo)
        empty = (cur_hi == SENTINEL) & (cur_lo == SENTINEL)
        found |= match
        payload = torch.where(match, table.slot_payload[slot], payload)
        pending &= ~match & ~empty
        p += 1
    return found, payload


def _claim_loop(s_hi, s_lo, s_pay, hi, lo, pending, payload_vals,
                max_probes: int):
    """The batched claim-insert loop shared by :func:`insert_unique` (on
    the real table) and :func:`first_occurrence` (on a per-wave scratch).

    Each iteration every pending candidate reads its current slot and
    either (a) matches the stored key — a duplicate, (b) wins an
    empty-slot claim (lowest candidate index) — inserted, (c) loses a
    claim — re-checks the same slot next iteration, or (d) sees a foreign
    key — advances one probe.  Candidates reaching ``max_probes``
    overflow.  Returns ``(s_hi, s_lo, s_pay, won, dup, overflow)``; the
    input tensors are not written to."""
    S = s_hi.shape[0]
    K = hi.shape[0]
    dev = hi.device
    base = _base_slot(hi, lo, S)
    idx = torch.arange(K, dtype=torch.int64, device=dev)
    probe = torch.zeros(K, dtype=torch.int64, device=dev)
    won = torch.zeros(K, dtype=torch.bool, device=dev)
    dup = torch.zeros_like(won)
    ovf = torch.zeros_like(won)
    # every advance or claim loss takes an iteration, and a loss is
    # followed by a resolution or an advance, so 2*D + 1 bounds the loop
    it = 0
    while it < 2 * max_probes + 1 and host_read(pending.any()):
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
        s_pay = torch.where(claimed, payload_vals[winner], s_pay)
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


def first_occurrence(hi, lo, valid, max_probes: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``first[i]`` iff candidate ``i`` is the lowest-indexed holder of its
    key within the batch, from a claim loop on a scratch table of
    ``table_slots(K)`` slots.  Returns ``(first, overflow)``."""
    dev = hi.device if isinstance(hi, torch.Tensor) else None
    hi, lo, valid = _lane(hi, dev), _lane(lo, dev), _mask(valid, dev)
    K = int(hi.shape[0])
    S = table_slots(max(K, 1))
    hi, lo = _canonical(hi, lo, valid)
    s_hi, s_lo, s_pay = _empty(S, 0, hi.device)
    _, _, _, won, _, ovf = _claim_loop(
        s_hi, s_lo, s_pay, hi, lo, valid,
        torch.zeros(K, dtype=torch.int32, device=hi.device),
        _probes(S, max_probes))
    return won, ovf


def insert_unique(table: HashTable, hi, lo, mask, payload=None,
                  max_probes: Optional[int] = None
                  ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Insert masked keys (expected distinct and absent).  A key found
    present anyway is left in place and reported as not inserted.
    Returns ``(table, inserted, overflow)``."""
    dev = table.slots_hi.device
    hi, lo, mask = _lane(hi, dev), _lane(lo, dev), _mask(mask, dev)
    if payload is None:
        payload = torch.arange(hi.shape[0], dtype=torch.int32, device=dev)
    elif not isinstance(payload, torch.Tensor):
        payload = torch.from_numpy(np.asarray(payload, dtype=np.int32))
    payload = payload.to(device=dev, dtype=torch.int32)
    hi, lo = _canonical(hi, lo, mask)
    s_hi, s_lo, s_pay, won, _, ovf = _claim_loop(
        table.slots_hi, table.slots_lo, table.slot_payload, hi, lo, mask,
        payload, _probes(table.num_slots, max_probes))
    count = table.count + won.sum(dtype=torch.int32)
    return HashTable(s_hi, s_lo, s_pay, count), won, ovf


def insert_if_absent(table: HashTable, hi, lo, valid, payload=None,
                     max_probes: Optional[int] = None
                     ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Lookup, intra-batch first occurrence, then insertion of the new
    keys.  Returns ``(table, is_new, overflow)``."""
    dev = table.slots_hi.device
    hi, lo, valid = _lane(hi, dev), _lane(lo, dev), _mask(valid, dev)
    found, _ = lookup(table, hi, lo, valid, max_probes)
    first, ovf_f = first_occurrence(hi, lo, valid, max_probes)
    table, inserted, ovf_i = insert_unique(
        table, hi, lo, valid & first & ~found, payload, max_probes)
    return table, inserted, ovf_f | ovf_i
