"""Device-resident open-addressing hash table for BFS frontier dedup.

The port of ``repro.core.hashtable``: a power-of-two table of ``S`` slots
with linear probing from a mixed base slot, bounded by 64 probes.  Three
parallel tensors hold the two hash lanes (int64 holding uint32 values,
``SENTINEL`` in both when empty) and an int32 payload (the engine stores
the archive row).  A real key equal to the empty marker is remapped to
``(SENTINEL, SENTINEL - 1)`` on both the insert and the lookup side.

Claims.  Within one batch only the *lowest-indexed* candidate of an
equal-key group counts as new: that rule fixes the archive order.  A claim
is decided by the minimum candidate index over the claimers of a slot,
which gives the same winner whatever order the card applies the updates
in (a plain atomic compare-and-swap would let any racer win); a claim
loser re-checks the slot it lost before probing on.

The probes.  The reference's probe ``while_loop``s are the hand-written
kernels of :mod:`repro_torch.kernels.hashtable`: H1 (lookup; for the BFS
level, :func:`_hash_lookup`, the candidate rows hashed and looked up in
one launch) and H2 (the claim rounds, shared by :func:`first_occurrence`
and the inserts, by the route :func:`~repro_torch.kernels.hashtable.ops.
claim_route` picks from the sizes), each a launch with no host read, so a
BFS level that dedups through this table runs on the card without reading
anything back.  On CPU tensors the same functions run the kernels' plain
versions (PyTorch loops over the same rounds).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .hashing import SENTINEL

__all__ = ["HashTable", "table_slots", "make_table", "lookup",
           "first_occurrence", "insert_unique", "insert_unique_",
           "insert_if_absent"]


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


def _keys(hi, lo, valid, dev):
    """Canonical contiguous lanes and mask on ``dev``."""
    hi, lo, valid = _lane(hi, dev), _lane(lo, dev), _mask(valid, dev)
    hi, lo = _canonical(hi, lo, valid)
    return hi.contiguous(), lo.contiguous(), valid.contiguous()


def _ops():
    # Imported here: the kernels package imports core modules, and core's
    # __init__ imports this one.
    from ..kernels.hashtable import ops
    return ops


def lookup(table: HashTable, hi, lo, valid,
           max_probes: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched membership probe (no writes): ``(found, payload)``.  A chain
    that exhausts ``max_probes`` occupied, non-matching slots resolves as
    absent — sound, because inserts bound their probes identically.  H1
    on the card, its plain version on the CPU."""
    dev = table.slots_hi.device
    hi, lo, valid = _keys(hi, lo, valid, dev)
    return _ops().lookup(table.slots_hi, table.slots_lo, table.slot_payload,
                         hi, lo, valid, _probes(table.num_slots, max_probes))


def _hash_lookup(table: HashTable, rows: torch.Tensor, valid,
                 max_probes: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The BFS level's hash and lookup of its candidate rows (K, m):
    ``(hi, lo, found)``, the lanes :func:`~.hashing.config_hash` gives,
    canonical under ``valid``, and :func:`lookup`'s verdict.  H1's rows
    body on the card (one launch, each row read once); on the CPU
    ``config_hash``, the canonical lanes and :func:`lookup`'s plain
    version."""
    dev = table.slots_hi.device
    return _ops().hash_lookup(table.slots_hi, table.slots_lo,
                              table.slot_payload, rows,
                              _mask(valid, dev).contiguous(),
                              _probes(table.num_slots, max_probes))


def first_occurrence(hi, lo, valid, max_probes: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``first[i]`` iff candidate ``i`` is the lowest-indexed holder of its
    key within the batch, from the claim rounds (H2) on a fresh table of
    ``table_slots(K)`` slots, the kernel's own (at the BFS wave it lives in
    one cluster's shared memory).  Returns ``(first, overflow)``."""
    dev = hi.device if isinstance(hi, torch.Tensor) else None
    hi, lo, valid = _keys(hi, lo, valid, dev)
    S = table_slots(max(int(hi.shape[0]), 1))
    won, _, ovf = _ops().first_claim(hi, lo, valid, S, _probes(S, max_probes))
    return won, ovf


def _payload(payload, K: int, dev) -> torch.Tensor:
    if payload is None:
        return torch.arange(K, dtype=torch.int32, device=dev)
    if not isinstance(payload, torch.Tensor):
        payload = torch.from_numpy(np.asarray(payload, dtype=np.int32))
    return payload.to(device=dev, dtype=torch.int32).contiguous()


def insert_unique_(table: HashTable, hi, lo, mask, payload=None,
                   max_probes: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`insert_unique` into ``table`` in place (its slots and its
    count): ``(inserted, overflow)``.  The BFS levels insert this way, so
    a captured level writes the state's own table."""
    dev = table.slots_hi.device
    hi, lo, mask = _keys(hi, lo, mask, dev)
    won, _, ovf = _ops().claim_(
        table.slots_hi, table.slots_lo, table.slot_payload, hi, lo, mask,
        _payload(payload, hi.shape[0], dev),
        _probes(table.num_slots, max_probes))
    table.count.add_(won.sum(dtype=torch.int32))
    return won, ovf


def insert_unique(table: HashTable, hi, lo, mask, payload=None,
                  max_probes: Optional[int] = None
                  ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Insert masked keys (expected distinct and absent).  A key found
    present anyway is left in place and reported as not inserted.
    Returns ``(table, inserted, overflow)``; ``table`` is not written to
    (the claim rounds run on a copy)."""
    new = HashTable(*(x.clone() for x in table))
    won, ovf = insert_unique_(new, hi, lo, mask, payload, max_probes)
    return new, won, ovf


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
