"""Wrappers around the hand-written hash-table kernels H1 and H2.

H1 (``csrc/hashtable.cu``, ``h1_kernel<BODY, L>``) has three bodies:

* :func:`lookup`, by keys: a table as its three slot tensors (``s_hi``,
  ``s_lo`` (S,) int64 holding uint32 lanes, ``s_pay`` (S,) int32; ``S`` a
  power of two) and canonical keys
  (:func:`repro_torch.core.hashtable._canonical`);
* :func:`hash_lookup`, by rows: int32 candidate rows, hashed as
  :func:`~repro_torch.core.hashing.config_hash` hashes them, made canonical
  under their mask and looked up, in one launch (the BFS level's);
* :func:`config_hash`, the rows' lanes alone.

H2 claims keys into a table by one of three routes, picked by
:func:`claim_route` from the sizes and whether the table starts empty:
:func:`claim_` into a given table (the cta or grid route),
:func:`first_claim` into a fresh one of its own (any route; the cluster
route's never exists in device memory).

On CPU tensors the wrappers run the plain versions (:mod:`.ref`, and for
the hash :func:`repro_torch.core.hashing.config_hash_ref`), as on meta
tensors, which carry shapes only (the dry run's SNP cell).  On CUDA
tensors they launch the kernel on the current stream and read nothing
back, or raise: there is no fallback, and no route takes over from
another.  A route's scratch (the grid route's claim words, probes, states
and round counts, a fresh table off the cluster) is allocated here with
``torch.empty``: inside a captured CUDA graph it comes from the graph's
pool.

Counters.  Each body counts its own launches on the card under its key
(:mod:`repro_torch.kernels.launch_counts`): ``("H1",)`` (keys),
``("H1", "rows")``, ``("H1", "hash")``, and ``("H2", route)`` for the
routes ``"cta"``, ``"cluster"`` and ``"grid"``.  :data:`plain_calls`
counts the plain versions' calls under the same keys (H2's by the route
the card would take), reset by callers that measure a run.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

from ..launch_counts import slot
from ..real import require_real
from ..snp_step._build import load_library
from .ref import claim_ref, config_hash_ref, lookup_ref

__all__ = ["lookup", "hash_lookup", "config_hash", "claim_", "first_claim",
           "claim_route", "ClaimRoute", "row_threads", "load_kernel",
           "claim_block_shape", "SOURCE", "plain_calls", "KEYS", "THREADS",
           "CTA_MAX", "CLUSTER_SMEM", "CLUSTER_SLOT_BYTES",
           "CLUSTER_KEY_BYTES", "CLUSTER_MAX_PROBES", "CLUSTER_ITEMS",
           "CLUSTER_CTAS", "FILL_WARPS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "hashtable.cu"

#: Threads a block of H1 and of H2's grid route.
THREADS = 256
#: Candidates of H2's cta route, one a thread of its block.
CTA_MAX = 1024
#: Dynamic shared memory a block of H2's cluster route may take, under the
#: card's 227 KB a block: 4 bytes a slot (its claim word) and 8 a
#: candidate (its key, which the claimers it beats read).
CLUSTER_SMEM = 220 * 1024
CLUSTER_SLOT_BYTES = 4
CLUSTER_KEY_BYTES = 8
#: Probes a candidate of H2's cluster route may take: its claim words keep
#: the round, at most 2·D + 1, in 15 bits.
CLUSTER_MAX_PROBES = (2 ** 15 - 2) // 2
#: Candidates a thread of the cluster route holds in its registers.
CLUSTER_ITEMS = 8
#: Blocks of the cluster route's cluster, the most the card allows: a
#: round's work spreads over 16 SMs (on an H100, 1.30x faster than 8 at
#: the full-width wave's first occurrence, 3.5% slower at 1,025
#: candidates; probes/claim_rounds.py).
CLUSTER_CTAS = 16
#: Warps one H100 holds at once (132 SMs x 64): rows fewer than this get a
#: block each in H1's rows and hash bodies, a warp each otherwise.
FILL_WARPS = 132 * 64

#: Every launch-count key of H1 and H2.
KEYS = (("H1",), ("H1", "rows"), ("H1", "hash"), ("H2", "cta"),
        ("H2", "cluster"), ("H2", "grid"))

#: Calls of the plain versions, by the key the card's launch would count.
plain_calls: Counter = Counter()

_ROUTES = {"cta": 0, "cluster": 1, "grid": 2}
_ready = set()


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    lib = load_library(SOURCE)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hashtable_setup.argtypes = [i]
    lib.hashtable_setup.restype = i
    lib.hashtable_lookup.argtypes = [vp] * 8 + [i, ll, i, vp, vp]
    lib.hashtable_lookup.restype = i
    lib.hashtable_rows.argtypes = [i] + [vp] * 9 + [i, i, ll, i, i, vp, vp]
    lib.hashtable_rows.restype = i
    lib.hashtable_claim.argtypes = [i, i, i] + [vp] * 14 + [i, ll, i, vp, vp]
    lib.hashtable_claim.restype = i
    lib.hashtable_claim_blocks.argtypes = [ll]
    lib.hashtable_claim_blocks.restype = i
    return lib


def _lib():
    """The library, its cluster kernel's limits set once on the current
    device (callers are inside ``torch.cuda.device(dev)``)."""
    lib = load_kernel()
    index = torch.cuda.current_device()
    if index not in _ready:
        rc = lib.hashtable_setup(CLUSTER_SMEM)
        if rc != 0:
            raise RuntimeError(f"hashtable_setup failed: CUDA error {rc}")
        _ready.add(index)
    return lib


class ClaimRoute(NamedTuple):
    """H2's route: ``name`` ``"cta"``, ``"cluster"`` or ``"grid"``, and its
    blocks (1, the cluster's 16, or 0: the card's cooperative grid)."""

    name: str
    ctas: int


def claim_route(K: int, S: int, D: int, fresh: bool) -> ClaimRoute:
    """H2's route for ``K`` candidates into ``S`` slots at ``D`` probes at
    most, into a ``fresh`` (empty) table or a given one: one block while a
    thread can take each candidate; for a fresh table, one cluster of
    :data:`CLUSTER_CTAS` blocks while the slots' claim words and the
    candidates' keys fit their shared memory, the candidates their threads
    and the rounds their claim words (``D`` at most
    :data:`CLUSTER_MAX_PROBES`); the cooperative grid otherwise."""
    if K < 0 or S < 1 or S & (S - 1) or D < 0:
        raise ValueError(f"no claim route for {K} candidates into {S} "
                         f"slots at {D} probes: K >= 0, D >= 0 and S a "
                         f"power of two")
    if K <= CTA_MAX:
        return ClaimRoute("cta", 1)
    if not fresh or D > CLUSTER_MAX_PROBES:
        return ClaimRoute("grid", 0)
    per = -(-K // CLUSTER_CTAS)
    if S >= CLUSTER_CTAS and per <= CLUSTER_ITEMS * CTA_MAX and \
            S // CLUSTER_CTAS * CLUSTER_SLOT_BYTES + \
            per * CLUSTER_KEY_BYTES <= CLUSTER_SMEM:
        return ClaimRoute("cluster", CLUSTER_CTAS)
    return ClaimRoute("grid", 0)


def row_threads(K: int) -> int:
    """Threads that hash one row in H1's rows and hash bodies: a warp, or
    a block while the rows are too few to fill the card with warps."""
    return 32 if K >= FILL_WARPS else THREADS


def claim_block_shape(K: int, S: int, D: int, fresh: bool):
    """``(blocks, threads)`` of H2's launch for :func:`claim_route`'s
    arguments (the grid route's blocks are the card's cooperative
    grid)."""
    route = claim_route(K, S, D, fresh)
    if route.name == "cta":
        return 1, max(32, -(-K // 32) * 32)
    if route.name == "cluster":
        return route.ctas, CTA_MAX
    return int(load_kernel().hashtable_claim_blocks(max(K, S))), THREADS


def _check_table(s_hi, s_lo, s_pay):
    S = s_hi.shape[0]
    for name, x, dtype in (("s_hi", s_hi, torch.int64),
                           ("s_lo", s_lo, torch.int64),
                           ("s_pay", s_pay, torch.int32)):
        if x.dtype != dtype or tuple(x.shape) != (S,) or \
                not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({S},) {dtype} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if S < 1 or S & (S - 1):
        raise ValueError(f"the table's slot count must be a power of two, "
                         f"got {S}")
    return S


def _check_keys(dev, K, **xs):
    for name, (x, dtype) in xs.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the table on {dev}")
        if x.dtype != dtype or tuple(x.shape) != (K,) or \
                not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({K},) {dtype} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")


def _on_card(dev, kernel):
    """True on a CUDA device; False on the CPU or meta (the plain version
    runs); anything else raises."""
    if dev.type in ("cpu", "meta"):
        return False
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on a CUDA tensor, got {dev}")
    return True


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def lookup(s_hi, s_lo, s_pay, hi, lo, valid, max_probes: int):
    """Batched membership probe by keys (no writes): ``(found (K,) bool,
    payload (K,) int32)``, H1's keys body on CUDA tensors, its plain
    version on CPU ones."""
    S = _check_table(s_hi, s_lo, s_pay)
    dev, K = s_hi.device, hi.shape[0]
    _check_keys(dev, K, hi=(hi, torch.int64), lo=(lo, torch.int64),
                valid=(valid, torch.bool))
    if not _on_card(dev, "H1"):
        plain_calls[("H1",)] += 1
        return lookup_ref(s_hi, s_lo, s_pay, hi, lo, valid, max_probes)
    require_real("lookup (H1)", s_hi, s_lo, s_pay, hi, lo, valid)
    found = torch.empty((K,), dtype=torch.bool, device=dev)
    payload = torch.empty((K,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_kernel().hashtable_lookup(
            s_hi.data_ptr(), s_lo.data_ptr(), s_pay.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), found.data_ptr(),
            payload.data_ptr(), K, S, max_probes,
            slot(("H1",), dev), _stream(dev))
    _launched(rc, "hashtable_lookup (H1)")
    return found, payload


def _rows(configs: torch.Tensor):
    """``configs`` (..., w) as contiguous int32 rows (K, w): int32 keeps
    each entry mod 2^32, as the reference's cast does."""
    w = configs.shape[-1]
    return configs.reshape(-1, w).to(torch.int32).contiguous()


def _launch_rows(hash_only, rows, valid, s_hi, s_lo, S, D, key, dev):
    from ...core.hashing import _config_consts
    K, w = rows.shape
    _, p1, p2 = _config_consts(w, dev)
    hi = torch.empty((K,), dtype=torch.int64, device=dev)
    lo = torch.empty((K,), dtype=torch.int64, device=dev)
    found = None if hash_only else \
        torch.empty((K,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = load_kernel().hashtable_rows(
            int(hash_only), rows.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            _ptr(valid), _ptr(s_hi), _ptr(s_lo), hi.data_ptr(),
            lo.data_ptr(), _ptr(found), K, w, S, D, row_threads(K),
            slot(key, dev), _stream(dev))
    _launched(rc, f"hashtable_rows ({' '.join(key)})")
    return hi, lo, found


def config_hash(configs: torch.Tensor):
    """:func:`~repro_torch.core.hashing.config_hash`: the lanes ``(hi,
    lo)`` of int configs (..., w), H1's hash body on a CUDA tensor, the
    plain version on a CPU or meta one."""
    if not _on_card(configs.device, "H1"):
        plain_calls[("H1", "hash")] += 1
        return config_hash_ref(configs)
    require_real("config_hash (H1)", configs)
    lead = configs.shape[:-1]
    hi, lo, _ = _launch_rows(True, _rows(configs), None, None, None, 1, 0,
                             ("H1", "hash"), configs.device)
    return hi.reshape(lead), lo.reshape(lead)


def hash_lookup(s_hi, s_lo, s_pay, rows, valid, max_probes: int):
    """Hash the int32 candidate rows (K, w), make the lanes canonical under
    ``valid`` and look them up (no writes): ``(hi, lo, found)``, (K,)
    each.  H1's rows body on CUDA tensors (one launch); on CPU ones its
    plain version, ``config_hash`` then the canonical lanes then
    :func:`lookup`'s plain version."""
    S = _check_table(s_hi, s_lo, s_pay)
    dev = s_hi.device
    if rows.dim() != 2:
        raise ValueError(f"rows must be (K, w), got {tuple(rows.shape)}")
    K = rows.shape[0]
    _check_keys(dev, K, valid=(valid, torch.bool))
    if rows.device != dev:
        raise ValueError(f"rows is on {rows.device}, the table on {dev}")
    if not _on_card(dev, "H1"):
        from ...core.hashtable import _canonical
        plain_calls[("H1", "rows")] += 1
        hi, lo = _canonical(*config_hash_ref(rows), valid)
        found, _ = lookup_ref(s_hi, s_lo, s_pay, hi, lo, valid, max_probes)
        return hi, lo, found
    require_real("hash_lookup (H1)", s_hi, s_lo, s_pay, rows, valid)
    return _launch_rows(False, _rows(rows), valid, s_hi, s_lo, S, max_probes,
                        ("H1", "rows"), dev)


def _claim(route, fresh, table, hi, lo, pending, payload, S, D, dev):
    """Launch H2 by ``route``; ``table`` is the three slot tensors, or
    None (a fresh table of the cluster route's own)."""
    K = hi.shape[0]
    won = torch.empty((K,), dtype=torch.bool, device=dev)
    dup = torch.empty((K,), dtype=torch.bool, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    scratch = (None,) * 4
    if route.name == "grid":
        scratch = (torch.empty((S,), dtype=torch.int32, device=dev),
                   torch.empty((K,), dtype=torch.int32, device=dev),
                   torch.empty((K,), dtype=torch.uint8, device=dev),
                   torch.empty((3,), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        rc = _lib().hashtable_claim(
            _ROUTES[route.name], route.ctas, int(fresh),
            *(_ptr(x) for x in table or (None,) * 3), hi.data_ptr(),
            lo.data_ptr(), pending.data_ptr(), _ptr(payload),
            *(_ptr(x) for x in scratch), won.data_ptr(), dup.data_ptr(),
            ovf.data_ptr(), K, S, D, slot(("H2", route.name), dev),
            _stream(dev))
    _launched(rc, f"hashtable_claim (H2, {route.name})")
    return won, dup, ovf


def claim_(s_hi, s_lo, s_pay, hi, lo, pending, payload, max_probes: int):
    """Claim-insert the pending keys into the table in place: ``(won (K,)
    bool, dup (K,) bool, overflow () bool)``, H2 by :func:`claim_route` (the
    cta or grid route) on CUDA tensors, its plain version on CPU ones
    (whose new table is copied into ``s_*``)."""
    S = _check_table(s_hi, s_lo, s_pay)
    dev, K = s_hi.device, hi.shape[0]
    _check_keys(dev, K, hi=(hi, torch.int64), lo=(lo, torch.int64),
                pending=(pending, torch.bool),
                payload=(payload, torch.int32))
    route = claim_route(K, S, max_probes, False)
    if not _on_card(dev, "H2"):
        plain_calls[("H2", route.name)] += 1
        n_hi, n_lo, n_pay, won, dup, ovf = claim_ref(
            s_hi, s_lo, s_pay, hi, lo, pending, payload, max_probes)
        s_hi.copy_(n_hi)
        s_lo.copy_(n_lo)
        s_pay.copy_(n_pay)
        return won, dup, ovf
    require_real("claim_ (H2)", s_hi, s_lo, s_pay, hi, lo, pending, payload)
    return _claim(route, False, (s_hi, s_lo, s_pay), hi, lo, pending,
                  payload, S, max_probes, dev)


def first_claim(hi, lo, pending, num_slots: int, max_probes: int):
    """The claim rounds of the pending keys into a fresh table of
    ``num_slots`` slots (payload 0): ``(won, dup, overflow)``, as
    :func:`claim_` on an empty table.  On the card the table is the
    kernel's own: the cluster route's lives in its shared memory, the
    others' are filled by the kernel.  Its plain version on CPU tensors."""
    S = int(num_slots)
    dev, K = hi.device, hi.shape[0]
    _check_keys(dev, K, hi=(hi, torch.int64), lo=(lo, torch.int64),
                pending=(pending, torch.bool))
    route = claim_route(K, S, max_probes, True)
    if not _on_card(dev, "H2"):
        from ...core.hashtable import _empty
        plain_calls[("H2", route.name)] += 1
        _, _, _, won, dup, ovf = claim_ref(
            *_empty(S, 0, dev), hi, lo, pending,
            torch.zeros(K, dtype=torch.int32, device=dev), max_probes)
        return won, dup, ovf
    require_real("first_claim (H2)", hi, lo, pending)
    table = None if route.name == "cluster" else (
        torch.empty((S,), dtype=torch.int64, device=dev),
        torch.empty((S,), dtype=torch.int64, device=dev),
        torch.empty((S,), dtype=torch.int32, device=dev))
    return _claim(route, True, table, hi, lo, pending, None, S, max_probes,
                  dev)
