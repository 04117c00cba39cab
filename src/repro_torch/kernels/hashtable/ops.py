"""Wrappers around the hand-written hash-table probe kernels H1 and H2.

:func:`lookup` (H1) and :func:`claim_` (H2) take a table as its three
slot tensors (``s_hi``, ``s_lo`` (S,) int64 holding uint32 lanes, ``s_pay``
(S,) int32; ``S`` a power of two) and canonical keys
(:func:`repro_torch.core.hashtable._canonical`):

* on CPU tensors they run the plain versions (:mod:`.ref`), as on meta
  tensors, which carry shapes only (the dry run's SNP cell);
* on CUDA tensors they launch ``csrc/hashtable.cu`` on the current stream
  and read nothing back, or raise.  There is no fallback.

:func:`claim_` writes the table in place on both routes.  H2's scratch
(the claim words, the candidates' probes and states, the round counts) is
allocated here with ``torch.empty``: inside a captured CUDA graph it comes
from the graph's pool.

Counters.  H1 and H2 count their own launches on the card, under the
keys ``("H1",)`` and ``("H2",)``
(:mod:`repro_torch.kernels.launch_counts`).  ``lookup_plain_calls`` and
``claim_plain_calls`` (plain integers, reset by callers that measure a
run) count the calls of their plain versions.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..launch_counts import slot
from ..real import require_real
from ..snp_step._build import load_library
from .ref import claim_ref, lookup_ref

__all__ = ["lookup", "claim_", "load_kernel", "claim_block_shape", "SOURCE",
           "lookup_plain_calls", "claim_plain_calls", "THREADS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "hashtable.cu"

#: Threads a block of H1 and H2.
THREADS = 256

lookup_plain_calls = 0
claim_plain_calls = 0


def load_kernel():
    """Build (at first use) and load the kernels' shared library."""
    lib = load_library(SOURCE)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hashtable_lookup.argtypes = [vp] * 8 + [i, ll, i, vp, vp]
    lib.hashtable_lookup.restype = i
    lib.hashtable_claim.argtypes = [vp] * 14 + [i, ll, i, vp, vp]
    lib.hashtable_claim.restype = i
    lib.hashtable_claim_blocks.argtypes = [ll]
    lib.hashtable_claim_blocks.restype = i
    return lib


def claim_block_shape(K: int, S: int):
    """``(blocks, threads)`` of H2's cooperative grid for ``K`` candidates
    into ``S`` slots: one thread a candidate or slot, at most the blocks
    the card holds at once."""
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


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def lookup(s_hi, s_lo, s_pay, hi, lo, valid, max_probes: int):
    """Batched membership probe (no writes): ``(found (K,) bool, payload
    (K,) int32)``, H1 on CUDA tensors, its plain version on CPU ones."""
    global lookup_plain_calls
    S = _check_table(s_hi, s_lo, s_pay)
    dev, K = s_hi.device, hi.shape[0]
    _check_keys(dev, K, hi=(hi, torch.int64), lo=(lo, torch.int64),
                valid=(valid, torch.bool))
    if dev.type in ("cpu", "meta"):
        lookup_plain_calls += 1
        return lookup_ref(s_hi, s_lo, s_pay, hi, lo, valid, max_probes)
    if dev.type != "cuda":
        raise ValueError(f"H1 runs on a CUDA tensor, got {dev}")
    require_real("lookup (H1)", s_hi, s_lo, s_pay, hi, lo, valid)
    found = torch.empty((K,), dtype=torch.bool, device=dev)
    payload = torch.empty((K,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_kernel().hashtable_lookup(
            s_hi.data_ptr(), s_lo.data_ptr(), s_pay.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), found.data_ptr(),
            payload.data_ptr(), K, S, max_probes,
            slot(("H1",), dev), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hashtable_lookup launch failed: CUDA error {rc}")
    return found, payload


def claim_(s_hi, s_lo, s_pay, hi, lo, pending, payload, max_probes: int):
    """Claim-insert the pending keys into the table in place: ``(won (K,)
    bool, dup (K,) bool, overflow () bool)``, H2 on CUDA tensors, its plain
    version on CPU ones (whose new table is copied into ``s_*``)."""
    global claim_plain_calls
    S = _check_table(s_hi, s_lo, s_pay)
    dev, K = s_hi.device, hi.shape[0]
    _check_keys(dev, K, hi=(hi, torch.int64), lo=(lo, torch.int64),
                pending=(pending, torch.bool),
                payload=(payload, torch.int32))
    if dev.type in ("cpu", "meta"):
        claim_plain_calls += 1
        n_hi, n_lo, n_pay, won, dup, ovf = claim_ref(
            s_hi, s_lo, s_pay, hi, lo, pending, payload, max_probes)
        s_hi.copy_(n_hi)
        s_lo.copy_(n_lo)
        s_pay.copy_(n_pay)
        return won, dup, ovf
    if dev.type != "cuda":
        raise ValueError(f"H2 runs on a CUDA tensor, got {dev}")
    require_real("claim_ (H2)", s_hi, s_lo, s_pay, hi, lo, pending, payload)
    won = torch.empty((K,), dtype=torch.bool, device=dev)
    dup = torch.empty((K,), dtype=torch.bool, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    claim = torch.empty((S,), dtype=torch.int32, device=dev)
    probe = torch.empty((K,), dtype=torch.int32, device=dev)
    state = torch.empty((K,), dtype=torch.uint8, device=dev)
    count = torch.empty((3,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_kernel().hashtable_claim(
            s_hi.data_ptr(), s_lo.data_ptr(), s_pay.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), pending.data_ptr(),
            payload.data_ptr(), claim.data_ptr(), probe.data_ptr(),
            state.data_ptr(), count.data_ptr(), won.data_ptr(),
            dup.data_ptr(), ovf.data_ptr(), K, S, max_probes,
            slot(("H2",), dev), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hashtable_claim launch failed: CUDA error {rc}")
    return won, dup, ovf
