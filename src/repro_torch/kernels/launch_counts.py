"""Launch counts that the step and hash-table kernels add on the card.

Each kernel B1-B7, H1 and H2 takes a pointer to a 64-bit counter and adds
one to it from thread 0 of block 0 when it runs.  So a count is what the
card ran: a launch made from Python and one replayed from a CUDA graph
(:mod:`repro_torch.core.graph_loop`) count alike, and no count is derived
from another.  A wrapper passes :func:`slot` for its key: ``(kernel, rows,
threads)`` for a step kernel (``"B1"`` ... ``"B7"``; B5's two bodies
``"B5-ELL"`` and ``"B5-COO"``), the block shape that ran, and for a
hash-table kernel its body or route: ``("H1",)``, ``("H1", "rows")``,
``("H1", "hash")``, ``("H2", "cta")``, ``("H2", "cluster")``, ``("H2",
"grid")`` (:data:`repro_torch.kernels.hashtable.ops.KEYS`).

The counters live in one int64 tensor a card, made at that card's first
launch, which must not be inside a graph capture (a capture would record
the allocation's fill into the graph).  :func:`reset` sets them to 0 on
the card; :func:`read` copies them out.  The copy is the caller's
measurement, not a read of the port's: it is not counted in
:data:`repro_torch.core.device.host_reads`, and it waits on the card, so
it is made outside :func:`~repro_torch.core.device.sync_check`.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Optional, Tuple

import torch

__all__ = ["slot", "reset", "read", "by_kernel", "launches", "SLOTS"]

#: Counters a card holds: one a key.
SLOTS = 1024

_buffers: Dict[torch.device, torch.Tensor] = {}
_keys: Dict[Hashable, int] = {}
_lock = threading.Lock()


def slot(key: Tuple, device: torch.device) -> int:
    """The address of ``key``'s counter on the CUDA ``device``."""
    dev = torch.device(device)
    with _lock:
        i = _keys.get(key)
        if i is None:
            if len(_keys) == SLOTS:
                raise RuntimeError(f"more than {SLOTS} launch-count keys")
            i = _keys[key] = len(_keys)
        buf = _buffers.get(dev)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"the launch counters of {dev} are made at its first "
                    f"launch outside a graph capture")
            buf = _buffers[dev] = torch.zeros(SLOTS, dtype=torch.int64,
                                              device=dev)
    return buf.data_ptr() + 8 * i


def reset() -> None:
    """Every counter to 0, on the card (enqueued; no wait)."""
    with _lock:
        for buf in _buffers.values():
            buf.zero_()


def read() -> Dict[Tuple, int]:
    """Launches by key since :func:`reset`, summed over the cards: one
    copy a card (keys that ran no launch are left out)."""
    with _lock:
        keys = dict(_keys)
        bufs = list(_buffers.values())
    total = [0] * len(keys)
    for buf in bufs:
        for i, n in enumerate(buf[:len(keys)].tolist()):
            total[i] += n
    return {k: total[i] for k, i in keys.items() if total[i]}


def by_kernel(counts: Dict[Tuple, int]) -> Dict[str, int]:
    """``read()``'s counts summed over block shapes, by kernel."""
    out: Dict[str, int] = {}
    for key, n in counts.items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


def launches(kernel: Optional[str] = None) -> int:
    """``kernel``'s launches since :func:`reset` (every kernel's with
    ``None``)."""
    counts = by_kernel(read())
    return sum(counts.values()) if kernel is None else counts.get(kernel, 0)
