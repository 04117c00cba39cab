"""Backend degradation: walk an explicit, encoding-compatible fallback
chain when a backend the caller did not name fails — never silently,
never in a loop.

The port of the JAX package's ``repro.core.failover``.  When — and only
when — the entry point chose the backend itself (``backend=None``, no
backend, encoding or kernel pinned by the plan, ``mode`` ``"auto"`` or
``"measure"``: the ``planned`` flag of
:func:`~.backend.resolve_entry_info`), a backend's failure to
build, lower or launch (:func:`is_backend_failure`) walks
:data:`DEGRADE_ORDER`, restricted to the backends whose
``supported_encodings`` realize the plan's encoding, warns once per edge
and notifies the listeners (the trace service counts degradations in its
stats).  A backend the caller *named* raises its failure: pinning is a
contract, not a hint.

On the card the walk stays on :data:`KERNEL_BACKENDS`: the plain
backends (``"sparse"``, ``"ref"``) never stand in for a kernel there, so
a kernel that does not build or launch raises its failure.  The walk
down to them is for tensors on the CPU, where every backend runs plain
PyTorch.

Degradation happens here and in the trace service's recovery only: a
kernel wrapper never falls back to its plain version, it launches or
raises.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

from ..runtime.faults import InjectedFault
from .backend import get_backend, supported_under
from .plan import SystemPlan

__all__ = ["DEGRADE_ORDER", "KERNEL_BACKENDS", "DegradeEvent",
           "degrade_candidates", "is_backend_failure", "run_with_failover",
           "record_degradation", "add_degrade_listener",
           "remove_degrade_listener"]

# Most specialised first, the reference's chain through REFERENCE_NAME
# ("sparse_pallas", "pallas", "sparse", "ref"); every walk moves strictly
# rightward, so a degraded run never returns to the backend that failed.
DEGRADE_ORDER: Tuple[str, ...] = ("sparse_cuda", "cuda", "sparse", "ref")

#: The backends whose steps are the hand-written kernels: on the card a
#: degraded run may move only between these.
KERNEL_BACKENDS: Tuple[str, ...] = ("sparse_cuda", "cuda")


@dataclass(frozen=True)
class DegradeEvent:
    """One degradation edge: which backend failed, at what stage
    (``"run"``, ``"serve"``), falling back to what, and the failure's
    repr."""

    from_backend: str
    to_backend: str
    stage: str
    error: str


_LOCK = threading.Lock()
_WARNED: set = set()
_LISTENERS: List[Callable[[DegradeEvent], None]] = []


def add_degrade_listener(cb: Callable[[DegradeEvent], None]) -> None:
    """Register a callback invoked on every degradation."""
    with _LOCK:
        _LISTENERS.append(cb)


def remove_degrade_listener(cb: Callable[[DegradeEvent], None]) -> None:
    with _LOCK:
        if cb in _LISTENERS:
            _LISTENERS.remove(cb)


def record_degradation(from_backend: str, to_backend: str, stage: str,
                       error: BaseException) -> DegradeEvent:
    """Emit one degradation: warn once per (from, to) edge for the life of
    the process, always notify the listeners."""
    event = DegradeEvent(from_backend, to_backend, stage, repr(error))
    with _LOCK:
        first = (from_backend, to_backend) not in _WARNED
        _WARNED.add((from_backend, to_backend))
        listeners = list(_LISTENERS)
    if first:
        warnings.warn(
            f"backend {from_backend!r} failed at {stage} time "
            f"({event.error}); degrading to {to_backend!r} — results are "
            "bit-identical across backends, only speed changes",
            RuntimeWarning, stacklevel=3)
    for cb in listeners:
        cb(event)
    return event


def is_backend_failure(error: BaseException) -> bool:
    """Whether ``error`` is a backend's failure to build, lower or launch
    — a ``RuntimeError``, as a failed kernel build or a CUDA launch error
    raises — and so may degrade.  The caller's own errors (a bad argument,
    a snapshot that does not fit: ``ValueError``, ``TypeError``,
    ``OSError``), running out of device memory and an
    :class:`~repro_torch.runtime.faults.InjectedFault` (the loss of a node,
    whose recovery is the supervisor's checkpoint-resume) never do."""
    return isinstance(error, RuntimeError) and not isinstance(
        error, (InjectedFault, torch.cuda.OutOfMemoryError))


def degrade_candidates(backend, plan: SystemPlan, *, device=None
                       ) -> List[Tuple[object, SystemPlan]]:
    """Encoding-compatible fallbacks strictly after ``backend`` in
    :data:`DEGRADE_ORDER`, each with the plan it runs under (the same
    encoding choice, the backend re-pinned, ``kernel`` dropped: a block
    shape belongs to the backend it was chosen for).  On the card (``device``
    ``None`` or a CUDA device) only :data:`KERNEL_BACKENDS` qualify, so a
    dense or sparse kernel has no fallback there.

    A candidate must realize the plan's encoding under its semantics tier
    — a degraded run re-lowers the same plan, so ``"sparse_cuda"`` on an
    ELL or hybrid plan degrades to ``"sparse"``, never to the dense-only
    ``"ref"`` — and a sharded plan degrades only to backends that step a
    shard."""
    name = getattr(backend, "name", None)
    if name not in DEGRADE_ORDER:
        return []
    on_card = device is None or torch.device(device).type == "cuda"
    out: List[Tuple[object, SystemPlan]] = []
    for cand_name in DEGRADE_ORDER[DEGRADE_ORDER.index(name) + 1:]:
        if on_card and cand_name not in KERNEL_BACKENDS:
            continue
        cand = get_backend(cand_name)
        sup = supported_under(cand, plan.semantics)
        if not sup:
            continue
        if plan.num_shards > 1 and "sharded" not in sup:
            continue
        if plan.encoding != "auto" and plan.encoding not in sup:
            continue
        out.append((cand, dataclasses.replace(plan, backend=cand_name,
                                              kernel=None)))
    return out


def run_with_failover(attempt: Callable[[object, SystemPlan], object],
                      backend, plan: SystemPlan, *, degradable: bool,
                      device=None, stage: str = "run"):
    """Run ``attempt(backend, plan)``; when ``degradable`` (the entry
    point chose the backend), walk the degrade chain on ``device`` while
    the failures are backend failures (:func:`is_backend_failure`).

    ``attempt`` covers compile, lowering and the run, so a backend that
    breaks only at its first launch still degrades.  Any other error
    raises at once.  Once the chain is exhausted the first backend's
    failure re-raises: the later ones are in the degradation events."""
    if not degradable:
        return attempt(backend, plan)
    chain = [(backend, plan)] + degrade_candidates(backend, plan,
                                                   device=device)
    first: BaseException = None
    for i, (be, p) in enumerate(chain):
        try:
            return attempt(be, p)
        except Exception as e:
            if not is_backend_failure(e):
                raise
            if first is None:
                first = e
            if i + 1 < len(chain):
                record_degradation(be.name, chain[i + 1][0].name, stage, e)
    raise first
