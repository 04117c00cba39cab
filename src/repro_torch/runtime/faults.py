"""Failure-domain primitives of the SNP serving and exploration paths (the
port of the JAX package's ``repro.runtime.faults``, pure Python, a copy of
its own).

Every transition is a deterministic function of the configuration and
(for traces) the per-request PRNG seed, which makes recovery by
re-execution safe: re-running a trace that already succeeded changes
nothing, and a BFS resumed from a snapshot of its state equals an
uninterrupted run bit for bit.  This module holds the vocabulary the
recovery machinery shares:

* :class:`FaultPolicy` — how a service reacts to failures: bounded
  retries with exponential backoff and *deterministic* jitter,
  per-request deadlines, admission control, and whether to bisect failing
  chunks and degrade backends.  Carried by
  :class:`~repro_torch.serve.snp_service.SNPTraceService` and
  ``launch/serve.py --snp``.
* :class:`FaultInjector` — a deterministic fault schedule for tests and
  the smoke run: "fail the Nth device call" (transient: fires once),
  "stall call K" (deadline pressure), "poison seed X" (persistent: every
  call whose batch holds that seed fails) and "fail the Nth compile".  One
  thread-safe call counter is shared by the service's runner, the
  engine's chunked explore loop and the sharded explore's chunk loop, so
  one schedule reaches every recovery path.
* :func:`run_supervised` — re-invoke a callable that resumes from its own
  checkpoint (e.g. :func:`repro_torch.core.engine.explore` with
  ``checkpoint_dir=``) until it completes, bounding the restarts.

The exception taxonomy is part of the recovery contract:
:class:`DeadlineExceeded` and :class:`AdmissionRejected` are *caller*
outcomes (the request never used the device); :class:`InjectedFault` is
transient (a retry may clear it); :class:`PoisonError` is persistent
(retries never clear it: only bisection isolates the culprit).
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = ["FaultPolicy", "FaultInjector", "InjectedFault", "PoisonError",
           "DeadlineExceeded", "AdmissionRejected", "run_supervised"]


class InjectedFault(RuntimeError):
    """A scheduled transient failure: the injector raises it once per
    scheduled call ordinal, so a retry of the same work succeeds."""


class PoisonError(InjectedFault):
    """A scheduled *persistent* failure: raised on every device call whose
    batch contains a poisoned seed.  Retries can never clear it; only
    bisecting the chunk isolates the culprit request."""


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_ms`` elapsed before it reached the device;
    it fails fast without consuming device time."""


class AdmissionRejected(RuntimeError):
    """``FaultPolicy.max_pending`` admission control rejected the request
    at submit time instead of growing the queue without bound."""


@dataclass(frozen=True)
class FaultPolicy:
    """How a serving/exploration path reacts to failures.

    * ``max_retries``    — whole-chunk re-runs after the first failure
      (exponential backoff between attempts).
    * ``backoff_ms`` / ``backoff_factor`` / ``jitter`` — attempt ``k``
      sleeps ``backoff_ms * backoff_factor**k`` scaled by up to
      ``+jitter`` *deterministic* jitter (a CRC of the attempt and chunk
      identity — reproducible schedules, no thundering herd).
    * ``deadline_ms``    — default per-request deadline; a request older
      than this fails fast with :class:`DeadlineExceeded` before the
      device call.  ``TraceRequest.deadline_ms`` overrides per request.
    * ``max_pending``    — admission control: ``submit`` raises
      :class:`AdmissionRejected` once this many requests are queued.
    * ``bisect``         — after retries are exhausted, split the chunk in
      half and recurse, isolating poison requests so only the culprit's
      future carries the exception (re-running good traces is free by
      seed-determinism).
    * ``degrade``        — after retries are exhausted, walk the
      encoding-compatible backend degrade chain
      (:mod:`repro_torch.core.failover`) before bisecting.
    """

    max_retries: int = 2
    backoff_ms: float = 10.0
    backoff_factor: float = 2.0
    jitter: float = 0.1
    deadline_ms: Optional[float] = None
    max_pending: Optional[int] = None
    bisect: bool = True
    degrade: bool = True

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_ms < 0 or self.backoff_factor < 1 or self.jitter < 0:
            raise ValueError("backoff_ms >= 0, backoff_factor >= 1 and "
                             "jitter >= 0 required")

    def backoff_s(self, attempt: int, token: Any = 0) -> float:
        """Seconds to sleep before retry ``attempt`` (0-based).  Jitter is
        a pure function of (attempt, token) — deterministic and
        schedule-reproducible, but decorrelated across chunks."""
        base = self.backoff_ms * (self.backoff_factor ** attempt) / 1e3
        frac = (zlib.crc32(f"{attempt}:{token}".encode()) % 1024) / 1023.0
        return base * (1.0 + self.jitter * frac)


class FaultInjector:
    """Deterministic fault schedule shared by every SNP recovery path.

    * ``fail_calls``  — 1-based device-call ordinals that raise
      :class:`InjectedFault` **once** each (transient).
    * ``slow_calls``  — ``{ordinal: seconds}`` stalls injected before the
      call runs (deadline pressure: "timeout flush K").
    * ``poison_seeds`` — any device call whose seed batch contains one of
      these raises :class:`PoisonError` **every time** (persistent;
      poisoned seeds must be nonzero — batch padding uses seed 0).
    * ``fail_compiles`` — 1-based compile ordinals that raise once each.

    One thread-safe counter is shared between the wrapped service runner
    (:meth:`runner`), the engine's chunked explore loop and the sharded
    explore's chunk loop (:meth:`on_device_call`), so a single schedule
    is meaningful across all three.
    """

    def __init__(self, *, fail_calls: Iterable[int] = (),
                 slow_calls: Optional[Dict[int, float]] = None,
                 poison_seeds: Iterable[int] = (),
                 fail_compiles: Iterable[int] = (),
                 error_factory: Optional[Callable[[int], Exception]] = None,
                 ) -> None:
        self.fail_calls = set(int(n) for n in fail_calls)
        self.slow_calls = dict(slow_calls or {})
        self.poison_seeds = frozenset(int(s) for s in poison_seeds)
        if 0 in self.poison_seeds:
            raise ValueError("poison seed 0 would also match batch padding")
        self.fail_compiles = set(int(n) for n in fail_compiles)
        self.error_factory = error_factory
        self.calls = 0
        self.compiles = 0
        self.injected = 0
        self._lock = threading.Lock()

    def on_device_call(self, seeds=None) -> int:
        """Advance the call counter; raise if this ordinal (or a poisoned
        seed in ``seeds``) is scheduled.  Returns the ordinal."""
        with self._lock:
            self.calls += 1
            n = self.calls
            fire = n in self.fail_calls
            if fire:
                self.fail_calls.discard(n)   # transient: fires once
        if n in self.slow_calls:
            time.sleep(self.slow_calls[n])
        # transient infrastructure faults fire regardless of payload, so a
        # scheduled ordinal is never masked by a poison request riding in
        # the same batch (the poison fires on the retry instead)
        if fire:
            with self._lock:
                self.injected += 1
            if self.error_factory is not None:
                raise self.error_factory(n)
            raise InjectedFault(f"injected failure at device call {n}")
        if seeds is not None and self.poison_seeds:
            present = self.poison_seeds.intersection(
                int(s) for s in np.asarray(seeds).reshape(-1).tolist())
            if present:
                with self._lock:
                    self.injected += 1
                raise PoisonError(
                    f"injected poison request (seed {sorted(present)}) "
                    f"at device call {n}")
        return n

    def on_compile(self, system=None) -> int:
        with self._lock:
            self.compiles += 1
            n = self.compiles
            fire = n in self.fail_compiles
            if fire:
                self.fail_compiles.discard(n)
        if fire:
            with self._lock:
                self.injected += 1
            raise InjectedFault(f"injected failure at compile {n}")
        return n

    def runner(self, inner: Callable) -> Callable:
        """Wrap a :func:`~repro_torch.core.engine.run_traces`-compatible
        runner so every device call passes through the schedule first."""
        def wrapped(comp, *, seeds, **kw):
            self.on_device_call(seeds=seeds)
            return inner(comp, seeds=seeds, **kw)
        return wrapped


def run_supervised(fn: Callable[[], Any], *, max_restarts: int = 3,
                   restartable: Tuple[type, ...] = (Exception,),
                   ) -> Tuple[Any, int]:
    """Re-invoke ``fn`` until it completes; returns ``(result, restarts)``.

    ``fn`` must be resumable from its own durable state — e.g. a closure
    over :func:`repro_torch.core.engine.explore` with
    ``checkpoint_dir=`` set, which restores the latest complete snapshot
    on entry — so each restart continues instead of starting over.
    Raises ``RuntimeError`` (chaining the last failure) once
    ``max_restarts`` is exceeded; never swallows ``KeyboardInterrupt``.
    """
    restarts = 0
    while True:
        try:
            return fn(), restarts
        except restartable as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={max_restarts}") from e
