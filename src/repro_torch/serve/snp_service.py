"""Batched SNP trace serving: heterogeneous requests -> padded device batches.

The port of the JAX package's ``repro.serve.snp_service``.
:func:`~repro_torch.core.engine.run_traces` is the device-side loop (the
whole batch through one ``StepBackend.expand`` a step); this module is
the host-side front end that makes it a service:

* **sync mode** (default): :meth:`~SNPTraceService.submit` returns a
  ticket; :meth:`~SNPTraceService.drain` groups compatible requests, pads
  every group to a fixed batch size and step bucket, runs one runner call
  per padded batch, and returns ``{ticket: TraceResult}``.
* **async mode** (``async_mode=True``): :meth:`submit` returns a
  :class:`concurrent.futures.Future`; a background flush thread fires as
  soon as a group fills a whole batch or the group's oldest request has
  waited ``max_delay_ms``.  A flush's error reaches the affected futures;
  :meth:`close` flushes everything still pending and joins the thread.
* **failure domains** (``policy=FaultPolicy(...)``): requests past their
  deadline fail fast with
  :class:`~repro_torch.runtime.faults.DeadlineExceeded` before using the
  device; transient flush failures retry with exponential backoff and
  deterministic jitter; exhausted retries of a backend the service chose
  itself walk the encoding-compatible backend degrade chain
  (:mod:`repro_torch.core.failover`; on the card only kernel backends
  qualify, so ``"cuda"`` has no fallback there), then **bisect the
  chunk** to isolate a poison request — re-running good traces is
  free by seed determinism — so only the culprit's future carries the
  exception; ``max_pending`` rejects at submit.  All of it shows in
  :meth:`stats`.  With ``policy=None`` one failure fails the whole
  co-batched flush.

Per-trace PRNG keys mean padding, batching and flush timing never change
a trajectory: a request's result equals a solo
:func:`~repro_torch.core.engine.run_trace` of its seed bit for bit, and
async results equal a synchronous :meth:`drain` of the same requests —
across retries and bisection too.

Departures from the reference.  ``device=None`` means the card, as at
every entry point of the port (it raises without one; the CPU runs only
when named), and the backend the service chooses (``backend=None``) is
``"cuda"`` (the reference's default is ``"ref"``): on the card the
default path runs the step kernels, as
:func:`~repro_torch.core.backend.resolve_entry` picks them.  Only that
chosen backend may degrade; a backend the caller names raises its
failure into the requests, as a named backend does at every entry point
of the port (the reference degrades a named backend too).  The runner
returns tensors on the device; each flush copies its four
:class:`~repro_torch.core.engine.TraceOut` fields to the host once and
slices the requests' results from those copies.  The drain thread runs
its flushes under ``torch.cuda.device(device)``: a thread does not
inherit another's current card.

``runner`` (a :func:`~repro_torch.core.engine.run_traces`-compatible
callable, called with ``device=``) replaces the device call;
``fault_injector`` wraps it with a deterministic fault schedule.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import failover
from ..core.backend import BackendLike, get_backend, lower_with_backend
from ..core.device import DeviceLike, resolve_device
from ..core.engine import run_traces
from ..core.matrix import CompiledAny, CompiledSparseSNP, is_compiled
from ..core.plan import SystemPlan
from ..core.system import SNPSystem
from ..runtime.faults import (AdmissionRejected, DeadlineExceeded,
                              FaultInjector, FaultPolicy, InjectedFault)

__all__ = ["TraceRequest", "TraceResult", "SNPTraceService"]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class TraceRequest:
    """One trajectory request: which system, how long, how to branch.

    ``deadline_ms`` (serving under a :class:`FaultPolicy` only) bounds
    how long the request may wait before its device call: an expired
    request fails fast with DeadlineExceeded instead of using the device.
    ``None`` falls back to the service policy's default."""

    system: SNPSystem | CompiledAny
    steps: int
    policy: str = "first"       # "first" | "random"
    seed: int = 0
    max_branches: int = 64
    deadline_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.policy not in ("first", "random"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.deadline_ms is not None and self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0")


@dataclass(frozen=True)
class TraceResult:
    """One served trajectory, unpadded to the request's ``steps``.

    ``branch_overflow[t]`` flags that step t had more than the request's
    ``max_branches`` successors (only the first T were candidates)."""

    configs: np.ndarray     # (steps, m) int32
    emissions: np.ndarray   # (steps,) int32 — the output spike train
    alive: np.ndarray       # (steps,) bool
    branch_overflow: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), bool))  # (steps,) bool

    @property
    def truncated(self) -> bool:
        """True when any step's branching was truncated to max_branches."""
        return bool(np.any(self.branch_overflow))


_STAT_KEYS = ("device_calls", "traces_served", "retries", "bisections",
              "degraded", "deadline_exceeded", "rejected", "failed_calls",
              "failed_requests", "branch_overflow_traces")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SNPTraceService:
    """Submit/drain batching front end over :func:`run_traces`.

    ``batch_size`` is the fixed device batch: every flush runs exactly this
    many traces (padded with seed 0), so a service with ``batch_size=256``
    serves a 256-request burst in **one** runner call.  ``step_bucket``
    rounds requested step counts up, so distinct ``steps`` share a batch.
    ``device`` (``None`` = the card) is where requests are compiled and
    served; ``backend`` the step backend (``None``: the service chooses
    ``"cuda"``, and only that choice may degrade).

    ``policy`` (:class:`~repro_torch.runtime.faults.FaultPolicy`) turns on
    the failure-domain machinery — deadlines, retry/backoff, degrade,
    bisect, admission control; ``None`` fails the whole flush on any
    failure.  ``fault_injector`` wraps the runner and compile path with a
    deterministic fault schedule.
    """

    def __init__(self, *, batch_size: int = 256, step_bucket: int = 16,
                 backend: BackendLike = None,
                 max_steps: Optional[int] = None,
                 runner: Optional[Callable] = None,
                 compile_cache_cap: int = 64,
                 async_mode: bool = False,
                 max_delay_ms: float = 10.0,
                 policy: Optional[FaultPolicy] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 device: DeviceLike = None) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if step_bucket < 1:
            raise ValueError("step_bucket must be >= 1")
        if compile_cache_cap < 1:
            raise ValueError("compile_cache_cap must be >= 1")
        if max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pin the card now: the drain thread has no current device
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.batch_size = batch_size
        self.step_bucket = step_bucket
        self.max_steps = max_steps
        self.backend = get_backend("cuda" if backend is None else backend)
        #: only a backend the service chose itself may degrade
        self.degradable = backend is None
        self.policy = policy
        self.fault_injector = fault_injector
        runner = run_traces if runner is None else runner
        if fault_injector is not None:
            runner = fault_injector.runner(runner)
        self.runner = runner
        self.async_mode = async_mode
        self.max_delay_ms = max_delay_ms
        self._stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}
        #: sync mode under a policy: {ticket: exception} of the requests
        #: the last drain() definitively failed (replaced per drain)
        self.last_failures: Dict[int, BaseException] = {}
        self._tickets = itertools.count()
        self._pending: Dict[int, TraceRequest] = {}
        self._comp_of: Dict[int, CompiledAny] = {}   # ticket -> compiled
        # compile memoization, keyed by SNPSystem (structural equality),
        # bounded; the backend is fixed, so one cache is one encoding
        self._compile_cache: Dict[SNPSystem, CompiledAny] = {}
        self._compile_cache_cap = compile_cache_cap
        # degraded lowerings ({(backend name, comp id): comp})
        self._degraded_cache: Dict[Tuple[str, int], CompiledAny] = {}
        # async state (all mutated under the one condition's lock)
        self._cv = threading.Condition()
        self._futures: Dict[int, Future] = {}
        self._submit_t: Dict[int, float] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if async_mode:
            self._thread = threading.Thread(
                target=self._drain_loop, name="snp-service-drain", daemon=True)
            self._thread.start()

    # -- observability -----------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._cv:
            self._stats[key] += n

    def stats(self) -> Dict[str, int]:
        """Snapshot of the service counters: ``device_calls``,
        ``traces_served``, and the failure-domain counters (``retries``,
        ``bisections``, ``degraded``, ``deadline_exceeded``, ``rejected``,
        ``failed_calls``, ``failed_requests``,
        ``branch_overflow_traces``)."""
        with self._cv:
            return dict(self._stats)

    @property
    def num_device_calls(self) -> int:
        with self._cv:
            return self._stats["device_calls"]

    @property
    def num_traces_served(self) -> int:
        with self._cv:
            return self._stats["traces_served"]

    # -- submission --------------------------------------------------------

    def _compile(self, request: TraceRequest) -> CompiledAny:
        if is_compiled(request.system):
            return request.system
        # Equal systems share one compilation and one batch group.  The
        # compile runs outside the lock (it may be slow and must not stall
        # the drain thread); two racing submitters may both compile, the
        # first insert wins and both use it.
        with self._cv:
            comp = self._compile_cache.get(request.system)
        if comp is None:
            if self.fault_injector is not None:
                self.fault_injector.on_compile(request.system)
            comp = self.backend.compile(request.system, device=self.device)
            with self._cv:
                if request.system not in self._compile_cache:
                    while len(self._compile_cache) >= self._compile_cache_cap:
                        self._compile_cache.pop(
                            next(iter(self._compile_cache)))
                    self._compile_cache[request.system] = comp
                comp = self._compile_cache[request.system]
        return comp

    def _admit(self) -> None:
        """Admission control (lock held)."""
        pol = self.policy
        if pol is not None and pol.max_pending is not None \
                and len(self._pending) >= pol.max_pending:
            self._stats["rejected"] += 1
            raise AdmissionRejected(
                f"{len(self._pending)} requests pending >= "
                f"max_pending={pol.max_pending}")

    def submit(self, request: TraceRequest):
        """Queue a request.

        Sync mode: returns an ``int`` ticket to look up in :meth:`drain`.
        Async mode: returns a :class:`~concurrent.futures.Future` resolving
        to the request's :class:`TraceResult` (or the flush's exception).
        Under a policy with ``max_pending``, raises
        :class:`~repro_torch.runtime.faults.AdmissionRejected` when the
        queue is full.
        """
        if self.max_steps is not None and request.steps > self.max_steps:
            raise ValueError(
                f"steps {request.steps} exceeds service max_steps "
                f"{self.max_steps}")
        with self._cv:
            self._admit()
        comp = self._compile(request)   # outside the lock: may be slow
        with self._cv:
            if self._closed:
                raise RuntimeError("service is closed")
            self._admit()
            ticket = next(self._tickets)
            self._pending[ticket] = request
            self._comp_of[ticket] = comp
            self._submit_t[ticket] = time.monotonic()
            if not self.async_mode:
                return ticket
            fut: Future = Future()
            self._futures[ticket] = fut
            self._cv.notify_all()
            return fut

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    # -- grouping ----------------------------------------------------------

    def _group_key(self, ticket: int) -> Tuple:
        r = self._pending[ticket]
        return (id(self._comp_of[ticket]), r.policy, r.max_branches)

    def _groups(self) -> Dict[Tuple, List[int]]:
        by_group: Dict[Tuple, List[int]] = {}
        for ticket in sorted(self._pending):
            by_group.setdefault(self._group_key(ticket), []).append(ticket)
        return by_group

    def _take(self, tickets: List[int]) -> List[TraceRequest]:
        """Remove ``tickets`` from the pending maps (lock held)."""
        reqs = [self._pending.pop(t) for t in tickets]
        for t in tickets:
            self._comp_of.pop(t)
            self._submit_t.pop(t, None)
        return reqs

    # -- synchronous draining ----------------------------------------------

    def drain(self) -> Dict[int, TraceResult]:
        """Serve every pending request; returns ``{ticket: TraceResult}``.

        One runner call per (group, full-batch chunk).  Sync mode only.

        Without a policy the drain is all-or-nothing: on any failure the
        whole drain stays pending and the exception raises, so a retry
        drain() serves everything (re-running a chunk that succeeded
        changes nothing).  With a :class:`FaultPolicy` the recovery
        machinery runs per chunk; requests it definitively fails are
        popped and their exceptions recorded in :attr:`last_failures`
        (and the ``failed_requests`` counter) while every other ticket's
        result returns.
        """
        if self.async_mode:
            raise RuntimeError(
                "drain() is sync-mode only; async results arrive via the "
                "futures returned by submit()")
        results: Dict[int, TraceResult] = {}
        with self._cv:
            batches = []
            for (_, policy, max_branches), tickets in self._groups().items():
                comp = self._comp_of[tickets[0]]
                for lo in range(0, len(tickets), self.batch_size):
                    chunk = tickets[lo:lo + self.batch_size]
                    batches.append((comp, policy, max_branches, chunk,
                                    [self._pending[t] for t in chunk]))
            born = dict(self._submit_t)
        if self.policy is None:
            for comp, policy, max_branches, chunk, reqs in batches:
                results.update(self._run_batch(comp, policy, max_branches,
                                               chunk, reqs))
            with self._cv:
                for _, _, _, chunk, _ in batches:
                    self._take(chunk)
            return results
        failures: Dict[int, BaseException] = {}
        for comp, policy, max_branches, chunk, reqs in batches:
            res, fail = self._serve_chunk(comp, policy, max_branches,
                                          chunk, reqs, born)
            results.update(res)
            failures.update(fail)
        # under a policy every ticket was resolved: served, expired, or
        # isolated and failed — so everything pops
        with self._cv:
            for _, _, _, chunk, _ in batches:
                self._take(chunk)
        self.last_failures = failures
        return results

    # -- the device call ---------------------------------------------------

    def _run_batch(self, comp: CompiledAny, policy: str, max_branches: int,
                   tickets: List[int], reqs: List[TraceRequest],
                   backend=None) -> Dict[int, TraceResult]:
        backend = self.backend if backend is None else backend
        steps = _round_up(max(r.steps for r in reqs), self.step_bucket)
        seeds = np.zeros((self.batch_size,), np.uint32)   # pad: seed 0
        seeds[:len(reqs)] = [r.seed for r in reqs]

        out = self.runner(
            comp, steps=steps, seeds=seeds, policy=policy,
            max_branches=max_branches, backend=backend, device=self.device)
        cfgs, emis, alive, ovf = (_host(x) for x in out)   # once a flush
        self._count("device_calls")
        self._count("traces_served", len(reqs))
        results = {
            t: TraceResult(configs=cfgs[i, :r.steps],
                           emissions=emis[i, :r.steps],
                           alive=alive[i, :r.steps],
                           branch_overflow=ovf[i, :r.steps])
            for i, (t, r) in enumerate(zip(tickets, reqs))
        }
        truncated = sum(1 for r in results.values() if r.truncated)
        if truncated:
            self._count("branch_overflow_traces", truncated)
        return results

    # -- failure-domain recovery (policy set) ------------------------------

    def _degraded_comps(self, comp: CompiledAny):
        """Yield ``(backend, lowered comp)`` down the encoding-compatible
        degrade chain of this service's backend.  The chunk's encoding is
        reused as it is — degradation swaps the step, never the encoding —
        so the re-lowering is cheap and memoized."""
        if isinstance(comp, CompiledSparseSNP):
            enc = "hybrid" if comp.is_hybrid else "ell"
        else:
            enc = "dense"
        for cand, plan in failover.degrade_candidates(
                self.backend, SystemPlan(encoding=enc), device=self.device):
            key = (cand.name, id(comp))
            try:
                with self._cv:
                    lowered = self._degraded_cache.get(key)
                if lowered is None:
                    lowered = lower_with_backend(cand, comp, plan)
                    with self._cv:
                        self._degraded_cache[key] = lowered
            except Exception:
                continue    # this candidate cannot lower the encoding
            yield cand, lowered

    def _serve_chunk(self, comp: CompiledAny, policy: str, max_branches: int,
                     tickets: List[int], reqs: List[TraceRequest],
                     born: Dict[int, float], depth: int = 0,
                     ) -> Tuple[Dict[int, TraceResult],
                                Dict[int, BaseException]]:
        """Serve one chunk under the failure-domain state machine:
        deadline filter -> run -> retry with backoff -> degrade -> bisect
        -> fail the irreducible request with the *last* exception.
        Returns ``(results, failures)``; every ticket lands in one."""
        pol = self.policy
        results: Dict[int, TraceResult] = {}
        failures: Dict[int, BaseException] = {}

        # fail fast on expired deadlines: no device time for dead requests
        now = time.monotonic()
        live_t, live_r = [], []
        for t, r in zip(tickets, reqs):
            limit = r.deadline_ms if r.deadline_ms is not None \
                else pol.deadline_ms
            t0 = born.get(t)
            if limit is not None and t0 is not None \
                    and (now - t0) * 1e3 > limit:
                failures[t] = DeadlineExceeded(
                    f"request waited {(now - t0) * 1e3:.1f} ms "
                    f"> deadline {limit:g} ms")
                self._count("deadline_exceeded")
                continue
            live_t.append(t)
            live_r.append(r)
        if not live_t:
            return results, failures

        # retry with exponential backoff and deterministic jitter; bisected
        # halves (depth > 0) run once: the parent spent the retries
        retries = pol.max_retries if depth == 0 else 0
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            if attempt:
                self._count("retries")
                time.sleep(pol.backoff_s(attempt - 1, token=live_t[0]))
            try:
                results.update(self._run_batch(
                    comp, policy, max_branches, live_t, live_r))
                return results, failures
            except Exception as e:
                last = e
                self._count("failed_calls")
                if isinstance(e, InjectedFault) and type(e) is not \
                        InjectedFault and attempt == 0:
                    # a PoisonError is persistent: retries never clear
                    # it, go isolate it instead
                    break

        # whole-chunk backend degradation (encoding-compatible chain) of
        # the service's own choice, on a backend failure only: injected
        # faults model the loss of a node, not a broken backend
        if pol.degrade and self.degradable and depth == 0 \
                and failover.is_backend_failure(last):
            for cand, lowered in self._degraded_comps(comp):
                try:
                    results.update(self._run_batch(
                        comp=lowered, policy=policy,
                        max_branches=max_branches, tickets=live_t,
                        reqs=live_r, backend=cand))
                except Exception as e:
                    last = e
                    self._count("failed_calls")
                    continue
                self._count("degraded")
                failover.record_degradation(
                    self.backend.name, cand.name, "serve", last)
                return results, failures

        # bisect: the good half re-runs for free, the bad half narrows
        if pol.bisect and len(live_t) > 1:
            self._count("bisections")
            mid = len(live_t) // 2
            for lo, hi in ((0, mid), (mid, len(live_t))):
                res, fail = self._serve_chunk(
                    comp, policy, max_branches, live_t[lo:hi],
                    live_r[lo:hi], born, depth + 1)
                results.update(res)
                failures.update(fail)
            return results, failures

        # irreducible: the request itself is the failure domain
        for t in live_t:
            failures[t] = last
            self._count("failed_requests")
        return results, failures

    # -- asynchronous draining ---------------------------------------------
    #
    # A group is FILLING until (a) it holds >= batch_size requests (its
    # full chunks flush now), (b) its oldest request is older than
    # max_delay_ms (the whole group flushes now, one padded partial chunk
    # last), or (c) the service closes (everything flushes).  The thread
    # sleeps until the earliest deadline or a submit notification.
    # _take_ready and _next_deadline compare time through the same
    # `submit_t + delay` expression, so a group is overdue iff its
    # remaining wait is exactly 0.0: the thread is never told "nothing to
    # flush" and "wait 0 seconds" at once.

    def _take_ready(self, now: float, flush_all: bool) -> List[Tuple]:
        """Pop every chunk that must flush now (lock held)."""
        delay = self.max_delay_ms / 1e3
        batches: List[Tuple] = []
        for (_, policy, max_branches), tickets in self._groups().items():
            comp = self._comp_of[tickets[0]]
            take: List[int] = []
            if flush_all or now >= self._submit_t[tickets[0]] + delay:
                take = tickets
            elif len(tickets) >= self.batch_size:
                n_full = (len(tickets) // self.batch_size) * self.batch_size
                take = tickets[:n_full]
            for lo in range(0, len(take), self.batch_size):
                chunk = take[lo:lo + self.batch_size]
                futs = [self._futures.pop(t) for t in chunk]
                born = {t: self._submit_t[t] for t in chunk}
                batches.append((comp, policy, max_branches, chunk,
                                self._take(chunk), futs, born))
        return batches

    def _next_deadline(self, now: float) -> Optional[float]:
        """Seconds until the earliest group deadline (lock held)."""
        if not self._submit_t:
            return None
        oldest = min(self._submit_t.values())
        return max(0.0, oldest + self.max_delay_ms / 1e3 - now)

    def _drain_loop(self) -> None:
        on_card = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        with on_card:
            while True:
                with self._cv:
                    now = time.monotonic()
                    batches = self._take_ready(now, flush_all=self._closed)
                    if not batches:
                        if self._closed:
                            return
                        timeout = self._next_deadline(now)
                        if timeout is not None and timeout <= 0:
                            continue    # unreachable by construction
                        self._cv.wait(timeout=timeout)
                        continue
                for batch in batches:
                    self._flush(*batch)

    def _flush(self, comp, policy, max_branches, tickets, reqs, futs,
               born) -> None:
        # claim RUNNING first: a future the caller cancelled is skipped,
        # not written to (set_result on it would raise and kill the
        # thread); once RUNNING, cancel() can no longer win the race
        live = [fut.set_running_or_notify_cancel() for fut in futs]
        if self.policy is None:
            try:
                results = self._run_batch(comp, policy, max_branches,
                                          tickets, reqs)
            except BaseException as e:      # into the futures
                for fut, ok in zip(futs, live):
                    if ok:
                        fut.set_exception(e)
                return
            failures: Dict[int, BaseException] = {}
        else:
            try:
                results, failures = self._serve_chunk(
                    comp, policy, max_branches, tickets, reqs, born)
            except BaseException as e:      # recovery itself failed
                results, failures = {}, {t: e for t in tickets}
        for t, fut, ok in zip(tickets, futs, live):
            if not ok:
                continue        # cancelled before the flush claimed it
            if t in results:
                fut.set_result(results[t])
            else:
                fut.set_exception(failures.get(t, RuntimeError(
                    f"request {t} left unserved by recovery")))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Flush everything pending and stop the drain thread (async mode);
        idempotent, and a no-op beyond marking closed in sync mode."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "SNPTraceService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
