"""Breadth-first exploration of an SNP system's computation tree, and
batched traces.

The port of ``repro.core.engine``.  :func:`explore` implements the paper's
Algorithm 1: each level expands the frontier through a step backend,
hashes every successor, dedups it against the visited set, and compacts
the new configurations into the next frontier and the archive.  The
reference runs the whole BFS as one ``lax.while_loop``; here a level
updates an :class:`ExploreState` of device tensors in place and reads
nothing (the hash table's probes are the kernels H1 and H2, the counts
and the step device scalars), and on the card the loop over levels is
one CUDA graph whose WHILE node tests ``step < bound && total_new > 0``
on the device (:mod:`.graph_loop`).  A run reads its counts and flags
once at the end and copies its archive out: two reads, counted in
:data:`repro_torch.core.device.host_reads`, whatever its levels.

The level loop's state is one :class:`ExploreState`; with
``checkpoint_dir`` the loop runs in chunks of levels (one graph launch
and one read each) and snapshots it between chunks
(:mod:`repro_torch.checkpoint`), so a killed run resumes where its last
snapshot left off and returns the uninterrupted archive.
An entry point that chose its backend itself degrades it when it fails
to build, lower or launch (:mod:`.failover`; on the card only to another
kernel backend).

Overflow conditions are reported, never silently dropped:

* ``branch_overflow``   — some config had Ψ > T (only its first T branches
  were explored);
* ``frontier_overflow`` — more than F new configs in one level; the excess
  are not marked visited, so they regenerate later;
* ``visited_overflow``  — the visited set is full (same soundness).

The transition is a step backend (:mod:`.backend`): ``"cuda"`` and
``"ref"`` on the dense encoding, ``"sparse_cuda"`` and ``"sparse"`` on
the ELL or hybrid one.  An :class:`SNPSystem` is lowered by the backend's
own ``compile`` under ``plan`` (:class:`~.plan.SystemPlan`); a compiled
encoding passes through the backend's ``lower`` check.  Under
``plan=SystemPlan(semantics="delays")`` every state row is ``3m`` wide
(``[spikes | countdown | pending]``, ``comp.state_width``): archives,
frontiers and traces hold whole state rows.  Archives, flags and traces
equal the reference's row for row, in discovery order, for both dedup
modes, every backend and both semantics tiers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, List, NamedTuple, Optional, Sequence, Set,
                    Tuple, Union)

import numpy as np
import torch

from ..checkpoint.checkpoint import (latest_step, read_manifest,
                                     restore_checkpoint, save_checkpoint)
from . import prng
from .autotune import DEFAULT_WORKLOAD
from .backend import (BackendLike, StepBackend, compile_with_plan,
                      lower_with_backend, resolve_entry_info)
from .device import DeviceLike, host_copy, host_read_all, resolve_device
from .failover import run_with_failover
from .graph_loop import FusedLoop, tree_tensors
from .hashing import M32, SENTINEL, config_hash
from .hashtable import (HashTable, _hash_lookup, first_occurrence,
                        insert_unique_, make_table)
from .matrix import CompiledAny, is_compiled, is_delayed
from .plan import SystemPlan

__all__ = ["ExploreState", "ExploreResult", "TraceOut", "explore",
           "resolve_dedup", "successor_set", "emission_gaps", "run_trace",
           "run_traces"]


def _resolve_comp(system, be: StepBackend, plan: Optional[SystemPlan],
                  device: DeviceLike) -> CompiledAny:
    """The encoding ``be`` steps, on the resolved device (``None`` = the
    card): a compiled encoding passes through ``be.lower`` (which refuses
    one its step cannot realize), a system is lowered by ``be.compile``
    under ``plan``."""
    if plan is not None and plan.num_shards > 1:
        raise ValueError(
            "plan.num_shards > 1 (neuron-axis sharding) is only consumed "
            "by repro_torch.core.distributed.explore_distributed")
    dev = resolve_device(device)
    if is_compiled(system):
        if plan is not None and (plan.semantics == "delays") != \
                is_delayed(system):
            raise ValueError(
                f"plan semantics {plan.semantics!r} does not match this "
                f"{'delayed' if is_delayed(system) else 'delay-free'} "
                "compiled encoding; compile the system under the plan")
        return lower_with_backend(be, system.to(dev), plan)
    return compile_with_plan(be, system, plan, dev)


@dataclass(frozen=True)
class ExploreResult:
    configs: np.ndarray         # (n_discovered, m|3m) in discovery order
    num_discovered: int
    steps: int
    exhausted: bool             # tree fully explored (no overflow, frontier drained)
    branch_overflow: bool
    frontier_overflow: bool
    visited_overflow: bool

    def as_strings(self) -> List[str]:
        """Configs in the paper's ``allGenCk`` 'a-b-c' string format."""
        return ["-".join(str(int(v)) for v in row) for row in self.configs]


def resolve_dedup(dedup: str, *, frontier_cap: int, visited_cap: int,
                  max_branches: int) -> str:
    """``"auto"`` -> ``"hash"`` once the visited capacity dominates the wave
    (``visited_cap >= max(16384, 8·frontier_cap·max_branches)``), else
    ``"sort"`` — the reference's rule, kept so both packages pick the same
    mode (the two give identical archives outside visited overflow)."""
    if dedup == "auto":
        wave = frontier_cap * max_branches
        return "hash" if visited_cap >= max(16384, 8 * wave) else "sort"
    if dedup not in ("hash", "sort"):
        raise ValueError(f"unknown dedup mode {dedup!r}")
    return dedup


# Sort dedup orders keys by (hi, lo) as unsigned 32-bit lanes; one int64
# key (hi - 2^31)·2^32 + lo orders the same way and cannot overflow.
_SORT_BIAS = 1 << 31
_SENTINEL_KEY = (SENTINEL - _SORT_BIAS) * (1 << 32) + SENTINEL


def _sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi - _SORT_BIAS) * (1 << 32) + lo


def _sort_dedup_verdict(visited_key: torch.Tensor, key: torch.Tensor,
                        cand_valid: torch.Tensor) -> torch.Tensor:
    """New-mask of the candidates (first occurrence of an unseen key) from
    one sort of visited keys and candidates.  The reference sorts
    ``(hi, lo, is_cand)`` stably; two stable sorts — by ``is_cand``, then
    by key — give the same order, so among equal keys visited entries
    come first and candidates keep index order (the lowest index wins)."""
    V, K = visited_key.shape[0], key.shape[0]
    dev = key.device
    all_key = torch.cat([visited_key, key])
    is_cand = torch.cat([torch.zeros(V, dtype=torch.uint8, device=dev),
                         cand_valid.to(torch.uint8)])
    order = torch.sort(is_cand, stable=True).indices
    order = order[torch.sort(all_key[order], stable=True).indices]
    s_key = all_key[order]
    eq_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                         s_key[1:] == s_key[:-1]])
    new_sorted = (is_cand[order] == 1) & ~eq_prev
    # back to candidate order through the inverse permutation
    inv = torch.empty_like(order)
    inv[order] = torch.arange(V + K, device=dev)
    return new_sorted[inv[V:]]


class ExploreState(NamedTuple):
    """The BFS level loop's whole state: what a checkpoint snapshots and a
    resume restores.  As in the reference, the counts, the step and the
    flags are device scalars, and a level updates every field in place
    (so one captured level serves every level of the loop,
    :mod:`.graph_loop`); ``total_new`` is the reference's convergence
    scalar, the configurations the last level added.  ``visited`` is the
    open-addressing table under ``dedup="hash"``, the sorted ``(V,)`` int64
    keys under ``"sort"`` (whose live count is ``archive_n``: both grow by
    each level's insertions, capped at V).  ``archive`` has one row past
    ``V``: the rows a level drops past the capacity land there.  The
    distributed schemes hold a tuple of per-shard or per-rank tensors where
    this holds one, and the dense-row scheme one count a rank in
    ``frontier_n`` and ``archive_n`` ((R,) tensors)."""

    frontier: torch.Tensor            # (F, w) int32
    frontier_n: torch.Tensor          # () int32 — valid prefix length
    visited: Union[HashTable, torch.Tensor]
    archive: torch.Tensor             # (V + 1, w) int32, discovery order
    archive_n: torch.Tensor           # () int32
    step: torch.Tensor                # () int32
    branch_overflow: torch.Tensor     # () bool
    frontier_overflow: torch.Tensor   # () bool
    visited_overflow: torch.Tensor    # () bool
    total_new: torch.Tensor           # () int32 — the last level's additions


def _scalar(v: int, dev) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=dev)


def _flags(dev):
    return tuple(torch.zeros((), dtype=torch.bool, device=dev)
                 for _ in range(3))


def _init_state(comp: CompiledAny, F: int, V: int, init, dedup: str
                ) -> ExploreState:
    dev = comp.device
    m = comp.state_width          # row width: m, or 3m under delays
    c0 = comp.init_config if init is None else \
        torch.as_tensor(list(init), dtype=torch.int32, device=dev)
    frontier = torch.zeros((F, m), dtype=torch.int32, device=dev)
    frontier[0] = c0
    archive = torch.zeros((V + 1, m), dtype=torch.int32, device=dev)
    archive[0] = c0
    hi0, lo0 = config_hash(c0)
    if dedup == "hash":
        visited = make_table(V, dev)
        insert_unique_(visited, hi0[None], lo0[None],
                       torch.ones(1, dtype=torch.bool, device=dev),
                       torch.zeros(1, dtype=torch.int32, device=dev))
    else:
        visited = torch.full((V,), _SENTINEL_KEY, dtype=torch.int64,
                             device=dev)
        visited[0] = _sort_key(hi0, lo0)
    one = _scalar(1, dev)
    return ExploreState(frontier, one, visited, archive, one.clone(),
                        _scalar(0, dev), *_flags(dev), one.clone())


def _append(archive: torch.Tensor, rows: torch.Tensor, ins: torch.Tensor,
            V: int, new_rows: torch.Tensor) -> None:
    """Write ``new_rows[j]`` to archive row ``rows[j]`` where ``ins[j]``
    and the row is below ``V``; the rest land on the spare row ``V``."""
    idx = torch.where(ins & (rows < V), rows, V).to(torch.int64)
    archive.index_copy_(0, idx, new_rows)


def _explore_level(s: ExploreState, comp: CompiledAny, be: StepBackend,
                   T: int, dedup: str) -> None:
    """One BFS level in place: expand, hash, dedup, compact, append.  It
    reads nothing from the device."""
    (F, m), dev = s.frontier.shape, s.frontier.device
    V = s.archive.shape[0] - 1
    take = torch.arange(F, device=dev)
    live = take < s.frontier_n
    out = be.expand(s.frontier, comp, T)
    cand = out.configs.reshape(F * T, m)
    cand_valid = (out.valid & live[:, None]).reshape(F * T)
    s.branch_overflow.logical_or_((out.overflow & live).any())

    if dedup == "hash":
        # hashed and looked up in one pass over the rows (H1 on the card)
        hi, lo, found = _hash_lookup(s.visited, cand, cand_valid)
        first, probe_ovf = first_occurrence(hi, lo, cand_valid)
        new_mask = cand_valid & first & ~found
    else:
        hi, lo = config_hash(cand)
        hi = torch.where(cand_valid, hi, SENTINEL)
        lo = torch.where(cand_valid, lo, SENTINEL)
        new_mask = _sort_dedup_verdict(s.visited, _sort_key(hi, lo),
                                       cand_valid)

    n_new = new_mask.sum()
    # new candidates first, in index order (stable), then the rest
    sel = torch.sort((~new_mask).to(torch.uint8), stable=True).indices[:F]
    n_ins = n_new.clamp(max=F)
    next_frontier = cand[sel]
    ins_mask = take < n_ins
    s.frontier_overflow.logical_or_(n_new > F)

    if dedup == "hash":
        # insert the selected prefix only (payload = archive row), so
        # excess discoveries are not marked visited and regenerate
        full = s.visited.count + n_ins > V
        _, ovf_i = insert_unique_(s.visited, hi[sel], lo[sel], ins_mask,
                                  (s.archive_n + take).to(torch.int32))
        s.visited_overflow.logical_or_(probe_ovf | ovf_i | full)
    else:
        # visited merge: entries beyond capacity fall off the sorted tail
        ins_key = torch.where(ins_mask, _sort_key(hi[sel], lo[sel]),
                              _SENTINEL_KEY)
        s.visited.copy_(torch.sort(torch.cat([s.visited, ins_key])
                                   ).values[:V])
        s.visited_overflow.logical_or_(s.archive_n + n_ins > V)

    # archive append in discovery order (rows past V are dropped)
    _append(s.archive, s.archive_n + take, ins_mask, V, next_frontier)
    s.frontier.copy_(next_frontier)
    s.frontier_n.copy_(n_ins)
    s.archive_n.copy_((s.archive_n + n_ins).clamp(max=V))
    s.total_new.copy_(n_ins)
    s.step.add_(1)


def _archive_prefix(archive, n: Tuple[int, ...]):
    """The filled rows of an archive: one tensor, or one per shard or
    rank; ``n`` holds one host count (every shard's), or one a rank (the
    dense-row scheme)."""
    if isinstance(archive, torch.Tensor):
        return archive[:n[0]]
    ns = n if len(n) == len(archive) else n * len(archive)
    return tuple(a[:k] for a, k in zip(archive, ns))


class Readout(NamedTuple):
    """A state's counts and flags, read to the host in one transfer."""

    step: int
    total_new: int
    flags: Tuple[bool, bool, bool]    # branch, frontier, visited overflow
    frontier_n: Tuple[int, ...]       # one, or one a rank
    archive_n: Tuple[int, ...]


def read_state(s: ExploreState) -> Readout:
    """One counted read (:func:`~.device.host_read_all`) of the state's
    step, convergence count, flags and counts."""
    home = s.step.device
    parts = (s.step, s.total_new, s.branch_overflow, s.frontier_overflow,
             s.visited_overflow, s.frontier_n, s.archive_n)
    v = host_read_all(torch.cat([x.reshape(-1).to(home, torch.int64)
                                 for x in parts]))
    nf = s.frontier_n.numel()
    return Readout(v[0], v[1], tuple(bool(x) for x in v[2:5]),
                   tuple(v[5:5 + nf]), tuple(v[5 + nf:]))


def _restore(checkpoint_dir: str, state):
    """The latest snapshot written into the live (fresh) state's tensors,
    its archive prefix (one tensor, or one per shard or rank) into the
    fresh archive, whose other rows stay zero.  The snapshot is read on
    the host and copied in, so its step and convergence count come back
    with no device read: returns ``(state, host copy of the snapshot)``."""
    step, manifest = read_manifest(checkpoint_dir)
    arrays = manifest["arrays"]
    if isinstance(state.archive, torch.Tensor):
        rows = (arrays[".archive"]["shape"][0],)
    else:
        rows = tuple(arrays[f".archive/{d}"]["shape"][0]
                     for d in range(len(state.archive)))
    template = state._replace(archive=_archive_prefix(state.archive, rows))
    got, _, _ = restore_checkpoint(checkpoint_dir, template, step=step,
                                   device="cpu")
    for live, host in zip(tree_tensors(template), tree_tensors(got)):
        live.copy_(host)
    return state, got


def _check_checkpointing(checkpoint_dir: Optional[str],
                         checkpoint_every: int) -> None:
    """Refuse a checkpoint interval below 1 before anything runs."""
    if checkpoint_dir is not None and checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")


def _run_chunked(state: ExploreState, level: Callable, devices, *,
                 max_steps: int, checkpoint_dir: Optional[str],
                 checkpoint_every: int, fault_injector
                 ) -> Tuple[ExploreState, Readout]:
    """Run ``level`` (one BFS level, in place) until the frontier drains or
    ``max_steps`` levels, as one :class:`~.graph_loop.FusedLoop` over
    ``devices``, with checkpoint/resume.  Returns the state and its final
    :func:`read_state`.

    Without a ``checkpoint_dir`` this is one uninterrupted run: one graph
    launch on the card and one read at the end.  With one, the BFS runs in
    chunks of ``checkpoint_every`` levels to absolute step bounds, each
    chunk one launch and one read of the state's counts, then a snapshot
    of the state (its archive's filled prefix only; atomic rename,
    content-verified, :mod:`repro_torch.checkpoint`); the latest snapshot
    is restored on entry.  So a chunked run equals an uninterrupted one,
    and a run killed mid-chunk resumes from its last snapshot and re-runs
    only that chunk.  ``fault_injector``
    (:class:`~repro_torch.runtime.faults.FaultInjector`) is called once
    before an uninterrupted run and once before every chunk, as the
    reference calls it, so a schedule kills the same chunk in both."""
    step, go = 0, True
    if checkpoint_dir is not None and latest_step(checkpoint_dir) is not None:
        state, got = _restore(checkpoint_dir, state)
        step, go = int(got.step), int(got.total_new) > 0
    with FusedLoop(level, state, devices) as loop:
        if checkpoint_dir is None:
            if fault_injector is not None:
                fault_injector.on_device_call()
            loop.run(max_steps, step, go)
        while checkpoint_dir is not None and step < max_steps and go:
            if fault_injector is not None:
                fault_injector.on_device_call()
            loop.run(min(max_steps, step + checkpoint_every), step, go)
            r = read_state(state)
            step, go = r.step, r.total_new > 0
            save_checkpoint(checkpoint_dir, step, state._replace(
                archive=_archive_prefix(state.archive, r.archive_n)))
        r = read_state(state)
    return state, r


def explore(
    system,
    *,
    max_steps: int = 64,
    frontier_cap: int = 256,
    visited_cap: int = 4096,
    max_branches: int = 64,
    init: Optional[Sequence[int]] = None,
    backend: BackendLike = None,
    plan: Optional[SystemPlan] = None,
    device: DeviceLike = None,
    dedup: str = "auto",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 32,
    fault_injector=None,
) -> ExploreResult:
    """BFS-explore the computation tree (paper Algorithm 1) until the
    frontier drains or ``max_steps`` levels.

    ``backend`` selects the transition (``"cuda"``, ``"ref"``,
    ``"sparse_cuda"``, ``"sparse"``; ``None`` applies
    :func:`~.backend.resolve_entry_info`), ``plan`` the encoding it lowers
    to, ``device`` where it runs (``None`` = the card, which must be
    present).  ``dedup="hash"`` keeps the device-resident open-addressing
    table, ``"sort"`` re-sorts the visited keys with each wave, ``"auto"``
    applies :func:`resolve_dedup`.

    ``checkpoint_dir`` snapshots the BFS state every ``checkpoint_every``
    levels and restores the latest snapshot on entry, so a killed run
    called again with the same arguments (e.g. under
    :func:`repro_torch.runtime.faults.run_supervised`) resumes and
    returns what an uninterrupted run returns (the capacities must match
    the snapshot's, else ``ValueError``).  ``fault_injector`` kills
    scheduled chunks.  A backend the entry point chose (``planned``) that
    fails to build, lower or launch degrades down
    :data:`~.failover.DEGRADE_ORDER` with a warning, on the card only to
    another kernel backend; a named backend raises."""
    dedup = resolve_dedup(dedup, frontier_cap=frontier_cap,
                          visited_cap=visited_cap, max_branches=max_branches)
    _check_checkpointing(checkpoint_dir, checkpoint_every)
    dev = resolve_device(device)      # no card: the caller's error
    be, plan, planned = resolve_entry_info(
        system, backend, plan, workload=(frontier_cap, max_branches),
        device=dev)
    if plan is not None and plan.num_shards > 1:
        _resolve_comp(system, be, plan, dev)   # caller error: raise
    T = max_branches

    def attempt(be, plan):
        comp = _resolve_comp(system, be, plan, dev)
        return _run_chunked(
            _init_state(comp, frontier_cap, visited_cap, init, dedup),
            lambda st: _explore_level(st, comp, be, T, dedup), [dev],
            max_steps=max_steps, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, fault_injector=fault_injector)

    s, r = run_with_failover(attempt, be, plan, degradable=planned,
                             device=dev)
    n = r.archive_n[0]
    return _result(host_copy(s.archive[:n]), r)


def _result(configs: torch.Tensor, r: Readout) -> ExploreResult:
    """The result of a run from its archive (on the host) and readout."""
    b_ovf, f_ovf, v_ovf = r.flags
    return ExploreResult(
        configs=configs.numpy(),
        num_discovered=sum(r.archive_n),
        steps=r.step,
        exhausted=sum(r.frontier_n) == 0 and not (b_ovf or f_ovf or v_ovf),
        branch_overflow=b_ovf, frontier_overflow=f_ovf,
        visited_overflow=v_ovf,
    )


# ---------------------------------------------------------------------------
# Small-system utilities (host-driven, used by tests and the paper repro)
# ---------------------------------------------------------------------------


def _successors(comp: CompiledAny, configs: Sequence[Tuple[int, ...]],
                max_branches: int, be) -> List[List[Tuple[tuple, int]]]:
    """Distinct (successor, emission) pairs of each config, in branch
    order, from one batched expand; raises on branch overflow."""
    if not configs:
        return []
    c = torch.as_tensor(list(configs), dtype=torch.int32, device=comp.device)
    out = be.expand(c, comp, max_branches)
    if bool(out.overflow.any()):
        raise ValueError("branch overflow; raise max_branches")
    cfgs = out.configs.cpu().numpy()
    valid = out.valid.cpu().numpy()
    emis = out.emissions.cpu().numpy()
    result = []
    for b in range(len(configs)):
        seen: Set = set()
        pairs = []
        for i in np.nonzero(valid[b])[0]:
            key = (tuple(int(v) for v in cfgs[b, i]), int(emis[b, i]))
            if key not in seen:
                seen.add(key)
                pairs.append(key)
        result.append(pairs)
    return result


def successor_set(system, config: Sequence[int], max_branches: int = 64,
                  backend: BackendLike = None,
                  plan: Optional[SystemPlan] = None,
                  device: DeviceLike = None) -> List[Tuple[tuple, int]]:
    """Distinct (successor, emission) pairs of one configuration."""
    be, plan, _ = resolve_entry_info(system, backend, plan,
                                     workload=(1, max_branches),
                                     device=resolve_device(device))
    comp = _resolve_comp(system, be, plan, device)
    return _successors(comp, [tuple(config)], max_branches, be)[0]


def emission_gaps(system, *, max_time: int, max_gap: int,
                  max_branches: int = 64, backend: BackendLike = None,
                  plan: Optional[SystemPlan] = None,
                  device: DeviceLike = None) -> Set[int]:
    """All gaps between the first two environment emissions, over every
    computation path of length <= ``max_time``.

    The number computed by an SNP generator is exactly this gap (paper
    §2.1); for the paper's Π in exact mode it must be {2, 3, ...} ∩ bound.
    BFS over *augmented* states (config, elapsed since the first emission)
    keeps the search polynomial.  Each time step expands all of its
    states in one batched call (the reference expands them one by one;
    the sets are the same)."""
    be, plan, _ = resolve_entry_info(
        system, backend, plan, workload=(DEFAULT_WORKLOAD[0], max_branches),
        device=resolve_device(device))
    comp = _resolve_comp(system, be, plan, device)
    init = tuple(int(v) for v in comp.init_config.cpu().tolist())
    # phase A: no emission yet; phase B: (config, elapsed) since 1st emission
    phase_a: set = {init}
    phase_b: set = set()
    gaps: Set[int] = set()
    for _ in range(max_time):
        a_list = sorted(phase_a)
        b_list = sorted((c, e) for c, e in phase_b if e + 1 <= max_gap)
        succ = _successors(comp, a_list + [c for c, _ in b_list],
                           max_branches, be)
        new_a: set = set()
        new_b: set = set()
        for pairs in succ[:len(a_list)]:
            for nxt, emis in pairs:
                if emis > 0:
                    new_b.add((nxt, 0))
                else:
                    new_a.add(nxt)
        for (_, elapsed), pairs in zip(b_list, succ[len(a_list):]):
            for nxt, emis in pairs:
                if emis > 0:
                    gaps.add(elapsed + 1)
                else:
                    new_b.add((nxt, elapsed + 1))
        phase_a, phase_b = new_a, new_b
        if not phase_a and not phase_b:
            break
    return gaps


# ---------------------------------------------------------------------------
# Traces: B independent trajectories stepped together
# ---------------------------------------------------------------------------


class TraceOut(NamedTuple):
    """:func:`run_traces` output.  ``branch_overflow[b, t]`` flags that
    trace b had more than ``max_branches`` successors at step t."""

    configs: torch.Tensor          # (B, steps, m|3m) int32
    emissions: torch.Tensor        # (B, steps) int32
    alive: torch.Tensor            # (B, steps) bool
    branch_overflow: torch.Tensor  # (B, steps) bool


def run_traces(system, *, steps: int, seeds, policy: str = "first",
               max_branches: int = 64, backend: BackendLike = None,
               plan: Optional[SystemPlan] = None,
               device: DeviceLike = None) -> TraceOut:
    """Batched trajectories: ``B = len(seeds)`` paths stepped together, one
    expand per step for the whole batch.  ``policy="first"`` follows
    branch 0 at every step, so every seed gives the same path.
    ``policy="random"`` follows a uniformly drawn valid branch: each trace
    carries the key ``PRNGKey(seed)`` (seeds as uint32) and, every step,
    splits it and draws ``randint(subkey, (), 0, max(n_valid, 1))``, as
    the reference's scan does, so row b equals the reference's trace of
    ``seeds[b]`` bit for bit (:mod:`.prng`).  A backend the entry point
    chose degrades on a failure to build, lower or launch
    (:mod:`.failover`; on the card only to another kernel backend); a
    named one raises."""
    if policy not in ("first", "random"):
        raise ValueError(f"unknown policy {policy!r}")
    seeds = np.asarray(seeds)
    if seeds.ndim != 1:
        raise ValueError(f"seeds must be 1-D, got shape {seeds.shape}")
    dev = resolve_device(device)      # no card: the caller's error
    be, plan, planned = resolve_entry_info(
        system, backend, plan, workload=(len(seeds), max_branches),
        device=dev)
    if plan is not None and plan.num_shards > 1:
        _resolve_comp(system, be, plan, dev)   # caller error: raise

    def attempt(be, plan):
        return _traces(_resolve_comp(system, be, plan, dev), be, seeds,
                       steps, policy, max_branches)

    return run_with_failover(attempt, be, plan, degradable=planned,
                             device=dev)


def _traces(comp, be, seeds: np.ndarray, steps: int, policy: str,
            max_branches: int) -> TraceOut:
    B, m, dev = int(seeds.shape[0]), comp.state_width, comp.device
    res = TraceOut(
        torch.empty((B, steps, m), dtype=torch.int32, device=dev),
        torch.empty((B, steps), dtype=torch.int32, device=dev),
        torch.empty((B, steps), dtype=torch.bool, device=dev),
        torch.empty((B, steps), dtype=torch.bool, device=dev))
    keys = prng.PRNGKey(torch.from_numpy(
        seeds.astype(np.int64) & M32).to(dev))
    rows = torch.arange(B, device=dev)
    cfgs = comp.init_config.expand(B, m)
    for s in range(steps):
        out = be.expand(cfgs, comp, max_branches)      # (B, T, m)
        n_valid = out.valid.sum(-1)
        if policy == "random":
            keys, subs = prng.split(keys)
            idx = prng.randint(subs, n_valid.clamp(min=1))
        else:
            idx = torch.zeros(B, dtype=torch.int64, device=dev)
        has = n_valid > 0
        cfgs = torch.where(has[:, None], out.configs[rows, idx], cfgs)
        res.configs[:, s] = cfgs
        res.emissions[:, s] = torch.where(has, out.emissions[rows, idx], 0)
        res.alive[:, s] = has
        res.branch_overflow[:, s] = out.overflow & has
    return res


def run_trace(system, *, steps: int, policy: str = "first", seed: int = 0,
              max_branches: int = 64, backend: BackendLike = None,
              plan: Optional[SystemPlan] = None,
              device: DeviceLike = None) -> TraceOut:
    """One trajectory: a B=1 :func:`run_traces` batch, so the single and
    batched paths cannot drift apart."""
    out = run_traces(system, steps=steps, seeds=[seed], policy=policy,
                     max_branches=max_branches, backend=backend, plan=plan,
                     device=device)
    return TraceOut(*(x[0] for x in out))
