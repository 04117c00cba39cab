"""Breadth-first exploration of an SNP system's computation tree, and
batched traces.

The port of ``repro.core.engine``.  :func:`explore` implements the paper's
Algorithm 1: each level expands the frontier through a step backend,
hashes every successor, dedups it against the visited set, and compacts
the new configurations into the next frontier and the archive.  The
reference runs the whole BFS as one ``lax.while_loop``; here the level
loop runs from the host and reads one device scalar per level (the number
of new configurations, which both ends the loop and sizes the archive
append), plus the hash table's probe-loop reads.  Every read is counted
in :data:`repro_torch.core.device.host_reads`.

The level loop's state is one :class:`ExploreState`; with
``checkpoint_dir`` the loop runs in chunks of levels and snapshots it
between chunks (:mod:`repro_torch.checkpoint`), so a killed run resumes
where its last snapshot left off and returns the uninterrupted archive.
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
from .backend import BackendLike, StepBackend, resolve_entry_info
from .device import DeviceLike, host_read, resolve_device
from .failover import run_with_failover
from .hashing import M32, SENTINEL, config_hash
from .hashtable import (HashTable, first_occurrence, insert_unique, lookup,
                        make_table)
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
        return be.lower(system.to(dev), SystemPlan() if plan is None
                        else plan)
    return be.compile(system, plan, device=dev)


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
    resume restores.  ``frontier_n``, ``archive_n`` and ``step`` are host
    integers (the level loop reads the level's new-configuration count
    anyway), so a chunk boundary reads nothing from the device.
    ``visited`` is the open-addressing table under ``dedup="hash"``, the
    sorted ``(V,)`` int64 keys under ``"sort"`` (whose live count is
    ``archive_n``: both grow by each level's insertions, capped at V).
    The distributed schemes hold a tuple of per-shard or per-rank
    tensors where this holds one, and the dense-row scheme a count per
    rank in ``frontier_n`` and ``archive_n``."""

    frontier: torch.Tensor            # (F, w) int32
    frontier_n: int                   # valid prefix length
    visited: Union[HashTable, torch.Tensor]
    archive: torch.Tensor             # (V, w) int32, discovery order
    archive_n: int
    step: int
    branch_overflow: torch.Tensor     # () bool
    frontier_overflow: torch.Tensor   # () bool
    visited_overflow: torch.Tensor    # () bool


def _init_state(comp: CompiledAny, F: int, V: int, init, dedup: str
                ) -> ExploreState:
    dev = comp.device
    m = comp.state_width          # row width: m, or 3m under delays
    c0 = comp.init_config if init is None else \
        torch.as_tensor(list(init), dtype=torch.int32, device=dev)
    frontier = torch.zeros((F, m), dtype=torch.int32, device=dev)
    frontier[0] = c0
    archive = torch.zeros((V, m), dtype=torch.int32, device=dev)
    archive[0] = c0
    hi0, lo0 = config_hash(c0)
    if dedup == "hash":
        visited, _, _ = insert_unique(
            make_table(V, dev), hi0[None], lo0[None],
            torch.ones(1, dtype=torch.bool, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    else:
        visited = torch.full((V,), _SENTINEL_KEY, dtype=torch.int64,
                             device=dev)
        visited[0] = _sort_key(hi0, lo0)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return ExploreState(frontier, 1, visited, archive, 1, 0, false, false,
                        false)


def _explore_level(s: ExploreState, comp: CompiledAny, be: StepBackend,
                   T: int, dedup: str) -> ExploreState:
    """One BFS level: expand, hash, dedup, compact, append."""
    (F, m), V, dev = s.frontier.shape, s.archive.shape[0], s.frontier.device
    take = torch.arange(F, device=dev)
    live = take < s.frontier_n
    out = be.expand(s.frontier, comp, T)
    cand = out.configs.reshape(F * T, m)
    cand_valid = (out.valid & live[:, None]).reshape(F * T)
    branch_ovf = s.branch_overflow | (out.overflow & live).any()

    hi, lo = config_hash(cand)
    hi = torch.where(cand_valid, hi, SENTINEL)
    lo = torch.where(cand_valid, lo, SENTINEL)
    if dedup == "hash":
        found, _ = lookup(s.visited, hi, lo, cand_valid)
        first, probe_ovf = first_occurrence(hi, lo, cand_valid)
        new_mask = cand_valid & first & ~found
    else:
        new_mask = _sort_dedup_verdict(s.visited, _sort_key(hi, lo),
                                       cand_valid)

    n_new = new_mask.sum()
    # new candidates first, in index order (stable), then the rest
    sel = torch.sort((~new_mask).to(torch.uint8), stable=True).indices[:F]
    n_ins = host_read(n_new.clamp(max=F))   # the one read per level
    next_frontier = cand[sel]
    ins_mask = take < n_ins
    frontier_ovf = s.frontier_overflow | (n_new > F)

    if dedup == "hash":
        # insert the selected prefix only (payload = archive row), so
        # excess discoveries are not marked visited and regenerate
        full = s.visited.count + n_ins > V
        visited, _, ovf_i = insert_unique(
            s.visited, hi[sel], lo[sel], ins_mask,
            (s.archive_n + take).to(torch.int32))
        visited_ovf = s.visited_overflow | probe_ovf | ovf_i | full
    else:
        # visited merge: entries beyond capacity fall off the sorted tail
        ins_key = torch.where(ins_mask, _sort_key(hi[sel], lo[sel]),
                              _SENTINEL_KEY)
        visited = torch.sort(torch.cat([s.visited, ins_key])).values[:V]
        visited_ovf = s.visited_overflow | (s.archive_n + n_ins > V)

    # archive append in discovery order (rows past V are dropped)
    k = min(n_ins, V - s.archive_n)
    archive = s.archive
    archive[s.archive_n:s.archive_n + k] = next_frontier[:k]
    return ExploreState(next_frontier, n_ins, visited, archive,
                        s.archive_n + k, s.step + 1, branch_ovf,
                        frontier_ovf, visited_ovf)


def _explore_loop(state: ExploreState, comp, be, bound: int, T: int,
                  dedup: str) -> ExploreState:
    """Levels until the frontier drains or the absolute step ``bound``."""
    while state.step < bound and state.frontier_n > 0:
        state = _explore_level(state, comp, be, T, dedup)
    return state


def _archive_prefix(archive, n):
    """The filled rows of an archive: one tensor, or one per shard or
    rank; ``n`` is one count, or one per rank (the dense-row scheme)."""
    if isinstance(archive, torch.Tensor):
        return archive[:n]
    ns = n if isinstance(n, tuple) else (n,) * len(archive)
    return tuple(a[:k] for a, k in zip(archive, ns))


def _live(n) -> int:
    """Valid frontier rows of a state: one count, or one per rank."""
    return sum(n) if isinstance(n, tuple) else n


def _restore(checkpoint_dir: str, state):
    """The latest snapshot on the live (fresh) state's devices, its
    archive prefix (one tensor, or one per shard or rank) written into
    the fresh archive, whose other rows are zero."""
    step, manifest = read_manifest(checkpoint_dir)
    arrays = manifest["arrays"]
    if isinstance(state.archive, torch.Tensor):
        rows = arrays[".archive"]["shape"][0]
    else:
        rows = tuple(arrays[f".archive/{d}"]["shape"][0]
                     for d in range(len(state.archive)))
    template = state._replace(archive=_archive_prefix(state.archive, rows))
    got, _, _ = restore_checkpoint(checkpoint_dir, template, step=step)

    def pad(live, prefix):
        live[:prefix.shape[0]] = prefix
        return live

    if isinstance(state.archive, torch.Tensor):
        return got._replace(archive=pad(state.archive, got.archive))
    return got._replace(archive=tuple(
        pad(a, p) for a, p in zip(state.archive, got.archive)))


def _check_checkpointing(checkpoint_dir: Optional[str],
                         checkpoint_every: int) -> None:
    """Refuse a checkpoint interval below 1 before anything runs."""
    if checkpoint_dir is not None and checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")


def _run_chunked(state, run: Callable, *, max_steps: int,
                 checkpoint_dir: Optional[str], checkpoint_every: int,
                 fault_injector):
    """Drive a level loop ``run(state, bound)`` (levels until the frontier
    drains or the absolute step ``bound``) with checkpoint/resume.

    Without a ``checkpoint_dir`` this is one uninterrupted run.  With one,
    the BFS runs in chunks of ``checkpoint_every`` levels to absolute step
    bounds, snapshotting the state after each chunk (its archive's filled
    prefix only; atomic rename, content-verified,
    :mod:`repro_torch.checkpoint`), and the latest snapshot is restored on
    entry.  So a chunked run equals an uninterrupted one, and a run killed
    mid-chunk resumes from its last snapshot and re-runs only that chunk.
    ``fault_injector`` (:class:`~repro_torch.runtime.faults.FaultInjector`)
    is called once before an uninterrupted run and once before every
    chunk, as the reference calls it, so a schedule kills the same chunk
    in both.  The state's step and frontier count (one a rank in the
    dense-row scheme) are host integers: a chunk boundary reads nothing
    from the device."""
    if checkpoint_dir is None:
        if fault_injector is not None:
            fault_injector.on_device_call()
        return run(state, max_steps)
    if latest_step(checkpoint_dir) is not None:
        state = _restore(checkpoint_dir, state)
    while state.step < max_steps and _live(state.frontier_n) > 0:
        if fault_injector is not None:
            fault_injector.on_device_call()
        state = run(state, min(max_steps, state.step + checkpoint_every))
        save_checkpoint(checkpoint_dir, state.step, state._replace(
            archive=_archive_prefix(state.archive, state.archive_n)))
    return state


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
            lambda st, bound: _explore_loop(st, comp, be, bound, T, dedup),
            max_steps=max_steps, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, fault_injector=fault_injector)

    s = run_with_failover(attempt, be, plan, degradable=planned, device=dev)
    b_ovf, f_ovf, v_ovf = (bool(x) for x in torch.stack(
        [s.branch_overflow, s.frontier_overflow, s.visited_overflow]
    ).tolist())
    return ExploreResult(
        configs=s.archive[:s.archive_n].cpu().numpy(),
        num_discovered=s.archive_n,
        steps=s.step,
        exhausted=s.frontier_n == 0 and not (b_ovf or f_ovf or v_ovf),
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
