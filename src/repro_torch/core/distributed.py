"""Neuron-sharded breadth-first exploration: :func:`explore_distributed`.

The port of ``repro.core.distributed``'s neuron-axis-sharded scheme
(``explore_distributed`` with a ``SystemPlan(num_shards > 1)``).  The
neuron axis is cut into ``S`` shards of ``mloc = ceil(m/S)`` columns
(:func:`~.plan.compile_sharded`): every frontier row, candidate and
archive row is held as ``S`` slices, and each level

1. computes each shard's branch info on its slice; the mixed-radix
   strides cross shard boundaries, so a shard's strides are multiplied by
   the branch totals of the shards after it (in shard order, as the
   reference's product does);
2. decodes the fired produce at the neurons a shard ships to other shards
   (``send_idx``) and exchanges it with one all-to-all: the halo;
3. steps each slice through the backend: ``"cuda"`` launches B6
   (:func:`~repro_torch.kernels.snp_step.ops.snp_step_dense_shard`),
   ``"sparse_cuda"`` B7
   (:func:`~repro_torch.kernels.snp_step.sparse_ops.snp_step_sparse_shard`);
   ``"ref"`` and ``"sparse"`` run the plain sparse math on the slice;
4. hashes each slice with :func:`~.hashing.zobrist_hash` at its global
   neuron positions and sums the partials (mod 2^32) to the global hash;
   the shard that owns a hash (``hi mod S``) dedups it against its own
   table, and the verdicts are combined;
5. selects the new configurations (replicated) and appends every shard's
   slice of them to its archive slice.

Transport.  The reference runs one ``shard_map`` over ``S`` devices.  Here
one process steps the ``S`` shards in lockstep, and the collectives are
exact tensor operations over the per-shard tensors, in shard order: the
all-to-all is ``recv[p][..., q-block] = send[q][..., p-block]`` (the
reference's tiled ``all_to_all``), the uint32 ``psum`` a sum of int64
lanes masked to 32 bits.  ``mesh`` is a sequence of ``S`` torch devices;
``mesh=None`` holds all ``S`` shards on one device, which is how one card
runs an ``S``-shard exploration.  Replicated bookkeeping (validity,
selection) lives on the first device of the mesh.  A ``torch.distributed``
transport is ROADMAP item 7.

Host reads.  As the port's :func:`~.engine.explore`, the level loop runs
from the host and reads the number of new configurations once per level;
each shard's hash-table probe loops read their own counts (about ``S``
times the single-device probe reads).

Archives, flags and counts equal the reference's sharded run row for row,
in discovery order, through all four backends and both partitions.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from .backend import (BackendLike, CudaBackend, SparseCudaBackend,
                      resolve_entry_info, supports_sharded)
from .device import DeviceLike, host_read, resolve_device
from .engine import (ExploreResult, ExploreState, _check_checkpointing,
                     _run_chunked)
from .hashing import M32, SENTINEL, zobrist_hash
from .hashtable import first_occurrence, insert_unique, lookup, make_table
from .plan import (ShardedCompiled, ShardView, SystemPlan, compile_sharded,
                   is_sharded, shard_view)
from .semantics import packed_rule_table, sparse_branch_info
from .system import SNPSystem

__all__ = ["explore_distributed"]


def _psum_u32(parts: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """Sum of uint32 lanes (int64 tensors in [0, 2^32)) over the shards,
    wrapping mod 2^32 as the reference's int32 ``psum`` does."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total & M32


def _all_to_all(sends: Sequence[torch.Tensor], devices, hmax: int
                ) -> List[torch.Tensor]:
    """The tiled all-to-all of the halo: shard ``q``'s ``(..., S·Hmax)``
    send holds its block for shard ``p`` at ``[p·Hmax, (p+1)·Hmax)``;
    shard ``p`` receives the blocks of shards ``0 .. S−1`` in order."""
    S = len(sends)
    return [torch.cat([sends[q][..., p * hmax:(p + 1) * hmax].to(devices[p])
                       for q in range(S)], -1) for p in range(S)]


class _Shard(NamedTuple):
    """One shard's static inputs, on its device."""

    dev: torch.device
    view: ShardView
    in_idx: torch.Tensor        # (mloc, Kin) — extended space
    sell: Optional[tuple]       # B7's sliced lists of in_idx (start, src)
    send: torch.Tensor          # (S·Hmax,) — local ids, pad mloc
    gidx: torch.Tensor          # (mloc,) — global neuron per column
    M_local: Optional[torch.Tensor]
    hadj: Optional[torch.Tensor]
    cols: Optional[tuple]       # B6's column lists of M_local and hadj


def _shards(comp: ShardedCompiled, devices, dense: bool) -> List[_Shard]:
    a = comp.arrays
    out = []
    for d, dev in enumerate(devices):
        view = ShardView(*(x.to(dev) for x in shard_view(a, d)))
        out.append(_Shard(
            dev=dev, view=view, in_idx=a.in_idx[d].to(dev),
            sell=None if a.sell_start is None else _to(
                (a.sell_start[d], a.sell_src[d]), dev),
            send=a.send_idx[d].reshape(-1).to(dev),
            gidx=a.global_idx[d].to(dev),
            M_local=comp.dense.M_local[d].to(dev) if dense else None,
            hadj=comp.dense.hadj[d].to(dev) if dense else None,
            cols=_to(comp.dense.shard_columns(d), dev) if dense else None))
    return out


def _to(xs, dev):
    return None if xs is None else tuple(x.to(dev) for x in xs)


def _decode(T: int, stride, choices, tab):
    """Fired ``produce | consume << 16`` per (row, branch, column)."""
    # Imported here: the kernels package imports core.semantics, and
    # core's __init__ imports this module.
    from ..kernels.snp_step.sparse_ref import decode_digits, fired_packed
    return fired_packed(decode_digits(T, stride, choices), tab)


class _Level(NamedTuple):
    """A level's per-shard step operands, from :func:`_exchange`."""

    infos: list        # BranchInfo per shard, on its slice
    strides: list      # (F, mloc) f32 — combined across shards
    tabs: list         # (F, mloc, R) — packed rule tables
    halos: list        # (F, T, S·Hmax) — received remote produce
    fired: list        # (F, T, mloc) fired packed actions (plain route)
    psi: torch.Tensor  # (F,) f32 — global branch totals (replicated)
    alive: torch.Tensor  # (F,) bool — any rule applicable anywhere


def _exchange(shards, frontier, T: int, kernel: bool) -> _Level:
    """Steps 1–2 of a level (module docstring): branch info, the
    cross-shard radix combine and the halo exchange.  ``kernel`` decodes
    the fired produce only at the send positions (the kernels decode the
    rest themselves); otherwise the whole slice is decoded and kept in
    ``fired`` for the plain step."""
    S = len(shards)
    home = shards[0].dev
    F, mloc = frontier[0].shape
    hmax = shards[0].send.shape[0] // S
    infos = [sparse_branch_info(frontier[d], sh.view)
             for d, sh in enumerate(shards)]
    tots = [info.psi.to(home) for info in infos]
    # psi and each shard's downstream product, multiplied in shard order
    psi = tots[0]
    for e in range(1, S):
        psi = psi * tots[e]
    below = [torch.ones_like(psi) for _ in range(S)]
    for d in range(S):
        for e in range(d + 1, S):
            below[d] = below[d] * tots[e]
    alive = torch.zeros((F,), dtype=torch.bool, device=home)
    for info in infos:
        alive = alive | info.app.any(-1).to(home)

    strides, tabs, sends, fired = [], [], [], []
    for d, (sh, info) in enumerate(zip(shards, infos)):
        stride = info.stride * below[d].to(sh.dev)[:, None]
        tab = packed_rule_table(info, sh.view)               # (F, mloc, R)
        if kernel:
            smask = sh.send < mloc
            sid = sh.send.clamp(max=mloc - 1).to(torch.int64)
            packed = _decode(T, stride[:, sid].contiguous(),
                             info.choices[:, sid].contiguous(),
                             tab[:, sid].contiguous())
            send = torch.where(smask, packed & 0xFFFF, 0)
        else:
            packed = _decode(T, stride, info.choices, tab)  # (F, T, mloc)
            prod_pad = torch.cat([packed & 0xFFFF, torch.zeros(
                (F, T, 1), dtype=torch.int32, device=sh.dev)], -1)
            send = prod_pad.index_select(-1, sh.send)
            fired.append(packed)
        strides.append(stride)
        tabs.append(tab)
        sends.append(send)
    halos = _all_to_all(sends, [sh.dev for sh in shards], hmax)
    return _Level(infos, strides, tabs, halos, fired, psi, alive)


def _expand(shards, frontier, T: int, backend):
    """One level's candidate slices ``(F·T, mloc)`` per shard, with the
    replicated ``psi`` (F,) and ``alive`` (F,) on the first device."""
    from ..kernels.snp_step.ops import snp_step_dense_shard
    from ..kernels.snp_step.sparse_ops import snp_step_sparse_shard

    F, mloc = frontier[0].shape
    lv = _exchange(shards, frontier, T,
                   isinstance(backend, (CudaBackend, SparseCudaBackend)))
    cands = []
    for d, (sh, info) in enumerate(zip(shards, lv.infos)):
        psi = lv.psi.to(sh.dev)
        if isinstance(backend, SparseCudaBackend):
            out = snp_step_sparse_shard(
                frontier[d], lv.strides[d], info.choices, psi, lv.tabs[d],
                sh.in_idx, lv.halos[d], sell=sh.sell, max_branches=T,
                rows=backend.block_t, threads=backend.threads)
        elif isinstance(backend, CudaBackend):
            out = snp_step_dense_shard(
                frontier[d], info.rank, info.app, lv.strides[d],
                info.choices, psi, sh.view.rule_neuron, sh.M_local,
                sh.hadj, lv.halos[d], max_branches=T, cols=sh.cols,
                rows=backend.block_t, threads=backend.threads)
        else:
            # plain route ("ref", "sparse"): the sparse math on the slice
            packed = lv.fired[d]
            prod_ext = torch.cat([packed & 0xFFFF, lv.halos[d], torch.zeros(
                (F, T, 1), dtype=torch.int32, device=sh.dev)], -1)
            out = frontier[d][:, None, :] - (packed >> 16)
            for k in range(sh.in_idx.shape[1]):
                out = out + prod_ext.index_select(-1, sh.in_idx[:, k])
        cands.append(out.reshape(F * T, mloc))
    return cands, lv.psi, lv.alive


def _init_sharded(comp: ShardedCompiled, shards, F: int, V: int,
                  init: Optional[Sequence[int]]) -> ExploreState:
    """The initial configuration as archive row 0 and frontier row 0 of
    every shard's slice, its hash in the table of the shard that owns
    it.  The state's fields are per-shard tuples where the single-device
    state holds one tensor."""
    S, mloc, m = comp.num_shards, comp.shard_size, comp.num_neurons
    home = shards[0].dev
    a = comp.arrays
    gidx = a.global_idx.reshape(-1).to(home)
    if init is None:
        init_cols = a.init_loc.reshape(-1).to(home)
    else:
        init_g = torch.zeros((S * mloc,), dtype=torch.int32, device=home)
        init_g[:m] = torch.as_tensor(list(init), dtype=torch.int32)
        init_cols = init_g[gidx.to(torch.int64)]
    init_slices = init_cols.reshape(S, mloc)
    hi0, lo0 = zobrist_hash(init_cols, positions=gidx)
    owner0 = host_read(hi0 % S)
    frontier, archive, tables = [], [], []
    for d, sh in enumerate(shards):
        fr = torch.zeros((F, mloc), dtype=torch.int32, device=sh.dev)
        fr[0] = init_slices[d]
        ar = torch.zeros((S * V, mloc), dtype=torch.int32, device=sh.dev)
        ar[0] = init_slices[d]
        table = make_table(V, sh.dev)
        if d == owner0:
            table, _, _ = insert_unique(
                table, hi0[None].to(sh.dev), lo0[None].to(sh.dev),
                torch.ones(1, dtype=torch.bool, device=sh.dev),
                torch.zeros(1, dtype=torch.int32, device=sh.dev))
        frontier.append(fr)
        archive.append(ar)
        tables.append(table)
    false = torch.zeros((), dtype=torch.bool, device=home)
    return ExploreState(tuple(frontier), 1, tuple(tables), tuple(archive),
                        1, 0, false, false, false)


def _sharded_level(st: ExploreState, shards, backend, T: int, V: int
                   ) -> ExploreState:
    """One level over the shards (module docstring, steps 1–5)."""
    S = len(shards)
    home = shards[0].dev
    F = st.frontier[0].shape[0]
    A = st.archive[0].shape[0]
    take = torch.arange(F, device=home)
    t = torch.arange(T, device=home).to(torch.float32)
    fvalid = take < st.frontier_n
    cands, psi, alive = _expand(shards, st.frontier, T, backend)
    valid = ((t[None, :] < psi[:, None]) & alive[:, None]
             & fvalid[:, None]).reshape(F * T)
    branch_ovf = st.branch_overflow | ((psi > float(T)) & fvalid).any()

    # global hashes from the slices' additive partials
    parts = [zobrist_hash(c, positions=sh.gidx)
             for c, sh in zip(cands, shards)]
    hi = torch.where(valid, _psum_u32([p[0] for p in parts], home),
                     SENTINEL)
    lo = torch.where(valid, _psum_u32([p[1] for p in parts], home),
                     SENTINEL)

    # each shard judges the candidates it owns against its own table
    owner = torch.where(valid, hi % S, S)
    new_mask = torch.zeros((F * T,), dtype=torch.bool, device=home)
    mine, probe_ovf = [], []
    for d, (sh, table) in enumerate(zip(shards, st.visited)):
        mine_d = owner == d
        h, lw, md = hi.to(sh.dev), lo.to(sh.dev), mine_d.to(sh.dev)
        found, _ = lookup(table, h, lw, md)
        first, ovf_f = first_occurrence(h, lw, md)
        new_mask = new_mask | (md & first & ~found).to(home)
        mine.append(mine_d)
        probe_ovf.append(ovf_f)

    # replicated selection: new candidates first, in index order
    n_new = new_mask.sum()
    sel = torch.sort((~new_mask).to(torch.uint8), stable=True).indices[:F]
    n_ins = host_read(n_new.clamp(max=F))    # the one read per level
    ins = take < n_ins
    frontier_ovf = st.frontier_overflow | (n_new > F)
    visited_ovf = st.visited_overflow
    k = min(n_ins, A - st.archive_n)
    payload = (st.archive_n + take).to(torch.int32)
    frontier, tables = [], []
    for d, sh in enumerate(shards):
        s_d = sel.to(sh.dev)
        frontier.append(cands[d][s_d])
        sel_mine = (mine[d][sel] & ins).to(sh.dev)
        full = st.visited[d].count + sel_mine.sum() > V
        table, _, ovf_i = insert_unique(
            st.visited[d], hi[sel].to(sh.dev), lo[sel].to(sh.dev), sel_mine,
            payload.to(sh.dev))
        tables.append(table)
        visited_ovf = visited_ovf | (probe_ovf[d] | ovf_i | full).to(home)
        st.archive[d][st.archive_n:st.archive_n + k] = frontier[d][:k]
    return ExploreState(tuple(frontier), n_ins, tuple(tables), st.archive,
                        st.archive_n + k, st.step + 1, branch_ovf,
                        frontier_ovf, visited_ovf)


def _explore_neuron_sharded(comp: ShardedCompiled, devices, backend, *,
                            max_steps: int, frontier_cap: int,
                            visited_cap: int, max_branches: int,
                            init: Optional[Sequence[int]],
                            checkpoint_dir: Optional[str],
                            checkpoint_every: int,
                            fault_injector) -> ExploreResult:
    """The level loop.  ``frontier_cap`` is the global frontier width
    (its bookkeeping is replicated; only the neuron slices are per
    shard), ``visited_cap`` is per shard (each shard's table holds the
    hashes it owns); the archive holds ``S·visited_cap`` rows, each as
    ``S`` slices.  Checkpointing and the fault injector run as in
    :func:`~.engine.explore` (:func:`~.engine._run_chunked`)."""
    S, mloc, m = comp.num_shards, comp.shard_size, comp.num_neurons
    V, T = visited_cap, max_branches
    shards = _shards(comp, devices, isinstance(backend, CudaBackend))
    home = shards[0].dev

    def run(st, bound):
        while st.step < bound and st.frontier_n > 0:
            st = _sharded_level(st, shards, backend, T, V)
        return st

    st = _run_chunked(
        _init_sharded(comp, shards, frontier_cap, V, init), run,
        max_steps=max_steps, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, fault_injector=fault_injector)
    b_ovf, f_ovf, v_ovf = (bool(x) for x in torch.stack(
        [st.branch_overflow, st.frontier_overflow, st.visited_overflow]
    ).tolist())
    # columns back to global neuron order through global_idx
    n = st.archive_n
    gidx = comp.arrays.global_idx.reshape(-1).to(home)
    cols = torch.cat([ar[:n].to(home) for ar in st.archive], 1)
    configs = torch.zeros((n, S * mloc), dtype=torch.int32, device=home)
    configs[:, gidx.to(torch.int64)] = cols
    return ExploreResult(
        configs=configs[:, :m].cpu().numpy(),
        num_discovered=n,
        steps=st.step,
        exhausted=st.frontier_n == 0 and not (b_ovf or f_ovf or v_ovf),
        branch_overflow=b_ovf, frontier_overflow=f_ovf,
        visited_overflow=v_ovf,
    )


def explore_distributed(
    system,
    *,
    mesh: Optional[Sequence[DeviceLike]] = None,
    max_steps: int = 64,
    frontier_cap: int = 64,
    visited_cap: int = 2048,
    max_branches: int = 32,
    init: Optional[Sequence[int]] = None,
    backend: BackendLike = None,
    plan: Optional[SystemPlan] = None,
    device: DeviceLike = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 32,
    fault_injector=None,
) -> ExploreResult:
    """Neuron-sharded BFS of ``system`` (an :class:`SNPSystem` with a
    ``plan`` of ``num_shards > 1``, e.g.
    :func:`repro_torch.sharding.neuron_axis`, or a pre-lowered
    :class:`~.plan.ShardedCompiled`), with the semantics and archive of
    :func:`~.engine.explore`.

    ``mesh`` is a sequence of one torch device per shard; ``None`` puts
    all ``plan.num_shards`` shards on ``device`` (``None`` = the card).
    ``frontier_cap`` is the global frontier width, ``visited_cap`` the
    capacity of each shard's table.  ``backend`` is one declaring
    ``"sharded"`` (all four do); ``None`` applies
    :func:`~.backend.resolve_entry_info` (``"sparse_cuda"`` for the ELL
    plan :func:`~repro_torch.sharding.neuron_axis` makes; an open plan,
    encoding ``"auto"``, goes to the query planner with the workload
    ``(frontier_cap, max_branches)``).

    ``checkpoint_dir``, ``checkpoint_every`` and ``fault_injector`` work
    as in :func:`~.engine.explore`: the per-shard state is snapshotted
    every ``checkpoint_every`` levels and restored on entry (onto each
    shard's device), and the injector is called once per chunk.

    Not ported yet: the dense-row hash-partitioned scheme (a call without a
    sharded plan), ROADMAP item 7; it raises ``NotImplementedError``."""
    if not (is_sharded(system) or (plan is not None
                                   and plan.num_shards > 1)):
        raise NotImplementedError(
            "explore_distributed runs the neuron-sharded scheme only (a "
            "plan with num_shards > 1, e.g. sharding.neuron_axis(S), or a "
            "ShardedCompiled); the dense-row hash-partitioned scheme is "
            "not ported yet (ROADMAP item 7)")
    if mesh is not None and device is not None:
        raise ValueError("pass mesh (one device per shard) or device, "
                         "not both")
    _check_checkpointing(checkpoint_dir, checkpoint_every)
    be, plan, _ = resolve_entry_info(
        system, backend, plan, workload=(frontier_cap, max_branches),
        device=device if mesh is None else mesh[0])
    if is_sharded(system):
        comp = system
    else:
        if not isinstance(system, SNPSystem):
            raise ValueError(
                "neuron-axis sharded exploration needs the SNPSystem (or a "
                "pre-lowered ShardedCompiled), not a single-device encoding "
                f"({type(system).__name__})")
        first = resolve_device(device if mesh is None else mesh[0])
        comp = compile_sharded(system, plan, device=first)
    if mesh is None:
        devices = [resolve_device(device)] * comp.num_shards
    else:
        devices = [resolve_device(d) for d in mesh]
        if comp.num_shards != len(devices):
            raise ValueError(
                f"plan.num_shards ({comp.num_shards}) must equal the mesh "
                f"device count ({len(devices)}); build the plan with "
                "sharding.neuron_axis(len(mesh))")
    if not supports_sharded(be):
        raise ValueError(
            f"backend {be.name!r} does not declare the 'sharded' encoding "
            "in its lowering registry (StepBackend.supported_encodings), so "
            "it cannot step a neuron shard; every built-in backend "
            "supports it")
    comp = be.lower(comp, comp.plan)
    return _explore_neuron_sharded(
        comp, devices, be, max_steps=max_steps, frontier_cap=frontier_cap,
        visited_cap=visited_cap, max_branches=max_branches, init=init,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        fault_injector=fault_injector)
