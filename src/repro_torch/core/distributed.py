"""Multi-device SNP workloads: :func:`explore_distributed` and
:func:`run_traces_distributed`.

The port of ``repro.core.distributed``.  Both entry points take ``mesh``,
a sequence of torch devices, one per rank (repeats allowed: ``["cuda"] *
4`` runs four ranks on one card); :func:`repro_torch.sharding.trace_mesh`
lists every visible card.

**Dense-row hash-partitioned BFS** (``explore_distributed`` without a
sharded plan; the reference's ``_dense_body``).  Rank ``d`` holds its own
frontier (``frontier_cap`` rows), hash-table shard and archive
(``visited_cap`` each).  A configuration with hash ``hi`` is owned by
rank ``hi mod R``.  Each level, every rank

1. expands its frontier through the backend (``"cuda"`` launches B1,
   ``"sparse_cuda"`` B2 or B3, ``"ref"``/``"sparse"`` run the plain math)
   and hashes every candidate with :func:`~.hashing.config_hash`;
2. orders its candidates by owner (a stable sort; invalid ones last) and
   places each in send slot ``owner·C + pos`` (``C`` = ``send_cap``, a
   candidate past its owner's ``C`` slots is dropped and sets the send
   overflow), its hashes beside it;
3. receives, by the tiled all-to-all over rows, the slots ``[d·C,
   (d+1)·C)`` of every rank's send buffer, in rank order;
4. dedups them against its own table (``lookup``, ``first_occurrence``),
   selects the new ones first (a stable sort) as its next frontier,
   inserts the selected prefix and appends it to its archive.

The archive is the ranks' archives concatenated in rank order: the
reference's order, not single-device order.  The delayed tier is refused
here, as the reference fails on it (it sizes rows by ``num_neurons``).

**Neuron-sharded BFS** (a ``SystemPlan(num_shards > 1)``, or a
:class:`~.plan.ShardedCompiled`).  The neuron axis is cut into ``S``
shards of ``mloc = ceil(m/S)`` columns (:func:`~.plan.compile_sharded`):
every frontier row, candidate and archive row is held as ``S`` slices,
and each level

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

**Distributed traces** (:func:`run_traces_distributed`).  The batch is
padded to a multiple of ``R`` with seed-0 dummies and rank ``d`` runs
:func:`~.engine.run_traces`' loop on its contiguous chunk; the chunks are
gathered on ``mesh[0]``.  Every trace's key depends on its seed only, so
the result equals ``run_traces`` bit for bit on any mesh.
:func:`repro_torch.serve.make_trace_runner` serves it.

Transport.  The reference runs one ``shard_map`` over ``R`` devices.  Here
one process steps the ranks in lockstep, and the collectives are exact
tensor operations over the per-rank tensors, in rank order: the
all-to-all is ``recv[p][q-block] = send[q][p-block]`` (the reference's
tiled ``all_to_all``), the uint32 ``psum`` a sum of int64 lanes masked to
32 bits.  ``mesh=None`` holds every rank on ``device`` (``None`` = the
card): one rank for the dense-row scheme, ``plan.num_shards`` for the
sharded one.  Replicated bookkeeping lives on the first device of the
mesh.  The reference has no multi-process path either (its ``shard_map``
runs over the devices of one process), so the port has no
``torch.distributed`` transport.

Host reads.  As in :func:`~.engine.explore`, a level reads nothing: the
ranks' counts are an (R,) tensor, the owner of the initial configuration
is taken on the device, the hash tables probe through the kernels H1 and
H2, and a candidate's owner bins by a scatter, not a ``bincount`` (which
waits on the card to size its output).  With every rank or shard on one
card (``mesh=None``, or the card repeated) all of them run in one CUDA
graph with the loop's predicate on the device (:mod:`.graph_loop`): a
run reads its counts and flags once at the end.  A mesh over several
cards keeps the read-free level but drives it from the host, with one
counted read of the predicate a level.

Archives, flags and counts equal the reference's distributed runs row for
row, in discovery order, through all four backends.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .backend import (BackendLike, CudaBackend, SparseCudaBackend,
                      lower_with_backend, resolve_entry_info,
                      supports_sharded)
from .device import DeviceLike, host_copy, resolve_device, same_device
from .engine import (ExploreResult, ExploreState, TraceOut, _append,
                     _check_checkpointing, _flags, _resolve_comp, _result,
                     _run_chunked, _scalar, _traces)
from .failover import run_with_failover
from .hashing import M32, SENTINEL, config_hash, zobrist_hash
from .hashtable import (_canonical, first_occurrence, insert_unique_, lookup,
                        make_table)
from .matrix import is_compiled, is_delayed
from .plan import (ShardedCompiled, ShardView, SystemPlan, compile_sharded,
                   is_sharded, shard_view)
from .semantics import packed_rule_table, sparse_branch_info
from .system import SNPSystem

__all__ = ["explore_distributed", "run_traces_distributed"]


def _psum_u32(parts: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """Sum of uint32 lanes (int64 tensors in [0, 2^32)) over the shards,
    wrapping mod 2^32 as the reference's int32 ``psum`` does."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total & M32


def _all_to_all(sends: Sequence[torch.Tensor], devices, block: int,
                dim: int = -1) -> List[torch.Tensor]:
    """The tiled all-to-all: rank ``q``'s send holds its block for rank
    ``p`` at ``[p·block, (p+1)·block)`` along ``dim``; rank ``p`` receives
    the blocks of ranks ``0 .. R−1`` in order.  The halo goes along the
    last axis (``block`` = Hmax), the dense-row exchange along the rows
    (``block`` = ``send_cap``)."""
    R = len(sends)
    return [torch.cat([sends[q].narrow(dim, p * block, block).to(devices[p])
                       for q in range(R)], dim) for p in range(R)]


def _mesh(mesh: Optional[Sequence[DeviceLike]], device: DeviceLike
          ) -> List[torch.device]:
    """The ranks' devices: ``mesh`` resolved, or ``[device]``."""
    if mesh is None:
        return [resolve_device(device)]
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("mesh names no device")
    return devices


# ---------------------------------------------------------------------------
# The dense-row hash-partitioned scheme
# ---------------------------------------------------------------------------


class _Rank(NamedTuple):
    """One rank's device and the encoding on it."""

    dev: torch.device
    comp: object


def _ranks(comp, devices) -> List[_Rank]:
    """The encoding on each rank's device, one copy a distinct device."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = comp if dev == comp.device else comp.to(dev)
    return [_Rank(dev, copies[dev]) for dev in devices]


def _bin_by_owner(cand, hi, lo, valid, R: int, C: int):
    """Step 2 of a dense-row level on one rank: the send buffers
    ``(configs (R·C, w), valid (R·C,), hi, lo)`` and the send overflow.
    A candidate's owner is ``hi mod R`` (``R`` when invalid); candidates
    are taken in a stable order by owner and the one at position ``pos``
    of its owner's group goes to slot ``owner·C + pos``, or nowhere once
    ``pos >= C``.  Empty slots hold zeros and are invalid."""
    K, dev = cand.shape[0], cand.device
    owner = torch.where(valid, hi % R, R)
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order]
    # a scatter into R + 1 slots: bincount would wait on the card to size
    # its output
    counts = torch.zeros(R + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, owner, torch.ones_like(owner))[:R]
    start = counts.cumsum(0) - counts
    pos = torch.arange(K, device=dev) - torch.where(
        owner_s < R, start[owner_s.clamp(max=R - 1)], 0)
    slot = torch.where((owner_s < R) & (pos < C), owner_s * C + pos, R * C)
    # the candidate in each slot (K: none); every drop lands on the spare
    # slot R·C, which is cut off
    src = torch.full((R * C + 1,), K, dtype=torch.int64, device=dev)
    src[slot] = order
    src = src[:R * C]
    has = src < K
    g = src.clamp(max=K - 1)
    return (torch.where(has[:, None], cand[g], 0), has,
            torch.where(has, hi[g], 0), torch.where(has, lo[g], 0),
            (counts > C).any())


def _init_dense(comp, ranks: List[_Rank], F: int, V: int,
                init: Optional[Sequence[int]]) -> ExploreState:
    """The initial configuration as row 0 of its owner's frontier and
    archive, its hash in the owner's table; the owner is taken on the
    canonical hash, on the device (every rank's row 0 and insertion are
    masked by it: no read).  The state's fields are per-rank tuples, its
    counts one a rank ((R,) int32 on the first rank's device)."""
    R, home, w = len(ranks), ranks[0].dev, comp.state_width
    c0 = comp.init_config.to(home) if init is None else torch.as_tensor(
        list(init), dtype=torch.int32, device=home)
    hi0, lo0 = config_hash(c0)
    hic, loc = _canonical(hi0[None], lo0[None],
                          torch.ones(1, dtype=torch.bool, device=home))
    owner0 = hic[0] % R
    frontier, archive, tables = [], [], []
    for d, rk in enumerate(ranks):
        mine = (owner0 == d).to(rk.dev)
        row = torch.where(mine, c0.to(rk.dev), 0)
        fr = torch.zeros((F, w), dtype=torch.int32, device=rk.dev)
        ar = torch.zeros((V + 1, w), dtype=torch.int32, device=rk.dev)
        fr[0] = row
        ar[0] = row
        table = make_table(V, rk.dev)
        insert_unique_(table, hic.to(rk.dev), loc.to(rk.dev), mine[None],
                       torch.zeros(1, dtype=torch.int32, device=rk.dev))
        frontier.append(fr)
        archive.append(ar)
        tables.append(table)
    ones = (torch.arange(R, device=home) == owner0).to(torch.int32)
    return ExploreState(tuple(frontier), ones, tuple(tables),
                        tuple(archive), ones.clone(), _scalar(0, home),
                        *_flags(home), _scalar(1, home))


def _dense_level(st: ExploreState, ranks: List[_Rank], backend, T: int,
                 C: int, V: int) -> None:
    """One dense-row level over the ranks in place (module docstring,
    steps 1–4).  It reads nothing from the device: the ranks' counts stay
    an (R,) tensor."""
    R, home = len(ranks), ranks[0].dev
    F = st.frontier[0].shape[0]
    sends = []
    for d, rk in enumerate(ranks):
        out = backend.expand(st.frontier[d], rk.comp, T)
        live = torch.arange(F, device=rk.dev) < st.frontier_n[d].to(rk.dev)
        cand = out.configs.reshape(F * T, -1)
        valid = (out.valid & live[:, None]).reshape(F * T)
        hi, lo = config_hash(cand)
        *send, send_ovf = _bin_by_owner(cand, hi, lo, valid, R, C)
        st.branch_overflow.logical_or_(
            ((out.overflow & live).any() | send_ovf).to(home))
        sends.append(send)
        del out, cand, hi, lo
    devices = [rk.dev for rk in ranks]
    recv = list(zip(*(_all_to_all([s[i] for s in sends], devices, C, 0)
                      for i in range(4))))
    del sends

    # dedup against each rank's own table: new = valid & first & ~found
    news, probe_ovf = [], []
    for p, (rcfg, rval, rhi, rlo) in enumerate(recv):
        found, _ = lookup(st.visited[p], rhi, rlo, rval)
        first, ovf_f = first_occurrence(rhi, rlo, rval)
        news.append(rval & first & ~found)
        probe_ovf.append(ovf_f)
    n_new = torch.stack([x.sum().to(home) for x in news])        # (R,)
    n_ins = n_new.clamp(max=F)
    st.frontier_overflow.logical_or_((n_new > F).any())
    for p, (rcfg, _, rhi, rlo) in enumerate(recv):
        dev = ranks[p].dev
        k, a_n = n_ins[p].to(dev), st.archive_n[p].to(dev)
        take = torch.arange(F, device=dev)
        # new rows first, in index order; rows past n_ins stay as the
        # reference leaves them, masked by the next level's count
        sel = torch.sort((~news[p]).to(torch.uint8), stable=True).indices[:F]
        nf = rcfg[sel]
        full = st.visited[p].count + k > V
        _, ovf_i = insert_unique_(st.visited[p], rhi[sel], rlo[sel],
                                  take < k, (a_n + take).to(torch.int32))
        st.visited_overflow.logical_or_(
            (probe_ovf[p] | ovf_i | full).to(home))
        _append(st.archive[p], a_n + take, take < k, V, nf)
        st.frontier[p].copy_(nf)
    st.frontier_n.copy_(n_ins)
    st.archive_n.copy_((st.archive_n + n_ins).clamp(max=V))
    st.total_new.copy_(n_ins.sum())
    st.step.add_(1)


# ---------------------------------------------------------------------------
# The neuron-sharded scheme
# ---------------------------------------------------------------------------


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
    every shard's slice, its hash in the table of the shard that owns it
    (taken on the device: each shard's insertion is masked by it).  The
    state's fields are per-shard tuples where the single-device state
    holds one tensor; an archive slice holds ``S·V`` rows and the spare
    one."""
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
    owner0 = hi0 % S
    frontier, archive, tables = [], [], []
    for d, sh in enumerate(shards):
        fr = torch.zeros((F, mloc), dtype=torch.int32, device=sh.dev)
        fr[0] = init_slices[d]
        ar = torch.zeros((S * V + 1, mloc), dtype=torch.int32, device=sh.dev)
        ar[0] = init_slices[d]
        table = make_table(V, sh.dev)
        insert_unique_(table, hi0[None].to(sh.dev), lo0[None].to(sh.dev),
                       (owner0 == d)[None].to(sh.dev),
                       torch.zeros(1, dtype=torch.int32, device=sh.dev))
        frontier.append(fr)
        archive.append(ar)
        tables.append(table)
    one = _scalar(1, home)
    return ExploreState(tuple(frontier), one, tuple(tables), tuple(archive),
                        one.clone(), _scalar(0, home), *_flags(home),
                        one.clone())


def _sharded_level(st: ExploreState, shards, backend, T: int, V: int
                   ) -> None:
    """One level over the shards in place (module docstring, steps 1–5).
    It reads nothing from the device."""
    S = len(shards)
    home = shards[0].dev
    F = st.frontier[0].shape[0]
    A = st.archive[0].shape[0] - 1
    take = torch.arange(F, device=home)
    t = torch.arange(T, device=home).to(torch.float32)
    fvalid = take < st.frontier_n
    cands, psi, alive = _expand(shards, st.frontier, T, backend)
    valid = ((t[None, :] < psi[:, None]) & alive[:, None]
             & fvalid[:, None]).reshape(F * T)
    st.branch_overflow.logical_or_(((psi > float(T)) & fvalid).any())

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
    n_ins = n_new.clamp(max=F)
    ins = take < n_ins
    st.frontier_overflow.logical_or_(n_new > F)
    rows = st.archive_n + take
    for d, sh in enumerate(shards):
        s_d = sel.to(sh.dev)
        nf = cands[d][s_d]
        sel_mine = (mine[d][sel] & ins).to(sh.dev)
        full = st.visited[d].count + sel_mine.sum() > V
        _, ovf_i = insert_unique_(
            st.visited[d], hi[sel].to(sh.dev), lo[sel].to(sh.dev), sel_mine,
            rows.to(device=sh.dev, dtype=torch.int32))
        st.visited_overflow.logical_or_(
            (probe_ovf[d] | ovf_i | full).to(home))
        _append(st.archive[d], rows.to(sh.dev), ins.to(sh.dev), A, nf)
        st.frontier[d].copy_(nf)
    st.frontier_n.copy_(n_ins)
    st.archive_n.copy_((st.archive_n + n_ins).clamp(max=A))
    st.total_new.copy_(n_ins)
    st.step.add_(1)


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
    st, r = _run_chunked(
        _init_sharded(comp, shards, frontier_cap, V, init),
        lambda st: _sharded_level(st, shards, backend, T, V), devices,
        max_steps=max_steps, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, fault_injector=fault_injector)
    # columns back to global neuron order through global_idx
    n = r.archive_n[0]
    gidx = comp.arrays.global_idx.reshape(-1).to(home)
    cols = torch.cat([ar[:n].to(home) for ar in st.archive], 1)
    configs = torch.zeros((n, S * mloc), dtype=torch.int32, device=home)
    configs[:, gidx.to(torch.int64)] = cols
    return _result(host_copy(configs[:, :m]), r)


def explore_distributed(
    system,
    *,
    mesh: Optional[Sequence[DeviceLike]] = None,
    max_steps: int = 64,
    frontier_cap: int = 64,
    visited_cap: int = 2048,
    max_branches: int = 32,
    send_cap: Optional[int] = None,
    init: Optional[Sequence[int]] = None,
    backend: BackendLike = None,
    plan: Optional[SystemPlan] = None,
    device: DeviceLike = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 32,
    fault_injector=None,
) -> ExploreResult:
    """Hash-partitioned BFS of ``system`` over the ranks of ``mesh``, with
    the semantics of :func:`~.engine.explore` (module docstring).

    Without a sharded plan this is the **dense-row** scheme: ``system``
    is an :class:`SNPSystem` (lowered under ``plan``, any delay-free
    encoding) or a compiled encoding; ``frontier_cap`` and
    ``visited_cap`` are per rank, and ``send_cap`` is the slots a rank
    sends each rank a level (``None``: ``max(16, frontier_cap ·
    max_branches // R)``).  ``mesh`` is one torch device per rank;
    ``None`` is one rank on ``device`` (``None`` = the card).  A delayed
    plan or encoding is refused (the reference fails on it), as is a
    ``send_cap`` with ``R · send_cap < frontier_cap``.

    With a plan of ``num_shards > 1`` (e.g.
    :func:`repro_torch.sharding.neuron_axis`), or a pre-lowered
    :class:`~.plan.ShardedCompiled`, this is the **neuron-sharded**
    scheme: ``mesh`` is one device per shard, ``None`` puts all
    ``plan.num_shards`` shards on ``device``; ``frontier_cap`` is the
    global frontier width, ``visited_cap`` the capacity of each shard's
    table, and ``backend`` one declaring ``"sharded"`` (all four do).

    ``mesh`` and ``device`` together are refused.  ``backend=None``
    applies :func:`~.backend.resolve_entry_info` with the workload
    ``(frontier_cap, max_branches)`` (an open plan goes to the query
    planner; a sparse plan picks ``"sparse_cuda"``, as the ELL plan
    :func:`~repro_torch.sharding.neuron_axis` makes).
    ``checkpoint_dir``, ``checkpoint_every`` and ``fault_injector`` work
    as in :func:`~.engine.explore`: the per-rank or per-shard state is
    snapshotted every ``checkpoint_every`` levels and restored on entry
    (onto each rank's device), and the injector is called once per
    chunk."""
    if mesh is not None and device is not None:
        raise ValueError("pass mesh (one device per rank or shard) or "
                         "device, not both")
    _check_checkpointing(checkpoint_dir, checkpoint_every)
    if not (is_sharded(system) or (plan is not None
                                   and plan.num_shards > 1)):
        return _explore_dense_rows(
            system, mesh=mesh, device=device, max_steps=max_steps,
            frontier_cap=frontier_cap, visited_cap=visited_cap,
            max_branches=max_branches, send_cap=send_cap, init=init,
            backend=backend, plan=plan, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, fault_injector=fault_injector)
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
    comp = lower_with_backend(be, comp, comp.plan)
    return _explore_neuron_sharded(
        comp, devices, be, max_steps=max_steps, frontier_cap=frontier_cap,
        visited_cap=visited_cap, max_branches=max_branches, init=init,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        fault_injector=fault_injector)


def _explore_dense_rows(system, *, mesh, device, max_steps: int,
                        frontier_cap: int, visited_cap: int,
                        max_branches: int, send_cap: Optional[int], init,
                        backend, plan, checkpoint_dir, checkpoint_every,
                        fault_injector) -> ExploreResult:
    """The dense-row branch of :func:`explore_distributed`: its refusals,
    then the level loop (``frontier_cap`` and ``visited_cap`` per rank;
    checkpointing and the fault injector as in :func:`~.engine.explore`,
    through :func:`~.engine._run_chunked`)."""
    devices = _mesh(mesh, device)
    R, F, T = len(devices), frontier_cap, max_branches
    C = max(16, (F * T) // R) if send_cap is None else send_cap
    if (plan is not None and plan.semantics == "delays") or (
            is_compiled(system) and is_delayed(system)):
        raise ValueError(
            "the dense-row scheme takes delay-free systems only: the "
            "reference's dense-row explore_distributed fails under the "
            "delays tier (it sizes rows by num_neurons, not state_width)")
    if R * C < F:
        raise ValueError(
            f"send_cap {C} over {R} rank(s) receives {R * C} rows a level, "
            f"fewer than frontier_cap {F}; raise send_cap")
    be, plan, _ = resolve_entry_info(system, backend, plan,
                                     workload=(F, T), device=devices[0])
    ranks = _ranks(_resolve_comp(system, be, plan, devices[0]), devices)
    home, V = ranks[0].dev, visited_cap
    st, r = _run_chunked(
        _init_dense(ranks[0].comp, ranks, F, V, init),
        lambda st: _dense_level(st, ranks, be, T, C, V), devices,
        max_steps=max_steps, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, fault_injector=fault_injector)
    configs = torch.cat([a[:n].to(home)
                         for a, n in zip(st.archive, r.archive_n)])
    return _result(host_copy(configs), r)


def run_traces_distributed(system, *, steps: int, seeds,
                           policy: str = "first", max_branches: int = 64,
                           backend: BackendLike = None,
                           mesh: Optional[Sequence[DeviceLike]] = None,
                           plan: Optional[SystemPlan] = None,
                           device: DeviceLike = None) -> TraceOut:
    """:func:`~.engine.run_traces` with the batch split over the ranks of
    ``mesh`` (one torch device per rank, repeats allowed; ``None`` = one
    rank on ``device``).  The batch is padded to a multiple of ``R`` with
    seed-0 dummies, rank ``d`` runs the traces of its contiguous chunk,
    and the chunks are gathered on ``mesh[0]`` and cut to ``len(seeds)``:
    each trace depends on its seed only, so the result equals
    ``run_traces`` bit for bit for every ``R``.

    ``device`` is where the result lands; with a mesh it may only name
    ``mesh[0]`` (the trace service passes its own device).  A backend the
    entry point chose degrades on a failure to build, lower or launch, as
    in ``run_traces`` (on the card only to another kernel backend)."""
    if policy not in ("first", "random"):
        raise ValueError(f"unknown policy {policy!r}")
    if plan is not None and plan.num_shards > 1:
        raise ValueError("trace serving shards the batch axis, not the "
                         "neuron axis; plan.num_shards > 1 is only "
                         "consumed by explore_distributed")
    seeds = np.asarray(seeds)
    if seeds.ndim != 1:
        raise ValueError(f"seeds must be 1-D, got shape {seeds.shape}")
    devices = _mesh(mesh, device)
    home = devices[0]
    if mesh is not None and device is not None and \
            not same_device(device, home):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{home}, where the traces are gathered")
    be, plan, planned = resolve_entry_info(
        system, backend, plan, workload=(len(seeds), max_branches),
        device=home)
    R, B = len(devices), int(seeds.shape[0])
    per = -(-max(B, 1) // R)
    padded = np.zeros((per * R,), np.int64)
    padded[:B] = seeds.astype(np.int64)

    def attempt(be, plan):
        ranks = _ranks(_resolve_comp(system, be, plan, home), devices)
        outs = [_traces(rk.comp, be, padded[d * per:(d + 1) * per], steps,
                        policy, max_branches) for d, rk in enumerate(ranks)]
        return TraceOut(*(torch.cat([o[f].to(home) for o in outs])[:B]
                          for f in range(len(TraceOut._fields))))

    return run_with_failover(attempt, be, plan, degradable=planned,
                             device=home)
