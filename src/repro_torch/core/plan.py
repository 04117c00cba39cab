"""Encoding plan: one :class:`SystemPlan` in front of compile.

The port of ``repro.core.plan``'s single-device half.  A plan decides the
storage layout a backend lowers a system to:

* ``"dense"`` — the paper's ``M_Π`` (:func:`~.matrix.compile_system`);
* ``"ell"`` — ELL rows and the ELL in-adjacency
  (:func:`~.matrix.compile_system_sparse`);
* ``"hybrid"`` — ELL capped at a hub threshold, with the tail synapses of
  heavy neurons in a COO segment;
* ``"auto"`` — the backend's native layout;

and the semantics tier it compiles under: ``"no_delays"`` (the paper's
``C' = C + S·M``) or ``"delays"`` (rules carry a firing delay; state rows
widen to ``[spikes | countdown | pending]``, :mod:`.matrix`).  Every
backend runs both tiers on all its encodings.

Decision rule of :meth:`SystemPlan.for_system`, the reference's
``mode="static"``: with ``mean`` the mean nonzero in-degree and ``Kin``
the max, the hub threshold is ``H = max(4, 4·ceil(mean))``; hybrid iff
``Kin > 2·H``, else plain ELL.

Neuron-axis partition.  ``num_shards > 1`` lowers a system through
:func:`compile_sharded` to a :class:`ShardedCompiled`: per-shard ELL
encodings stacked on a leading shard axis, plus the halo metadata saying
which remote neurons each shard's in-synapses read.  Only
:func:`repro_torch.core.distributed.explore_distributed` consumes it.
``partition`` maps neurons to shards: ``"contiguous"`` slices of ``mloc =
ceil(m/S)`` neurons, or ``"degree"``, a greedy bin-packing by degree that
spreads hubs across shards (:func:`partition_neurons`).  Every array
equals the reference's, array for array.

``mode``, ``backend`` and ``kernel`` are the reference's planning
fields.  With ``mode="auto"`` (the default) or ``"measure"`` and nothing
pinned, the entry points ask the query planner
(:mod:`.autotune`: the autotune cache, the committed seed rows, the cost
model fitted to them; ``"measure"`` times the candidates on the spot),
and fall back to the port's encoding rule
(:func:`~.backend.resolve_entry_info`) when it has nothing to say;
``"static"`` keeps that rule.  ``kernel`` is a :class:`KernelConfig`, the
block shape of the port's kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .system import SNPSystem

__all__ = ["KernelConfig", "SystemPlan", "auto_hub_threshold",
           "ShardArrays", "ShardView",
           "DenseShardArrays", "dense_shard_columns", "ShardedCompiled",
           "is_sharded", "partition_neurons", "partition_stats",
           "compile_sharded", "lower_shard_dense", "shard_view"]

_ENCODINGS = ("auto", "dense", "ell", "hybrid")
_SEMANTICS = ("no_delays", "delays")
_PARTITIONS = ("contiguous", "degree")
_MODES = ("auto", "measure", "static")

# Dummy padding rules of the sharded lowering use this regex base: they
# apply only at 2^24 spikes, which the spike-count contract (< 2^24) makes
# unreachable.
_NEVER_BASE = 1 << 24


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The block shape of the port's step kernels, carried by a plan
    (``SystemPlan.kernel``) to the backend that launches them.

    * ``block_t`` — branch rows a block: B1 takes 8, 16 or 32 (one bit
      each in a rule's fired-row mask); B4, B6 and the sliced-list kernel
      (B2, B3, B5, B7) take 1, 2, 4 or 8;
    * ``threads`` — threads a block, 256 or 1024: B4 and the sliced-list
      kernel only (B1 and B6 run 256).

    ``None`` keeps the library's rule for that field.  Each field is a
    positive int or ``None`` here; which values a kernel takes, and
    whether its stage fits, is checked where the plan meets a backend
    (:func:`~.backend.resolve_kernel`) and again by the wrappers, before
    any launch.  The reference's ``block_b`` and
    ``block_n`` have no counterpart: the port's kernels tile neither the
    batch (a block owns one configuration) nor the rule axis.  Frozen and
    hashable, so a backend carrying it keys caches on the shape."""

    block_t: Optional[int] = None
    threads: Optional[int] = None

    def __post_init__(self) -> None:
        for field in ("block_t", "threads"):
            v = getattr(self, field)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"KernelConfig.{field} must be a positive int or "
                    f"None, got {v!r}")


@dataclasses.dataclass(frozen=True)
class SystemPlan:
    """How to lay an SNP system out on the card.

    * ``encoding`` — ``"auto"``, ``"dense"``, ``"ell"`` or ``"hybrid"``;
    * ``hub_threshold`` — ELL in-degree cap of the hybrid encoding
      (``None``: :func:`auto_hub_threshold`);
    * ``semantics`` — ``"no_delays"`` or ``"delays"``;
    * ``num_shards`` — neuron-axis partition count; ``> 1`` lowers through
      :func:`compile_sharded` and is consumed by ``explore_distributed``
      only;
    * ``partition`` — ``"contiguous"`` or ``"degree"``
      (:func:`partition_neurons`);
    * ``mode`` — ``"auto"`` (the entry point asks the query planner,
      :mod:`.autotune`, then the encoding rule, and may degrade its pick
      on failure, :mod:`.failover`), ``"measure"`` (the planner times the
      candidates first) or ``"static"`` (the encoding rule, pinned);
    * ``backend`` — a step backend's registry name the plan pins, or
      ``None``;
    * ``kernel`` — a :class:`KernelConfig` block shape for the kernel
      backends, or ``None`` (the library's rule).
    """

    encoding: str = "auto"
    hub_threshold: Optional[int] = None
    semantics: str = "no_delays"
    num_shards: int = 1
    partition: str = "contiguous"
    mode: str = "auto"
    backend: Optional[str] = None
    kernel: Optional[KernelConfig] = None

    def __post_init__(self) -> None:
        if self.encoding not in _ENCODINGS:
            raise ValueError(
                f"unknown encoding {self.encoding!r}; one of {_ENCODINGS}")
        if self.semantics not in _SEMANTICS:
            raise ValueError(
                f"unknown semantics {self.semantics!r}; one of {_SEMANTICS}")
        if self.hub_threshold is not None and self.hub_threshold < 1:
            raise ValueError(
                f"hub_threshold must be >= 1, got {self.hub_threshold}")
        if self.num_shards < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {self.num_shards}")
        if self.partition not in _PARTITIONS:
            raise ValueError(
                f"unknown partition {self.partition!r}; one of {_PARTITIONS}")
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; one of {_MODES}")
        if self.kernel is not None and not isinstance(self.kernel,
                                                      KernelConfig):
            raise ValueError(
                f"plan kernel must be a KernelConfig or None, "
                f"got {type(self.kernel).__name__}")

    @staticmethod
    def for_system(system: SNPSystem, *, num_shards: int = 1,
                   workload: Optional[Tuple[int, int]] = None,
                   mode: str = "static", semantics: str = "no_delays",
                   device: DeviceLike = None) -> "SystemPlan":
        """Concrete plan for ``system``.

        ``mode="static"`` (the default): the degree heuristic (module
        docstring) — hybrid iff the max in-degree is heavy-tailed against
        the mean, else plain ELL; over ``num_shards > 1`` the plan stays
        ELL (the shards are ELL only) and a heavy-tailed graph gets the
        ``"degree"`` partition instead.  ``backend`` stays ``None``.

        ``mode="auto"`` asks the query planner (the autotune cache, the
        committed seed rows, then the cost model); ``mode="measure"``
        times the candidates on ``device`` (``None`` = the card) and
        stores the winner (:func:`.autotune.plan_for`).  Their plans name a
        backend; when the planner has nothing to say they fall through to
        the heuristic.  ``workload=(B, T)`` is the batch and branch cap
        the plan will serve."""
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {_MODES}")
        if semantics not in _SEMANTICS:
            raise ValueError(
                f"unknown semantics {semantics!r}; one of {_SEMANTICS}")
        if semantics == "delays" and num_shards > 1:
            raise ValueError(
                "no backend shards semantics='delays' yet; use "
                "num_shards=1 for delayed systems")
        if mode != "static":
            from . import autotune      # autotune imports backend and plan
            plan = autotune.plan_for(system, num_shards=num_shards,
                                     workload=workload,
                                     measure=mode == "measure",
                                     semantics=semantics, device=device)
            if plan is not None:
                return plan
        in_deg = _in_degrees(system)
        h = auto_hub_threshold(in_deg)
        kin = int(in_deg.max()) if in_deg.size else 0
        if num_shards == 1 and kin > 2 * h:
            return SystemPlan(encoding="hybrid", hub_threshold=h, mode=mode,
                              semantics=semantics)
        part = "degree" if (num_shards > 1 and kin > 2 * h) else "contiguous"
        return SystemPlan(encoding="ell", semantics=semantics, mode=mode,
                          num_shards=num_shards, partition=part)

    def resolved_hub_threshold(self, system: SNPSystem) -> Optional[int]:
        """The hub threshold ``compile_system_sparse`` caps ELL rows at:
        ``None`` unless this plan asks for the hybrid encoding."""
        if self.encoding != "hybrid":
            return None
        if self.hub_threshold is not None:
            return self.hub_threshold
        return auto_hub_threshold(_in_degrees(system))


def _in_degrees(system: SNPSystem) -> np.ndarray:
    syn = np.asarray(system.synapses, np.int64).reshape(-1, 2)
    return np.bincount(syn[:, 1], minlength=system.num_neurons) \
        if syn.size else np.zeros((system.num_neurons,), np.int64)


def auto_hub_threshold(in_deg: np.ndarray) -> int:
    """``max(4, 4·ceil(mean nonzero in-degree))`` — see module docstring."""
    in_deg = np.asarray(in_deg)
    nz = in_deg[in_deg > 0]
    mean = float(nz.mean()) if nz.size else 0.0
    return max(4, 4 * math.ceil(mean))


# ---------------------------------------------------------------------------
# Neuron-axis sharded lowering
# ---------------------------------------------------------------------------


class ShardArrays(NamedTuple):
    """Per-shard arrays stacked on a leading shard axis ``S``, int32
    unless noted; ``rule_slots`` is shared by every shard.

    ``mloc = ceil(m/S)`` neurons a shard, ``nloc`` the most rules a shard
    holds (the real, local-neuron-sorted prefix, then never-applicable
    dummies), ``Kin`` the max in-degree, ``Hmax`` (at least 1) the widest
    halo between two shards.  ``in_idx`` indexes a shard's extended
    produce space ``[local (mloc) | halo (S·Hmax) | zero (1)]``: a remote
    in-neighbour owned by shard ``o`` at halo slot ``s`` is ``mloc +
    o·Hmax + s``, padding is the zero slot ``mloc + S·Hmax``.
    ``send_idx[d, p]`` lists the local neurons shard ``d`` ships to shard
    ``p`` (padded with ``mloc``), so one all-to-all moves every halo.
    ``global_idx[d, c]`` is the global neuron of shard ``d``'s column
    ``c`` (pad columns take the unused ids ``m .. S·mloc − 1``).

    The port's own fields are what B7 walks in place of ``in_idx``
    (:func:`~.matrix.shard_sliced_lists`): each shard's ``in_idx`` in
    slices of 32 local neurons, padded with the zero slot, each shard's
    ``sell_src`` padded with it past its end to the longest shard's.
    ``None`` only on a hand-built lowering, which B7 then refuses."""

    rule_neuron: torch.Tensor   # (S, nloc) — local neuron of each rule
    consume: torch.Tensor       # (S, nloc)
    produce: torch.Tensor       # (S, nloc)
    regex_base: torch.Tensor    # (S, nloc)
    regex_period: torch.Tensor  # (S, nloc)
    covering: torch.Tensor      # (S, nloc) bool
    seg_start: torch.Tensor     # (S, mloc)
    seg_count: torch.Tensor     # (S, mloc)
    rule_slots: torch.Tensor    # (R,) == arange(R)
    in_idx: torch.Tensor        # (S, mloc, Kin) — extended space
    send_idx: torch.Tensor      # (S, S, Hmax) — local ids, pad mloc
    out_local: torch.Tensor     # (S,) — local output neuron, or mloc
    init_loc: torch.Tensor      # (S, mloc) — C_0 slices, zero padded
    global_idx: torch.Tensor    # (S, mloc) — global neuron per column
    sell_start: Optional[torch.Tensor] = None  # (S, ceil(mloc/32)+1)
    sell_src: Optional[torch.Tensor] = None    # (S, Emax), pad zero slot


class ShardView(NamedTuple):
    """One shard's rule arrays, with the fields and properties of a
    :class:`~.matrix.CompiledSparseSNP` that
    :func:`~.semantics.sparse_branch_info` and
    :func:`~.semantics.packed_rule_table` read, so a shard steps through
    the sparse semantics on its local slice."""

    rule_neuron: torch.Tensor
    consume: torch.Tensor
    produce: torch.Tensor
    regex_base: torch.Tensor
    regex_period: torch.Tensor
    covering: torch.Tensor
    seg_start: torch.Tensor
    seg_count: torch.Tensor
    rule_slots: torch.Tensor

    @property
    def num_rules(self) -> int:
        return self.rule_neuron.shape[0]

    @property
    def num_neurons(self) -> int:
        return self.seg_start.shape[0]


class DenseShardArrays(NamedTuple):
    """The dense step's per-shard operands (kernel B6), stacked like
    :class:`ShardArrays`: ``C' = C + halo·hadj + S·M_local``.
    ``M_local[d]`` restricts each local rule's row of ``M_Π`` to shard
    ``d``'s columns (``−consume`` at the owner, ``produce`` on local
    out-neighbours; dummy rules all zero); ``hadj[d][s, j] = 1`` iff halo
    slot ``s`` feeds local neuron ``j``.  The reference's rule→neuron
    one-hot is not carried: the kernel reads ``rule_neuron``.

    The port's own fields are what B6 walks instead of the two matrices
    (:func:`dense_shard_columns`): per shard the column lists of
    ``M_local[d]`` and the halo slots feeding each local neuron, each
    shard's lists padded with zeros to the longest (its ``col_start`` /
    ``hcol_start`` bound them).  ``None`` only on a hand-built view, which
    B6 then refuses."""

    M_local: torch.Tensor       # (S, nloc, mloc) int32
    hadj: torch.Tensor          # (S, S·Hmax, mloc) int8
    col_start: Optional[torch.Tensor] = None   # (S, mloc+1) int32
    col_rule: Optional[torch.Tensor] = None    # (S, L) int32
    col_val: Optional[torch.Tensor] = None     # (S, L) int32
    hcol_start: Optional[torch.Tensor] = None  # (S, mloc+1) int32
    hcol_slot: Optional[torch.Tensor] = None   # (S, Lh) int32

    def shard_columns(self, shard: int) -> Optional[Tuple[torch.Tensor,
                                                          ...]]:
        """Shard ``shard``'s ``(col_start, col_rule, col_val, hcol_start,
        hcol_slot)``, or ``None`` when the view lacks them."""
        if self.col_start is None:
            return None
        return tuple(x[shard] for x in self[2:])


def dense_shard_columns(M_local: torch.Tensor, hadj: torch.Tensor) -> dict:
    """:class:`DenseShardArrays`' column-list fields from its stacked
    ``M_local`` and ``hadj``, on their device: each shard's
    :func:`~.matrix.shard_column_lists`, padded with zeros to the longest
    shard's."""
    from .matrix import shard_column_lists   # matrix stays plan-free
    lists = [shard_column_lists(M_local[d], hadj[d])
             for d in range(M_local.shape[0])]

    def stack(k):
        width = max(1, max(x[k].shape[0] for x in lists))
        out = torch.zeros((len(lists), width), dtype=torch.int32,
                          device=M_local.device)
        for d, x in enumerate(lists):
            out[d, :x[k].shape[0]] = x[k]
        return out

    return dict(zip(("col_start", "col_rule", "col_val", "hcol_start",
                     "hcol_slot"), (stack(k) for k in range(5))))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCompiled:
    """Neuron-axis partitioned lowering: stacked shard encodings, halo
    metadata and the static sizes (:func:`compile_sharded`).  ``dense``
    is the dense step's view of the same shards, attached by
    :func:`lower_shard_dense`; ``occupancy`` the degree weight a shard
    holds (:func:`partition_stats`)."""

    arrays: ShardArrays
    plan: SystemPlan
    num_neurons: int            # m, before padding to S·mloc
    num_rules: int              # n, before dummy padding
    shard_size: int             # mloc
    num_shards: int             # S
    halo_width: int             # Hmax
    dense: Optional[DenseShardArrays] = None
    occupancy: Optional[np.ndarray] = None   # (S,)

    @property
    def device(self) -> torch.device:
        return self.arrays.in_idx.device

    @property
    def init_config(self) -> torch.Tensor:
        """The whole (m,) initial configuration, put back in global neuron
        order through ``global_idx``."""
        flat = self.arrays.init_loc.reshape(-1)
        out = torch.zeros_like(flat)
        out[self.arrays.global_idx.reshape(-1).to(torch.int64)] = flat
        return out[:self.num_neurons]


def is_sharded(obj) -> bool:
    return isinstance(obj, ShardedCompiled)


def _degree_weights(system: SNPSystem) -> np.ndarray:
    """Per-neuron work weight: in-degree + out-degree + 1."""
    syn = np.asarray(system.synapses, np.int64).reshape(-1, 2)
    w = np.ones((system.num_neurons,), np.int64)
    if syn.size:
        w += np.bincount(syn[:, 0], minlength=system.num_neurons)
        w += np.bincount(syn[:, 1], minlength=system.num_neurons)
    return w


def partition_neurons(system: SNPSystem, num_shards: int,
                      partition: str = "contiguous"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Neuron→shard assignment: ``(shard_of (m,), local_of (m,),
    global_idx (S, mloc), occupancy (S,))``.

    ``"contiguous"``: neuron ``j`` goes to shard ``j // mloc``.
    ``"degree"``: neurons in descending :func:`_degree_weights` order
    (ties by index) each go to the least-loaded shard with a free slot
    (ties to the lowest shard), under the capacity ``mloc``.  Pad columns
    take the unused ids ``m .. S·mloc − 1`` in shard order."""
    if partition not in _PARTITIONS:
        raise ValueError(
            f"unknown partition {partition!r}; one of {_PARTITIONS}")
    S, m = num_shards, system.num_neurons
    mloc = -(-m // S)
    w = _degree_weights(system)
    if partition == "contiguous":
        ids = np.arange(m, dtype=np.int64)
        shard_of = (ids // mloc).astype(np.int32)
        local_of = (ids % mloc).astype(np.int32)
        global_idx = np.arange(S * mloc, dtype=np.int32).reshape(S, mloc)
    else:
        shard_of = np.zeros((m,), np.int32)
        local_of = np.zeros((m,), np.int32)
        load = np.zeros((S,), np.int64)
        cnt = np.zeros((S,), np.int64)
        for j in np.argsort(-w, kind="stable"):
            free = np.flatnonzero(cnt < mloc)
            d = int(free[np.argmin(load[free])])
            shard_of[j] = d
            local_of[j] = cnt[d]
            load[d] += w[j]
            cnt[d] += 1
        global_idx = np.zeros((S, mloc), np.int32)
        global_idx[shard_of, local_of] = np.arange(m, dtype=np.int32)
        pad = m
        for d in range(S):
            for c in range(int(cnt[d]), mloc):
                global_idx[d, c] = pad
                pad += 1
    occupancy = np.zeros((S,), np.int64)
    np.add.at(occupancy, shard_of, w)
    return shard_of, local_of, global_idx, occupancy


def partition_stats(occupancy: np.ndarray) -> dict:
    """Imbalance of a shard assignment: max and mean occupancy and their
    ratio (1.0 = level)."""
    occ = np.asarray(occupancy, np.float64)
    mean = float(occ.mean()) if occ.size else 0.0
    mx = float(occ.max()) if occ.size else 0.0
    return {"max": mx, "mean": mean,
            "imbalance": (mx / mean) if mean else 1.0}


def compile_sharded(system: SNPSystem, plan: SystemPlan,
                    device: DeviceLike = None) -> ShardedCompiled:
    """Lower ``system`` to ``plan.num_shards`` neuron-axis shards on
    ``device`` (``None`` = the card).  Host-side numpy; every shard gets
    the same shapes (rules padded with never-applicable dummies, halos to
    the widest pair).  Refuses delays, hybrid and dense plans."""
    from .matrix import (_lower, _ragged_arange,   # matrix stays plan-free
                         shard_sliced_lists)

    if plan.semantics == "delays":
        raise ValueError(
            "neuron-axis sharding does not support semantics='delays' "
            "(the halo exchange carries spike counts only); run delayed "
            "systems single-device")
    if plan.encoding == "hybrid":
        raise ValueError(
            "neuron-axis sharding does not support the hybrid ELL+COO "
            "encoding (the sharded step gathers over per-shard ELL "
            "rows only); use encoding='ell' with num_shards > 1")
    if plan.encoding not in ("auto", "ell"):
        raise ValueError(
            f"neuron-axis sharding lowers to per-shard ELL encodings; "
            f"plan encoding {plan.encoding!r} cannot be realized "
            "(supported: 'auto', 'ell')")
    dev = resolve_device(device)
    S = plan.num_shards
    m = system.num_neurons
    low = _lower(system)
    n = low.neuron.shape[0]
    mloc = -(-m // S)
    shard_of, local_of, global_idx, occupancy = partition_neurons(
        system, S, plan.partition)

    # rules by shard, then by local neuron (stable), dummies after
    r_shard = shard_of[low.neuron]
    r_local = local_of[low.neuron]
    rorder = np.lexsort((r_local, r_shard))
    counts = np.bincount(r_shard, minlength=S)
    nloc = int(max(1, counts.max()))
    starts = np.cumsum(counts) - counts
    rn = np.full((S, nloc), mloc - 1, np.int32)
    cons = np.ones((S, nloc), np.int32)
    prod = np.zeros((S, nloc), np.int32)
    base = np.full((S, nloc), _NEVER_BASE, np.int32)
    period = np.zeros((S, nloc), np.int32)
    cov = np.zeros((S, nloc), bool)
    seg_count = np.zeros((S, mloc), np.int32)
    for d in range(S):
        k = int(counts[d])
        sl = rorder[int(starts[d]): int(starts[d]) + k]
        rn[d, :k] = r_local[sl]
        cons[d, :k] = low.consume[sl]
        prod[d, :k] = low.produce[sl]
        base[d, :k] = low.regex_base[sl]
        period[d, :k] = low.regex_period[sl]
        cov[d, :k] = low.covering[sl]
        seg_count[d] = np.bincount(rn[d, :k], minlength=mloc)
    seg_start = (np.cumsum(seg_count, axis=1) - seg_count).astype(np.int32)
    R = int(max(1, seg_count.max()))

    # halo: the sources shard o ships to shard d, in global order
    src, dst = low.src.astype(np.int64), low.dst.astype(np.int64)
    ssh, dsh = shard_of[src], shard_of[dst]
    halo = {}
    hmax = 1
    for o in range(S):
        for d in range(S):
            if o == d:
                continue
            need = np.unique(src[(dsh == d) & (ssh == o)])
            if need.size:
                halo[(o, d)] = need
                hmax = max(hmax, int(need.size))
    send_idx = np.full((S, S, hmax), mloc, np.int32)
    for (o, d), need in halo.items():
        send_idx[o, d, :need.size] = local_of[need]

    # in-adjacency in the extended [local | halo | zero] space
    in_deg = np.bincount(dst, minlength=m)
    kin = int(max(1, in_deg.max() if in_deg.size else 0))
    z = mloc + S * hmax
    in_idx = np.full((S, mloc, kin), z, np.int32)
    if src.size:
        order = np.lexsort((src, dst))
        s_s, d_s = src[order], dst[order]
        slot = _ragged_arange(in_deg)
        e_dsh, e_ssh = shard_of[d_s], shard_of[s_s]
        ext = np.where(e_ssh == e_dsh, local_of[s_s], -1)
        for (o, d), need in halo.items():
            sel = (e_ssh == o) & (e_dsh == d)
            if sel.any():
                ext[sel] = mloc + o * hmax + np.searchsorted(need, s_s[sel])
        in_idx[e_dsh, local_of[d_s], slot] = ext

    out_local = np.full((S,), mloc, np.int32)
    if system.output_neuron >= 0:
        out_local[shard_of[system.output_neuron]] = \
            local_of[system.output_neuron]
    init_loc = np.zeros((S, mloc), np.int32)
    init_loc[shard_of, local_of] = np.asarray(system.initial_spikes,
                                              np.int32)

    sell_start, sell_src = shard_sliced_lists(in_idx, z)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    arrays = ShardArrays(
        rule_neuron=t(rn), consume=t(cons), produce=t(prod),
        regex_base=t(base), regex_period=t(period),
        covering=t(cov, torch.bool), seg_start=t(seg_start),
        seg_count=t(seg_count),
        rule_slots=torch.arange(R, dtype=torch.int32, device=dev),
        in_idx=t(in_idx), send_idx=t(send_idx), out_local=t(out_local),
        init_loc=t(init_loc), global_idx=t(global_idx),
        sell_start=t(sell_start), sell_src=t(sell_src))
    return ShardedCompiled(arrays=arrays, plan=plan, num_neurons=m,
                           num_rules=n, shard_size=mloc, num_shards=S,
                           halo_width=hmax, occupancy=occupancy)


def lower_shard_dense(comp: ShardedCompiled) -> ShardedCompiled:
    """``comp`` with the dense step's operands (:class:`DenseShardArrays`)
    attached; one that has them passes through."""
    if comp.dense is not None:
        return comp
    from .matrix import _ragged_arange   # matrix stays plan-free
    a = comp.arrays
    S, mloc, hmax = comp.num_shards, comp.shard_size, comp.halo_width
    nloc = a.rule_neuron.shape[1]
    rn, cons, prod, base, seg_start, seg_count, in_idx = (
        x.cpu().numpy() for x in (a.rule_neuron, a.consume, a.produce,
                                  a.regex_base, a.seg_start, a.seg_count,
                                  a.in_idx))
    M = np.zeros((S, nloc, mloc), np.int32)
    hadj = np.zeros((S, S * hmax, mloc), np.int8)
    for d in range(S):
        real = np.nonzero(base[d] != _NEVER_BASE)[0]
        M[d, real, rn[d, real]] = -cons[d, real]
        # a local source's every rule writes its produce into the target
        jj, kk = np.nonzero(in_idx[d] < mloc)
        src = in_idx[d][jj, kk]
        cnt = seg_count[d, src].astype(np.int64)
        rr = np.repeat(seg_start[d, src], cnt) + _ragged_arange(cnt)
        np.add.at(M[d], (rr, np.repeat(jj, cnt)), prod[d, rr])
        hj, hk = np.nonzero((in_idx[d] >= mloc) &
                            (in_idx[d] < mloc + S * hmax))
        hadj[d][in_idx[d][hj, hk] - mloc, hj] = 1
    M, hadj = torch.from_numpy(M), torch.from_numpy(hadj)
    lists = dense_shard_columns(M, hadj)
    dev = comp.device
    return dataclasses.replace(comp, dense=DenseShardArrays(
        M_local=M.to(dev), hadj=hadj.to(dev),
        **{k: v.to(dev) for k, v in lists.items()}))


def shard_view(arrays: ShardArrays, shard: int) -> ShardView:
    """Shard ``shard``'s rule arrays (``rule_slots`` is shared)."""
    return ShardView(
        rule_neuron=arrays.rule_neuron[shard], consume=arrays.consume[shard],
        produce=arrays.produce[shard], regex_base=arrays.regex_base[shard],
        regex_period=arrays.regex_period[shard],
        covering=arrays.covering[shard], seg_start=arrays.seg_start[shard],
        seg_count=arrays.seg_count[shard], rule_slots=arrays.rule_slots)
