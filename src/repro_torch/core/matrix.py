"""Matrix encodings of an SNP system (paper §2.2) as torch tensors.

The port of ``repro.core.matrix``.  Both lowerings sort rules **by owning
neuron** (stable), build their arrays by vectorized numpy adjacency
indexing, and move them to the requested device once:

* :func:`compile_system` — the paper's dense ``M_Π``
  (:class:`CompiledSNP`), ``O(n·m)``;
* :func:`compile_system_sparse` — the ELL/segment encoding
  (:class:`CompiledSparseSNP`): ELL rows of ``M_Π``, per-neuron rule
  segments, the ELL in-adjacency of the synapse graph and, with a hub
  threshold (the hybrid plan), a COO tail of the hub neurons'
  in-synapses.  Nothing ``O(n·m)``.

Both compile under either semantics tier (``semantics=``, normally a
:class:`~.plan.SystemPlan`'s).  ``"no_delays"`` is the paper's and refuses
a system with a delayed rule, as the reference does.  ``"delays"`` widens
``init_config`` to the ``3m`` state row ``[spikes | countdown | pending]``
and adds the per-rule ``delay``; the dense encoding also carries the 0/1
synapse ``adjacency`` (which moves a reopening neuron's pending spikes),
the output neuron, ``adj_in``, the in-neighbour lists of ``adjacency``
that the plain delayed step reads in its place, and ``adj_in`` in
slices of 32 neurons (:func:`sliced_in_lists`), which the dense delayed
kernel B4 walks.  Without
delays the dense encoding carries the column lists of ``[M_Π |
env_produce]`` (:func:`dense_column_lists`), which the dense step kernel
B1 walks in place of the ``(n, m)`` matrix.  This module is the one that
builds column lists: the shard kernel B6's too
(:func:`shard_column_lists`).

The reference's ``neuron_onehot`` (the ``(n, m)`` rule→neuron incidence)
is not carried: on the TPU it turned the per-rule gather into a matmul,
while the port gathers through ``rule_neuron`` directly.  Nor is its
``coo_dst``: the COO tail's targets are read through ``coo_bounds`` and
``hub_slot``.  Every sparse encoding also carries its ELL in-adjacency in
slices of 32 neurons (:func:`sliced_in_lists`), and a hybrid one the
inverse of ``hub_slot`` (:func:`hub_neurons`), which the sparse step's
sliced-list kernel (B2, B3, B5) walks in place of ``in_idx`` and
``hub_slot``; the sharded lowering slices each shard's extended-space
``in_idx`` the same way for B7 (:func:`shard_sliced_lists`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .system import Rule, SNPSystem

__all__ = ["CompiledSNP", "CompiledSparseSNP", "CompiledAny",
           "check_coo_metadata", "check_sliced_lists", "column_lists",
           "compile_system", "compile_system_sparse", "dense_column_lists",
           "hub_neurons", "in_neighbours", "is_compiled", "is_delayed",
           "shard_column_lists", "shard_sliced_lists", "sliced_in_lists"]

_SEMANTICS = ("no_delays", "delays")


def _check_semantics(system: SNPSystem, semantics: str) -> bool:
    """Validate the semantics tier at compile time; ``True`` for the
    delayed tier.  A system with a delayed rule raises under
    ``no_delays``, where its delays would otherwise be ignored."""
    if semantics not in _SEMANTICS:
        raise ValueError(
            f"semantics must be one of {_SEMANTICS}, got {semantics!r}")
    if semantics == "no_delays" and system.max_delay > 0:
        raise ValueError(
            f"system {system.name!r} has rules with delay > 0; compile it "
            "under SystemPlan(semantics=\"delays\") (the paper's matrix "
            "semantics is delay-free)")
    return semantics == "delays"


def _to_device(comp, device):
    """``comp`` (a NamedTuple of tensors) on ``device``, or itself when
    already there."""
    if comp.device == torch.device(device):
        return comp
    return type(comp)(*(x.to(device) if isinstance(x, torch.Tensor) else x
                        for x in comp))


class CompiledSNP(NamedTuple):
    """Dense encoding of an SNP system.  Shapes: ``m`` neurons, ``n`` rules
    (sorted by neuron); every tensor lives on one device.  The trailing
    delay fields are ``None`` under ``no_delays``."""

    M: torch.Tensor             # (n, m) int32 — spiking transition matrix
    rule_neuron: torch.Tensor   # (n,)  int32 — owning neuron of each rule
    consume: torch.Tensor       # (n,)  int32
    produce: torch.Tensor       # (n,)  int32
    regex_base: torch.Tensor    # (n,)  int32
    regex_period: torch.Tensor  # (n,)  int32 (0 => single word)
    covering: torch.Tensor      # (n,)  bool
    env_produce: torch.Tensor   # (n,)  int32 — spikes emitted to environment
    init_config: torch.Tensor   # (m,)  int32 — C_0 (3m under delays)
    rule_order: Tuple[int, ...]  # original rule index per sorted position
    delay: Optional[torch.Tensor] = None      # (n,) int32 — firing delay
    adjacency: Optional[torch.Tensor] = None  # (m, m) int32 — 0/1 synapses
    out_neuron: Optional[torch.Tensor] = None  # () int32 — or m if none
    # In-neighbours of each neuron in ``adjacency``, ascending, padded
    # with m (:func:`in_neighbours`); not a reference field.
    adj_in: Optional[torch.Tensor] = None     # (m, Kin) int32
    # The column lists of [M | env_produce] (n, m+1), column m being
    # env's (:func:`dense_column_lists`), which B1 walks; not reference
    # fields.  None under delays and on a hand-built encoding, which B1
    # then refuses.
    col_start: Optional[torch.Tensor] = None  # (m+2,) int32
    col_rule: Optional[torch.Tensor] = None   # (nnz,) int32
    col_val: Optional[torch.Tensor] = None    # (nnz,) int32
    # adj_in in slices of 32 neurons (:func:`sliced_in_lists`), which B4
    # walks; not reference fields.  Under delays only (as col_* exist only
    # without), None on a hand-built encoding, which B4 then refuses.
    sell_start: Optional[torch.Tensor] = None  # (ceil(m/32)+1,) int32
    sell_src: Optional[torch.Tensor] = None    # (E,) int32, pad m

    @property
    def num_rules(self) -> int:
        return self.M.shape[0]

    @property
    def num_neurons(self) -> int:
        return self.M.shape[1]

    @property
    def state_width(self) -> int:
        """Columns of one state row: ``m``, or ``3m`` under delays."""
        return self.init_config.shape[0]

    @property
    def device(self) -> torch.device:
        return self.M.device

    def to(self, device: torch.device) -> "CompiledSNP":
        """The same encoding on ``device`` (``self`` when already there)."""
        return _to_device(self, device)


class CompiledSparseSNP(NamedTuple):
    """ELL/segment encoding of an SNP system; no ``O(n·m)`` tensor.

    Shapes: ``m`` neurons, ``n`` rules (sorted by neuron), ``K`` =
    ``max_nnz_per_rule``, ``R`` = ``max_rules_per_neuron``, ``Kin`` = the
    ELL in-degree width (>= 1), ``Ec`` COO tail entries over ``Hn`` hubs.
    Index padding points at the out-of-range id (neuron ``m``), which every
    consumer reads as a zero slot."""

    rule_neuron: torch.Tensor   # (n,)  int32
    consume: torch.Tensor       # (n,)  int32
    produce: torch.Tensor       # (n,)  int32
    regex_base: torch.Tensor    # (n,)  int32
    regex_period: torch.Tensor  # (n,)  int32
    covering: torch.Tensor      # (n,)  bool
    env_produce: torch.Tensor   # (n,)  int32
    init_config: torch.Tensor   # (m,)  int32
    out_neuron: torch.Tensor    # ()    int32 — output neuron, or m if none
    rule_order: Tuple[int, ...]
    seg_start: torch.Tensor     # (m,)  int32 — first rule of each neuron
    seg_count: torch.Tensor     # (m,)  int32 — rules owned by each neuron
    rule_slots: torch.Tensor    # (R,)  int32 == arange(R)
    ell_col: torch.Tensor       # (n, K) int32 — target neuron, pad m
    ell_val: torch.Tensor       # (n, K) int32 — value, pad 0
    ell_nnz: torch.Tensor       # (n,)  int32 — real row lengths
    in_idx: torch.Tensor        # (m, Kin) int32 — in-neighbours, pad m
    coo_src: torch.Tensor       # (Ec,) int32 — tail in-neighbour
    # The tail is sorted by (target, source), so each hub's entries are
    # one contiguous run: hub h owns coo_bounds[h]:coo_bounds[h+1], and
    # hub_slot maps a neuron to its hub or to Hn (none).  The reference's
    # per-entry target coo_dst is not carried: these two hold it.  None
    # only on a hand-built encoding, which the sparse backends refuse
    # (check_coo_metadata).
    coo_bounds: Optional[torch.Tensor] = None  # (Hn+1,) int32
    hub_slot: Optional[torch.Tensor] = None    # (m,) int32
    # The delayed tier's per-rule delay (None under no_delays).  A
    # reopening neuron's pending spikes ride the same in-adjacency as the
    # fired produce, so no other array is needed.
    delay: Optional[torch.Tensor] = None       # (n,) int32
    # What the sliced-list kernel (B2, B3, B5) reads in place of in_idx and
    # hub_slot (not reference fields): the ELL part in slices of 32
    # neurons (sliced_in_lists), built for every encoding, and for a
    # hybrid one each hub's neuron, the inverse of hub_slot (hub_neurons).
    # None only on a hand-built encoding, which the kernel then refuses.
    sell_start: Optional[torch.Tensor] = None  # (ceil(m/32)+1,) int32
    sell_src: Optional[torch.Tensor] = None    # (E,) int32, pad m
    hub_neuron: Optional[torch.Tensor] = None  # (Hn,) int32

    @property
    def num_rules(self) -> int:
        return self.rule_neuron.shape[0]

    @property
    def num_neurons(self) -> int:
        return self.seg_start.shape[0]

    @property
    def state_width(self) -> int:
        """Columns of one state row: ``m``, or ``3m`` under delays."""
        return self.init_config.shape[0]

    @property
    def max_nnz_per_rule(self) -> int:
        return self.ell_col.shape[1]

    @property
    def max_rules_per_neuron(self) -> int:
        return self.rule_slots.shape[0]

    @property
    def max_in_degree(self) -> int:
        return self.in_idx.shape[1]

    @property
    def is_hybrid(self) -> bool:
        """True when the in-adjacency carries a COO tail."""
        return self.coo_src.shape[0] > 0

    @property
    def device(self) -> torch.device:
        return self.in_idx.device

    def to(self, device: torch.device) -> "CompiledSparseSNP":
        """The same encoding on ``device`` (``self`` when already there)."""
        return _to_device(self, device)


CompiledAny = Union[CompiledSNP, CompiledSparseSNP]


def check_coo_metadata(comp: CompiledSparseSNP, who: str) -> None:
    """Raise unless a hybrid encoding carries the COO tail's per-hub runs
    (``coo_bounds``/``hub_slot``) that the sparse step reads."""
    if comp.is_hybrid and (comp.coo_bounds is None or comp.hub_slot is None):
        raise ValueError(
            f"{who}: this hybrid ELL+COO encoding lacks the COO segment "
            "metadata (coo_bounds/hub_slot) the step's tail stage reads; "
            "lower the system through compile_system_sparse / "
            "backend.compile")


def check_sliced_lists(comp: CompiledSparseSNP, who: str) -> None:
    """Raise unless ``comp`` carries the sliced in-lists (``sell_start``/
    ``sell_src``) and, when hybrid, the hub neurons (``hub_neuron``) that
    the sliced-list kernel walks."""
    if comp.sell_start is None or comp.sell_src is None or (
            comp.is_hybrid and comp.hub_neuron is None):
        raise ValueError(
            f"{who}: this encoding lacks the sliced in-lists "
            "(sell_start/sell_src/hub_neuron) the sliced-list kernel walks; "
            "lower the system through compile_system_sparse or "
            "convert.compiled_from_arrays")


def sliced_in_lists(in_idx: np.ndarray, pad: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The rows of ``in_idx`` (m, Kin) (padding ``pad``, by default ``m``;
    a shard's zero slot ``mloc + S·Hmax``) in slices of 32 neurons, stored
    column by column: ``(sell_start (ceil(m/32)+1,), sell_src (E,))``
    int32, entry ``k`` of neuron ``32s + l`` at ``sell_start[s] + 32k +
    l``.  Slice ``s`` is as wide as its longest row (up to its last entry
    that is not ``pad``); shorter rows and the lanes past ``m`` are padded
    with ``pad``, and each row keeps its order."""
    in_idx = np.asarray(in_idx)
    m, kin = in_idx.shape
    pad = m if pad is None else pad
    n_slices = -(-m // 32)
    rows = np.full((n_slices * 32, kin), pad, np.int32)
    rows[:m] = in_idx
    length = ((rows != pad) * np.arange(1, kin + 1)).max(1)
    width = length.reshape(n_slices, 32).max(1)
    start = np.zeros((n_slices + 1,), np.int32)
    np.cumsum(32 * width, out=start[1:])
    pos = _ragged_arange(32 * width)
    neuron = 32 * np.repeat(np.arange(n_slices), 32 * width) + pos % 32
    return start, rows[neuron, pos // 32]


def shard_sliced_lists(in_idx: np.ndarray, pad: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Each shard's :func:`sliced_in_lists` of its extended-space
    ``in_idx`` (S, mloc, Kin), padded with the zero slot ``pad``, stacked:
    ``(sell_start (S, ceil(mloc/32)+1), sell_src (S, Emax))`` int32, each
    shard's ``sell_src`` padded with ``pad`` past its end to the longest
    shard's (at least 1)."""
    lists = [sliced_in_lists(x, pad) for x in np.asarray(in_idx)]
    width = max(1, max(src.size for _, src in lists))
    src = np.full((len(lists), width), pad, np.int32)
    for d, (_, x) in enumerate(lists):
        src[d, :x.size] = x
    return np.stack([st for st, _ in lists]), src


def hub_neurons(hub_slot: np.ndarray, num_hubs: int) -> np.ndarray:
    """``(Hn,)`` int32: the neuron of each hub, the inverse of
    ``hub_slot`` (``num_hubs`` = ``Hn`` marks a neuron that is no hub)."""
    hub_slot = np.asarray(hub_slot)
    out = np.zeros((num_hubs,), np.int32)
    hubs = np.flatnonzero(hub_slot < num_hubs)
    out[hub_slot[hubs]] = hubs
    return out


def is_compiled(obj) -> bool:
    """True for either compiled encoding."""
    return isinstance(obj, (CompiledSNP, CompiledSparseSNP))


def is_delayed(comp) -> bool:
    """True when ``comp`` was compiled under the delayed tier (its
    ``delay`` is set and its state rows are ``3m`` wide)."""
    return getattr(comp, "delay", None) is not None


def in_neighbours(src: np.ndarray, dst: np.ndarray, m: int) -> np.ndarray:
    """``(m, Kin)`` int32: the sources of the synapses into each neuron,
    ascending, padded with ``m``; ``Kin`` = max in-degree (at least 1)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    in_deg = np.bincount(dst, minlength=m)
    kin = int(max(in_deg.max() if in_deg.size else 0, 1))
    o = np.lexsort((src, dst))
    out = np.full((m, kin), m, dtype=np.int32)
    out[dst[o], _ragged_arange(in_deg)] = src[o]
    return out


def column_lists(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The nonzeros of a 2-D ``mat`` (r, c) by column, on its device:
    ``(col_start (c+1,), col_row (nnz,), col_val (nnz,))`` int32, column
    ``j``'s entries being rows ``col_row[col_start[j]:col_start[j+1]]``,
    ascending, with values ``col_val`` (``mat``'s, as int32).  One host
    read (the count of nonzeros)."""
    cols, rows = (mat.T != 0).nonzero(as_tuple=True)   # column-major
    start = torch.zeros((mat.shape[1] + 1,), dtype=torch.int32,
                        device=mat.device)
    start[1:] = torch.cumsum(torch.bincount(cols, minlength=mat.shape[1]),
                             0)
    return (start, rows.to(torch.int32),
            mat[rows, cols].to(torch.int32))


def dense_column_lists(M: torch.Tensor, env: torch.Tensor):
    """The dense step's lists ``(col_start (m+2,), col_rule, col_val)``:
    :func:`column_lists` of ``[M | env]``, env being column ``m``."""
    return column_lists(torch.cat([M, env[:, None].to(M.dtype)], 1))


def shard_column_lists(M_local: torch.Tensor, hadj: torch.Tensor):
    """One shard's lists for B6 ``(col_start, col_rule, col_val,
    hcol_start, hcol_slot)``: :func:`column_lists` of ``M_local`` (nloc,
    mloc), then the halo slots of ``hadj`` (H, mloc)'s nonzeros by column
    (hadj enters as its nonzero pattern, as in the plain step)."""
    return column_lists(M_local) + column_lists(hadj)[:2]


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """``concatenate([arange(c) for c in counts])`` without the Python loop."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0,), np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total) - np.repeat(starts, counts)


class _Lowered(NamedTuple):
    """Neuron-sorted rule arrays and the synapse adjacency, all numpy."""

    order: Tuple[int, ...]
    rules: List[Rule]
    neuron: np.ndarray        # (n,) i32
    consume: np.ndarray       # (n,) i32
    produce: np.ndarray       # (n,) i32
    regex_base: np.ndarray
    regex_period: np.ndarray
    covering: np.ndarray      # (n,) bool
    env_produce: np.ndarray   # (n,) i32
    src: np.ndarray           # (E,) i32 — synapse sources, sorted (src, dst)
    dst: np.ndarray           # (E,) i32
    out_deg: np.ndarray       # (m,) i64
    out_start: np.ndarray     # (m,) i64 — CSR row starts into src/dst


def _lower(system: SNPSystem) -> _Lowered:
    m, n = system.num_neurons, system.num_rules
    if n == 0:
        raise ValueError("system has no rules")
    # Stable sort rules by neuron, remembering the original total order so
    # spiking vectors can be reported in the paper's ordering.
    neuron0 = np.fromiter((r.neuron for r in system.rules), np.int64, n)
    order = np.argsort(neuron0, kind="stable")
    rules = [system.rules[i] for i in order]
    neuron = neuron0[order].astype(np.int32)
    produce = np.fromiter((r.produce for r in rules), np.int32, n)
    syn = np.asarray(system.synapses, np.int64).reshape(-1, 2)
    o = np.lexsort((syn[:, 1], syn[:, 0]))
    src, dst = syn[o, 0], syn[o, 1]
    out_deg = np.bincount(src, minlength=m)
    return _Lowered(
        order=tuple(int(i) for i in order), rules=rules, neuron=neuron,
        consume=np.fromiter((r.consume for r in rules), np.int32, n),
        produce=produce,
        regex_base=np.fromiter((r.regex_base for r in rules), np.int32, n),
        regex_period=np.fromiter((r.regex_period for r in rules), np.int32,
                                 n),
        covering=np.fromiter((r.covering for r in rules), bool, n),
        env_produce=np.where(neuron == system.output_neuron, produce, 0)
        .astype(np.int32),
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        out_deg=out_deg, out_start=np.cumsum(out_deg) - out_deg)


def _rule_row_entries(low: _Lowered):
    """Flat ``(rows, pos, cols, vals, prod_rules, deg_r)`` of the produce
    entries of ``M_Π``: rule ``i`` with ``produce > 0`` writes ``produce``
    into every out-neighbour column of its neuron, ``pos`` being the slot
    within the row.  The consume entry is each caller's own."""
    prod_rules = np.nonzero(low.produce > 0)[0]
    deg_r = low.out_deg[low.neuron[prod_rules]]
    rows = np.repeat(prod_rules, deg_r)
    pos = _ragged_arange(deg_r)
    flat = np.repeat(low.out_start[low.neuron[prod_rules]], deg_r) + pos
    cols = low.dst[flat] if rows.size else np.zeros((0,), np.int32)
    vals = np.repeat(low.produce[prod_rules], deg_r)
    return rows.astype(np.int64), pos, cols, vals.astype(np.int32), \
        prod_rules, deg_r


def _tensors(dev: torch.device, **arrays):
    # (np.ascontiguousarray would turn the 0-d out_neuron into shape (1,))
    return {k: torch.from_numpy(a if a.flags.c_contiguous
                                else np.ascontiguousarray(a)).to(dev)
            for k, a in arrays.items()}


def _delay_vector(low: _Lowered) -> np.ndarray:
    return np.fromiter((r.delay for r in low.rules), np.int32,
                       len(low.rules))


def _init(system: SNPSystem, delayed: bool) -> np.ndarray:
    """``C_0``, or under delays ``[spikes | 0 | 0]``: every neuron open,
    nothing pending."""
    spikes = np.asarray(system.initial_spikes, np.int32)
    if not delayed:
        return spikes
    return np.concatenate([spikes, np.zeros(2 * spikes.shape[0], np.int32)])


def _out_neuron(system: SNPSystem) -> np.ndarray:
    m = system.num_neurons
    return np.asarray(system.output_neuron if system.output_neuron >= 0
                      else m, np.int32)


def compile_system(system: SNPSystem, *, semantics: str = "no_delays",
                   device: DeviceLike = None) -> CompiledSNP:
    """Dense lowering (paper eq. 1) onto ``device`` (``None`` = the card).
    ``semantics="delays"`` adds the delay fields and the ``3m`` initial
    state (module docstring)."""
    delayed = _check_semantics(system, semantics)
    dev = resolve_device(device)
    low = _lower(system)
    n, m = low.neuron.shape[0], system.num_neurons
    M = np.zeros((n, m), dtype=np.int32)
    M[np.arange(n), low.neuron] = -low.consume
    rows, _, cols, vals, _, _ = _rule_row_entries(low)
    M[rows, cols] = vals  # no collisions: self-synapses are forbidden
    extra = {}
    if delayed:
        adj = np.zeros((m, m), np.int32)
        adj[low.src, low.dst] = 1
        adj_in = in_neighbours(low.src, low.dst, m)
        extra = dict(delay=_delay_vector(low), adjacency=adj,
                     out_neuron=_out_neuron(system), adj_in=adj_in)
        extra.update(zip(("sell_start", "sell_src"),
                         sliced_in_lists(adj_in)))
    else:
        lists = dense_column_lists(torch.from_numpy(M),
                                   torch.from_numpy(low.env_produce))
        extra = dict(zip(("col_start", "col_rule", "col_val"),
                         (x.numpy() for x in lists)))
    return CompiledSNP(rule_order=low.order, **_tensors(
        dev, M=M, rule_neuron=low.neuron, consume=low.consume,
        produce=low.produce, regex_base=low.regex_base,
        regex_period=low.regex_period, covering=low.covering,
        env_produce=low.env_produce, init_config=_init(system, delayed),
        **extra))


def compile_system_sparse(system: SNPSystem, *,
                          hub_threshold: Optional[int] = None,
                          semantics: str = "no_delays",
                          device: DeviceLike = None) -> CompiledSparseSNP:
    """Sparse lowering onto ``device`` (``None`` = the card): ELL rows of
    ``M_Π``, per-neuron segments and the ELL in-adjacency, in
    ``O(n·K + m·Kin)`` memory with measured widths.

    ``hub_threshold=H`` selects the hybrid in-adjacency: ELL rows hold at
    most ``H`` in-neighbours and every further in-synapse of a hub lands in
    the COO tail, sorted by ``(dst, src)``, with its per-hub run offsets
    ``coo_bounds`` and the neuron→hub map ``hub_slot``, and the port's
    own ``hub_neuron`` that the sliced-list kernel reads.  ``None`` is
    pure ELL (an empty tail).  Either way the encoding carries the port's
    ``sell_start``/``sell_src`` (:func:`sliced_in_lists` of ``in_idx``).
    ``semantics="delays"`` adds the per-rule ``delay`` and the ``3m``
    initial state."""
    delayed = _check_semantics(system, semantics)
    dev = resolve_device(device)
    low = _lower(system)
    m, n = system.num_neurons, low.neuron.shape[0]
    # A fired rule is packed as produce | consume << 16 (one gather per
    # branch and neuron), which needs these bounds.
    if int(low.produce.max(initial=0)) >= 1 << 16 \
            or int(low.consume.max(initial=0)) >= 1 << 15:
        raise ValueError("sparse encoding requires produce < 2^16 and "
                         "consume < 2^15 per rule")
    if hub_threshold is not None and hub_threshold < 1:
        raise ValueError(f"hub_threshold must be >= 1, got {hub_threshold}")

    seg_count = np.bincount(low.neuron, minlength=m).astype(np.int32)
    seg_start = (np.cumsum(seg_count) - seg_count).astype(np.int32)
    R = int(max(seg_count.max(), 1))

    # ELL rows of M: slot 0 is the consume entry, 1.. the produce fan-out.
    rows, pos, cols, vals, prod_rules, deg_r = _rule_row_entries(low)
    K = int(1 + (deg_r.max() if deg_r.size else 0))
    ell_col = np.full((n, K), m, dtype=np.int32)
    ell_val = np.zeros((n, K), dtype=np.int32)
    ell_col[:, 0] = low.neuron
    ell_val[:, 0] = -low.consume
    ell_col[rows, 1 + pos] = cols
    ell_val[rows, 1 + pos] = vals
    ell_nnz = np.ones((n,), np.int32)
    ell_nnz[prod_rules] += deg_r.astype(np.int32)

    # In-adjacency sorted by (target, source); slots past the threshold
    # spill to the COO tail, still in (target, source) order.
    in_deg = np.bincount(low.dst, minlength=m)
    kin_full = int(max(in_deg.max() if in_deg.size else 0, 1))
    Kin = kin_full if hub_threshold is None else min(kin_full,
                                                    int(hub_threshold))
    o = np.lexsort((low.src, low.dst))
    slot = _ragged_arange(in_deg)
    ell_part = slot < Kin
    in_idx = np.full((m, Kin), m, dtype=np.int32)
    in_idx[low.dst[o][ell_part], slot[ell_part]] = low.src[o][ell_part]
    coo_src = low.src[o][~ell_part].astype(np.int32)
    hubs, hub_counts = np.unique(low.dst[o][~ell_part], return_counts=True)
    hn = hubs.shape[0]
    coo_bounds = np.zeros((hn + 1,), np.int32)
    np.cumsum(hub_counts, out=coo_bounds[1:])
    hub_slot = np.full((m,), hn, np.int32)
    hub_slot[hubs] = np.arange(hn, dtype=np.int32)

    extra = dict(zip(("sell_start", "sell_src"), sliced_in_lists(in_idx)))
    if delayed:
        extra["delay"] = _delay_vector(low)
    if hn:
        extra["hub_neuron"] = hub_neurons(hub_slot, hn)
    return CompiledSparseSNP(rule_order=low.order, **_tensors(
        dev, rule_neuron=low.neuron, consume=low.consume,
        produce=low.produce, regex_base=low.regex_base,
        regex_period=low.regex_period, covering=low.covering,
        env_produce=low.env_produce, init_config=_init(system, delayed),
        out_neuron=_out_neuron(system), seg_start=seg_start,
        seg_count=seg_count, rule_slots=np.arange(R, dtype=np.int32),
        ell_col=ell_col, ell_val=ell_val, ell_nnz=ell_nnz, in_idx=in_idx,
        coo_src=coo_src, coo_bounds=coo_bounds, hub_slot=hub_slot,
        **extra))
