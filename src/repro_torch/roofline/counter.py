"""The step counter: FLOPs, HBM bytes, collective traffic and live memory
of the per-device program of one eager step.

The counterpart of the JAX package's ``roofline/hlo_analyzer.py``, which
parses the optimized HLO text of a compiled step.  Torch has no HLO text
to parse: an eager step is a stream of ATen operations, so
:class:`StepCounter` is one ``TorchDispatchMode`` that sees each of them
as it runs (on the card, or on the dry run's fake tensors) and keeps one
record a kind of operation (op, local shape, dtype: calls, FLOPs,
bytes), the HLO analyzer's per-instruction costs:

* **FLOPs** of matmul-like operations only, by the formulas of
  ``torch.utils.flop_counter`` (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the convolutions and the attention kernels, B8 through
  the formula its custom operator registers); elementwise operations
  count none, as the reference's dots-only rule counts none.  An
  operation on DTensors is seen at its global shapes (a dispatch mode
  sits above DTensor's own dispatch and never sees its local
  operations), so its count is divided by the size of every mesh dim
  along which its output is ``Shard`` or ``Partial``: the share of the
  one device.  Replicated work counts whole on every device.
  Recomputation under ``torch.utils.checkpoint`` runs through the mode,
  so it is counted, as XLA's remat duplicates are.
* **Bytes** by ``hlo_analyzer.py``'s model on local shapes: views and
  metadata count 0, slices and gathers 2× their output, updates and
  scatters 2× the update, every other operation its tensor inputs plus
  its outputs.
* **Collectives**: the ``_c10d_functional`` operations DTensor issues
  and the ``c10d`` ones of ``torch.distributed``, at their local sizes,
  the group's size and ranks read from the operation's group.  Per-device
  link bytes by the reference's ring factors (all-reduce ``2·s·(g−1)/g``;
  all-gather, reduce-scatter and all-to-all ``s·(g−1)/g``; a permute, an
  all-to-all with one destination, ``s``), each on the link class of its
  group (:func:`link_class`: NVLink inside an 8-card node, InfiniBand
  across nodes).  The size ``s`` is the output for an all-gather, the
  larger of input and output otherwise.
* **Memory**: the bytes of the tensors the step allocates and still
  holds, and their peak (a live-bytes count: each non-view output is
  counted until its tensor is freed).

The HLO analyzer's ``num_whiles``, ``max_trip_count`` and XLA's own
``cost_analysis`` aggregates (``xla_*``) have no eager counterpart: a
Python loop is unrolled into the operations it runs, so the counter
sees every trip, and there is no compiler estimate to keep beside it.

On fake or meta tensors a data-dependent read (``bool(t)``, a probe
loop's predicate) has no value: the counter answers boolean reads
``True`` and ``False`` in turn, so a loop whose predicate reads the data
once a trip runs one trip, as the reference's analyzer counts a
``while`` of unknown trip count once (``default_trip=1``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels.real import is_fake

__all__ = ["StepCounter", "OpRecord", "link_class", "wire_bytes",
           "COLLECTIVES", "NODE_SIZE"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: cards a node (an H100 SXM node: 8 cards on one NVLink switch)
NODE_SIZE = 8

_aten = torch.ops.aten

# metadata and aliasing: no data moves (the HLO analyzer's
# _ZERO_BYTE_OPS and its bitcasts; in eager torch every view)
_ZERO = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "as_strided", "alias",
    "detach", "lift_fresh", "unflatten", "flatten", "view_as",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_reshape_alias", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "dim",
    "_local_scalar_dense", "wait_tensor", "set_", "resize_",
})
# the traffic is the slice read and written, not the operand
_SLICE = frozenset({
    "slice", "select", "narrow", "index_select", "gather", "index",
    "embedding", "split", "split_with_sizes", "unbind", "chunk",
    "tensor_split", "take", "diagonal",
})
# the traffic is the update read and written: (op -> its update's arg)
_UPDATE = {
    "copy_": 1, "copy": 1, "index_put": 2, "index_put_": 2,
    "_index_put_impl_": 2, "scatter": 3, "scatter_": 3, "scatter_add": 3,
    "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
    "index_add": 3, "index_add_": 3, "index_copy": 3, "index_copy_": 3,
    "slice_scatter": 1, "select_scatter": 1, "masked_scatter": 2,
    "masked_scatter_": 2,
}
# collective -> kind, by the functional and the c10d names
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "all-gather", "broadcast_": "all-gather",
}
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "all-gather",
}


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """The tensor one device holds: a DTensor's local shard."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def wire_bytes(kind: str, size: float, group: int) -> float:
    """Per-device link bytes of one collective of ``size`` bytes over a
    group of ``group`` ranks: the reference's ring factors
    (``hlo_analyzer.py``)."""
    g = max(int(group), 1)
    if kind == "all-reduce":
        return 2 * size * (g - 1) / g
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return size * (g - 1) / g
    return float(size)                           # collective-permute


def link_class(ranks) -> str:
    """``"nvlink"`` when every rank of the group sits on one node of
    :data:`NODE_SIZE` cards (ranks ``8k .. 8k+7``), else ``"ib"``."""
    return "nvlink" if len({int(r) // NODE_SIZE for r in ranks}) <= 1 \
        else "ib"


@dataclasses.dataclass
class OpRecord:
    """The operations of one kind (op, local shape, dtype): calls, FLOPs
    and bytes summed over them."""
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


def _group_of(func, args, kwargs):
    """(size, ranks) of a collective's group: the functional ops name it
    by ``group_name``, the c10d ops pass the process group object."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = kwargs.get("group_name")
    pg = None
    if name is None:
        for a in args:
            if isinstance(a, str):
                name = a
            elif isinstance(a, torch.ScriptObject) and \
                    "ProcessGroup" in str(a._type()):  # c10d's ops
                pg = dist.ProcessGroup.unbox(a)
            elif isinstance(a, dist.ProcessGroup):
                pg = a
    if pg is None and name is not None:
        pg = _resolve_process_group(name)
    if pg is None:
        return 1, [0]
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), ranks


class StepCounter(TorchDispatchMode):
    """Counts the operations that run under it (module docstring).
    ``with StepCounter() as c: step(...)``; then ``c.flops``,
    ``c.flops_by_dtype``, ``c.bytes``, ``c.details`` (one ``(kind,
    bytes, group size, link class)`` a collective), ``c.peak_bytes`` and
    ``c.records``."""

    def __init__(self):
        super().__init__()
        self.records: Dict[Tuple[str, str, str], OpRecord] = \
            collections.defaultdict(OpRecord)
        self.flops_by_dtype: Dict[str, float] = collections.defaultdict(
            float)
        self.bytes = 0.0
        # (kind, bytes, group size, link class) per collective
        self.details: List[Tuple[str, float, int, str]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0
        self._reads = 0

    # -- totals ------------------------------------------------------------

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    # -- explicit records ----------------------------------------------------

    @contextlib.contextmanager
    def paused(self):
        """A block in which nothing is counted (an in-process exchange
        that stands for one collective, recorded by :meth:`collective`)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def collective(self, kind: str, size: float, ranks) -> None:
        """Record one collective of ``kind`` moving ``size`` bytes a device
        over the group of ``ranks``."""
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        ranks = list(ranks)
        self.details.append((kind, float(size), len(ranks),
                             link_class(ranks)))

    def scaled(self, factor: float) -> None:
        """Scale FLOPs, bytes, the peak and records by ``factor`` (one
        rank's share of work run for several in one process); collectives
        stay."""
        for d in self.flops_by_dtype:
            self.flops_by_dtype[d] *= factor
        self.bytes *= factor
        self.peak_bytes = int(self.peak_bytes * factor)
        for r in self.records.values():
            r.flops *= factor
            r.bytes *= factor

    # -- the mode ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten._local_scalar_dense.default:
            x = args[0]
            if is_fake(_local(x)) and x.dtype == torch.bool:
                self._reads += 1
                return self._reads % 2 == 1
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "prim":                 # metadata (``prim.device``)
            return
        if ns in ("_c10d_functional", "c10d"):
            kind = (_FUNCTIONAL if ns == "_c10d_functional"
                    else _C10D).get(name)
            if kind is not None:
                self._collective(kind, func, args, kwargs, out)
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not outs and not ins:
            return
        dt = [x for x in ins + outs if isinstance(x, DTensor)]
        flops = 0.0
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            if dt and outs and isinstance(outs[0], DTensor):
                o = outs[0]
                for i, p in enumerate(o.placements):
                    if p.is_shard() or p.is_partial():
                        flops /= o.device_mesh.size(i)
        lins = [_local(x) for x in ins]
        louts = [_local(x) for x in outs]
        if name in _SLICE:
            nbytes = 2.0 * sum(_bytes(t) for t in louts)
        elif name in _ZERO or func.is_view:
            nbytes = 0.0
        elif name in _UPDATE:
            i = _UPDATE[name]
            upd = args[i] if len(args) > i else None
            upd = _local(upd) if isinstance(upd, torch.Tensor) else None
            nbytes = 2.0 * (_bytes(upd) if upd is not None else
                            sum(_bytes(t) for t in louts))
        else:
            nbytes = float(sum(_bytes(t) for t in lins)
                           + sum(_bytes(t) for t in louts))
        ref = (louts or lins)[0]
        dtype = str(lins[0].dtype if lins else ref.dtype).replace(
            "torch.", "")
        key = (name, "x".join(map(str, ref.shape)) or "scalar", dtype)
        rec = self.records[key]
        rec.calls += 1
        rec.flops += flops
        rec.bytes += nbytes
        if flops:
            self.flops_by_dtype[dtype] += flops
        self.bytes += nbytes
        if not func.is_view:
            self._track(outs, ins)

    def _track(self, outs, ins) -> None:
        """Count each new output until its tensor is freed."""
        held = {id(x) for x in ins}
        for o in outs:
            if id(o) in held:            # an in-place op's own argument
                continue
            t = _local(o)
            n = _bytes(t)
            if not n:
                continue
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _collective(self, kind, func, args, kwargs, out) -> None:
        ins = [_local(x) for x in _tensors((args, kwargs))]
        outs = [_local(x) for x in _tensors(out)]
        g, ranks = _group_of(func, args, kwargs)
        out_b = sum(_bytes(t) for t in outs)
        in_b = sum(_bytes(t) for t in ins)
        size = out_b if kind == "all-gather" else max(out_b, in_b)
        if func.overloadpacket.__name__ == "all_to_all_single":
            # what leaves the device is its input (a fake output's shape
            # follows the split sizes, which need not be rows)
            size = in_b
            splits = args[2] if len(args) > 2 else kwargs.get(
                "input_split_sizes")
            if splits and sum(1 for s in splits if s) == 1:
                kind = "collective-permute"      # one destination
        self.details.append((kind, float(size), g, link_class(ranks)))
        if out is not None and not func.overloadpacket.__name__.endswith(
                "_"):
            self._track([x for x in _tensors(out)], _tensors((args,
                                                                kwargs)))
