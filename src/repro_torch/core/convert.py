"""Carry state across from the JAX package without importing it.

* :func:`system_from_spec` rebuilds an :class:`SNPSystem` from
  ``dataclasses.asdict`` of a reference ``repro.core.system.SNPSystem``;
* :func:`compiled_from_arrays` rebuilds a :class:`CompiledSNP` or a
  :class:`CompiledSparseSNP` from the fields of a reference
  ``repro.core.matrix.CompiledSNP`` / ``CompiledSparseSNP`` given as numpy
  arrays (``{k: np.asarray(v) for k, v in comp._asdict().items()}``; the
  sparse encoding is recognised by its ``in_idx`` field), delayed
  encodings (``semantics="delays"``) included;
* :func:`sharded_from_arrays` rebuilds a :class:`~.plan.ShardedCompiled`
  from the fields of a reference ``ShardedCompiled``'s ``arrays`` (and
  optionally its ``dense`` view) as numpy arrays, plus its static ints.

The port's own fields that the reference does not carry are derived from
its matrices: the dense encoding's ``adj_in`` and its sliced lists
(delays) or column lists (no delays), a sparse encoding's sliced
in-lists (and a hybrid one's hub neurons), each shard's sliced in-lists
and the dense shard view's column lists.

All take plain Python and numpy values only, so this module never needs
JAX; the parity tests use it to feed the two packages the same state.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .matrix import (CompiledAny, CompiledSNP, CompiledSparseSNP,
                     dense_column_lists, hub_neurons, in_neighbours,
                     shard_sliced_lists, sliced_in_lists)
from .plan import (DenseShardArrays, ShardArrays, ShardedCompiled,
                   SystemPlan, dense_shard_columns)
from .system import Rule, SNPSystem

__all__ = ["system_from_spec", "compiled_from_arrays", "sharded_from_arrays"]

# Fields of the reference encodings the port does not carry: the dense
# rule→neuron one-hot (the port gathers through rule_neuron) and the COO
# tail's per-entry targets (coo_bounds/hub_slot hold them).
_DERIVED = {CompiledSNP: ("neuron_onehot",), CompiledSparseSNP: ("coo_dst",)}
# The delayed tier's fields: all set, or none.  The dense encoding's
# adj_in and its sliced lists are the port's own, derived here from
# adjacency.
_DELAY_FIELDS = {CompiledSNP: ("delay", "adjacency", "out_neuron"),
                 CompiledSparseSNP: ("delay",)}

_DTYPES = {"covering": torch.bool, "hadj": torch.int8}


def system_from_spec(spec: Mapping[str, Any]) -> SNPSystem:
    """An :class:`SNPSystem` from ``dataclasses.asdict`` of a reference
    system (validated again by the port's own ``__post_init__``)."""
    return SNPSystem(
        num_neurons=int(spec["num_neurons"]),
        initial_spikes=tuple(int(s) for s in spec["initial_spikes"]),
        rules=tuple(Rule(**{k: (bool(v) if k == "covering" else int(v))
                            for k, v in r.items()})
                    for r in spec["rules"]),
        synapses=tuple((int(i), int(j)) for i, j in spec["synapses"]),
        input_neuron=int(spec.get("input_neuron", -1)),
        output_neuron=int(spec.get("output_neuron", -1)),
        name=str(spec.get("name", "snp")),
    )


def compiled_from_arrays(fields: Mapping[str, Any],
                         device: DeviceLike = None) -> CompiledAny:
    """A :class:`CompiledSNP` or :class:`CompiledSparseSNP` on ``device``
    from a reference encoding's fields as numpy arrays (``rule_order`` may
    stay a tuple; a hand-built sparse encoding may lack ``coo_bounds`` and
    ``hub_slot``, which then stay ``None``, as does a hybrid encoding's
    ``hub_neuron``, which the sliced-list kernel needs)."""
    dev = resolve_device(device)
    cls = CompiledSparseSNP if "in_idx" in fields else CompiledSNP
    known = set(cls._fields) | set(_DERIVED[cls])
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown encoding fields {sorted(unknown)}")
    fields = dict(fields)
    if cls is CompiledSNP and fields.get("adjacency") is not None \
            and fields.get("adj_in") is None:
        adj = np.asarray(fields["adjacency"])
        src, dst = np.nonzero(adj)
        fields["adj_in"] = in_neighbours(src, dst, adj.shape[0])
    delay_set = [k for k in _DELAY_FIELDS[cls] if fields.get(k) is not None]
    if delay_set and len(delay_set) != len(_DELAY_FIELDS[cls]):
        raise ValueError(
            f"a delayed encoding needs all of {_DELAY_FIELDS[cls]}, got "
            f"only {delay_set}")
    m = np.shape(fields["M"])[1] if cls is CompiledSNP \
        else np.shape(fields["seg_start"])[0]
    width = 3 * m if delay_set else m
    if np.shape(fields["init_config"]) != (width,):
        raise ValueError(
            f"init_config has shape {np.shape(fields['init_config'])}, "
            f"expected ({width},) for a "
            f"{'delayed' if delay_set else 'delay-free'} encoding of {m} "
            "neurons")
    out = {}
    for k in cls._fields:
        v = fields.get(k)
        if k == "rule_order":
            out[k] = tuple(int(i) for i in v)
        elif v is not None:
            arr = np.array(v, copy=True)   # writable, contiguous
            out[k] = torch.from_numpy(arr).to(
                device=dev, dtype=_DTYPES.get(k, torch.int32))
    if cls is CompiledSNP and not delay_set and out.get("col_start") is None:
        out.update(zip(("col_start", "col_rule", "col_val"),
                       dense_column_lists(out["M"], out["env_produce"])))
    if cls is CompiledSNP and delay_set and out.get("sell_start") is None:
        out.update((k, torch.from_numpy(v).to(dev)) for k, v in zip(
            ("sell_start", "sell_src"), sliced_in_lists(fields["adj_in"])))
    if cls is CompiledSparseSNP and out.get("sell_start") is None:
        derived = dict(zip(("sell_start", "sell_src"),
                           sliced_in_lists(fields["in_idx"])))
        if np.size(fields["coo_src"]) and out.get("coo_bounds") is not None \
                and out.get("hub_slot") is not None:
            derived["hub_neuron"] = hub_neurons(
                fields["hub_slot"], np.size(fields["coo_bounds"]) - 1)
        out.update((k, torch.from_numpy(v).to(dev))
                   for k, v in derived.items())
    return cls(**out)


def sharded_from_arrays(arrays: Mapping[str, Any],
                        dense: Optional[Mapping[str, Any]] = None, *,
                        num_neurons: int, num_rules: int, shard_size: int,
                        num_shards: int, halo_width: int,
                        partition: str = "contiguous", occupancy=None,
                        device: DeviceLike = None) -> ShardedCompiled:
    """A :class:`~.plan.ShardedCompiled` on ``device`` from a reference
    lowering: ``arrays`` are the fields of its ``ShardArrays`` and
    ``dense`` (optional) those of its ``DenseShardArrays``, as numpy
    arrays; the keywords are its static ints and its plan's partition.
    The reference's dense ``onehot`` is accepted and not carried (B6
    reads ``rule_neuron``); each shard's sliced in-lists, which B7 walks,
    are derived from ``in_idx`` unless given."""
    dev = resolve_device(device)

    def build(cls, fields, derived=()):
        unknown = set(fields) - set(cls._fields) - set(derived)
        if unknown:
            raise ValueError(f"unknown {cls.__name__} fields "
                             f"{sorted(unknown)}")
        out = {}
        for k in cls._fields:
            if k not in fields and k in cls._field_defaults:
                continue                    # the port's own, derived below
            arr = np.array(fields[k], copy=True)     # writable, contiguous
            if k != "rule_slots" and arr.shape[:1] != (num_shards,):
                raise ValueError(
                    f"{k} has shape {arr.shape}, expected a leading shard "
                    f"axis of {num_shards}")
            out[k] = torch.from_numpy(arr).to(
                device=dev, dtype=_DTYPES.get(k, torch.int32))
        return cls(**out)

    shards = build(ShardArrays, arrays)
    if shards.sell_start is None:
        zero = int(shard_size) + int(num_shards) * int(halo_width)
        start, src = shard_sliced_lists(shards.in_idx.cpu().numpy(), zero)
        shards = shards._replace(sell_start=torch.from_numpy(start).to(dev),
                                 sell_src=torch.from_numpy(src).to(dev))
    return ShardedCompiled(
        arrays=shards,
        plan=SystemPlan(encoding="ell", num_shards=num_shards,
                        partition=partition),
        num_neurons=int(num_neurons), num_rules=int(num_rules),
        shard_size=int(shard_size), num_shards=int(num_shards),
        halo_width=int(halo_width),
        dense=None if dense is None else _with_columns(
            build(DenseShardArrays, dense, ("onehot",))),
        occupancy=None if occupancy is None else np.asarray(occupancy))


def _with_columns(dense: DenseShardArrays) -> DenseShardArrays:
    """``dense`` with its column lists, derived when they were not given."""
    if dense.col_start is not None:
        return dense
    return dense._replace(**dense_shard_columns(dense.M_local, dense.hadj))
