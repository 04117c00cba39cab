"""Carry state across from the JAX package without importing it.

* :func:`system_from_spec` rebuilds an :class:`SNPSystem` from
  ``dataclasses.asdict`` of a reference ``repro.core.system.SNPSystem``;
* :func:`compiled_from_arrays` rebuilds a :class:`CompiledSNP` from the
  fields of a reference ``repro.core.matrix.CompiledSNP`` given as numpy
  arrays (``{k: np.asarray(v) for k, v in comp._asdict().items()}``).

Both take plain Python and numpy values only, so this module never needs
JAX; the parity tests use it to feed the two packages the same state.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .matrix import CompiledSNP
from .system import Rule, SNPSystem

__all__ = ["system_from_spec", "compiled_from_arrays"]

# Fields of the reference encoding the port does not carry: the rule→neuron
# one-hot (the port gathers through rule_neuron) and the delayed tier's
# extension, which must be absent (None) since delays are not ported.
_DERIVED = ("neuron_onehot",)
_DELAY_FIELDS = ("delay", "adjacency", "out_neuron")

_DTYPES = {"covering": torch.bool}


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
                         device: DeviceLike = None) -> CompiledSNP:
    """A :class:`CompiledSNP` on ``device`` from a reference encoding's
    fields as numpy arrays (``rule_order`` may stay a tuple)."""
    dev = resolve_device(device)
    for k in _DELAY_FIELDS:
        if fields.get(k) is not None:
            raise ValueError(
                f"field {k!r} is set: a delayed encoding cannot be carried "
                "across (the delayed tier is not ported yet)")
    known = set(CompiledSNP._fields) | set(_DERIVED) | set(_DELAY_FIELDS)
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown encoding fields {sorted(unknown)}")
    out = {}
    for k in CompiledSNP._fields:
        if k == "rule_order":
            out[k] = tuple(int(i) for i in fields[k])
            continue
        dtype = _DTYPES.get(k, torch.int32)
        arr = np.array(fields[k], copy=True)   # writable, contiguous
        out[k] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    return CompiledSNP(**out)
