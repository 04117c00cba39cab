"""Dense matrix encoding of an SNP system (paper §2.2) as torch tensors.

The port of ``repro.core.matrix``'s dense lowering: rules are **sorted by
owning neuron** (stable), ``M_Π`` is built by vectorized numpy adjacency
indexing, and the arrays move to the requested device once.  Only the
paper's delay-free semantics is ported: a system with a delayed rule
raises, as the reference does under ``semantics="no_delays"``.

The reference's ``neuron_onehot`` (the ``(n, m)`` rule→neuron incidence)
is not carried: on the TPU it turned the per-rule gather into a matmul,
while the port gathers through ``rule_neuron`` directly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .system import SNPSystem

__all__ = ["CompiledSNP", "compile_system", "is_compiled"]


class CompiledSNP(NamedTuple):
    """Dense encoding of an SNP system.  Shapes: ``m`` neurons, ``n`` rules
    (sorted by neuron); every tensor lives on one device."""

    M: torch.Tensor             # (n, m) int32 — spiking transition matrix
    rule_neuron: torch.Tensor   # (n,)  int32 — owning neuron of each rule
    consume: torch.Tensor       # (n,)  int32
    produce: torch.Tensor       # (n,)  int32
    regex_base: torch.Tensor    # (n,)  int32
    regex_period: torch.Tensor  # (n,)  int32 (0 => single word)
    covering: torch.Tensor      # (n,)  bool
    env_produce: torch.Tensor   # (n,)  int32 — spikes emitted to environment
    init_config: torch.Tensor   # (m,)  int32 — C_0
    rule_order: Tuple[int, ...]  # original rule index per sorted position

    @property
    def num_rules(self) -> int:
        return self.M.shape[0]

    @property
    def num_neurons(self) -> int:
        return self.M.shape[1]

    @property
    def device(self) -> torch.device:
        return self.M.device

    def to(self, device: torch.device) -> "CompiledSNP":
        """The same encoding on ``device`` (``self`` when already there)."""
        if self.M.device == torch.device(device):
            return self
        return CompiledSNP(*(x.to(device) if isinstance(x, torch.Tensor)
                             else x for x in self))


def is_compiled(obj) -> bool:
    return isinstance(obj, CompiledSNP)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """``concatenate([arange(c) for c in counts])`` without the Python loop."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0,), np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total) - np.repeat(starts, counts)


def compile_system(system: SNPSystem, *,
                   device: DeviceLike = None) -> CompiledSNP:
    """Dense lowering (paper eq. 1) onto ``device`` (``None`` = the card)."""
    if system.max_delay > 0:
        raise ValueError(
            f"system {system.name!r} has rules with delay > 0; the port "
            "runs only the paper's delay-free semantics (the delayed tier "
            "is not ported yet)")
    dev = resolve_device(device)
    m, n = system.num_neurons, system.num_rules
    if n == 0:
        raise ValueError("system has no rules")

    # Stable sort rules by neuron, remembering the original total order so
    # spiking vectors can be reported in the paper's ordering.
    neuron0 = np.fromiter((r.neuron for r in system.rules), np.int64, n)
    order = np.argsort(neuron0, kind="stable")
    rules = [system.rules[i] for i in order]
    neuron = neuron0[order].astype(np.int32)
    consume = np.fromiter((r.consume for r in rules), np.int32, n)
    produce = np.fromiter((r.produce for r in rules), np.int32, n)
    regex_base = np.fromiter((r.regex_base for r in rules), np.int32, n)
    regex_period = np.fromiter((r.regex_period for r in rules), np.int32, n)
    covering = np.fromiter((r.covering for r in rules), bool, n)
    env_produce = np.where(neuron == system.output_neuron, produce, 0) \
        .astype(np.int32)

    # CSR view of the synapses, sorted by (src, dst).
    syn = np.asarray(system.synapses, np.int64).reshape(-1, 2)
    o = np.lexsort((syn[:, 1], syn[:, 0]))
    dst = syn[o, 1]
    out_deg = np.bincount(syn[o, 0], minlength=m)
    out_start = np.cumsum(out_deg) - out_deg

    # Rule i consumes at its own neuron and, if it produces, writes its
    # produce into every out-neighbour column of that neuron.
    M = np.zeros((n, m), dtype=np.int32)
    M[np.arange(n), neuron] = -consume
    prod_rules = np.nonzero(produce > 0)[0]
    deg_r = out_deg[neuron[prod_rules]]
    rows = np.repeat(prod_rules, deg_r)
    flat = np.repeat(out_start[neuron[prod_rules]], deg_r) \
        + _ragged_arange(deg_r)
    M[rows, dst[flat]] = np.repeat(produce[prod_rules], deg_r)  # no self-synapses

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return CompiledSNP(
        M=t(M), rule_neuron=t(neuron), consume=t(consume),
        produce=t(produce), regex_base=t(regex_base),
        regex_period=t(regex_period), covering=t(covering),
        env_produce=t(env_produce),
        init_config=t(np.asarray(system.initial_spikes, np.int32)),
        rule_order=tuple(int(i) for i in order),
    )
