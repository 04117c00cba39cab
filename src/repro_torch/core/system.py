"""Definitions of Spiking Neural P systems (without delays).

This module is the *specification* layer: plain-Python dataclasses describing
an SNP system exactly as in Definition 1 of the paper (Cabarle, Adorna,
Martínez-del-Amor 2011).  It is a faithful copy of ``repro.core.system``
(validation included): the JAX package cannot be imported without JAX, so
the port keeps its own.  The tensor layer lives in
:mod:`repro_torch.core.matrix` and :mod:`repro_torch.core.semantics`.

Rule regular expressions.  Every regular language over the unary alphabet
``{a}`` is a finite union of arithmetic progressions; a single rule here
carries one progression ``L(E) = { base + t * period : t >= 0 }`` (with
``period = 0`` meaning the single word ``a^base``).  Unions are expressed by
giving a neuron several rules with identical action.  Two membership modes
are supported (see DESIGN.md §1.1):

* ``exact``    — standard SNP semantics: applicable iff ``spikes ∈ L(E)``.
* ``covering`` — the paper's implemented (b-3) semantics: applicable iff
  ``spikes >= base`` (and, for ``period > 0``, the progression also matches
  some value ``<= spikes``; with ``period == 0`` it is a plain threshold).
  The paper's printed trace of Π requires this mode (DESIGN.md §1.2).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

__all__ = ["Rule", "SNPSystem", "paper_pi"]


@dataclass(frozen=True)
class Rule:
    """One rule ``E / a^consume -> a^produce`` owned by ``neuron``.

    ``produce == 0`` encodes a forgetting rule ``a^s -> λ`` (with
    ``consume = s``).  ``regex_base``/``regex_period`` encode ``E`` as the
    arithmetic progression ``{base + t*period}``; ``covering`` selects the
    membership mode (see module docstring).

    ``delay`` is the rule's firing delay ``d`` from the general SNP
    definition (arXiv 1212.2529): firing closes the owning neuron for ``d``
    steps and its spikes land when it reopens.  The paper's matrix
    formalism requires ``d == 0``: a system with ``delay > 0`` compiles
    only under ``SystemPlan(semantics="delays")`` (the delayed tier,
    :mod:`repro_torch.core.semantics`) and raises under ``no_delays``.
    """

    neuron: int
    consume: int
    produce: int
    regex_base: int
    regex_period: int = 0
    covering: bool = False
    delay: int = 0

    def __post_init__(self) -> None:
        if self.neuron < 0:
            raise ValueError(f"neuron index must be >= 0, got {self.neuron}")
        if self.consume < 1:
            raise ValueError(f"consume must be >= 1, got {self.consume}")
        if self.produce < 0:
            raise ValueError(f"produce must be >= 0, got {self.produce}")
        if self.regex_base < self.consume:
            # a^k ∈ L(E) requires k >= c for the rule to be usable at all.
            raise ValueError(
                f"regex base {self.regex_base} < consume {self.consume}: "
                "rule could fire with fewer spikes than it consumes"
            )
        if self.regex_period < 0:
            raise ValueError("regex_period must be >= 0")
        if not 0 <= self.delay < 1 << 15:
            # The sparse lowering packs (produce | delay << 16) into one
            # int32; any realistic delay is orders of magnitude smaller.
            raise ValueError(
                f"delay must be in [0, 2^15), got {self.delay}")

    @property
    def is_forgetting(self) -> bool:
        return self.produce == 0

    def describe(self) -> str:
        e = f"a^{self.regex_base}"
        if self.regex_period:
            e += f"(a^{self.regex_period})*"
        if self.covering:
            e += "(>=)"
        rhs = f"a^{self.produce}" if self.produce else "λ"
        if self.delay:
            rhs += f"; {self.delay}"
        return f"σ{self.neuron}: {e}/a^{self.consume} -> {rhs}"


@dataclass(frozen=True)
class SNPSystem:
    """An SNP system without delays, ``Π = (O, σ_1..σ_m, syn, in, out)``."""

    num_neurons: int
    initial_spikes: Tuple[int, ...]
    rules: Tuple[Rule, ...]
    synapses: Tuple[Tuple[int, int], ...]
    input_neuron: int = -1  # -1: none
    output_neuron: int = -1  # -1: none
    name: str = "snp"

    def __post_init__(self) -> None:
        m = self.num_neurons
        if m < 1:
            raise ValueError("need at least one neuron")
        if len(self.initial_spikes) != m:
            raise ValueError(
                f"initial_spikes has {len(self.initial_spikes)} entries, "
                f"expected {m}"
            )
        if any(s < 0 for s in self.initial_spikes):
            raise ValueError("initial spike counts must be >= 0")
        for i, j in self.synapses:
            if not (0 <= i < m and 0 <= j < m):
                raise ValueError(f"synapse ({i},{j}) out of range")
            if i == j:
                raise ValueError(f"self-synapse ({i},{j}) not allowed")
        if len(set(self.synapses)) != len(self.synapses):
            raise ValueError("duplicate synapses")
        for r in self.rules:
            if r.neuron >= m:
                raise ValueError(f"rule {r} refers to missing neuron")
        for idx in (self.input_neuron, self.output_neuron):
            if idx != -1 and not (0 <= idx < m):
                raise ValueError(f"in/out neuron {idx} out of range")

    # -- convenience -------------------------------------------------------

    @property
    def num_rules(self) -> int:
        return len(self.rules)

    @property
    def max_delay(self) -> int:
        """Largest per-rule firing delay (0 for a paper-style system)."""
        return max((r.delay for r in self.rules), default=0)

    def rules_of(self, neuron: int) -> List[Rule]:
        return [r for r in self.rules if r.neuron == neuron]

    def out_degree(self, neuron: int) -> int:
        return sum(1 for (i, _) in self.synapses if i == neuron)

    def with_mode(self, covering: bool) -> "SNPSystem":
        """Return a copy with every rule's membership mode replaced."""
        rules = tuple(dataclasses.replace(r, covering=covering) for r in self.rules)
        return dataclasses.replace(self, rules=rules)

    def describe(self) -> str:
        lines = [f"SNP system '{self.name}': m={self.num_neurons} "
                 f"n={self.num_rules} out={self.output_neuron}"]
        lines += [f"  ({k + 1}) {r.describe()}" for k, r in enumerate(self.rules)]
        lines.append(f"  syn = {sorted(self.synapses)}")
        lines.append(f"  C0  = {list(self.initial_spikes)}")
        return "\n".join(lines)


def paper_pi(covering: bool = True) -> SNPSystem:
    """The paper's Fig. 1 system Π generating ℕ∖{1}.

    Total rule order (1)..(5) as in the paper's ``M_Π`` (eq. 1):

    1. σ1: a^2/a   -> a
    2. σ1: a^2/a^2 -> a
    3. σ2: a/a     -> a
    4. σ3: a/a     -> a      (to the environment)
    5. σ3: a^2     -> λ

    ``covering=True`` reproduces the paper's simulator ((b-3) ``>=``
    semantics, matching its printed ``allGenCk``); ``covering=False`` is the
    standard exact semantics under which Π generates exactly ℕ∖{1}.
    """
    rules = (
        Rule(neuron=0, consume=1, produce=1, regex_base=2, covering=covering),
        Rule(neuron=0, consume=2, produce=1, regex_base=2, covering=covering),
        Rule(neuron=1, consume=1, produce=1, regex_base=1, covering=covering),
        Rule(neuron=2, consume=1, produce=1, regex_base=1, covering=covering),
        Rule(neuron=2, consume=2, produce=0, regex_base=2, covering=covering),
    )
    return SNPSystem(
        num_neurons=3,
        initial_spikes=(2, 1, 1),
        rules=rules,
        synapses=((0, 1), (0, 2), (1, 0), (1, 2)),
        output_neuron=2,
        name="paper-pi" + ("-covering" if covering else "-exact"),
    )
