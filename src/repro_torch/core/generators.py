"""Synthetic SNP-system families for scaling benchmarks and stress tests.

A faithful copy of ``repro.core.generators``: every family draws from
Python's ``random`` with the same seeds, so both packages build the same
systems from the same arguments.

The paper evaluates on the single 3-neuron Π; to measure how the engine
scales with system size (neurons, rules, synapse density, nondeterministic
width) we need parameterized families, all valid SNPSystems:

* ``ring``            — deterministic m-neuron ring, one a->a rule each.
* ``nd_chain``        — k neurons with two applicable rules each: Ψ = 2^k
                        branching, worst-case enumeration stress.
* ``random_system``   — Erdős–Rényi synapse graph with random rules;
                        branching statistically controlled.
* ``counter``         — b-bit ripple counter (2-neuron pacemaker + divider
                        chain): long deterministic runs with a known exact
                        trajectory (period-2^b limit cycle, ≥ 2^b distinct
                        configs).
* ``scaled_pi``       — k disjoint copies of the paper's Π fused into one
                        system: tree = product of k independent Π trees;
                        lets us grow the paper's own workload.

Large-system families (bounded synapse degree, O(m·degree) construction —
the sparse-backend benchmark tier; ``random_system``'s O(m²) edge scan is
unusable past a few thousand neurons):

* ``ring_lattice``    — each neuron feeds its next ``degree`` ring
                        neighbors: exact, uniform out-degree.
* ``torus``           — 2-D wrap-around grid, 4-neighborhood (degree 4).
* ``power_law``       — preferential attachment: bounded *mean* degree
                        with heavy-tailed in-degree, the adversarial case
                        for ELL row packing.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional, Sequence, Tuple, Union

from .system import Rule, SNPSystem

__all__ = ["ring", "nd_chain", "random_system", "counter", "scaled_pi",
           "ring_lattice", "torus", "power_law", "with_delays"]


def ring(m: int, produce: int = 1) -> SNPSystem:
    rules = tuple(
        Rule(neuron=i, consume=1, produce=produce, regex_base=1, covering=True)
        for i in range(m)
    )
    syn = tuple((i, (i + 1) % m) for i in range(m))
    init = tuple(1 if i == 0 else 0 for i in range(m))
    return SNPSystem(m, init, rules, syn, output_neuron=m - 1,
                     name=f"ring-{m}")


def nd_chain(k: int) -> SNPSystem:
    """Every neuron holds 1 spike and may either relay or forget: Ψ = 2^k."""
    rules = []
    for i in range(k):
        rules.append(Rule(neuron=i, consume=1, produce=1, regex_base=1,
                          covering=True))
        rules.append(Rule(neuron=i, consume=1, produce=0, regex_base=1,
                          covering=True))
    syn = tuple((i, i + 1) for i in range(k - 1))
    return SNPSystem(k, (1,) * k, tuple(rules), syn, output_neuron=k - 1,
                     name=f"nd-chain-{k}")


def random_system(
    m: int,
    rules_per_neuron: int = 2,
    synapse_prob: float = 0.25,
    max_spikes: int = 3,
    seed: int = 0,
) -> SNPSystem:
    rng = random.Random(seed)
    rules = []
    for i in range(m):
        for _ in range(rules_per_neuron):
            consume = rng.randint(1, max_spikes)
            base = rng.randint(consume, max_spikes)
            rules.append(Rule(
                neuron=i, consume=consume,
                produce=rng.choice([0, 1, 1, 2]),
                regex_base=base,
                regex_period=rng.choice([0, 0, 1]),
                covering=rng.random() < 0.5,
            ))
    syn = tuple(
        (i, j) for i in range(m) for j in range(m)
        if i != j and rng.random() < synapse_prob
    )
    init = tuple(rng.randint(0, max_spikes) for _ in range(m))
    return SNPSystem(m, init, tuple(rules), syn, output_neuron=m - 1,
                     name=f"random-{m}x{rules_per_neuron}-s{seed}")


def counter(bits: int) -> SNPSystem:
    """A deterministic b-bit ripple counter: period-doubling divider chain.

    Self-synapses are forbidden, so the clock is a 2-neuron pacemaker
    (neurons 0 and 1) bouncing a single spike and feeding divider stage 0
    every step.  Divider stage ``i`` (neuron ``2 + i``) accumulates spikes
    and fires exactly at 2 (``a^2/a^2 -> a``, exact mode), halving the rate:
    stage ``i`` fires every ``2^(i+1)`` steps, and its held spike count is
    bit ``i`` of a binary counter.  The trajectory is a limit cycle of
    period ``2^bits`` (plus a short chain-fill transient), so a run visits
    at least ``2^bits`` distinct configurations; the output neuron (last
    stage) emits one spike to the environment every ``2^bits`` steps.
    """
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")
    rules = [
        # pacemaker: each neuron relays the clock spike to its twin and
        # into divider stage 0.
        Rule(neuron=0, consume=1, produce=1, regex_base=1, covering=True),
        Rule(neuron=1, consume=1, produce=1, regex_base=1, covering=True),
    ]
    for i in range(bits):
        # divider stage: fire exactly when 2 spikes have accumulated.
        rules.append(Rule(neuron=2 + i, consume=2, produce=1, regex_base=2,
                          covering=False))
    syn = [(0, 1), (1, 0), (0, 2), (1, 2)]
    syn += [(2 + i, 3 + i) for i in range(bits - 1)]
    init = (1, 0) + (0,) * bits
    return SNPSystem(bits + 2, init, tuple(rules), tuple(syn),
                     output_neuron=bits + 1, name=f"counter-{bits}")


def scaled_pi(copies: int, covering: bool = True) -> SNPSystem:
    """``copies`` disjoint instances of the paper's Π as one system.

    Computation tree size grows as (paper tree)^copies; neuron/rule counts
    grow linearly — the natural 'bigger Π' the paper's future-work section
    asks for ("very large systems with equally large matrices").
    """
    from .system import paper_pi

    base = paper_pi(covering=covering)
    m0 = base.num_neurons
    rules = []
    syn = []
    init: Tuple[int, ...] = ()
    for c in range(copies):
        off = c * m0
        for r in base.rules:
            rules.append(dataclasses.replace(r, neuron=r.neuron + off))
        syn += [(i + off, j + off) for (i, j) in base.synapses]
        init = init + tuple(base.initial_spikes)
    return SNPSystem(copies * m0, init, tuple(rules), tuple(syn),
                     output_neuron=copies * m0 - 1,
                     name=f"pi-x{copies}")


# ---------------------------------------------------------------------------
# Large-system families: bounded-degree synapse topologies, O(m·degree)
# construction, for the sparse-backend benchmark tier.
# ---------------------------------------------------------------------------


def _bounded_rules(m: int, rules_per_neuron: int, max_spikes: int,
                   rng: random.Random) -> Tuple[Rule, ...]:
    """Random rules in the same bounded family as :func:`random_system`."""
    rules = []
    for i in range(m):
        for _ in range(rules_per_neuron):
            consume = rng.randint(1, max_spikes)
            rules.append(Rule(
                neuron=i, consume=consume,
                produce=rng.choice([0, 1, 1, 2]),
                regex_base=rng.randint(consume, max_spikes),
                regex_period=rng.choice([0, 0, 1]),
                covering=rng.random() < 0.5,
            ))
    return tuple(rules)


def _sparse_family(name: str, m: int, syn, rules_per_neuron: int,
                   max_spikes: int, seed: int) -> SNPSystem:
    rng = random.Random(seed)
    rules = _bounded_rules(m, rules_per_neuron, max_spikes, rng)
    init = tuple(rng.randint(0, max_spikes) for _ in range(m))
    return SNPSystem(m, init, rules, tuple(syn), output_neuron=m - 1,
                     name=name)


def ring_lattice(m: int, degree: int = 4, rules_per_neuron: int = 2,
                 max_spikes: int = 3, seed: int = 0) -> SNPSystem:
    """Each neuron synapses onto its next ``degree`` ring neighbors:
    exact, uniform out- and in-degree (the best case for ELL packing)."""
    if not 1 <= degree < m:
        raise ValueError(f"need 1 <= degree < m, got degree={degree}, m={m}")
    syn = [(i, (i + d) % m) for i in range(m) for d in range(1, degree + 1)]
    return _sparse_family(f"ring-lattice-{m}d{degree}", m, syn,
                          rules_per_neuron, max_spikes, seed)


def torus(rows: int, cols: Optional[int] = None, rules_per_neuron: int = 2,
          max_spikes: int = 3, seed: int = 0) -> SNPSystem:
    """2-D wrap-around grid, synapses to the 4-neighborhood (degree 4)."""
    cols = rows if cols is None else cols
    if rows < 3 or cols < 3:
        raise ValueError("torus needs rows, cols >= 3 (distinct neighbors)")
    m = rows * cols
    syn = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            syn += [(i, r * cols + (c + 1) % cols),
                    (i, r * cols + (c - 1) % cols),
                    (i, ((r + 1) % rows) * cols + c),
                    (i, ((r - 1) % rows) * cols + c)]
    return _sparse_family(f"torus-{rows}x{cols}", m, syn,
                          rules_per_neuron, max_spikes, seed)


def power_law(m: int, attach: int = 4, rules_per_neuron: int = 2,
              max_spikes: int = 3, seed: int = 0,
              max_in: Optional[int] = None) -> SNPSystem:
    """Preferential attachment (Barabási–Albert): node ``i`` synapses onto
    ``attach`` distinct earlier nodes sampled by degree.  Mean out-degree
    is ``attach``; in-degree is heavy-tailed — the adversarial case for the
    ELL in-adjacency (``K_in`` ≫ mean degree).

    ``max_in=None`` (the default) is the **unbounded-hub** family: the top
    hub's in-degree — hence a pure-ELL ``K_in`` and its padding — grows
    with ``m``, which is exactly the workload the hybrid ELL+COO plan
    (``SystemPlan(encoding="hybrid")``, DESIGN.md §3) exists for; the
    hybrid benchmark tier sweeps this family.  ``max_in`` caps hub
    in-degree (rejection-sampled, with a deterministic fallback scan so a
    saturated pool cannot stall generation — keep ``max_in >= 2·attach``
    to make the fallback rare), bounding ``K_in`` for the pure-ELL tiers.

    Deterministic in ``(m, attach, rules_per_neuron, max_spikes, seed,
    max_in)`` on every Python version: candidate targets are drawn from a
    seeded PRNG and committed in sorted order (never in hash/set order),
    so equal arguments always build the identical system."""
    if not 1 <= attach < m:
        raise ValueError(f"need 1 <= attach < m, got attach={attach}, m={m}")
    if max_in is not None and max_in < attach:
        raise ValueError(f"max_in {max_in} < attach {attach}")
    rng = random.Random(seed ^ 0x5eed)
    syn = []
    in_deg = [0] * m
    # degree-proportional endpoint pool, seeded with a clique of attach+1
    pool = []
    for i in range(attach + 1):
        for j in range(attach + 1):
            if i != j:
                syn.append((i, j))
                pool.append(j)
                in_deg[j] += 1
    for i in range(attach + 1, m):
        targets = set()
        for _ in range(50 * attach):  # bounded rejection sampling
            if len(targets) == attach:
                break
            j = pool[rng.randrange(len(pool))]
            if max_in is None or in_deg[j] < max_in:
                targets.add(j)
        if len(targets) < attach:
            # Near-saturated pool (max_in close to attach), or an extreme
            # hub-dominated pool in the unbounded family: top up from an
            # explicit ascending scan of eligible earlier nodes so
            # generation always terminates, deterministically.
            for j in range(i):
                if len(targets) == attach:
                    break
                if max_in is None or in_deg[j] < max_in:
                    targets.add(j)
            if len(targets) < attach:
                raise ValueError(
                    f"cannot attach {attach} edges under max_in={max_in} "
                    f"at node {i}; raise max_in (>= 2*attach recommended)")
        for j in sorted(targets):
            syn.append((i, j))
            pool.append(j)
            in_deg[j] += 1
        pool.append(i)
    cap = "" if max_in is None else f"c{max_in}"
    return _sparse_family(f"power-law-{m}a{attach}{cap}", m, syn,
                          rules_per_neuron, max_spikes, seed)


# ---------------------------------------------------------------------------
# Delayed variants: every family above gains a semantics="delays" workload
# by injecting per-rule firing delays into an existing system.
# ---------------------------------------------------------------------------


DelaySpec = Union[int, Sequence[int], Callable[[int, Rule], int]]


def with_delays(system: SNPSystem, delays: DelaySpec) -> SNPSystem:
    """A copy of ``system`` whose rules carry firing delays.

    ``delays`` is one of:

    * an ``int`` — every rule gets that delay;
    * a sequence of ``len(system.rules)`` ints — per-rule delays in rule
      order;
    * a callable ``(rule_index, rule) -> int`` — e.g.
      ``lambda k, r: k % 3`` for a deterministic mixed-delay variant.

    Once any delay is nonzero the result compiles only under
    ``semantics="delays"`` (``SystemPlan(semantics="delays")``);
    ``with_delays(sys, 0)`` is a delay-annotated system that compiles like
    ``sys`` under either tier."""
    rules = system.rules
    if callable(delays):
        ds = [int(delays(k, r)) for k, r in enumerate(rules)]
    elif isinstance(delays, int):
        ds = [delays] * len(rules)
    else:
        ds = [int(d) for d in delays]
        if len(ds) != len(rules):
            raise ValueError(
                f"delays has {len(ds)} entries, expected one per rule "
                f"({len(rules)})")
    new_rules = tuple(dataclasses.replace(r, delay=d)
                      for r, d in zip(rules, ds))
    suffix = "-delays" if any(ds) else "-delays0"
    return dataclasses.replace(system, rules=new_rules,
                               name=system.name + suffix)
