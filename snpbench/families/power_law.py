"""``power_law``: preferential attachment with random bounded rules.

Frozen copy of ``repro_torch.core.generators.power_law`` (and its helpers
``_bounded_rules`` / ``_sparse_family``) as it stands when this benchmark
was written: the same draws from Python's ``random`` in the same order,
so the same arguments build the same system, whatever later edits the
program's generator.

Node ``i`` synapses onto ``attach`` distinct earlier nodes sampled by
degree (Barabási–Albert), so in-degree is heavy-tailed; every neuron gets
``rules_per_neuron`` random rules with ``consume`` and ``base`` up to
``max_spikes``, ``produce`` in {0, 1, 1, 2}, period in {0, 0, 1}, covering
with probability 1/2.

``params``: ``{"m", "attach", "rules_per_neuron", "max_spikes", "seed",
"max_in"}`` (``max_in`` null: hubs unbounded).

``draw_init``: with ``{"kind": "uniform", "low": a, "high": b}`` every
neuron's spikes are drawn uniformly from ``a .. b``; with ``"active": n``
as well, only neurons ``0 .. n-1`` are drawn and the rest hold none.
Every synapse leads to an earlier neuron, or stays among the first
``attach + 1``, so no spike leaves those ``n`` neurons (``n > attach``):
the computation stays inside them, and the other neurons, empty, never
fire.
"""

from __future__ import annotations

import random

import numpy as np

from snpb.systems import PlainSystem, plain


def _bounded_rules(m, rules_per_neuron, max_spikes, rng):
    rules = []
    for i in range(m):
        for _ in range(rules_per_neuron):
            consume = rng.randint(1, max_spikes)
            produce = rng.choice([0, 1, 1, 2])
            base = rng.randint(consume, max_spikes)
            period = rng.choice([0, 0, 1])
            covering = rng.random() < 0.5
            rules.append((i, consume, produce, base, period, int(covering)))
    return rules


def build(params: dict) -> PlainSystem:
    m, attach = int(params["m"]), int(params.get("attach", 4))
    rpn = int(params.get("rules_per_neuron", 2))
    max_spikes = int(params.get("max_spikes", 3))
    seed = int(params.get("seed", 0))
    max_in = params.get("max_in")
    if not 1 <= attach < m:
        raise ValueError(f"need 1 <= attach < m, got attach={attach}, m={m}")
    if max_in is not None and max_in < attach:
        raise ValueError(f"max_in {max_in} < attach {attach}")
    rng = random.Random(seed ^ 0x5eed)
    syn = []
    in_deg = [0] * m
    pool = []
    for i in range(attach + 1):
        for j in range(attach + 1):
            if i != j:
                syn.append((i, j))
                pool.append(j)
                in_deg[j] += 1
    for i in range(attach + 1, m):
        targets = set()
        for _ in range(50 * attach):
            if len(targets) == attach:
                break
            j = pool[rng.randrange(len(pool))]
            if max_in is None or in_deg[j] < max_in:
                targets.add(j)
        if len(targets) < attach:
            for j in range(i):
                if len(targets) == attach:
                    break
                if max_in is None or in_deg[j] < max_in:
                    targets.add(j)
            if len(targets) < attach:
                raise ValueError(f"cannot attach {attach} edges under "
                                 f"max_in={max_in} at node {i}")
        for j in sorted(targets):
            syn.append((i, j))
            pool.append(j)
            in_deg[j] += 1
        pool.append(i)
    rng = random.Random(seed)
    rules = _bounded_rules(m, rpn, max_spikes, rng)
    init = [rng.randint(0, max_spikes) for _ in range(m)]
    cap = "" if max_in is None else f"c{max_in}"
    return plain(m, rules, syn, init, m - 1, f"power-law-{m}a{attach}{cap}")


def draw_init(system: PlainSystem, params: dict,
              rng: np.random.Generator) -> np.ndarray:
    if params.get("kind") != "uniform":
        raise ValueError(f"power_law draws only 'uniform' inits: {params}")
    m = system.num_neurons
    n = int(params.get("active", m))
    src, dst = system.synapses[:, 0], system.synapses[:, 1]
    if not 0 < n <= m or (dst[src < n] >= n).any():
        raise ValueError(f"neurons 0 .. {n - 1} are not a set that no "
                         f"synapse leaves: {params}")
    init = np.zeros(m, dtype=np.int64)
    init[:n] = rng.integers(int(params["low"]), int(params["high"]) + 1,
                            size=n)
    return init
