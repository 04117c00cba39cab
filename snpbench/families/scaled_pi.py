"""``scaled_pi``: disjoint copies of the paper's Π as one system.

Frozen copy of ``repro_torch.core.generators.scaled_pi`` and
``repro_torch.core.system.paper_pi`` as they stand when this benchmark was
written (the same rules, synapses, neuron numbering and rule order), so a
later edit of the program's generators cannot move the yardstick.

The paper's Π (Cabarle, Adorna, Martínez-del-Amor 2011, Fig. 1; rules in
the order of its ``M_Π``): σ1 ``a^2/a -> a``, σ1 ``a^2/a^2 -> a``, σ2
``a/a -> a``, σ3 ``a/a -> a``, σ3 ``a^2 -> λ``; synapses (1,2), (1,3),
(2,1), (2,3); C0 = (2, 1, 1).  ``covering`` selects the paper's
simulator's ``>=`` semantics (the default) or the exact one.

``params``: ``{"copies": k, "covering": bool}``.  Copy ``c`` holds
neurons ``3c .. 3c+2``; the output neuron is the last one.

``draw_init``: with ``{"kind": "reachable", "steps": s}`` every copy's
configuration is drawn uniformly and independently from the distinct
configurations Π reaches from (2, 1, 1) within its first ``s`` steps
(found by the reference's own BFS), so every copy starts somewhere its
own computation goes.
"""

from __future__ import annotations

import functools

import numpy as np

from snpb.systems import PlainSystem, plain

# (neuron, consume, produce, base, period); covering is a parameter
PI_RULES = ((0, 1, 1, 2, 0), (0, 2, 1, 2, 0), (1, 1, 1, 1, 0),
            (2, 1, 1, 1, 0), (2, 2, 0, 2, 0))
PI_SYNAPSES = ((0, 1), (0, 2), (1, 0), (1, 2))
PI_INIT = (2, 1, 1)


def paper_pi(covering: bool = True) -> PlainSystem:
    rules = [r + (int(covering),) for r in PI_RULES]
    return plain(3, rules, PI_SYNAPSES, PI_INIT, 2,
                 "paper-pi" + ("-covering" if covering else "-exact"))


def build(params: dict) -> PlainSystem:
    k, cov = int(params["copies"]), bool(params.get("covering", True))
    rules, syn = [], []
    for c in range(k):
        off = 3 * c
        rules += [(nu + off, a, b, e, p, int(cov))
                  for nu, a, b, e, p in PI_RULES]
        syn += [(i + off, j + off) for i, j in PI_SYNAPSES]
    return plain(3 * k, rules, syn, PI_INIT * k, 3 * k - 1, f"pi-x{k}")


@functools.lru_cache(maxsize=None)
def reachable(steps: int, covering: bool = True) -> np.ndarray:
    """The distinct configurations Π reaches from C0 within ``steps``
    steps, in discovery order, (N, 3)."""
    from snpb.reference import Reference
    ref = Reference(paper_pi(covering), "cpu")
    out = ref.explore(PI_INIT, frontier_cap=4096, max_branches=64,
                      visited_cap=4096, max_steps=steps)
    if out.frontier_overflow or out.visited_overflow or out.branch_overflow:
        raise ValueError("Π's reachable set overflowed its caps")
    return out.configs.numpy().astype(np.int64)


def draw_init(system: PlainSystem, params: dict,
              rng: np.random.Generator) -> np.ndarray:
    if params.get("kind") != "reachable":
        raise ValueError(f"scaled_pi draws only 'reachable' inits: {params}")
    pool = reachable(int(params["steps"]),
                     bool(system.rules[0, 5]) if system.num_rules else True)
    copies = system.num_neurons // 3
    return pool[rng.integers(0, len(pool), size=copies)].reshape(-1)
