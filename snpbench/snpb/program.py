"""The one adapter between the benchmark and the program under test.

It puts the checkout's ``src/`` on the path, hands a
:class:`~.systems.PlainSystem` to the port as an ``SNPSystem``, lowers it
once under the configuration's pinned backend and plan, and calls the
public ``repro_torch.core.explore`` with the traffic's caps.  Nothing
else of the benchmark imports ``repro_torch``.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def import_port():
    """``repro_torch.core`` from this checkout's ``src/``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core as core
    return core


def to_snp(system):
    """The port's ``SNPSystem`` of a plain description."""
    core = import_port()
    rules = tuple(core.Rule(neuron=int(r[0]), consume=int(r[1]),
                            produce=int(r[2]), regex_base=int(r[3]),
                            regex_period=int(r[4]), covering=bool(r[5]))
                  for r in system.rules.tolist())
    return core.SNPSystem(
        system.num_neurons, tuple(int(v) for v in system.init),
        rules, tuple((int(a), int(b)) for a, b in system.synapses.tolist()),
        output_neuron=system.output_neuron, name=system.name)


class Program:
    """The configuration's system lowered once for its pinned backend and
    plan on ``device``; :meth:`explore` runs one explore of the traffic."""

    def __init__(self, system, config: dict, device: str) -> None:
        core = import_port()
        from repro_torch.core.backend import compile_with_plan
        pinned = config["program"]
        self.core, self.device = core, device
        self.backend = pinned["backend"]
        self.plan = core.SystemPlan(**pinned["plan"])
        self.comp = compile_with_plan(core.get_backend(self.backend),
                                      to_snp(system), self.plan, device)

    def explore(self, traffic: dict, init, max_steps=None):
        return self.core.explore(
            self.comp, backend=self.backend, plan=self.plan,
            device=self.device, init=[int(v) for v in init],
            frontier_cap=traffic["frontier_cap"],
            max_branches=traffic["max_branches"],
            visited_cap=traffic["visited_cap"],
            max_steps=traffic["max_steps"] if max_steps is None
            else max_steps,
            dedup=traffic["dedup"])
