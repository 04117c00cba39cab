"""Plain descriptions of SNP systems, and the families that build them.

A :class:`PlainSystem` is what both sides of a run receive: the neurons,
the rules in the system's own total order, the synapses and the
generator's initial configuration, as numpy arrays.  The port gets it as
an ``SNPSystem`` (:mod:`.program`), the reference as it is
(:mod:`.reference`).

A configuration file names a family; the family is a module
``snpbench/families/<family>.py`` with

* ``build(params) -> PlainSystem`` — the frozen generator, and
* ``draw_init(system, params, rng) -> np.ndarray`` — one initial
  configuration drawn from ``rng`` (a ``numpy.random.Generator``),

so a later configuration of a new family adds a file and edits none.
"""

from __future__ import annotations

import functools
import importlib.util
from dataclasses import dataclass
from pathlib import Path

import numpy as np

FAMILIES = Path(__file__).resolve().parent.parent / "families"

# rule columns of PlainSystem.rules
NEURON, CONSUME, PRODUCE, BASE, PERIOD, COVERING = range(6)


@dataclass(frozen=True)
class PlainSystem:
    num_neurons: int
    rules: np.ndarray       # (n, 6) int64: neuron, consume, produce, base,
    #                         period, covering (0/1), in the system's order
    synapses: np.ndarray    # (E, 2) int64: (source, target)
    init: np.ndarray        # (m,) int64: the generator's own C0
    output_neuron: int
    name: str

    @property
    def num_rules(self) -> int:
        return int(self.rules.shape[0])

    @property
    def num_synapses(self) -> int:
        return int(self.synapses.shape[0])


def plain(num_neurons, rules, synapses, init, output_neuron, name
          ) -> PlainSystem:
    """A :class:`PlainSystem` from Python sequences."""
    return PlainSystem(
        int(num_neurons),
        np.asarray(rules, dtype=np.int64).reshape(-1, 6),
        np.asarray(synapses, dtype=np.int64).reshape(-1, 2),
        np.asarray(init, dtype=np.int64),
        int(output_neuron), str(name))


@functools.lru_cache(maxsize=None)
def family(name: str):
    """The family module ``families/<name>.py``."""
    path = FAMILIES / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no family file {path}")
    spec = importlib.util.spec_from_file_location(f"snpb_family_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def init_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of explore ``index``'s initial configuration in a run
    of ``seed`` (any integer; reduced mod 2^64)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), int(index)]))


def build(config: dict) -> PlainSystem:
    """The configuration's system, from its family's frozen generator."""
    return family(config["family"]).build(config["params"])


def draw_init(config: dict, spec: dict, system: PlainSystem, seed: int,
              index: int) -> np.ndarray:
    """Explore ``index``'s initial configuration in a run of ``seed``,
    drawn as ``spec`` (one of a traffic's ``inits``) says."""
    init = family(config["family"]).draw_init(
        system, spec, init_rng(seed, index))
    init = np.asarray(init, dtype=np.int64)
    if init.shape != (system.num_neurons,) or (init < 0).any():
        raise ValueError(f"bad initial configuration of shape {init.shape}")
    return init
