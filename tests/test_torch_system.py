"""The port's specification layer against the reference: ``Rule``,
``SNPSystem``, ``paper_pi`` and every generator build equal systems from
equal arguments (the generators share Python ``random`` seeds)."""

import dataclasses

import pytest

pytest.importorskip("torch")

import conftest  # noqa: E402
from repro.core import generators as jgen  # noqa: E402
from repro.core import system as jsys  # noqa: E402
from repro_torch.core import generators as pgen  # noqa: E402
from repro_torch.core import system as psys  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402

# (generator function, args, kwargs) per EQUIV_SYSTEMS entry, plus the
# scaled and counter families and the other generators.
BUILDS = {
    "paper-pi": ("paper_pi", (True,), {}),
    "nd-chain-4": ("nd_chain", (4,), {}),
    "random-16": ("random_system", (16, 2, 0.2), {"seed": 4}),
    "random-17": ("random_system", (17, 3, 0.3), {"seed": 3}),
    "ring-lattice-12": ("ring_lattice", (12, 3), {"seed": 1}),
    "power-law-40": ("power_law", (40, 3), {"seed": 3}),
    "paper-pi-exact": ("paper_pi", (False,), {}),
    "scaled-pi-4": ("scaled_pi", (4,), {}),
    "counter-6": ("counter", (6,), {}),
    "ring-9": ("ring", (9,), {}),
    "torus-4x5": ("torus", (4, 5), {"seed": 2}),
    "power-law-capped": ("power_law", (60, 3), {"seed": 1, "max_in": 8}),
}


def _build(mod_system, mod_gen, fn, args, kwargs):
    mod = mod_system if fn == "paper_pi" else mod_gen
    return getattr(mod, fn)(*args, **kwargs)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_generators_match_reference(name):
    fn, args, kwargs = BUILDS[name]
    ref = _build(jsys, jgen, fn, args, kwargs)
    port = _build(psys, pgen, fn, args, kwargs)
    if name in conftest.EQUIV_SYSTEMS:
        assert ref == conftest.EQUIV_SYSTEMS[name][0]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.describe() == ref.describe()
    # the converter carries the reference system across unchanged
    assert system_from_spec(dataclasses.asdict(ref)) == port


def test_with_delays_matches_reference():
    ref = jgen.with_delays(jgen.nd_chain(3), lambda k, r: k % 3)
    port = pgen.with_delays(pgen.nd_chain(3), lambda k, r: k % 3)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.max_delay == ref.max_delay == 2


@pytest.mark.parametrize("kwargs", [
    dict(neuron=-1, consume=1, produce=1, regex_base=1),
    dict(neuron=0, consume=0, produce=1, regex_base=1),
    dict(neuron=0, consume=1, produce=-1, regex_base=1),
    dict(neuron=0, consume=2, produce=1, regex_base=1),
    dict(neuron=0, consume=1, produce=1, regex_base=1, regex_period=-1),
    dict(neuron=0, consume=1, produce=1, regex_base=1, delay=1 << 15),
])
def test_rule_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        jsys.Rule(**kwargs)
    with pytest.raises(ValueError):
        psys.Rule(**kwargs)


@pytest.mark.parametrize("change", [
    dict(num_neurons=0, initial_spikes=()),
    dict(initial_spikes=(1, 1)),
    dict(initial_spikes=(1, -1, 1)),
    dict(synapses=((0, 3),)),
    dict(synapses=((1, 1),)),
    dict(synapses=((0, 1), (0, 1))),
    dict(output_neuron=5),
])
def test_system_validation_matches_reference(change):
    base = dataclasses.asdict(jsys.paper_pi(True))
    spec = {**base, **change}
    for mod in (jsys, psys):
        rules = tuple(mod.Rule(**r) for r in spec["rules"])
        with pytest.raises(ValueError):
            mod.SNPSystem(**{**spec, "rules": rules})
