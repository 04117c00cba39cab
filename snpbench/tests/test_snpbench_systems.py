"""The frozen generators build the program's systems; the configuration
files state the systems' sizes; initial configurations are drawn from the
seed alone."""

import json
from pathlib import Path

import numpy as np
import pytest

from snpb import systems

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _as_plain(s):
    rules = np.array([(r.neuron, r.consume, r.produce, r.regex_base,
                       r.regex_period, int(r.covering)) for r in s.rules],
                     dtype=np.int64)
    return (s.num_neurons, rules, np.array(s.synapses, dtype=np.int64),
            tuple(s.initial_spikes), s.output_neuron)


def _same(plain, snp):
    m, rules, syn, init, out = _as_plain(snp)
    assert plain.num_neurons == m
    np.testing.assert_array_equal(plain.rules, rules)
    np.testing.assert_array_equal(plain.synapses, syn)
    assert tuple(plain.init) == init and plain.output_neuron == out


@pytest.mark.parametrize("copies", [1, 4, 682])
def test_scaled_pi_is_the_programs(copies):
    from repro_torch.core.generators import scaled_pi
    _same(systems.family("scaled_pi").build({"copies": copies}),
          scaled_pi(copies))


def test_paper_pi_is_the_programs():
    from repro_torch.core.system import paper_pi
    fam = systems.family("scaled_pi")
    _same(fam.paper_pi(True), paper_pi(True))
    _same(fam.paper_pi(False), paper_pi(False))


@pytest.mark.parametrize("m, seed, max_in", [(64, 2, None), (200, 0, 12),
                                             (8192, 2, None)])
def test_power_law_is_the_programs(m, seed, max_in):
    from repro_torch.core.generators import power_law
    params = {"m": m, "attach": 4, "seed": seed, "max_in": max_in}
    _same(systems.family("power_law").build(params),
          power_law(m, 4, seed=seed, max_in=max_in))


def test_configuration_sizes_are_the_systems():
    cfg = json.loads((ROOT / "snpbench/configs/powerlaw8192.json")
                     .read_text())
    s = systems.build(cfg)
    assert cfg["sizes"] == {"num_neurons": s.num_neurons,
                            "num_rules": s.num_rules,
                            "num_synapses": s.num_synapses,
                            "row_width": s.num_neurons}


def test_powerlaw_plan_pins_what_the_static_rule_gives():
    from repro_torch.core.generators import power_law
    from repro_torch.core.plan import SystemPlan
    cfg = json.loads((ROOT / "snpbench/configs/powerlaw8192.json")
                     .read_text())
    plan = SystemPlan.for_system(power_law(8192, 4, seed=2))
    assert cfg["program"]["plan"]["encoding"] == plan.encoding
    assert cfg["program"]["plan"]["hub_threshold"] == plan.hub_threshold


def test_pi_reachable_set():
    got = systems.family("scaled_pi").reachable(4)
    assert len(got) == 19 and tuple(got[0]) == (2, 1, 1)
    assert len({tuple(r) for r in got}) == 19


def _traffic_inits():
    out = []
    for p in sorted((BENCH / "traffic").glob("*.json")):
        out += [(p.stem, x["name"]) for x in json.loads(p.read_text())
                ["inits"]]
    return out


@pytest.mark.parametrize("traffic, kind", _traffic_inits())
def test_inits_depend_on_seed_and_index_only(traffic, kind):
    cfg = json.loads((ROOT / "snpbench/configs/powerlaw8192.json")
                     .read_text())
    spec = next(x for x in json.loads((BENCH / "traffic" / f"{traffic}.json")
                                      .read_text())["inits"]
                if x["name"] == kind)
    s = systems.build(cfg)
    big = 2 ** 31 + 12345

    def draw(seed, index):
        return systems.draw_init(cfg, spec, s, seed, index)

    a = draw(big, 3)
    np.testing.assert_array_equal(a, draw(big, 3))
    assert not np.array_equal(a, draw(big, 4))
    assert not np.array_equal(a, draw(big + 1, 3))
    assert a.shape == (s.num_neurons,) and a.min() >= 0 and a.max() <= 3
    n = spec.get("active", s.num_neurons)
    assert not a[n:].any()
    # no synapse leaves the neurons that hold spikes
    src, dst = s.synapses[:, 0], s.synapses[:, 1]
    assert (dst[src < n] < n).all()


def test_an_active_set_that_a_synapse_leaves_is_refused():
    cfg = {"family": "power_law", "params": {"m": 64, "seed": 2}}
    s = systems.build(cfg)
    with pytest.raises(ValueError):
        systems.draw_init(cfg, {"kind": "uniform", "low": 0, "high": 3,
                                "active": 3}, s, 1, 0)
