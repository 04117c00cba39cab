"""The plain reference against the program's plain ``"ref"`` backend on
the CPU, and its independence from the program."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from snpb import systems
from snpb.reference import KeyCollision, Reference

BENCH = Path(__file__).resolve().parents[1]

CASES = {
    "paper_pi": ("scaled_pi", None, dict(frontier_cap=16, max_branches=16,
                                         max_steps=20)),
    "scaled_pi_4": ("scaled_pi", {"copies": 4},
                    dict(frontier_cap=32, max_branches=16, max_steps=12)),
    "power_law_64": ("power_law", {"m": 64, "seed": 2},
                     dict(frontier_cap=32, max_branches=16, max_steps=12)),
}


def _systems(case):
    fam, params, caps = CASES[case]
    from repro_torch.core.generators import power_law, scaled_pi
    from repro_torch.core.system import paper_pi
    if params is None:
        return systems.family(fam).paper_pi(True), paper_pi(True), caps
    if fam == "scaled_pi":
        return (systems.family(fam).build(params),
                scaled_pi(params["copies"]), caps)
    return (systems.family(fam).build(params),
            power_law(params["m"], seed=params["seed"]), caps)


@pytest.mark.parametrize("dedup, V", [("hash", 16384), ("sort", 1024)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_programs_ref_backend(case, dedup, V):
    from repro_torch.core import explore
    plain, snp, caps = _systems(case)
    got = explore(snp, backend="ref", device="cpu", dedup=dedup,
                  visited_cap=V, **caps)
    ref = Reference(plain, "cpu").explore(plain.init, visited_cap=V, **caps)
    assert not got.visited_overflow
    np.testing.assert_array_equal(got.configs, ref.configs.numpy())
    assert (got.num_discovered, got.steps) == (ref.num_discovered,
                                               ref.steps)
    assert (got.branch_overflow, got.frontier_overflow,
            got.visited_overflow) == (ref.branch_overflow,
                                      ref.frontier_overflow,
                                      ref.visited_overflow)


def test_reference_from_a_drawn_init_equals_the_programs():
    from repro_torch.core import explore
    plain, snp, caps = _systems("scaled_pi_4")
    cfg = {"family": "scaled_pi", "params": {"copies": 4}}
    init = systems.draw_init(cfg, {"kind": "reachable", "steps": 4}, plain,
                             2 ** 31 + 99, 0)
    got = explore(snp, backend="ref", device="cpu", init=list(init),
                  visited_cap=16384, **caps)
    ref = Reference(plain, "cpu").explore(init, visited_cap=16384, **caps)
    np.testing.assert_array_equal(got.configs, ref.configs.numpy())


@pytest.mark.parametrize("dedup, V", [("hash", 16384), ("sort", 1024)])
def test_reference_from_a_core_init_equals_the_programs(dedup, V):
    """Spikes in a set no synapse leaves: most candidates are seen
    before, so the dedup decides every level."""
    from repro_torch.core import explore
    plain, snp, caps = _systems("power_law_64")
    cfg = {"family": "power_law", "params": {"m": 64, "seed": 2}}
    spec = {"kind": "uniform", "low": 0, "high": 3, "active": 24}
    init = systems.draw_init(cfg, spec, plain, 2 ** 31 + 99, 1)
    assert init[:24].any() and not init[24:].any()
    got = explore(snp, backend="ref", device="cpu", init=list(init),
                  dedup=dedup, visited_cap=V, **caps)
    ref = Reference(plain, "cpu").explore(init, visited_cap=V, **caps)
    np.testing.assert_array_equal(got.configs, ref.configs.numpy())
    assert (got.num_discovered, got.steps, got.frontier_overflow) == \
        (ref.num_discovered, ref.steps, ref.frontier_overflow)


def test_visited_overflow_keeps_the_first_V_rows():
    from repro_torch.core import explore
    plain, snp, caps = _systems("scaled_pi_4")
    got = explore(snp, backend="ref", device="cpu", dedup="hash",
                  visited_cap=100, **caps)
    ref = Reference(plain, "cpu").explore(plain.init, visited_cap=100,
                                          **caps)
    assert got.visited_overflow and ref.visited_overflow
    np.testing.assert_array_equal(got.configs, ref.configs.numpy())


def test_a_key_collision_is_caught():
    plain, _, caps = _systems("scaled_pi_4")
    with pytest.raises(KeyCollision):
        Reference(plain, "cpu", key_bits=4).explore(
            plain.init, visited_cap=4096, **caps)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import snpb.reference, snpb.compare, snpb.counts, "
            "snpb.systems, snpb.trace; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)" % str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
