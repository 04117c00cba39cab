"""The control of ``correct`` must come out not correct: the reference in
the program's place with a 32-bit dedup key trusted unconfirmed.  On the
card at the cells' own sizes on three seeds; on the CPU, where a test
cannot hold those sizes, at a small size with a key narrow enough to
collide there."""

import pytest

from snpb import compare
from snpb.manifest import Manifest

import control

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _cell(workload):
    m = Manifest()
    w = m.workload(workload)
    return m.config(w["config"]), m.traffic(w["traffic"])


def test_the_control_fails_at_a_small_size():
    from test_snpbench_faults import small_cell
    cell, _ = small_cell("powerlaw8192.explore_v262k")
    for seed in SEEDS:
        checks = control.control_checks(cell.config, cell.traffic, seed,
                                        "cpu", key_bits=10)
        assert not compare.passed(checks)


def test_the_exact_reference_passes_against_itself():
    from test_snpbench_faults import small_cell
    cell, _ = small_cell("powerlaw8192.explore_v262k")
    checks = control.control_checks(cell.config, cell.traffic, SEEDS[0],
                                    "cpu", key_bits=64)
    assert compare.passed(checks)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      Manifest().data["workloads"]])
def test_the_control_fails_at_the_cells_size(workload, card):
    config, traffic = _cell(workload)
    for seed in SEEDS:
        checks = control.control_checks(config, traffic, seed, card)
        assert not compare.passed(checks), (seed, checks)
