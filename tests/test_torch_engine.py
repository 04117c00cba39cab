"""The port's engine against the reference and the paper.

* Every assertion of ``tests/test_paper_repro.py`` holds for the port on
  the CPU, through both port backends.
* ``explore`` archives equal the reference's row for row, in discovery
  order, with equal flags: on ``EQUIV_SYSTEMS``, under both dedup modes,
  and in frontier- and visited-overflow runs.
* ``run_traces(policy="first")`` equals the reference's per seed.
* Entry points called without ``device`` raise when there is no card:
  they never fall back to the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from test_paper_repro import PAPER_ALLGENCK  # noqa: E402

CPU = "cpu"


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


# ---------------------------------------------------------------------------
# the paper's §5 run (test_paper_repro.py) on the port
# ---------------------------------------------------------------------------


@pytest.fixture(params=["cuda", "ref"])
def backend(request):
    return request.param


@pytest.fixture(scope="module")
def comp_covering():
    return P.compile_system(P.paper_pi(covering=True), device=CPU)


@pytest.fixture(scope="module")
def comp_exact():
    return P.compile_system(P.paper_pi(covering=False), device=CPU)


def test_transition_matrix_matches_paper_eq1(comp_covering):
    expected = np.array(
        [[-1, 1, 1], [-2, 1, 1], [1, -1, 1], [0, 0, -1], [0, 0, -2]],
        dtype=np.int32)
    np.testing.assert_array_equal(comp_covering.M.numpy(), expected)
    assert comp_covering.rule_order == (0, 1, 2, 3, 4)


def test_spiking_vectors_at_c0(comp_covering):
    S, valid, overflow = P.spiking_vectors(
        torch.tensor([2, 1, 1], dtype=torch.int32), comp_covering, 8)
    assert not bool(overflow)
    got = {tuple(int(v) for v in S[i]) for i in np.nonzero(valid.numpy())[0]}
    assert got == {(1, 0, 1, 1, 0), (0, 1, 1, 1, 0)}


def test_successors_match_paper_trace(comp_covering, comp_exact, backend):
    def succ(comp, c):
        return P.successor_set(comp, c, backend=backend, device=CPU)

    assert {c for c, _ in succ(comp_covering, (2, 1, 1))} == \
        {(2, 1, 2), (1, 1, 2)}
    assert all(e == 1 for _, e in succ(comp_covering, (2, 1, 1)))
    assert {c for c, _ in succ(comp_covering, (2, 1, 2))} == \
        {(2, 1, 3), (1, 1, 3), (2, 1, 2), (1, 1, 2)}
    assert {c for c, _ in succ(comp_exact, (2, 1, 2))} == \
        {(2, 1, 2), (1, 1, 2)}
    assert succ(comp_covering, (0, 0, 0)) == []
    assert succ(comp_covering, (1, 0, 0)) == []


def test_allgenck_discovery_prefix(comp_covering, backend):
    res = P.explore(comp_covering, max_steps=16, frontier_cap=128,
                    visited_cap=2048, max_branches=16, backend=backend,
                    device=CPU)
    mine = res.as_strings()
    paper_unique = list(dict.fromkeys(PAPER_ALLGENCK))
    assert mine[:45] == paper_unique[:45]
    assert set(paper_unique) <= set(mine)


def test_zero_config_is_terminal(comp_covering):
    res = P.explore(comp_covering, max_steps=4, frontier_cap=16,
                    visited_cap=64, max_branches=8, init=(0, 0, 0),
                    device=CPU)
    assert res.num_discovered == 1


def test_exact_mode_generates_naturals_minus_one(comp_exact, backend):
    gaps = P.emission_gaps(comp_exact, max_time=30, max_gap=14,
                           backend=backend, device=CPU)
    assert 1 not in gaps
    assert set(range(2, 13)) <= gaps


def test_covering_mode_differs_from_exact(comp_covering):
    gaps = P.emission_gaps(comp_covering, max_time=16, max_gap=8, device=CPU)
    assert 1 in gaps


def test_emission_gaps_match_reference():
    for covering, kw in ((False, dict(max_time=20, max_gap=10)),
                         (True, dict(max_time=10, max_gap=6))):
        system = J.paper_pi(covering)
        assert P.emission_gaps(_port(system), device=CPU, **kw) == \
            J.emission_gaps(system, **kw)


def test_explore_reports_exhaustion_only_when_tree_finite(comp_covering):
    res = P.explore(comp_covering, max_steps=8, frontier_cap=128,
                    visited_cap=2048, max_branches=16, device=CPU)
    assert not res.exhausted


# ---------------------------------------------------------------------------
# explore archives against the reference
# ---------------------------------------------------------------------------


def _assert_same_explore(p, j):
    np.testing.assert_array_equal(p.configs, np.asarray(j.configs))
    assert (p.num_discovered, p.steps, p.exhausted) == \
        (j.num_discovered, j.steps, j.exhausted)
    assert (p.branch_overflow, p.frontier_overflow, p.visited_overflow) == \
        (j.branch_overflow, j.frontier_overflow, j.visited_overflow)


@pytest.mark.parametrize("dedup", ["hash", "sort"])
@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_explore_archive_matches_reference(name, dedup):
    system, T = conftest.EQUIV_SYSTEMS[name]
    kw = dict(max_steps=6, frontier_cap=64, visited_cap=1024,
              max_branches=T, dedup=dedup)
    ref = J.explore(system, backend="ref", **kw)
    for backend in ("cuda", "ref"):
        _assert_same_explore(
            P.explore(_port(system), backend=backend, device=CPU, **kw), ref)


@pytest.mark.parametrize("dedup", ["hash", "sort"])
@pytest.mark.parametrize("regime", ["frontier", "visited"])
def test_explore_overflow_runs_match_reference(regime, dedup):
    if regime == "frontier":
        system = J.generators.power_law(40, 3, seed=3)
        kw = dict(max_steps=8, frontier_cap=8, visited_cap=4096,
                  max_branches=8)
    else:
        system = conftest.EQUIV_SYSTEMS["random-16"][0]
        kw = dict(max_steps=8, frontier_cap=32, visited_cap=48,
                  max_branches=32)
    ref = J.explore(system, backend="ref", dedup=dedup, **kw)
    port = P.explore(_port(system), dedup=dedup, device=CPU, **kw)
    assert getattr(ref, f"{regime}_overflow")
    _assert_same_explore(port, ref)


def test_explore_from_init_matches_reference():
    system = J.paper_pi(True)
    kw = dict(max_steps=6, frontier_cap=32, visited_cap=256,
              max_branches=16, init=(3, 0, 2))
    _assert_same_explore(P.explore(_port(system), device=CPU, **kw),
                         J.explore(system, backend="ref", **kw))


def test_dedup_resolution_matches_reference():
    for f, v, t in ((16, 16384, 8), (128, 2048, 16), (512, 16384, 64),
                    (1, 8192, 1), (512, 262144, 64)):
        kw = dict(frontier_cap=f, visited_cap=v, max_branches=t)
        assert P.resolve_dedup("auto", **kw) == J.resolve_dedup("auto", **kw)
    with pytest.raises(ValueError, match="dedup"):
        P.explore(P.paper_pi(True), dedup="bloom", device=CPU)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["paper-pi", "random-17", "power-law-40"])
def test_run_traces_first_matches_reference(name):
    system, T = conftest.EQUIV_SYSTEMS[name]
    seeds = np.arange(5)
    ref = J.run_traces(system, steps=12, seeds=seeds, policy="first",
                       max_branches=T, backend="ref")
    port = P.run_traces(_port(system), steps=12, seeds=seeds,
                        policy="first", max_branches=T, device=CPU)
    for p, j in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    one = P.run_trace(_port(system), steps=12, seed=3, max_branches=T,
                      device=CPU)
    for p, batch in zip(one, port):
        np.testing.assert_array_equal(p.numpy(), batch[3].numpy())


def test_run_traces_policies():
    """Both policies run (random traces equal the reference per seed);
    any other policy raises."""
    ref = J.run_traces(J.paper_pi(True), steps=6, seeds=[0, 9],
                       policy="random", max_branches=16, backend="ref")
    port = P.run_traces(P.paper_pi(True), steps=6, seeds=[0, 9],
                        policy="random", max_branches=16, device=CPU)
    for p, j in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="policy"):
        P.run_traces(P.paper_pi(True), steps=2, seeds=[0], policy="best",
                     device=CPU)


# ---------------------------------------------------------------------------
# the card is the default, and there is no fallback
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = P.paper_pi(True)
    comp = P.compile_system(system, device=CPU)
    calls = [
        lambda: P.explore(system, max_steps=1),
        lambda: P.explore(comp, max_steps=1),
        lambda: P.successor_set(comp, (2, 1, 1)),
        lambda: P.emission_gaps(comp, max_time=2, max_gap=2),
        lambda: P.run_traces(comp, steps=1, seeds=[0]),
        lambda: P.run_trace(comp, steps=1),
        lambda: P.compile_system(system),
        lambda: P.make_table(8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
