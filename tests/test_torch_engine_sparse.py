"""The port's engine on the sparse encodings and with random traces,
against the reference:

* ``explore`` archives equal the reference's ``explore(backend="sparse" |
  "sparse_pallas", plan=...)`` row for row, with equal flags, for ELL,
  hybrid and planned encodings, through both port sparse backends;
* ``run_traces(policy="random")`` equals the reference's per seed through
  all four port backends, and ``run_trace`` equals row b of the batch;
* ``resolve_entry`` and the backends' lowering refuse or pick as
  documented.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import power_law  # noqa: E402
from repro_torch.core.backend import REFERENCE_NAME  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402

CPU = "cpu"

PLANS = {"ell": dict(encoding="ell"),
         "hybrid-h1": dict(encoding="hybrid", hub_threshold=1),
         "hybrid-auto": dict(encoding="hybrid")}


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _assert_same_explore(p, j):
    np.testing.assert_array_equal(p.configs, np.asarray(j.configs))
    assert (p.num_discovered, p.steps, p.exhausted) == \
        (j.num_discovered, j.steps, j.exhausted)
    assert (p.branch_overflow, p.frontier_overflow, p.visited_overflow) == \
        (j.branch_overflow, j.frontier_overflow, j.visited_overflow)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_sparse_explore_matches_reference(name, plan):
    system, T = conftest.EQUIV_SYSTEMS[name]
    kw = dict(max_steps=6, frontier_cap=64, visited_cap=1024,
              max_branches=T)
    ref = J.explore(system, backend="sparse", plan=J.SystemPlan(
        **PLANS[plan]), **kw)
    for backend in ("sparse_cuda", "sparse"):
        got = P.explore(_port(system), backend=backend,
                        plan=P.SystemPlan(**PLANS[plan]), device=CPU, **kw)
        _assert_same_explore(got, ref)


@pytest.mark.parametrize("dedup", ["hash", "sort"])
def test_planned_hybrid_explore_matches_sparse_pallas(dedup):
    """A hub-heavy system under its own static plan (hybrid), explored
    with overflow through the port's kernel backend, against the
    reference's Pallas kernel backend (interpret mode)."""
    system = power_law(400, 3, seed=0)
    jplan = J.SystemPlan.for_system(system, mode="static")
    assert jplan.encoding == "hybrid"
    kw = dict(max_steps=5, frontier_cap=16, visited_cap=256,
              max_branches=16, dedup=dedup)
    ref = J.explore(system, backend="sparse_pallas", plan=jplan, **kw)
    port_system = _port(system)
    got = P.explore(port_system, backend="sparse_cuda",
                    plan=P.SystemPlan.for_system(port_system), device=CPU,
                    **kw)
    _assert_same_explore(got, ref)
    assert got.frontier_overflow or got.branch_overflow


def test_precompiled_sparse_encoding_explores_like_the_system():
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    kw = dict(max_steps=5, frontier_cap=32, visited_cap=512, max_branches=T)
    comp = P.compile_system_sparse(_port(system), hub_threshold=2,
                                   device=CPU)
    ref = J.explore(system, backend="sparse",
                    plan=J.SystemPlan(encoding="hybrid", hub_threshold=2),
                    **kw)
    # no backend named: a sparse encoding resolves to "sparse_cuda"
    _assert_same_explore(P.explore(comp, device=CPU, **kw), ref)


@pytest.mark.parametrize("backend", sorted(REFERENCE_NAME))
@pytest.mark.parametrize("name", ["paper-pi", "power-law-40",
                                  "random-17"])
def test_random_traces_match_reference(name, backend):
    system, T = conftest.EQUIV_SYSTEMS[name]
    seeds = np.array([0, 1, 5, 17, 2 ** 31 + 3, 2 ** 32 - 1])
    plan = dict(encoding="hybrid", hub_threshold=2) \
        if backend.startswith("sparse") else {}
    ref = J.run_traces(system, steps=10, seeds=seeds, policy="random",
                       max_branches=T, backend=REFERENCE_NAME[backend],
                       plan=J.SystemPlan(**plan))
    port = P.run_traces(_port(system), steps=10, seeds=seeds,
                        policy="random", max_branches=T, backend=backend,
                        plan=P.SystemPlan(**plan), device=CPU)
    for p, j in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    one = P.run_trace(_port(system), steps=10, seed=int(seeds[2]),
                      policy="random", max_branches=T, backend=backend,
                      plan=P.SystemPlan(**plan), device=CPU)
    for p, batch in zip(one, port):
        np.testing.assert_array_equal(p.numpy(), batch[2].numpy())


def test_random_traces_differ_across_seeds_and_stay_valid():
    system, T = conftest.EQUIV_SYSTEMS["nd-chain-4"]
    out = P.run_traces(_port(system), steps=3, seeds=range(32),
                       policy="random", max_branches=T, device=CPU)
    assert len({tuple(r.reshape(-1).tolist()) for r in out.configs}) > 1
    first = P.run_traces(_port(system), steps=3, seeds=range(4),
                         policy="first", max_branches=T, device=CPU)
    assert len({tuple(r.reshape(-1).tolist()) for r in first.configs}) == 1


def test_resolve_entry_picks_as_documented():
    system = P.paper_pi(True)
    sparse = P.compile_system_sparse(system, device=CPU)
    pick = P.resolve_entry
    assert pick(system, "ref", None).name == "ref"
    assert pick(system, None, None).name == "cuda"
    assert pick(system, "sparse", P.SystemPlan(encoding="ell")).name == \
        "sparse"
    assert pick(sparse, None, None).name == "sparse_cuda"
    for enc in ("ell", "hybrid"):
        assert pick(system, None, P.SystemPlan(encoding=enc)).name == \
            "sparse_cuda"
    assert pick(system, None, P.SystemPlan(encoding="dense")).name == "cuda"
    with pytest.raises(ValueError, match="unknown step backend"):
        pick(system, "pallas", None)


@pytest.mark.parametrize("backend,encoding", [
    ("ref", "ell"), ("cuda", "hybrid"), ("sparse", "dense"),
    ("sparse_cuda", "dense")])
def test_backends_refuse_plans_they_cannot_realize(backend, encoding):
    with pytest.raises(ValueError, match="cannot realize"):
        P.explore(P.paper_pi(True), backend=backend,
                  plan=P.SystemPlan(encoding=encoding), max_steps=1,
                  device=CPU)


def test_backends_refuse_a_foreign_encoding():
    dense = P.compile_system(P.paper_pi(True), device=CPU)
    sparse = P.compile_system_sparse(P.paper_pi(True), device=CPU)
    for name, comp in (("sparse", dense), ("sparse_cuda", dense),
                       ("ref", sparse), ("cuda", sparse)):
        with pytest.raises(TypeError, match="needs a Compiled"):
            P.get_backend(name).expand(comp.init_config[None], comp, 4)


def test_sparse_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = P.paper_pi(True)
    plan = P.SystemPlan(encoding="hybrid", hub_threshold=1)
    for call in (
            lambda: P.explore(system, plan=plan, max_steps=1),
            lambda: P.run_traces(system, steps=1, seeds=[0],
                                 policy="random", plan=plan),
            lambda: P.compile_system_sparse(system)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
