"""The port's entry points under ``SystemPlan(semantics="delays")``:

* the hand-built scenarios and the delayed ``paper_pi`` variants of the
  reference's oracle suite (``tests/test_delays_oracle.py``) hold against
  the pure-Python oracle (``tests/oracle.py``) through all four port
  backends;
* ``explore`` archives and flags, ``run_traces`` rows (first and random
  policies, per seed), ``successor_set`` and ``emission_gaps`` equal the
  JAX package's, bit for bit;
* a plan or encoding of the wrong tier raises.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import oracle  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import nd_chain, power_law  # noqa: E402
from repro_torch.core.backend import REFERENCE_NAME  # noqa: E402
from repro_torch.core.convert import (compiled_from_arrays,  # noqa: E402
                                      system_from_spec)

CPU = "cpu"
BACKENDS = sorted(REFERENCE_NAME)


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _enc(backend):
    return "dense" if backend in ("ref", "cuda", "pallas") else "ell"


def _plan(backend, **kw):
    return P.SystemPlan(semantics="delays", encoding=_enc(backend), **kw)


def _jplan(backend, **kw):
    return J.SystemPlan(semantics="delays", encoding=_enc(backend), **kw)


def _rows(res):
    return set(map(tuple, np.asarray(res.configs).tolist()))


def _assert_same_explore(p, j):
    np.testing.assert_array_equal(p.configs, np.asarray(j.configs))
    assert (p.num_discovered, p.steps, p.exhausted) == \
        (j.num_discovered, j.steps, j.exhausted)
    assert (p.branch_overflow, p.frontier_overflow, p.visited_overflow) == \
        (j.branch_overflow, j.frontier_overflow, j.visited_overflow)


# ---------------------------------------------------------------------------
# Hand-built scenarios, expected states written out literally
# ---------------------------------------------------------------------------

def _scenario(name):
    if name == "reopen":
        # n0 fires a d=2 rule: closed for two steps, its spike lands on n1
        # when it reopens — not before, not after
        return J.SNPSystem(
            num_neurons=2, initial_spikes=(1, 0),
            rules=(J.Rule(neuron=0, consume=1, produce=1, regex_base=1,
                          delay=2),),
            synapses=((0, 1),), output_neuron=1, name="reopen"), [
            (0, 0, 2, 0, 1, 0), (0, 0, 1, 0, 1, 0), (0, 1, 0, 0, 0, 0),
            (0, 1, 0, 0, 0, 0)]
    if name == "loss":
        # n1 closes itself (d=3 forgetting rule) in the step n0 spikes at
        # it: the spike is lost
        return J.SNPSystem(
            num_neurons=2, initial_spikes=(2, 1),
            rules=(J.Rule(neuron=0, consume=1, produce=1, regex_base=2),
                   J.Rule(neuron=1, consume=1, produce=0, regex_base=1,
                          delay=3)),
            synapses=((0, 1),), name="loss"), [
            (1, 0, 0, 3, 0, 0), (1, 0, 0, 2, 0, 0), (1, 0, 0, 1, 0, 0),
            (1, 0, 0, 0, 0, 0)]
    # while closed, n0 holds spikes its rule matches but cannot fire; the
    # pending spike lands on the reopen step, and n0 fires again after
    return J.SNPSystem(
        num_neurons=2, initial_spikes=(2, 0),
        rules=(J.Rule(neuron=0, consume=1, produce=1, regex_base=1,
                      regex_period=1, covering=True, delay=2),),
        synapses=((0, 1),), name="suspend"), [
        (1, 0, 2, 0, 1, 0), (1, 0, 1, 0, 1, 0), (1, 1, 0, 0, 0, 0),
        (0, 1, 2, 0, 1, 0)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["reopen", "loss", "suspend"])
def test_hand_built_scenarios_match_oracle(name, backend):
    system, want = _scenario(name)
    states, _ = oracle.run_deterministic(system, len(want))
    assert states == want            # the oracle itself is pinned down
    out = P.run_trace(_port(system), steps=len(want), backend=backend,
                      plan=_plan(backend), device=CPU)
    assert out.configs.tolist() == [list(s) for s in want]


@pytest.mark.parametrize("backend", BACKENDS)
def test_delayed_emissions_match_oracle(backend):
    # the output neuron's spike reaches the environment when it reopens,
    # d steps after firing
    system = J.SNPSystem(
        num_neurons=2, initial_spikes=(1, 1),
        rules=(J.Rule(neuron=0, consume=1, produce=1, regex_base=1),
               J.Rule(neuron=1, consume=1, produce=1, regex_base=1,
                      regex_period=1, delay=2)),
        synapses=((0, 1),), output_neuron=1, name="emit-delayed")
    states, emis = oracle.run_deterministic(system, 6)
    assert emis[0] == 0 and emis[2] == 1
    out = P.run_trace(_port(system), steps=6, backend=backend,
                      plan=_plan(backend), device=CPU)
    assert out.configs.tolist() == [list(s) for s in states]
    assert out.emissions.tolist() == emis


def _pi_variants():
    base = J.paper_pi()
    return [J.with_delays(base, 0), J.with_delays(base, 1),
            J.with_delays(base, lambda k, r: k % 3),
            J.with_delays(base, (2, 0, 1, 0, 3))]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", range(4))
def test_paper_pi_with_delays_matches_oracle(backend, variant):
    system = _pi_variants()[variant]
    want, want_done = oracle.explore(system, max_steps=8)
    # caps well above the 53 states the largest variant reaches, so no
    # overflow can hide a state
    got = P.explore(_port(system), max_steps=8, frontier_cap=64,
                    visited_cap=1024, max_branches=16, backend=backend,
                    plan=_plan(backend), device=CPU)
    assert _rows(got) == want and got.exhausted == want_done
    assert not (got.branch_overflow or got.frontier_overflow
                or got.visited_overflow)


# ---------------------------------------------------------------------------
# Entry points against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", ["hash", "sort"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["paper-pi", "nd-chain-4", "random-17"])
def test_explore_matches_reference(name, backend, dedup):
    system, T = conftest.EQUIV_SYSTEMS[name]
    system = conftest.delayed_variant(system)
    kw = dict(max_steps=6, frontier_cap=32, visited_cap=512,
              max_branches=T, dedup=dedup)
    ref = J.explore(system, backend=REFERENCE_NAME[backend],
                    plan=_jplan(backend), **kw)
    got = P.explore(_port(system), backend=backend, plan=_plan(backend),
                    device=CPU, **kw)
    _assert_same_explore(got, ref)
    assert got.configs.shape[1] == 3 * system.num_neurons


@pytest.mark.parametrize("backend", ["sparse", "sparse_cuda"])
def test_planned_hybrid_explore_matches_reference(backend):
    """A hub-heavy delayed system under its own static plan (hybrid),
    explored with overflow, against the reference's sparse Pallas
    backend (interpret mode)."""
    system = conftest.delayed_variant(power_law(200, 3, seed=0))
    jplan = J.SystemPlan.for_system(system, mode="static",
                                    semantics="delays")
    assert jplan.encoding == "hybrid"
    kw = dict(max_steps=4, frontier_cap=16, visited_cap=256,
              max_branches=16)
    ref = J.explore(system, backend="sparse_pallas", plan=jplan, **kw)
    port = _port(system)
    got = P.explore(port, backend=backend, plan=P.SystemPlan.for_system(
        port, semantics="delays"), device=CPU, **kw)
    _assert_same_explore(got, ref)
    assert got.frontier_overflow or got.branch_overflow


@pytest.mark.parametrize("policy", ["first", "random"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["paper-pi", "power-law-40"])
def test_traces_match_reference(name, backend, policy):
    system, T = conftest.EQUIV_SYSTEMS[name]
    system = conftest.delayed_variant(system)
    seeds = np.array([0, 1, 5, 17, 2 ** 31 + 3, 2 ** 32 - 1])
    extra = dict(hub_threshold=2) if _enc(backend) == "ell" else {}
    enc = "hybrid" if extra else _enc(backend)
    ref = J.run_traces(system, steps=10, seeds=seeds, policy=policy,
                       max_branches=T, backend=REFERENCE_NAME[backend],
                       plan=J.SystemPlan(semantics="delays", encoding=enc,
                                         **extra))
    plan = P.SystemPlan(semantics="delays", encoding=enc, **extra)
    port = P.run_traces(_port(system), steps=10, seeds=seeds, policy=policy,
                        max_branches=T, backend=backend, plan=plan,
                        device=CPU)
    for p, j in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    one = P.run_trace(_port(system), steps=10, seed=int(seeds[3]),
                      policy=policy, max_branches=T, backend=backend,
                      plan=plan, device=CPU)
    for p, batch in zip(one, port):
        np.testing.assert_array_equal(p.numpy(), batch[3].numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_successor_set_matches_reference(backend):
    system, T = conftest.EQUIV_SYSTEMS["nd-chain-4"]
    system = conftest.delayed_variant(system)
    for state in conftest.random_states(system, "delays", 4, seed=9):
        ref = J.successor_set(system, state.tolist(), T,
                              backend=REFERENCE_NAME[backend],
                              plan=_jplan(backend))
        got = P.successor_set(_port(system), state.tolist(), T,
                              backend=backend, plan=_plan(backend),
                              device=CPU)
        assert got == ref
    # a state with more than T successors raises in both packages
    wide = conftest.delayed_variant(nd_chain(8))     # Ψ = 2^8 > T
    state = [1] * 8 + [0] * 16
    with pytest.raises(ValueError, match="branch overflow"):
        J.successor_set(wide, state, T, backend=REFERENCE_NAME[backend],
                        plan=_jplan(backend))
    with pytest.raises(ValueError, match="branch overflow"):
        P.successor_set(_port(wide), state, T, backend=backend,
                        plan=_plan(backend), device=CPU)


@pytest.mark.parametrize("backend", BACKENDS)
def test_emission_gaps_of_a_delayed_encoding_match_reference(backend):
    """The reference's ``emission_gaps`` takes no plan but accepts a
    delayed compiled encoding; the port accepts that and a delayed plan,
    with equal results."""
    system = J.with_delays(J.paper_pi(), lambda k, r: k % 3)
    jref = J.compile_system(system, semantics="delays") \
        if _enc(backend) == "dense" \
        else J.compile_system_sparse(system, semantics="delays")
    want = J.emission_gaps(jref, max_time=14, max_gap=8,
                           backend=REFERENCE_NAME[backend])
    fields = {k: (v if k == "rule_order" or v is None else np.asarray(v))
              for k, v in jref._asdict().items()}
    comp = compiled_from_arrays(fields, device=CPU)
    assert P.emission_gaps(comp, max_time=14, max_gap=8, backend=backend,
                           device=CPU) == want
    assert P.emission_gaps(_port(system), max_time=14, max_gap=8,
                           backend=backend, plan=_plan(backend),
                           device=CPU) == want
    assert want                     # the delayed Π still emits twice


def test_wrong_tier_plans_and_encodings_raise():
    system = _port(conftest.delayed_variant(J.paper_pi()))
    for backend in BACKENDS:
        with pytest.raises(ValueError, match="delay"):
            P.run_traces(system, steps=2, seeds=[0], backend=backend,
                         plan=P.SystemPlan(encoding=_enc(backend)),
                         device=CPU)
        comp = P.get_backend(backend).compile(system, _plan(backend),
                                              device=CPU)
        with pytest.raises(ValueError, match="semantics"):
            P.explore(comp, backend=backend, max_steps=1, device=CPU,
                      plan=P.SystemPlan(encoding=_enc(backend)))
    free = P.compile_system(P.paper_pi(), device=CPU)
    with pytest.raises(ValueError, match="semantics"):
        P.explore(free, backend="ref", max_steps=1, device=CPU,
                  plan=P.SystemPlan(semantics="delays"))
    # each backend realizes its encodings under both tiers, but for the
    # neuron-sharded one, which is delay-free only (as in the reference)
    for name in BACKENDS:
        be = P.get_backend(name)
        assert "sharded" in be.supported_encodings()
        assert be.supported_encodings(semantics="delays") == tuple(
            e for e in be.supported_encodings() if e != "sharded")
