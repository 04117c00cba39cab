"""The port's failure-domain primitives against the JAX package's:
``FaultPolicy`` (validation, ``backoff_s``), ``FaultInjector`` (which call
ordinals fire), ``run_supervised``, the degrade chain
(``degrade_candidates`` over the conftest lowering matrix, mapped through
``REFERENCE_NAME``; ``run_with_failover``'s three contracts) and
``resolve_entry_info``'s ``planned`` flag.  Everything is integer or
exact, so the two packages agree exactly."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro.core.backend as J_backend  # noqa: E402
import repro.runtime.faults as J_faults  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime.faults as P_faults  # noqa: E402
from repro.core import failover as J_failover  # noqa: E402
from repro_torch.core import failover as P_failover  # noqa: E402
from repro_torch.core.backend import REFERENCE_NAME  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402

PORT_NAME = {v: k for k, v in REFERENCE_NAME.items()}
CPU = "cpu"
PI = J.paper_pi(True)
PI_PORT = system_from_spec(dataclasses.asdict(PI))


@pytest.fixture(autouse=True)
def _fresh_warn_state():
    """Degradation warns once per edge per process: reset both packages so
    every test sees its own first warning, whatever ran before it on the
    worker."""
    for mod in (J_failover, P_failover):
        mod._WARNED.clear()
    yield
    for mod in (J_failover, P_failover):
        mod._WARNED.clear()


# ---------------------------------------------------------------------------
# FaultPolicy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(max_retries=-1), dict(backoff_factor=0.5), dict(backoff_ms=-1.0),
    dict(jitter=-0.1)], ids=lambda kw: next(iter(kw)))
def test_policy_validation_matches(kw):
    for mod in (J_faults, P_faults):
        with pytest.raises(ValueError):
            mod.FaultPolicy(**kw)


def test_policy_defaults_match():
    assert dataclasses.asdict(P_faults.FaultPolicy()) == \
        dataclasses.asdict(J_faults.FaultPolicy())


@pytest.mark.parametrize("pol", [
    dict(), dict(backoff_ms=4.0, jitter=0.0),
    dict(backoff_ms=7.5, backoff_factor=3.0, jitter=0.5)],
    ids=["default", "no-jitter", "steep"])
def test_backoff_equals_reference_on_a_grid(pol):
    p, j = P_faults.FaultPolicy(**pol), J_faults.FaultPolicy(**pol)
    for attempt in range(6):
        for token in (0, 1, 7, 255, "other", (3, 4)):
            assert p.backoff_s(attempt, token) == j.backoff_s(attempt, token)


def _outcomes(inj, calls):
    out = []
    for seeds in calls:
        try:
            out.append(inj.on_device_call(seeds=seeds))
        except Exception as e:
            out.append(type(e).__name__)
    return out, inj.injected, inj.calls


@pytest.mark.parametrize("schedule", [
    dict(fail_calls=(2,), poison_seeds=(9,)),
    dict(fail_calls=(1, 3, 4), poison_seeds=(5, 17)),
    dict(fail_calls=(1,), poison_seeds=(9,)),
    dict(slow_calls={2: 0.0}, poison_seeds=(3,))],
    ids=["transient-2", "mixed", "transient-masks-poison", "slow"])
def test_injector_fires_on_the_same_calls(schedule):
    calls = [[1, 2], [1, 2], [9], [1, 9], [5, 6], [17], [0, 0], [3], [9],
             None, [9]]
    assert _outcomes(P_faults.FaultInjector(**schedule), calls) == \
        _outcomes(J_faults.FaultInjector(**schedule), calls)


def test_injector_compile_schedule_and_padding_seed():
    p = P_faults.FaultInjector(fail_compiles=(2,))
    j = J_faults.FaultInjector(fail_compiles=(2,))
    for inj in (p, j):
        assert inj.on_compile() == 1
        with pytest.raises(P_faults.InjectedFault if inj is p
                           else J_faults.InjectedFault):
            inj.on_compile()
        assert inj.on_compile() == 3
    with pytest.raises(ValueError, match="padding"):
        P_faults.FaultInjector(poison_seeds=(0,))


def test_injector_runner_counts_every_call():
    seen = []
    inj = P_faults.FaultInjector(poison_seeds=(4,))
    run = inj.runner(lambda comp, *, seeds, **kw: seen.append(list(seeds)))
    run(None, seeds=[1, 2])
    with pytest.raises(P_faults.PoisonError):
        run(None, seeds=[4])
    assert seen == [[1, 2]] and inj.calls == 2


@pytest.mark.parametrize("fail_first", [0, 2, 3, 5])
def test_run_supervised_bound_and_chaining(fail_first):
    def supervise(mod):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) <= fail_first:
                raise RuntimeError(f"boom {len(calls)}")
            return "done"

        try:
            out, restarts = mod.run_supervised(flaky, max_restarts=3)
            return out, restarts, len(calls)
        except RuntimeError as e:
            return str(e), str(e.__cause__), len(calls)

    assert supervise(P_faults) == supervise(J_faults)


def test_run_supervised_passes_non_restartable():
    def boom():
        raise KeyError("not restartable")

    with pytest.raises(KeyError):
        P_faults.run_supervised(boom, restartable=(RuntimeError,))


# ---------------------------------------------------------------------------
# the degrade chain
# ---------------------------------------------------------------------------

def _matrix():
    """The conftest lowering matrix's (backend, plan) cells, and the
    ``"auto"`` encoding of each backend and tier, over 1 and 2 shards."""
    cells = [p.values[0] for p in conftest.lowering_cells()]
    cells += [(name, J.SystemPlan(semantics=sem))
              for sem in conftest.SEMANTICS
              for name in sorted(J.available_backends())]
    out = []
    for name, plan in cells:
        for shards in (1, 2):
            tag = (f"{plan.semantics}-{name}-{plan.encoding}"
                   f"-h{plan.hub_threshold}-s{shards}")
            out.append(pytest.param(
                name, dataclasses.replace(plan, num_shards=shards), id=tag))
    return out


@pytest.mark.parametrize("ref_name,ref_plan", _matrix())
def test_degrade_candidates_equal_reference(ref_name, ref_plan):
    port_plan = P.SystemPlan(
        encoding=ref_plan.encoding, hub_threshold=ref_plan.hub_threshold,
        semantics=ref_plan.semantics, num_shards=ref_plan.num_shards)
    want = [(be.name, plan.backend) for be, plan in
            J_failover.degrade_candidates(J.get_backend(ref_name), ref_plan)]
    got = P_failover.degrade_candidates(
        P.get_backend(PORT_NAME[ref_name]), port_plan, device=CPU)
    assert [(REFERENCE_NAME[be.name], REFERENCE_NAME[plan.backend])
            for be, plan in got] == want
    for _, plan in got:     # only the backend is re-pinned
        assert dataclasses.replace(plan, backend=None) == port_plan


@pytest.mark.parametrize("ref_name,ref_plan", _matrix())
@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_degrade_candidates_on_the_card_are_kernels(ref_name, ref_plan,
                                                    device):
    """On the card the chain keeps to the kernel backends: it is the CPU
    chain without ``"sparse"`` and ``"ref"`` (no card is touched)."""
    port_plan = P.SystemPlan(
        encoding=ref_plan.encoding, hub_threshold=ref_plan.hub_threshold,
        semantics=ref_plan.semantics, num_shards=ref_plan.num_shards)
    be = P.get_backend(PORT_NAME[ref_name])
    on_cpu = [c.name for c, _ in P_failover.degrade_candidates(
        be, port_plan, device=CPU)]
    got = [c.name for c, _ in P_failover.degrade_candidates(
        be, port_plan, device=device)]
    assert got == [n for n in on_cpu if n in P_failover.KERNEL_BACKENDS]


@pytest.mark.parametrize("device", [None, "cuda"])
def test_no_plain_fallback_on_the_card(device):
    assert P_failover.KERNEL_BACKENDS == ("sparse_cuda", "cuda")
    for top, enc in (("cuda", "dense"), ("cuda", "auto"),
                     ("sparse_cuda", "ell"), ("sparse_cuda", "hybrid")):
        assert P_failover.degrade_candidates(
            P.get_backend(top), P.SystemPlan(encoding=enc),
            device=device) == []
    assert [c.name for c, _ in P_failover.degrade_candidates(
        P.get_backend("sparse_cuda"), P.SystemPlan(), device=device)] == \
        ["cuda"]
    # a failing "cuda" raises its own failure and records nothing
    events, tried = [], []

    def attempt(be, plan):
        tried.append(be.name)
        raise RuntimeError(f"{be.name} did not build")

    P_failover.add_degrade_listener(events.append)
    try:
        with pytest.raises(RuntimeError, match="cuda did not build"):
            P_failover.run_with_failover(
                attempt, P.get_backend("cuda"), P.SystemPlan(),
                degradable=True, device=device)
    finally:
        P_failover.remove_degrade_listener(events.append)
    assert tried == ["cuda"] and events == []


def test_degrade_order_is_the_reference_chain():
    assert tuple(REFERENCE_NAME[n] for n in P_failover.DEGRADE_ORDER) == \
        J_failover.DEGRADE_ORDER


def _walk(failover, get_backend, top, plan, fail, **kw):
    """Run the chain from ``top``, failing the backends in ``fail``;
    returns (result, tried, events)."""
    events, tried = [], []
    failover.add_degrade_listener(events.append)
    try:
        def attempt(be, p):
            tried.append(be.name)
            if be.name in fail:
                raise RuntimeError(f"{be.name} exploded")
            return be.name

        with pytest.warns(RuntimeWarning, match="degrading"):
            got = failover.run_with_failover(
                attempt, get_backend(top), plan, degradable=True, **kw)
    finally:
        failover.remove_degrade_listener(events.append)
    return got, tried, [(e.from_backend, e.to_backend, e.stage)
                        for e in events]


@pytest.mark.parametrize("top,encoding,fail", [
    ("sparse_cuda", "ell", ("sparse_cuda",)),
    ("sparse_cuda", "auto", ("sparse_cuda", "cuda")),
    ("cuda", "dense", ("cuda",)),
    ("cuda", "auto", ("cuda", "sparse"))])
def test_run_with_failover_walks_the_chain_as_the_reference(top, encoding,
                                                            fail):
    got = _walk(P_failover, P.get_backend, top, P.SystemPlan(
        encoding=encoding), fail, device=CPU)
    want = _walk(J_failover, J.get_backend, REFERENCE_NAME[top],
                 J.SystemPlan(encoding=encoding),
                 tuple(REFERENCE_NAME[f] for f in fail))
    ref = lambda n: REFERENCE_NAME[n]  # noqa: E731
    assert (ref(got[0]), [ref(n) for n in got[1]],
            [(ref(a), ref(b), s) for a, b, s in got[2]]) == want


def test_run_with_failover_never_degrades_injected_faults():
    def attempt(be, plan):
        raise P_faults.InjectedFault("node lost")

    with pytest.raises(P_faults.InjectedFault):
        P_failover.run_with_failover(
            attempt, P.get_backend("sparse_cuda"), P.SystemPlan(),
            degradable=True)


def test_run_with_failover_passthrough_when_not_degradable():
    tried = []

    def attempt(be, plan):
        tried.append(be.name)
        raise RuntimeError("explicit backend failure")

    with pytest.raises(RuntimeError, match="explicit"):
        P_failover.run_with_failover(
            attempt, P.get_backend("sparse_cuda"), P.SystemPlan(),
            degradable=False)
    assert tried == ["sparse_cuda"]


def test_exhausted_chain_raises_the_first_failure():
    tried = []

    def attempt(be, plan):
        tried.append(be.name)
        raise RuntimeError(f"{be.name} failed")

    with pytest.warns(RuntimeWarning):
        with pytest.raises(RuntimeError, match="sparse_cuda failed"):
            P_failover.run_with_failover(
                attempt, P.get_backend("sparse_cuda"),
                P.SystemPlan(encoding="ell"), degradable=True, device=CPU)
    assert tried == ["sparse_cuda", "sparse"]


@pytest.mark.parametrize("error", [
    ValueError("checkpoint_every must be >= 1"),
    TypeError("bad argument"), OSError("disk full"),
    torch.cuda.OutOfMemoryError("out of memory"),
    P_faults.PoisonError("poisoned")])
def test_caller_errors_are_never_degraded(error):
    """Only a backend's failure to build, lower or launch (a
    RuntimeError) degrades: the caller's errors, running out of memory
    and injected faults raise at once."""
    assert not P_failover.is_backend_failure(error)
    tried = []

    def attempt(be, plan):
        tried.append(be.name)
        raise error

    with pytest.raises(type(error)):
        P_failover.run_with_failover(
            attempt, P.get_backend("cuda"), P.SystemPlan(),
            degradable=True, device=CPU)
    assert tried == ["cuda"]


def test_warns_once_per_edge_but_always_notifies():
    events = []
    P_failover.add_degrade_listener(events.append)
    try:
        with pytest.warns(RuntimeWarning):
            P_failover.record_degradation("cuda", "sparse", "run",
                                          RuntimeError("a"))
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            P_failover.record_degradation("cuda", "sparse", "run",
                                          RuntimeError("b"))
    finally:
        P_failover.remove_degrade_listener(events.append)
    assert [e.error for e in events] == ["RuntimeError('a')",
                                         "RuntimeError('b')"]


# ---------------------------------------------------------------------------
# the planned flag, the plan's mode
# ---------------------------------------------------------------------------

def _systems():
    return {"system": (PI_PORT, PI),
            "dense": (P.compile_system(PI_PORT, device="cpu"),
                      J.compile_system(PI)),
            "sparse": (P.compile_system_sparse(PI_PORT, device="cpu"),
                       J.compile_system_sparse(PI))}


PLANS = {
    "none": None, "default": dict(), "backend-ref": dict(backend="ref"),
    "static": dict(mode="static"), "ell": dict(encoding="ell"),
    "hybrid": dict(encoding="hybrid"), "delays": dict(semantics="delays"),
    "two-shards": dict(num_shards=2)}


@pytest.mark.parametrize("backend", [None, "ref", "cuda"])
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("system", ["system", "dense", "sparse"])
def test_planned_flag_equals_reference(system, plan, backend, tmp_path,
                                       monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    port_sys, ref_sys = _systems()[system]
    kw = PLANS[plan]
    port_plan = None if kw is None else P.SystemPlan(**kw)
    ref_plan = None if kw is None else J.SystemPlan(**kw)
    be, got_plan, planned = P.resolve_entry_info(port_sys, backend,
                                                 port_plan)
    _, _, want = J_backend.resolve_entry_info(
        ref_sys, None if backend is None else REFERENCE_NAME[backend],
        ref_plan, workload=(4, 8))
    assert planned is want
    assert be is P.resolve_entry(port_sys, backend, port_plan)
    if planned:     # the chosen backend pinned into the plan
        assert got_plan.backend == be.name
    else:
        assert got_plan is port_plan


def test_plan_backend_pins_and_mode_measure_raises(tmp_path, monkeypatch):
    be, _, planned = P.resolve_entry_info(
        PI_PORT, None, P.SystemPlan(backend="sparse"))
    assert be.name == "sparse" and planned is False
    # the planner is ported: mode="measure" is accepted, as the
    # reference's is, and for_system times the candidates
    assert P.SystemPlan(mode="measure").mode == "measure"
    J.SystemPlan(mode="measure")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    plan = P.SystemPlan.for_system(PI_PORT, workload=(4, 8), mode="measure",
                                   device="cpu")
    sig = P.autotune.signature_of(PI_PORT, workload=(4, 8))
    candidates = P.autotune.default_candidates(sig, device="cpu")
    assert plan.mode == "measure"
    assert plan.backend in {c.backend for c in candidates}
    with pytest.raises(ValueError, match="unknown mode"):
        P.SystemPlan(mode="fastest")


def test_lower_with_backend_lowers_under_the_plan():
    comp = P.compile_system_sparse(PI_PORT, device="cpu")
    assert P.lower_with_backend(P.get_backend("sparse"), comp, None) is comp
    seen = []

    class Recording:
        name = "recording"

        def lower(self, compiled, plan):
            seen.append(plan)
            return compiled

    plan = P.SystemPlan(encoding="ell")
    for given, want in ((None, P.SystemPlan()), (plan, plan)):
        assert P.lower_with_backend(Recording(), comp, given) is comp
        assert seen.pop() == want
