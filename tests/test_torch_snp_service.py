"""The port's SNP trace service against the JAX package's.

* The same requests (the paper's Π and a hybrid ``power_law(40)``, both
  branch policies, mixed step counts) give per-ticket ``configs``,
  ``emissions``, ``alive`` and ``branch_overflow`` equal to the
  reference service's, and equal ``stats()``.
* Under the same ``FaultInjector`` schedule and ``FaultPolicy`` — a
  transient failure, a poison seed, expired deadlines, admission control,
  exhausted retries, a degrading flaky runner — the two services serve and
  fail the same tickets, with the same exception types and ``stats()``.
* Async results equal sync ones; the contracts of the reference's
  ``tests/test_serve_async.py`` (its two mesh cases over the port's mesh
  runner, ``make_trace_runner(mesh=trace_mesh(["cpu"] * 3))``) and the
  service cases of ``tests/test_faults.py`` hold for the port; over the
  mesh runner the fault scenarios and a degradation give the reference's
  default runner's results and stats.
* The smoke run's fault schedule (``chip_smoke.FAULT_STATS``) is what both
  services give on the CPU.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import repro.core as J  # noqa: E402
import repro.runtime.faults as J_faults  # noqa: E402
import repro.serve as J_serve  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime.faults as P_faults  # noqa: E402
from repro.core import failover as J_failover  # noqa: E402
from repro.core.generators import (nd_chain, power_law,  # noqa: E402
                                   random_system)
from repro_torch.core import failover as P_failover  # noqa: E402
from repro_torch.core.backend import REFERENCE_NAME  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.serve import (SNPTraceService, TraceRequest,  # noqa: E402
                               make_trace_runner)
from repro_torch.sharding import trace_mesh  # noqa: E402

CPU = "cpu"
TIMEOUT = 120
PI = J.paper_pi(True)
HYBRID = power_law(40, 3, seed=3)


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


PI_PORT = _port(PI)


@pytest.fixture(autouse=True)
def _fresh_warn_state():
    for mod in (J_failover, P_failover):
        mod._WARNED.clear()
    yield
    for mod in (J_failover, P_failover):
        mod._WARNED.clear()


def _svc(**kw):
    return SNPTraceService(device=CPU, **kw)


def _systems(kind):
    """(port system, reference system) — the hybrid pair compiled by each
    package at hub threshold 4, so requests carry the encoding."""
    if kind == "pi":
        return PI_PORT, PI
    return (P.compile_system_sparse(_port(HYBRID), hub_threshold=4,
                                    device=CPU),
            J.compile_system_sparse(HYBRID, hub_threshold=4))


# (steps, policy, seed, max_branches): mixed steps, both policies
SPECS = [(5, "random", 7, 64), (11, "random", 9, 64), (6, "first", 0, 64),
         (1, "random", 3, 64), (13, "random", 21, 64), (4, "first", 5, 2),
         (7, "random", 4, 2), (9, "random", 30, 64), (3, "random", 8, 64)]


def _serve_both(kind, port_kw, ref_kw, specs=SPECS, port_runner=None,
                ref_runner=None, warns=False):
    """Drain the same requests through both services; returns
    ``(port, reference)`` as (results by index, failure types by index,
    stats)."""
    psys, rsys = _systems(kind)
    out = []
    for svc, mk, system in (
            (_svc(runner=port_runner, **port_kw), TraceRequest, psys),
            (J_serve.SNPTraceService(runner=ref_runner, **ref_kw),
             J_serve.TraceRequest, rsys)):
        tickets = []
        for steps, policy, seed, T in specs:
            try:
                tickets.append(svc.submit(mk(system, steps=steps,
                                             policy=policy, seed=seed,
                                             max_branches=T)))
            except Exception as e:
                tickets.append(type(e).__name__)
        time.sleep(0.002)       # past a zero-millisecond deadline
        if warns:
            with pytest.warns(RuntimeWarning, match="degrading"):
                res = svc.drain()
        else:
            res = svc.drain()
        got = {i: res[t] for i, t in enumerate(tickets) if t in res}
        fails = {i: (t if isinstance(t, str)
                     else type(svc.last_failures[t]).__name__)
                 for i, t in enumerate(tickets) if t not in res}
        out.append((got, fails, svc.stats()))
    return out


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for i in want:
        for f in ("configs", "emissions", "alive", "branch_overflow"):
            np.testing.assert_array_equal(
                getattr(got[i], f), np.asarray(getattr(want[i], f)),
                err_msg=f"request {i}, {f}")


@pytest.mark.parametrize("kind,port_backend,ref_backend", [
    ("pi", "ref", "ref"), ("pi", "cuda", "ref"),
    ("hybrid", "sparse", "sparse"), ("hybrid", "sparse_cuda", "sparse")])
def test_results_and_stats_equal_reference(kind, port_backend,
                                           ref_backend):
    (pg, pf, ps), (rg, rf, rs) = _serve_both(
        kind, dict(batch_size=4, step_bucket=8, backend=port_backend),
        dict(batch_size=4, step_bucket=8, backend=ref_backend))
    _assert_results_equal(pg, rg)
    assert pf == rf == {}
    assert ps == rs
    assert ps["branch_overflow_traces"] > 0     # max_branches=2 truncates


def _policies(**kw):
    return P_faults.FaultPolicy(**kw), J_faults.FaultPolicy(**kw)


def _injectors(**kw):
    return P_faults.FaultInjector(**kw), J_faults.FaultInjector(**kw)


SCENARIOS = {
    "transient": (dict(max_retries=2, backoff_ms=0.0),
                  dict(fail_calls=(1, 3))),
    "poison": (dict(max_retries=1, backoff_ms=0.0),
               dict(fail_calls=(2,), poison_seeds=(9,))),
    "poison-no-bisect": (dict(max_retries=0, backoff_ms=0.0, bisect=False),
                         dict(poison_seeds=(21,))),
    "exhausted": (dict(max_retries=1, backoff_ms=0.0, bisect=False,
                       degrade=False), dict(fail_calls=(1, 2, 3))),
    "admission": (dict(max_pending=5), {}),
    "compile-fault": (dict(max_retries=0), dict(fail_compiles=(1,))),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("kind", ["pi", "hybrid"])
def test_stats_equal_reference_under_faults(kind, scenario):
    pol, inj = SCENARIOS[scenario]
    (pp, rp), (pi, ri) = _policies(**pol), _injectors(**inj)
    backend = "ref" if kind == "pi" else "sparse"
    (pg, pf, ps), (rg, rf, rs) = _serve_both(
        kind, dict(batch_size=4, step_bucket=8, backend=backend, policy=pp,
                   fault_injector=pi),
        dict(batch_size=4, step_bucket=8, backend=backend, policy=rp,
             fault_injector=ri))
    _assert_results_equal(pg, rg)
    assert pf == rf
    assert ps == rs
    assert pi.calls == ri.calls and pi.injected == ri.injected


def test_deadlines_equal_reference():
    pp, rp = _policies(deadline_ms=0.0)
    specs = [(4, "random", s, 64) for s in range(1, 7)]
    (pg, pf, ps), (rg, rf, rs) = _serve_both(
        "pi", dict(batch_size=4, backend="ref", policy=pp),
        dict(batch_size=4, backend="ref", policy=rp), specs=specs)
    assert pg == rg == {}
    assert pf == rf == {i: "DeadlineExceeded" for i in range(6)}
    assert ps == rs and ps["deadline_exceeded"] == 6


def _flaky(served, run_traces, get_backend, broken, tag, error=None):
    def runner(comp, *, backend=None, **kw):
        be = get_backend(backend)
        if be.name == broken:
            raise error or RuntimeError("kernel exploded")
        served[tag].append(be.name)
        return run_traces(comp, backend=be, **kw)
    return runner


def test_degrade_with_a_flaky_runner_equals_reference():
    """The port's service degrades the backend it chose itself
    (``backend=None``: ``"cuda"``) as the reference's degrades its
    ``"pallas"``: the same stats, results and chain (here on the CPU; on
    the card ``"cuda"`` has no fallback)."""
    served = {"port": [], "reference": []}
    pp, rp = _policies(max_retries=1, backoff_ms=0.0, bisect=False)
    events = []
    P_failover.add_degrade_listener(events.append)
    try:
        (pg, pf, ps), (rg, rf, rs) = _serve_both(
            "pi", dict(batch_size=4, policy=pp),
            dict(batch_size=4, backend="pallas", policy=rp),
            port_runner=_flaky(served, P.run_traces, P.get_backend, "cuda",
                               "port"),
            ref_runner=_flaky(served, J.run_traces, J.get_backend, "pallas",
                              "reference"),
            warns=True)
    finally:
        P_failover.remove_degrade_listener(events.append)
    _assert_results_equal(pg, rg)
    assert pf == rf == {}
    chunks = ps["device_calls"]         # one a group and full chunk
    assert ps == rs and ps["degraded"] == chunks == 5
    fallback = REFERENCE_NAME[served["reference"][0]]
    assert served["port"] == [fallback] * chunks
    assert served["reference"] == [REFERENCE_NAME[fallback]] * chunks
    assert [(e.from_backend, e.to_backend, e.stage) for e in events] == \
        [("cuda", fallback, "serve")] * chunks


@pytest.mark.parametrize("kind,backend,error", [
    ("hybrid", "sparse_cuda", None), ("pi", "cuda", None),
    ("pi", None, ValueError("a caller's error"))])
def test_named_backends_and_caller_errors_never_degrade(kind, backend,
                                                        error):
    """A backend the caller names raises its failure into the requests,
    and so does an error that is not a backend failure, even on the
    service's own choice: no degradation, every request failed."""
    served = {"port": []}
    svc = _svc(batch_size=4, backend=backend,
               policy=P_faults.FaultPolicy(max_retries=1, backoff_ms=0.0),
               runner=_flaky(served, P.run_traces, P.get_backend,
                             backend or "cuda", "port", error))
    assert svc.degradable is (backend is None)
    system = _systems(kind)[0]
    events = []
    P_failover.add_degrade_listener(events.append)
    try:
        tickets = [svc.submit(TraceRequest(system, steps=4, policy="random",
                                           seed=s)) for s in range(6)]
        got = svc.drain()
    finally:
        P_failover.remove_degrade_listener(events.append)
    want = type(error) if error else RuntimeError
    assert got == {} and served["port"] == [] and events == []
    assert sorted(svc.last_failures) == tickets
    assert all(type(e) is want for e in svc.last_failures.values())
    assert svc.stats()["degraded"] == 0


def test_smoke_fault_schedule_prediction():
    """The smoke's fault run (1,024 random traces in chunks of 256, ``fail=2
    poison=17``, one retry, no backoff) on the CPU: both services give
    ``chip_smoke.FAULT_STATS`` and fail only seed 17, with PoisonError."""
    n, steps = chip_smoke.FAULT_RUN["requests"], 4
    specs = [(steps, "random", s, 64) for s in range(n)]
    pp, rp = _policies(**chip_smoke.FAULT_RUN["policy"])
    pi, ri = _injectors(**chip_smoke.FAULT_RUN["inject"])
    batch = chip_smoke.FAULT_RUN["batch"]
    (pg, pf, ps), (rg, rf, rs) = _serve_both(
        "pi", dict(batch_size=batch, backend="ref", policy=pp,
                   fault_injector=pi),
        dict(batch_size=batch, backend="ref", policy=rp,
             fault_injector=ri), specs=specs)
    _assert_results_equal(pg, rg)
    assert pf == rf == {17: "PoisonError"}
    assert ps == rs
    assert {k: ps[k] for k in chip_smoke.FAULT_STATS} == \
        chip_smoke.FAULT_STATS


# ---------------------------------------------------------------------------
# async == sync, and the async contracts
# ---------------------------------------------------------------------------

def _mixed_requests():
    chain = _port(nd_chain(4))
    return [
        TraceRequest(PI_PORT, steps=5, policy="random", seed=7),
        TraceRequest(PI_PORT, steps=11, policy="random", seed=9),
        TraceRequest(PI_PORT, steps=6, policy="first"),
        TraceRequest(chain, steps=4, policy="random", seed=1,
                     max_branches=32),
    ]


def _assert_result_equal(a, b):
    np.testing.assert_array_equal(a.configs, np.asarray(b.configs))
    np.testing.assert_array_equal(a.emissions, np.asarray(b.emissions))
    np.testing.assert_array_equal(a.alive, np.asarray(b.alive))


def _trace(system, **kw):
    return P.run_trace(system, device=CPU, backend="ref", **kw)


def test_async_results_bit_identical_to_sync_drain():
    reqs = _mixed_requests()
    sync = _svc(batch_size=8, step_bucket=8)
    tickets = [sync.submit(r) for r in reqs]
    expected = sync.drain()
    with _svc(batch_size=8, step_bucket=8, async_mode=True,
              max_delay_ms=20) as svc:
        futs = [svc.submit(r) for r in reqs]
        for t, fut in zip(tickets, futs):
            _assert_result_equal(expected[t], fut.result(timeout=TIMEOUT))


def test_async_submit_returns_future_and_drain_is_rejected():
    with _svc(async_mode=True, max_delay_ms=1) as svc:
        fut = svc.submit(TraceRequest(PI_PORT, steps=3))
        assert hasattr(fut, "result")
        with pytest.raises(RuntimeError, match="sync-mode only"):
            svc.drain()
        fut.result(timeout=TIMEOUT)


def test_full_group_flushes_without_deadline_or_close():
    svc = _svc(batch_size=4, step_bucket=4, async_mode=True,
               max_delay_ms=60_000)
    try:
        futs = [svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                        seed=s)) for s in range(4)]
        for s, fut in enumerate(futs):
            _assert_result_equal(fut.result(timeout=TIMEOUT), _trace(
                PI_PORT, steps=3, policy="random", seed=s))
        assert svc.num_device_calls == 1
    finally:
        svc.close()


def test_partial_group_flushes_at_deadline():
    svc = _svc(batch_size=64, step_bucket=4, async_mode=True,
               max_delay_ms=10)
    try:
        fut = svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                      seed=5))
        _assert_result_equal(fut.result(timeout=TIMEOUT), _trace(
            PI_PORT, steps=3, policy="random", seed=5))
    finally:
        svc.close()


def test_close_flushes_pending_and_is_idempotent():
    svc = _svc(batch_size=64, step_bucket=4, async_mode=True,
               max_delay_ms=60_000)
    futs = [svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                    seed=s)) for s in range(3)]
    svc.close()
    assert all(f.done() for f in futs)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(TraceRequest(PI_PORT, steps=3))


def test_cancelled_future_does_not_kill_the_drain_thread():
    svc = _svc(batch_size=4, step_bucket=4, async_mode=True,
               max_delay_ms=60_000)
    try:
        futs = [svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                        seed=s)) for s in range(3)]
        assert futs[1].cancel()
        futs.append(svc.submit(
            TraceRequest(PI_PORT, steps=3, policy="random", seed=3)))
        for s in (0, 2, 3):
            _assert_result_equal(futs[s].result(timeout=TIMEOUT), _trace(
                PI_PORT, steps=3, policy="random", seed=s))
        assert futs[1].cancelled()
        late = svc.submit(TraceRequest(PI_PORT, steps=3, seed=9))
        svc.close()
        assert late.result(timeout=TIMEOUT) is not None
    finally:
        svc.close()


def test_flush_error_propagates_into_futures_and_thread_survives():
    calls = {"n": 0}

    def flaky(comp, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("kaboom")
        return P.run_traces(comp, **kw)

    with _svc(batch_size=2, async_mode=True, max_delay_ms=1,
              runner=flaky) as svc:
        bad = svc.submit(TraceRequest(PI_PORT, steps=3, seed=1))
        err = bad.exception(timeout=TIMEOUT)
        assert isinstance(err, RuntimeError) and "kaboom" in str(err)
        good = svc.submit(TraceRequest(PI_PORT, steps=3, seed=1))
        _assert_result_equal(good.result(timeout=TIMEOUT),
                             _trace(PI_PORT, steps=3, seed=1))


def test_drain_with_zero_pending_returns_empty():
    svc = _svc(batch_size=4)
    assert svc.drain() == {}
    assert svc.num_device_calls == 0


@pytest.mark.parametrize("failing_call", [1, 2])
def test_failed_sync_drain_keeps_all_requests_for_retry(failing_call):
    calls = {"n": 0}

    def flaky(comp, **kw):
        calls["n"] += 1
        if calls["n"] == failing_call:
            raise RuntimeError("transient")
        return P.run_traces(comp, **kw)

    svc = _svc(batch_size=2, step_bucket=4, runner=flaky)
    tickets = [svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                       seed=s)) for s in range(4)]
    with pytest.raises(RuntimeError, match="transient"):
        svc.drain()
    assert svc.pending == 4
    results = svc.drain()
    assert svc.pending == 0 and set(results) == set(tickets)
    for s, t in enumerate(tickets):
        _assert_result_equal(results[t], _trace(PI_PORT, steps=3,
                                                policy="random", seed=s))


def test_mixed_step_counts_share_one_group_and_one_call():
    svc = _svc(batch_size=8, step_bucket=16)
    reqs = [TraceRequest(PI_PORT, steps=s, policy="random", seed=s)
            for s in (1, 7, 13)]
    tickets = [svc.submit(r) for r in reqs]
    results = svc.drain()
    assert svc.num_device_calls == 1
    for t, r in zip(tickets, reqs):
        assert results[t].configs.shape[0] == r.steps
        _assert_result_equal(results[t], _trace(
            PI_PORT, steps=r.steps, policy=r.policy, seed=r.seed))


def test_compile_cache_evicts_at_cap_and_stays_correct():
    systems = [_port(random_system(6, 2, 0.4, seed=s)) for s in range(3)]
    svc = _svc(batch_size=2, compile_cache_cap=2)
    tickets = [svc.submit(TraceRequest(s, steps=4, seed=1))
               for s in systems]
    assert len(svc._compile_cache) == 2
    assert systems[0] not in svc._compile_cache     # FIFO
    t_again = svc.submit(TraceRequest(systems[0], steps=4, seed=1))
    assert len(svc._compile_cache) == 2
    results = svc.drain()
    for sysm, t in zip(systems + [systems[0]], tickets + [t_again]):
        _assert_result_equal(results[t], _trace(sysm, steps=4, seed=1))


def test_precompiled_systems_bypass_the_compile_cache():
    comp = P.compile_system(PI_PORT, device=CPU)
    svc = _svc(batch_size=2, compile_cache_cap=1)
    t = svc.submit(TraceRequest(comp, steps=4, seed=2))
    assert len(svc._compile_cache) == 0
    _assert_result_equal(svc.drain()[t], _trace(comp, steps=4, seed=2))


def test_make_trace_runner_without_mesh_is_run_traces():
    assert make_trace_runner() is P.run_traces


# ---------------------------------------------------------------------------
# the mesh runner (the reference's two mesh cases, and its trace mesh)
# ---------------------------------------------------------------------------

MESH = trace_mesh([CPU] * 3)


def test_mesh_runner_service_matches_default_runner():
    reqs = _mixed_requests()
    plain = _svc(batch_size=8, step_bucket=8)
    tickets = [plain.submit(r) for r in reqs]
    expected = plain.drain()
    svc = _svc(batch_size=8, step_bucket=8,
               runner=make_trace_runner(mesh=MESH))
    tickets2 = [svc.submit(r) for r in reqs]
    results = svc.drain()
    for t, t2 in zip(tickets, tickets2):
        _assert_result_equal(expected[t], results[t2])
    assert svc.stats() == plain.stats()


def test_async_mesh_service_end_to_end():
    """The launch path's composition: async drain and mesh runner."""
    with _svc(batch_size=4, step_bucket=8, async_mode=True,
              max_delay_ms=10, runner=make_trace_runner(mesh=MESH)) as svc:
        futs = [svc.submit(TraceRequest(PI_PORT, steps=6, policy="random",
                                        seed=s)) for s in range(6)]
        for s, fut in enumerate(futs):
            _assert_result_equal(fut.result(timeout=TIMEOUT),
                                 _trace(PI_PORT, steps=6, policy="random",
                                        seed=s))


def test_trace_mesh_flattens_all_devices():
    """Trace serving treats every device as one data axis: a 2-D layout
    of devices flattens to one list, in order; without devices the mesh
    is every visible card, and without a card it raises."""
    tm = trace_mesh([[CPU, "meta"], [CPU, CPU]])
    assert tm == [torch.device(d) for d in (CPU, "meta", CPU, CPU)]
    assert trace_mesh(np.array([CPU] * 4).reshape(-1, 1)) == \
        [torch.device(CPU)] * 4
    with pytest.raises(ValueError, match="at least one device"):
        trace_mesh([])
    if torch.cuda.is_available():
        assert len(trace_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trace_mesh()


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_mesh_runner_stats_equal_reference_under_faults(scenario):
    """A flush, a retry, a bisection and a poisoned seed behave over the
    mesh runner as the reference's default runner has them."""
    pol, inj = SCENARIOS[scenario]
    (pp, rp), (pi, ri) = _policies(**pol), _injectors(**inj)
    (pg, pf, ps), (rg, rf, rs) = _serve_both(
        "pi", dict(batch_size=4, step_bucket=8, backend="ref", policy=pp,
                   fault_injector=pi),
        dict(batch_size=4, step_bucket=8, backend="ref", policy=rp,
             fault_injector=ri), port_runner=make_trace_runner(mesh=MESH))
    _assert_results_equal(pg, rg)
    assert pf == rf
    assert ps == rs
    assert pi.calls == ri.calls and pi.injected == ri.injected


def test_mesh_runner_degrades_as_the_default_runner():
    """The service's own ``"cuda"`` failing over the mesh runner degrades
    chunk by chunk to the reference's fallback, with its stats."""
    served = {"port": [], "reference": []}
    pp, rp = _policies(max_retries=1, backoff_ms=0.0, bisect=False)
    (pg, pf, ps), (rg, rf, rs) = _serve_both(
        "pi", dict(batch_size=4, policy=pp),
        dict(batch_size=4, backend="pallas", policy=rp),
        port_runner=_flaky(served, make_trace_runner(mesh=MESH),
                           P.get_backend, "cuda", "port"),
        ref_runner=_flaky(served, J.run_traces, J.get_backend, "pallas",
                          "reference"),
        warns=True)
    _assert_results_equal(pg, rg)
    assert pf == rf == {}
    assert ps == rs and ps["degraded"] == ps["device_calls"] == 5
    assert served["port"] == \
        [REFERENCE_NAME[served["reference"][0]]] * 5


def test_mesh_runner_refuses_a_service_device_off_the_mesh():
    svc = _svc(batch_size=4, backend="ref",
               runner=make_trace_runner(mesh=["meta", CPU]))
    svc.submit(TraceRequest(PI_PORT, steps=4, seed=1))
    with pytest.raises(ValueError, match="first device"):
        svc.drain()


def test_submissions_from_many_threads_all_resolve():
    with _svc(batch_size=8, step_bucket=8, async_mode=True,
              max_delay_ms=5) as svc:
        out = {}

        def producer(seed):
            fut = svc.submit(TraceRequest(PI_PORT, steps=4,
                                          policy="random", seed=seed))
            out[seed] = fut.result(timeout=TIMEOUT)

        threads = [threading.Thread(target=producer, args=(s,))
                   for s in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    assert sorted(out) == list(range(12))
    for seed, got in out.items():
        _assert_result_equal(got, _trace(PI_PORT, steps=4,
                                         policy="random", seed=seed))


# ---------------------------------------------------------------------------
# the failure domains in async mode (tests/test_faults.py's service cases)
# ---------------------------------------------------------------------------

def test_async_burst_poison_isolated_others_bit_identical():
    sync = _svc(batch_size=16, backend="ref")
    tickets = [sync.submit(TraceRequest(PI_PORT, steps=5, policy="random",
                                        seed=s + 1)) for s in range(64)]
    baseline = sync.drain()
    inj = P_faults.FaultInjector(fail_calls=(2, 4), poison_seeds=(17,))
    pol = P_faults.FaultPolicy(max_retries=2, backoff_ms=0.0, degrade=False)
    svc = _svc(batch_size=16, backend="ref", async_mode=True,
               max_delay_ms=0.0, policy=pol, fault_injector=inj)
    futs = [svc.submit(TraceRequest(PI_PORT, steps=5, policy="random",
                                    seed=s + 1)) for s in range(64)]
    svc.close()
    for s, (t, fut) in enumerate(zip(tickets, futs)):
        if s + 1 == 17:
            with pytest.raises(P_faults.PoisonError):
                fut.result(timeout=TIMEOUT)
            continue
        got, want = fut.result(timeout=TIMEOUT), baseline[t]
        for f in ("configs", "emissions", "alive", "branch_overflow"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    s = svc.stats()
    assert s["failed_requests"] == 1 and s["bisections"] >= 1
    assert s["traces_served"] == 63


def test_async_held_burst_gives_the_sync_stats():
    """The smoke's burst, submitted while the drain thread waits on the
    service's lock, flushes in full chunks in ticket order: async stats
    equal a sync drain's."""
    n = 96
    pol = P_faults.FaultPolicy(max_retries=1, backoff_ms=0.0)

    def serve(async_mode):
        svc = _svc(batch_size=32, backend="ref", async_mode=async_mode,
                   max_delay_ms=5.0, policy=pol,
                   fault_injector=P_faults.FaultInjector(
                       fail_calls=(2,), poison_seeds=(17,)))
        reqs = [TraceRequest(PI_PORT, steps=4, policy="random", seed=s)
                for s in range(n)]
        with svc._cv:
            for r in reqs:
                svc.submit(r)
        if not async_mode:
            svc.drain()
        svc.close()
        return svc.stats()

    assert serve(True) == serve(False)


def test_async_deadline_failure_reaches_the_future():
    svc = _svc(batch_size=4, async_mode=True, max_delay_ms=30.0,
               policy=P_faults.FaultPolicy(deadline_ms=1.0))
    fut = svc.submit(TraceRequest(PI_PORT, steps=3, seed=1))
    with pytest.raises(P_faults.DeadlineExceeded):
        fut.result(timeout=TIMEOUT)
    svc.close()


def test_drain_loop_never_waits_zero_with_max_delay_ms_zero():
    svc = _svc(batch_size=8, async_mode=True, max_delay_ms=0.0)
    orig_wait, bad_waits = svc._cv.wait, []

    def spying_wait(timeout=None):
        if timeout is not None and timeout <= 0:
            bad_waits.append(timeout)
        return orig_wait(timeout)

    svc._cv.wait = spying_wait
    try:
        futs = [svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                        seed=s)) for s in range(24)]
        for fut in futs:
            fut.result(timeout=TIMEOUT)
    finally:
        svc.close()
        svc._cv.wait = orig_wait
    assert bad_waits == []


def test_close_races_in_flight_flush_and_futures_still_resolve():
    inj = P_faults.FaultInjector(slow_calls={1: 0.2})
    svc = _svc(batch_size=4, async_mode=True, max_delay_ms=0.0,
               fault_injector=inj)
    futs = [svc.submit(TraceRequest(PI_PORT, steps=3, policy="random",
                                    seed=s)) for s in range(4)]
    svc.close()
    for s, fut in enumerate(futs):
        _assert_result_equal(fut.result(timeout=TIMEOUT), _trace(
            PI_PORT, steps=3, policy="random", seed=s))


def test_cancelled_future_skipped_during_bisecting_flush():
    inj = P_faults.FaultInjector(poison_seeds=(3,))
    pol = P_faults.FaultPolicy(max_retries=0, backoff_ms=0.0, degrade=False)
    svc = _svc(batch_size=8, async_mode=True, max_delay_ms=60_000.0,
               policy=pol, fault_injector=inj)
    futs = [svc.submit(TraceRequest(PI_PORT, steps=4, policy="random",
                                    seed=s + 1)) for s in range(8)]
    assert futs[0].cancel()
    svc.close()
    assert futs[0].cancelled()
    for s, fut in enumerate(futs[1:], start=1):
        if s + 1 == 3:
            with pytest.raises(P_faults.PoisonError):
                fut.result(timeout=TIMEOUT)
            continue
        _assert_result_equal(fut.result(timeout=TIMEOUT), _trace(
            PI_PORT, steps=4, policy="random", seed=s + 1))


def test_runner_returning_host_arrays_serves():
    """A runner may return the four fields as host arrays."""
    def host_runner(comp, **kw):
        return tuple(x.numpy() for x in P.run_traces(comp, **kw))

    svc = _svc(batch_size=4, runner=host_runner)
    t = svc.submit(TraceRequest(PI_PORT, steps=4, seed=1))
    res = svc.drain()[t]
    want = P.run_trace(PI_PORT, steps=4, seed=1, device=CPU)
    np.testing.assert_array_equal(res.configs, want.configs.numpy())
    assert res.branch_overflow.shape == (4,) and not res.truncated


def test_request_validation():
    with pytest.raises(ValueError):
        TraceRequest(PI_PORT, steps=0)
    with pytest.raises(ValueError):
        TraceRequest(PI_PORT, steps=3, policy="best")
    with pytest.raises(ValueError):
        TraceRequest(PI_PORT, steps=3, deadline_ms=-1)
    svc = _svc(max_steps=4)
    with pytest.raises(ValueError, match="max_steps"):
        svc.submit(TraceRequest(PI_PORT, steps=5))
    for kw in (dict(batch_size=0), dict(step_bucket=0),
               dict(compile_cache_cap=0), dict(max_delay_ms=-1)):
        with pytest.raises(ValueError):
            _svc(**kw)


def test_device_none_is_the_card():
    """Without a card the service's default device raises: it never
    carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None serves there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNPTraceService()
    assert _svc().backend.name == "cuda"    # the default backend


def test_backend_names_map_to_the_reference():
    assert {REFERENCE_NAME[n] for n in ("ref", "cuda", "sparse",
                                        "sparse_cuda")} == \
        set(J.available_backends())


# ---------------------------------------------------------------------------
# shared state the drain thread touches
# ---------------------------------------------------------------------------

def test_host_read_count_and_library_load_survive_threads(monkeypatch):
    """More threads than cores, a short switch interval: the host-read
    count loses no update, and a kernel library is built and loaded once
    however many threads ask for it at once."""
    import ctypes.util
    import sys
    from pathlib import Path

    from repro_torch.core import device
    from repro_torch.kernels.snp_step import _build

    builds = []

    def fake_build(source):
        builds.append(source)
        time.sleep(0.01)            # widen the check-then-act window
        return Path(ctypes.util.find_library("c") or "libc.so.6"), ""

    monkeypatch.setattr(_build, "build", fake_build)
    source = Path("fake-source.cu")
    monkeypatch.delitem(_build._loaded, source, raising=False)
    monkeypatch.setattr(device, "host_reads", 0)
    x = torch.ones((), dtype=torch.int32)
    threads, reads = 32, 300
    libs = []

    def work():
        libs.append(_build.load_library(source))
        for _ in range(reads):
            device.host_read(x)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
        _build._loaded.pop(source, None)
    assert not any(th.is_alive() for th in pool)
    assert device.host_reads == threads * reads
    assert len(builds) == 1 and len({id(lib) for lib in libs}) == 1
