"""The port's query planner and block autotuner (``core/autotune.py``,
``SystemPlan.kernel``, ``resolve_kernel``) against the JAX package's.

* the counterparts of ``tests/test_autotune.py``'s fourteen cases: every
  decision the planner can make, forced through the cache, runs
  bit-identical to the reference's ``"ref"`` result on the same system
  and seeds; the cache, its corruption and its poisoned entries; the
  measure mode; the model; the kernel config and its validation;
* the decisions themselves against the reference's: signature keys, and
  with one synthetic baseline fed to both packages (backend names mapped
  through ``REFERENCE_NAME``) the fitted curves, the predictions, the
  model's pick and the plan a choice becomes; the static mode;
* what is the port's own: the block shape reaching the wrappers (which
  refuse a stage that does not fit, or 512 threads, on the CPU too), the
  kernel-only candidates and cache entries on a CUDA device, the domain
  check, a measured candidate's failure propagating, the degrade chain
  dropping ``kernel``, the entry points' workloads, the committed seed
  file and its fits, and the encoding rule when the planner has nothing
  to say."""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.core.autotune as J_tune  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.core.autotune as P_tune  # noqa: E402
from repro.core.generators import (power_law, ring_lattice,  # noqa: E402
                                   scaled_pi)
from repro_torch.core import failover as P_failover  # noqa: E402
from repro_torch.core.backend import REFERENCE_NAME  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.kernels.snp_step import ops, sparse_ops  # noqa: E402
from repro_torch.sharding import neuron_axis  # noqa: E402

CPU = "cpu"
SEEDS = [0, 1, 2]
STEPS = 6
T = 8
PORT_NAME = {v: k for k, v in REFERENCE_NAME.items()}
# A block shape each kernel backend takes for a delay-free plan.
BLOCKS = {"cuda": dict(block_t=8), "sparse_cuda": dict(block_t=2,
                                                       threads=256)}


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _system():
    return ring_lattice(12, 3, seed=0)


@pytest.fixture()
def cache_file(tmp_path, monkeypatch):
    """Both packages' caches in a fresh file each, so no cache on the
    machine steers a decision."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    return path


def _ref_traces(system, **kw):
    return J.run_traces(system, steps=STEPS, seeds=SEEDS, max_branches=T,
                        backend="ref", **kw)


def _assert_same_traces(port, ref):
    for p, j in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def _force_choice(system, choice):
    """Store ``choice`` at the signature ``run_traces(seeds=SEEDS,
    max_branches=T)`` plans for."""
    sig = P_tune.signature_of(system, workload=(len(SEEDS), T))
    P_tune.store_choice(sig, choice)
    return sig


# ---------------------------------------------------------------------------
# the counterparts of tests/test_autotune.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(P.available_backends()))
def test_auto_decisions_bit_identical_to_ref(name, cache_file):
    """Force the planner onto every (backend, encoding) cell, at a block
    shape for the kernel backends: run_traces under the open plan equals
    the reference's "ref" traces."""
    ref_system = _system()
    system = _port(ref_system)
    ref = _ref_traces(ref_system)
    for encoding in [e for e in P.get_backend(name).supported_encodings()
                     if e != "sharded"]:
        _force_choice(system, P_tune.TunedChoice(
            backend=name, encoding=encoding, **BLOCKS.get(name, {})))
        plan = P.SystemPlan.for_system(system, workload=(len(SEEDS), T),
                                       mode="auto", device=CPU)
        assert plan.backend == name and plan.encoding == encoding
        be, got_plan, planned = P.resolve_entry_info(
            system, None, None, workload=(len(SEEDS), T), device=CPU)
        assert planned and got_plan == plan
        assert (getattr(be, "block_t", None), getattr(be, "threads", None)) \
            == (BLOCKS.get(name, {}).get("block_t"),
                BLOCKS.get(name, {}).get("threads"))
        _assert_same_traces(P.run_traces(system, steps=STEPS, seeds=SEEDS,
                                         max_branches=T, device=CPU), ref)


def test_auto_explore_matches_ref_archive(cache_file):
    """The default, planner-decided explore finds the reference's "ref"
    archive, in order."""
    kw = dict(max_steps=8, frontier_cap=32, visited_cap=256, max_branches=T)
    ref = J.explore(_system(), backend="ref", **kw)
    auto = P.explore(_port(_system()), device=CPU, **kw)
    np.testing.assert_array_equal(auto.configs, np.asarray(ref.configs))
    assert auto.num_discovered == ref.num_discovered


def test_cache_round_trips_on_full_signature(cache_file):
    sig = P_tune.WorkloadSignature(m=7, n=13, kin=3, B=4, T=8)
    choice = P_tune.TunedChoice(backend="sparse_cuda", encoding="ell",
                                block_t=2, threads=1024, us_per_step=12.5,
                                source="measure")
    P_tune.store_choice(sig, choice)
    got = P_tune.lookup(sig, device=CPU)
    assert got is not None
    assert (got.backend, got.encoding, got.block_t, got.threads) == \
        ("sparse_cuda", "ell", 2, 1024)
    for field in ("m", "n", "kin", "B", "T"):
        other = dataclasses.replace(sig, **{field: getattr(sig, field) + 1})
        assert P_tune.lookup(other, device=CPU) is None, field
    # the two tiers never share an entry
    assert P_tune.lookup(dataclasses.replace(sig, semantics="delays"),
                         device=CPU) is None
    payload = json.loads(cache_file.read_text())
    assert "m7_n13_kin3_B4_T8" in payload["entries"]
    assert P_tune.load_cache(cache_file) == payload["entries"]


def test_corrupt_cache_degrades_to_model_with_warning(cache_file):
    cache_file.write_text("{this is not json")
    with pytest.warns(UserWarning, match="autotune cache"):
        plan = P.SystemPlan.for_system(_port(_system()), workload=(4, 8),
                                       mode="auto", device=CPU)
    assert isinstance(plan, P.SystemPlan)
    ref = _ref_traces(_system())
    with pytest.warns(UserWarning, match="autotune cache"):
        got = P.run_traces(_port(_system()), steps=STEPS, seeds=SEEDS,
                           max_branches=T, device=CPU)
    _assert_same_traces(got, ref)


def test_poisoned_entry_is_skipped_not_fatal(cache_file):
    system = _port(_system())
    sig = P_tune.signature_of(system, workload=(len(SEEDS), T))
    cache_file.write_text(json.dumps({"version": 1, "entries": {
        sig.key(): {"backend": "no-such-backend", "block_t": "huge"},
        sig.wildcard_key(): {"backend": "sparse_cuda", "threads": 512},
    }}))
    assert P_tune.lookup(sig, device=CPU) is None
    plan = P.SystemPlan.for_system(system, workload=(len(SEEDS), T),
                                   mode="auto", device=CPU)
    assert isinstance(plan, P.SystemPlan)
    _assert_same_traces(P.run_traces(system, steps=STEPS, seeds=SEEDS,
                                     max_branches=T, device=CPU),
                        _ref_traces(_system()))


def test_measure_mode_times_and_persists(cache_file):
    system = _port(_system())
    plan = P.SystemPlan.for_system(system, workload=(4, T), mode="measure",
                                   device=CPU)
    sig = P_tune.signature_of(system, workload=(4, T))
    cands = P_tune.default_candidates(sig, device=CPU)
    assert plan.mode == "measure"
    assert plan.backend in {c.backend for c in cands}
    # every candidate was timed, none refused
    assert [(r["backend"], r["block_t"], r["threads"])
            for r in P_tune.last_sweep] == \
        [(c.backend, c.block_t, c.threads) for c in cands]
    assert all(r["us"] > 0 and r["refused"] is None
               for r in P_tune.last_sweep)
    entries = P_tune.load_cache(cache_file)
    assert entries[sig.key()]["source"] == "measure"
    assert entries[sig.key()]["us_per_step"] > 0
    again = P.SystemPlan.for_system(system, workload=(4, T), mode="auto",
                                    device=CPU)
    assert (again.backend, again.kernel) == (plan.backend, plan.kernel)
    # the measured plan runs the reference's traces
    got = P.run_traces(system, steps=STEPS, seeds=SEEDS, max_branches=T,
                       plan=plan, device=CPU)
    _assert_same_traces(got, _ref_traces(_system()))


def _baseline(tmp_path, monkeypatch, rows):
    """One synthetic baseline, fed to both packages: the port's under its
    own backend names, the reference's under the names they map to."""
    def write(name, mapping):
        path = tmp_path / name
        path.write_text(json.dumps({"rows": [
            {"name": f"snp_step/{mapping(b)}/m{m}_n{n}_B{B}_T{t}",
             "us_per_call": us} for b, m, n, B, t, us in rows]}))
        return str(path)
    monkeypatch.setenv("REPRO_TORCH_BENCH_BASELINE",
                       write("port.json", lambda b: b))
    monkeypatch.setenv("REPRO_BENCH_BASELINE",
                       write("ref.json", lambda b: REFERENCE_NAME[b]))


# (backend, m, n, B, T, µs): the kernel rows small enough to stay inside
# the reference's interpret-mode guard at every signature below.
ROWS = [("ref", 16, 32, 8, 8, 40.0), ("ref", 64, 128, 16, 16, 300.0),
        ("ref", 256, 512, 32, 32, 4000.0),
        ("cuda", 16, 32, 8, 8, 60.0), ("cuda", 64, 128, 16, 16, 200.0),
        ("sparse", 16, 32, 8, 8, 55.0), ("sparse", 64, 128, 16, 16, 280.0),
        ("sparse_cuda", 16, 32, 8, 8, 30.0),
        ("sparse_cuda", 64, 128, 16, 16, 250.0)]


def _system_rows(m, n, T, batches=(1, 64)):
    """Kernel rows of one system, at two batches: "cuda" ahead at the
    first, "sparse_cuda" at the second."""
    return [(b, m, n, B, T, us) for b, B, us in (
        ("cuda", batches[0], 50.0), ("cuda", batches[1], 300.0),
        ("sparse_cuda", batches[0], 60.0),
        ("sparse_cuda", batches[1], 200.0))]


def test_model_predicts_and_guards_extrapolation(cache_file, tmp_path,
                                                 monkeypatch):
    """The port's model has no interpret guard; in its place it never
    picks a kernel outside its domain: past the sliced-list kernel's
    widest system the model's cheapest kernel is skipped."""
    _baseline(tmp_path, monkeypatch, ROWS)
    small = P_tune.WorkloadSignature(m=16, n=32, kin=3, B=8, T=8)
    assert P_tune.predict_us(small, "ref") > 0
    choice = P_tune.model_choice(small, device=CPU)
    assert choice is not None and choice.source == "model"
    assert choice.backend == "sparse_cuda"
    wide = P_tune.WorkloadSignature(m=sparse_ops.SMEM_LIMIT // 2, n=16,
                                    kin=4, B=1, T=1)
    assert P_tune.model_choice(wide, device=CPU).backend != "sparse_cuda"
    # the card's model fits the rows of the system itself: given rows for
    # ``wide``, it still skips the sliced-list kernel
    _baseline(tmp_path, monkeypatch, _system_rows(wide.m, wide.n, 1))
    assert P_tune.model_choice(wide, device="cuda").backend == "cuda"


def test_workload_hint_reaches_the_signature():
    ref_system = _system()
    sig = P_tune.signature_of(_port(ref_system), workload=(17, 5))
    assert (sig.B, sig.T) == (17, 5)
    assert (sig.m, sig.n) == (ref_system.num_neurons, ref_system.num_rules)
    assert sig.kin >= 1
    assert sig.key() == J_tune.signature_of(ref_system,
                                            workload=(17, 5)).key()


def test_kernel_config_validation():
    with pytest.raises(ValueError, match="block_t"):
        P.KernelConfig(block_t=0)
    with pytest.raises(ValueError, match="block_t"):
        P.KernelConfig(block_t=-4)
    with pytest.raises(ValueError, match="threads"):
        P.KernelConfig(threads=0)
    # which values a kernel takes is checked where the plan meets it
    for cfg in (P.KernelConfig(block_t=3), P.KernelConfig(threads=512)):
        with pytest.raises(ValueError, match="plan kernel sets"):
            P.resolve_kernel(P.get_backend("sparse_cuda"),
                             P.SystemPlan(kernel=cfg))
    assert hash(P.KernelConfig(block_t=4)) == hash(P.KernelConfig(block_t=4))
    with pytest.raises(ValueError, match="KernelConfig"):
        P.SystemPlan(kernel=(8, 256))


def test_resolve_kernel_applicability_errors():
    cfg = P.KernelConfig(block_t=8)
    for name in ("ref", "sparse"):
        with pytest.raises(ValueError, match="no kernel block"):
            P.resolve_kernel(P.get_backend(name), P.SystemPlan(kernel=cfg))
    # B1 runs 256 threads; B4 takes them
    with pytest.raises(ValueError, match="threads=1024.*B1"):
        P.resolve_kernel(P.get_backend("cuda"), P.SystemPlan(
            kernel=P.KernelConfig(threads=1024)))
    P.resolve_kernel(P.get_backend("cuda"), P.SystemPlan(
        kernel=P.KernelConfig(threads=1024), semantics="delays"))
    # B1 takes 8, 16 or 32 rows; B4, B6 and the sliced-list kernel 1-8
    with pytest.raises(ValueError, match="block_t=2.*B1"):
        P.resolve_kernel(P.get_backend("cuda"), P.SystemPlan(
            kernel=P.KernelConfig(block_t=2)))
    with pytest.raises(ValueError, match="block_t=16.*B6"):
        P.resolve_kernel(P.get_backend("cuda"), P.SystemPlan(
            kernel=P.KernelConfig(block_t=16), num_shards=2))
    with pytest.raises(ValueError, match="block_t=32.*sliced-list"):
        P.resolve_kernel(P.get_backend("sparse_cuda"), P.SystemPlan(
            kernel=P.KernelConfig(block_t=32)))
    # and the same errors surface at compile time
    with pytest.raises(ValueError, match="no kernel block"):
        P.get_backend("ref").compile(_port(_system()),
                                     plan=P.SystemPlan(kernel=cfg),
                                     device=CPU)


def test_resolve_kernel_reblocks_and_keys_caches(monkeypatch):
    """Distinct shapes are distinct backends; equal shapes equal ones;
    ``None`` keeps the backend's own; and the shape reaches the wrapper
    from ``expand`` and from the shard step."""
    base = P.get_backend("sparse_cuda")
    be1 = P.resolve_kernel(base, P.SystemPlan(
        kernel=P.KernelConfig(block_t=2, threads=256)))
    be2 = P.resolve_kernel(base, P.SystemPlan(
        kernel=P.KernelConfig(block_t=4, threads=1024)))
    assert (be1.block_t, be1.threads) == (2, 256)
    assert be1 != be2 and hash(be1) != hash(be2)
    assert be1 == P.resolve_kernel(base, P.SystemPlan(
        kernel=P.KernelConfig(block_t=2, threads=256)))
    be3 = P.resolve_kernel(be1, P.SystemPlan(
        kernel=P.KernelConfig(block_t=8)))
    assert (be3.block_t, be3.threads) == (8, 256)
    assert P.resolve_kernel(base, P.SystemPlan()) is base

    seen = []
    step, shard = sparse_ops.snp_step_sparse, sparse_ops.snp_step_sparse_shard

    def spy(fn):
        def wrapped(*a, rows=None, threads=None, **kw):
            seen.append((rows, threads))
            return fn(*a, rows=rows, threads=threads, **kw)
        return wrapped
    monkeypatch.setattr(sparse_ops, "snp_step_sparse", spy(step))
    monkeypatch.setattr(sparse_ops, "snp_step_sparse_shard", spy(shard))
    system = _port(_system())
    P.run_traces(system, steps=2, seeds=[0], max_branches=T, backend=be1,
                 plan=P.SystemPlan(encoding="ell"), device=CPU)
    assert set(seen) == {(2, 256)}
    seen.clear()
    from repro_torch.core.distributed import explore_distributed
    explore_distributed(system, plan=neuron_axis(2), backend=be2,
                        max_steps=2, frontier_cap=8, visited_cap=64,
                        max_branches=T, device=CPU)
    assert set(seen) == {(4, 1024)}


@pytest.mark.parametrize("backend,cfg,semantics", [
    ("cuda", P.KernelConfig(block_t=32), "no_delays"),
    ("cuda", P.KernelConfig(block_t=8), "no_delays"),
    ("cuda", P.KernelConfig(block_t=1, threads=256), "delays"),
    ("sparse_cuda", P.KernelConfig(block_t=1, threads=1024), "no_delays"),
    ("sparse_cuda", P.KernelConfig(block_t=8, threads=256), "delays")])
def test_plan_kernel_runs_bit_identical_with_odd_blocks(backend, cfg,
                                                        semantics):
    """A plan-carried block shape at each kernel's extremes runs the
    reference's "ref" traces (the plain versions here; the kernels at
    every shape in smoke phase 19)."""
    ref_system = _system()
    if semantics == "delays":
        ref_system = J.with_delays(ref_system, 2)
    ref = J.run_traces(ref_system, steps=STEPS, seeds=SEEDS, max_branches=T,
                       backend="ref", plan=J.SystemPlan(semantics=semantics))
    got = P.run_traces(_port(ref_system), steps=STEPS, seeds=SEEDS,
                       max_branches=T, backend=backend, device=CPU,
                       plan=P.SystemPlan(kernel=cfg, semantics=semantics))
    _assert_same_traces(got, ref)


def test_static_mode_keeps_the_heuristic(cache_file):
    """``mode="static"`` (for_system's default) reads neither cache nor
    model: a poisoned cache file is not even read."""
    cache_file.write_text("{broken")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = P.SystemPlan.for_system(_port(_system()))
    assert plan.backend is None and plan.encoding in ("ell", "hybrid")
    assert plan.mode == "static"


def test_sharded_planning_picks_sharded_capable_backend(cache_file,
                                                        tmp_path,
                                                        monkeypatch):
    _baseline(tmp_path, monkeypatch, ROWS)
    system = _port(_system())
    for device in (CPU, "cuda"):
        if device == "cuda":    # the card's model asks for the system's rows
            _baseline(tmp_path, monkeypatch, _system_rows(
                system.num_neurons, system.num_rules, T, (4, 64)))
        plan = P_tune.plan_for(system, num_shards=2, workload=(8, T),
                               device=device)
        assert plan is not None
        assert plan.encoding == "ell" and plan.num_shards == 2
        assert "sharded" in P.get_backend(plan.backend).supported_encodings()
        assert plan.kernel is None


# ---------------------------------------------------------------------------
# decisions against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: ring_lattice(64, 4, seed=1), lambda: power_law(200, 3, seed=2),
    lambda: scaled_pi(6)], ids=["ring_lattice", "power_law", "scaled_pi"])
@pytest.mark.parametrize("semantics", ["no_delays", "delays"])
def test_signature_key_equals_reference(make, semantics):
    system = make()
    for workload in (None, (512, 64)):
        assert P_tune.signature_of(
            _port(system), workload=workload, semantics=semantics).key() == \
            J_tune.signature_of(system, workload=workload,
                                semantics=semantics).key()


SIGS = [J_tune.WorkloadSignature(m=16, n=32, kin=3, B=8, T=8),
        J_tune.WorkloadSignature(m=40, n=80, kin=5, B=16, T=8),
        J_tune.WorkloadSignature(m=64, n=128, kin=9, B=16, T=16)]


def test_fits_predictions_and_model_choice_equal_reference(tmp_path,
                                                           monkeypatch):
    _baseline(tmp_path, monkeypatch, ROWS)
    ref_fits = J_tune._fitted_curves()
    fits = P_tune._fitted_curves()
    assert {PORT_NAME[k] for k in ref_fits} == set(fits)
    for name, fit in ref_fits.items():
        np.testing.assert_allclose(fits[PORT_NAME[name]], fit, rtol=1e-9)
    for jsig in SIGS:
        sig = P_tune.WorkloadSignature(**dataclasses.asdict(jsig))
        for name in ref_fits:
            assert P_tune.predict_us(sig, PORT_NAME[name]) == \
                pytest.approx(J_tune.predict_us(jsig, name), rel=1e-9)
        assert P_tune.model_choice(sig, device=CPU).backend == \
            PORT_NAME[J_tune.model_choice(jsig).backend]


@pytest.mark.parametrize("make", [
    lambda: ring_lattice(64, 4, seed=1), lambda: power_law(200, 3, seed=2),
    lambda: power_law(40, 2, seed=5)],
    ids=["ring_lattice", "power_law-200", "power_law-40"])
@pytest.mark.parametrize("num_shards", [1, 4])
def test_choice_to_plan_and_static_plan_equal_reference(make, num_shards):
    system = make()
    port = _port(system)
    fields = ("encoding", "hub_threshold", "partition", "num_shards",
              "semantics")
    for name in P.available_backends():
        got = P_tune.choice_to_plan(P_tune.TunedChoice(backend=name), port,
                                    num_shards=num_shards)
        want = J_tune.choice_to_plan(
            J_tune.TunedChoice(backend=REFERENCE_NAME[name]), system,
            num_shards=num_shards)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.backend == name
            assert [getattr(got, f) for f in fields] == \
                [getattr(want, f) for f in fields]
    got = P.SystemPlan.for_system(port, num_shards=num_shards)
    want = J.SystemPlan.for_system(system, num_shards=num_shards,
                                   mode="static")
    assert [getattr(got, f) for f in fields + ("mode", "backend")] == \
        [getattr(want, f) for f in fields + ("mode", "backend")]


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def test_wrappers_refuse_bad_block_shapes():
    """On CPU tensors the plain versions ignore the shape, but the
    wrappers validate it: a shape a kernel has no instance for, 512
    threads, or a stage past 227 KB is a ValueError."""
    from repro_torch.core.generators import ring
    wide = P.compile_system_sparse(ring(15000), device=CPU)
    c = torch.zeros((1, 15000), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 4 rows"):
        sparse_ops.snp_step_sparse(c, wide, max_branches=8, rows=8)
    sparse_ops.snp_step_sparse(c, wide, max_branches=8, rows=4)
    # rows above T are clipped first, as the rule clips its own
    sparse_ops.snp_step_sparse(c, wide, max_branches=4, rows=8)
    with pytest.raises(ValueError, match="at most 1 rows"):
        ops.delay_block_shape(40000, 64, rows=2)
    with pytest.raises(ValueError, match="at most 4 rows"):
        ops.delay_block_shape(7300, 64, rows=8)
    system = _port(_system())
    dense = P.compile_system(system, device=CPU)
    delayed = P.compile_system(P.with_delays(system, 1), semantics="delays",
                               device=CPU)
    sparse = P.compile_system_sparse(system, device=CPU)
    c = torch.as_tensor(np.asarray(dense.init_config)[None], dtype=torch.int32)
    d = torch.cat([c, torch.zeros((1, 2 * c.shape[1]), dtype=torch.int32)],
                  1)
    for fn, comp, x in ((ops.snp_step, dense, c), (ops.snp_step, delayed, d),
                        (sparse_ops.snp_step_sparse, sparse, c)):
        with pytest.raises(ValueError, match="threads=512"):
            fn(x, comp, max_branches=T, threads=512)
        with pytest.raises(ValueError, match="rows=3"):
            fn(x, comp, max_branches=T, rows=3)
    ops.snp_step(c, dense, max_branches=T, rows=32)
    with pytest.raises(ValueError, match="B1 takes 256"):
        ops.snp_step(c, dense, max_branches=T, threads=1024)
    with pytest.raises(ValueError, match="rows=4"):
        ops.snp_step(c, dense, max_branches=T, rows=4)
    ops.snp_step(d, delayed, max_branches=T, rows=1, threads=1024)


def test_default_candidates_on_the_card_are_kernels_only(cache_file):
    sig = P_tune.signature_of(_port(_system()), workload=(512, 64))
    on_card = P_tune.default_candidates(sig, device="cuda")
    assert {c.backend for c in on_card} == set(P_failover.KERNEL_BACKENDS)
    # the library's rule (no shape) first, then the other shapes
    assert [(c.backend, c.block_t, c.threads) for c in on_card] == [
        ("cuda", None, None), ("cuda", 32, None),
        ("sparse_cuda", None, None), ("sparse_cuda", 8, 256),
        ("sparse_cuda", 4, 1024)]
    delayed = dataclasses.replace(sig, semantics="delays")
    assert [(c.backend, c.block_t, c.threads) for c in
            P_tune.default_candidates(delayed, device="cuda")][:2] == [
        ("cuda", None, None), ("cuda", 8, 256)]
    assert {c.backend for c in P_tune.default_candidates(sig, device=CPU)} \
        == set(P.available_backends())
    # a stage that does not fit drops the candidate: m = 20,000 takes 4
    # rows a block of the sliced-list kernel, at most
    wide = dataclasses.replace(sig, m=30000)
    assert ("sparse_cuda", 8, 256) not in [
        (c.backend, c.block_t, c.threads)
        for c in P_tune.default_candidates(wide, device="cuda")]
    # a cached plain backend is unusable on the card
    P_tune.store_choice(sig, P_tune.TunedChoice(backend="ref"))
    assert P_tune.lookup(sig, device=CPU).backend == "ref"
    assert P_tune.lookup(sig, device="cuda") is None


def test_measure_skips_domain_refusals_and_raises_kernel_failures(
        cache_file, monkeypatch):
    system = _port(_system())
    sig = P_tune.signature_of(system, workload=(4, T))
    cands = [P_tune.TunedChoice(backend="sparse_cuda", block_t=8),
             P_tune.TunedChoice(backend="ref")]
    real = P_tune._time_step

    def refuse(be, *a, **kw):
        if be.name == "sparse_cuda":
            raise ValueError("outside the kernel's domain")
        return real(be, *a, **kw)
    monkeypatch.setattr(P_tune, "_time_step", refuse)
    best = P_tune.measure_best(system, sig, candidates=cands, device=CPU)
    assert best.backend == "ref" and best.source == "measure"
    assert P_tune.last_sweep[0]["refused"] == "outside the kernel's domain"

    def fail(be, *a, **kw):
        raise RuntimeError("snp_step_sparse launch failed: CUDA error 98")
    monkeypatch.setattr(P_tune, "_time_step", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        P_tune.measure_best(system, sig, candidates=cands, device=CPU)


def test_degrade_chain_drops_the_kernel():
    plan = P.SystemPlan(backend="sparse_cuda", kernel=P.KernelConfig(
        block_t=4, threads=256))
    cands = P_failover.degrade_candidates(P.get_backend("sparse_cuda"), plan,
                                          device=CPU)
    assert [be.name for be, _ in cands] == ["cuda", "sparse", "ref"]
    assert all(p.kernel is None for _, p in cands)


def test_entry_points_pass_their_workload(cache_file, monkeypatch):
    seen = []
    real = P_tune.plan_for

    def spy(system, **kw):
        seen.append(kw["workload"])
        return real(system, **kw)
    monkeypatch.setattr(P_tune, "plan_for", spy)
    system = _port(_system())
    P.explore(system, max_steps=2, frontier_cap=32, visited_cap=256,
              max_branches=T, device=CPU)
    P.run_traces(system, steps=2, seeds=SEEDS, max_branches=T, device=CPU)
    P.successor_set(system, np.asarray(_system().initial_spikes),
                    max_branches=T, device=CPU)
    from repro_torch.core.distributed import explore_distributed
    explore_distributed(system, plan=P.SystemPlan(num_shards=2), max_steps=2,
                        frontier_cap=16, visited_cap=64, max_branches=T,
                        device=CPU)
    assert seen == [(32, T), (len(SEEDS), T), (1, T), (16, T)]


def test_committed_seed_file_parses(monkeypatch):
    """The committed seed rows: the card's, for the kernel backends, in
    both tiers, each with its spread; they fit a curve per kernel backend
    and tier, and without a seed file there is no fit at all."""
    monkeypatch.delenv("REPRO_TORCH_BENCH_BASELINE", raising=False)
    path = P_tune.seed_path()
    assert path is not None and path.name == "autotune_seed.json"
    payload = json.loads(path.read_text())
    assert payload["device"]["name"].startswith("NVIDIA H100")
    assert payload["device"]["power_limit"].endswith("W")
    rows = P_tune._baseline_rows()
    assert len(rows) == len(payload["rows"]) > 0
    assert {r.backend for r in rows} == set(P_failover.KERNEL_BACKENDS)
    assert all(r.us > 0 and r.spread >= 0 for r in rows)
    for semantics in ("no_delays", "delays"):
        assert set(P_tune._fitted_curves(semantics)) == \
            set(P_failover.KERNEL_BACKENDS)
    monkeypatch.setenv("REPRO_TORCH_BENCH_BASELINE", str(path) + ".missing")
    assert P_tune._fitted_curves() == {}
    assert P_tune._seed_entries() == {}


def test_no_cache_seed_or_fit_keeps_the_encoding_rule(cache_file, tmp_path,
                                                      monkeypatch):
    """When the planner has nothing to say, an open plan gets exactly the
    backend the entry points chose before the planner: "cuda", or
    "sparse_cuda" for a sparse encoding; still planned."""
    monkeypatch.setenv("REPRO_TORCH_BENCH_BASELINE",
                       str(tmp_path / "missing.json"))
    system = _port(_system())
    for device in (CPU, "cuda"):
        assert P_tune.plan_for(system, workload=(4, T),
                               device=device) is None
    be, plan, planned = P.resolve_entry_info(system, None, None, device=CPU)
    assert (be.name, plan.backend, planned) == ("cuda", "cuda", True)
    sparse = P.compile_system_sparse(system, device=CPU)
    assert P.resolve_entry(sparse, None, None, device=CPU).name == \
        "sparse_cuda"
    assert P.resolve_entry(system, None, P.SystemPlan(encoding="hybrid"),
                           device=CPU).name == "sparse_cuda"


def test_card_model_answers_only_inside_the_seeded_span(cache_file,
                                                       tmp_path,
                                                       monkeypatch):
    """On the card the model fits the seed rows of the signature's own
    system and tier, and neither extrapolates nor prices a system, or a
    delayed signature, by another's rows: outside the span of W those
    rows cover, for every kernel that takes it, the plan is left to the
    entry points' rule.  Off the card the reference's model still
    answers."""
    _baseline(tmp_path, monkeypatch, ROWS + _system_rows(40, 80, 8))
    inside = P_tune.WorkloadSignature(m=40, n=80, kin=5, B=16, T=8)
    assert P_tune.model_choice(inside, device="cuda").source == "model"
    # at the rows' own batches the model agrees with them
    for B, want in ((1, "cuda"), (64, "sparse_cuda")):
        assert P_tune.model_choice(dataclasses.replace(inside, B=B),
                                   device="cuda").backend == want
    for sig in (dataclasses.replace(inside, B=4096),      # past the rows
                dataclasses.replace(inside, B=1, T=1),    # below them
                dataclasses.replace(inside, m=41),        # another system
                dataclasses.replace(inside, semantics="delays")):
        assert P_tune.model_choice(sig, device="cuda") is None
        assert P_tune.model_choice(sig, device=CPU) is not None
    system = _port(_system())
    assert P_tune.plan_for(system, workload=(8, T), device="cuda") is None
    be, plan, planned = P.resolve_entry_info(
        system, None, None, workload=(8, T), device="cuda")
    assert (be.name, plan.kernel, planned) == ("cuda", None, True)


@pytest.mark.parametrize("gap, picked", [(50.0, (32, None)),
                                         (5.0, (None, None))])
def test_a_shape_beats_the_rule_only_past_the_spread(cache_file, tmp_path,
                                                     monkeypatch, gap,
                                                     picked):
    """A seeded or measured block shape displaces its backend's rule only
    when it is faster by more than the larger spread; otherwise the rule
    (no shape) is the winner, at the rule's time."""
    rows = [("cuda", None, 1000.0, 10.0), ("cuda", 32, 1000.0 - gap, 8.0),
            ("sparse_cuda", None, 2000.0, 10.0)]
    path = tmp_path / "seed.json"
    path.write_text(json.dumps({"rows": [
        {"name": f"snp_step/{b}/m40_n80_B16_T8", "us_per_call": us,
         "block_t": bt, "threads": None, "spread_us": sp}
        for b, bt, us, sp in rows]}))
    monkeypatch.setenv("REPRO_TORCH_BENCH_BASELINE", str(path))
    sig = P_tune.WorkloadSignature(m=40, n=80, kin=5, B=16, T=8)
    hit = P_tune.lookup(sig, device="cuda")
    assert (hit.backend, hit.block_t, hit.threads, hit.source) == \
        ("cuda", *picked, "seed")
    assert hit.us_per_step == (1000.0 - gap if picked[0] else 1000.0)
    timed = [(P_tune.TunedChoice(backend=b, block_t=bt, us_per_step=us,
                                 source="measure"), sp)
             for b, bt, us, sp in rows]
    assert (P_tune._pick(timed).block_t, P_tune._pick(timed).threads) == \
        picked


def test_measure_times_candidates_in_interleaved_rounds(cache_file,
                                                        monkeypatch):
    """One untimed call a candidate, then ``reps`` rounds that time every
    candidate once in turn; each row keeps its median and spread."""
    system = _port(_system())
    sig = P_tune.signature_of(system, workload=(4, T))
    cands = [P_tune.TunedChoice(backend="ref"),
             P_tune.TunedChoice(backend="sparse")]
    order = []
    real = P_tune._time_step

    def spy(be, *a, **kw):
        order.append(be.name)
        return real(be, *a, **kw)
    monkeypatch.setattr(P_tune, "_time_step", spy)
    best = P_tune.measure_best(system, sig, candidates=cands, reps=3,
                               device=CPU)
    assert order == ["ref", "sparse"] * 4
    assert best.backend in ("ref", "sparse") and best.source == "measure"
    assert all(r["us"] > 0 and r["spread_us"] >= 0
               for r in P_tune.last_sweep)
