"""The port's ``run_traces_distributed`` on the CPU: the batch split over
``mesh=["cpu"] * R`` ranks (R = 1, 3 and 8, padded batches included)
equals the reference's single-device ``run_traces`` bit for bit, for both
policies, a dense and a hybrid encoding and all four port backends; one
case equals the reference's own ``run_traces_distributed`` on 8 forced
devices (a subprocess with the reference's ``shard_map`` name rebound, as
``tests/test_torch_distributed.py`` does); the refusals carry the
reference's messages; a backend the entry point chose degrades as in
``run_traces``; and ``make_trace_runner(mesh=)`` is the mesh runner."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.core import failover as J_failover  # noqa: E402
from repro.core.distributed import \
    run_traces_distributed as J_run_traces_distributed  # noqa: E402
from repro.core.generators import nd_chain, power_law  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import failover as P_failover  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.core.distributed import run_traces_distributed  # noqa: E402
from repro_torch.serve import make_trace_runner  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BACKENDS = ("ref", "cuda", "sparse", "sparse_cuda")
PI = J.paper_pi(True)
HYBRID = power_law(40, 3, seed=3)


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this module: its level loops run many
    small ops, and when the suite runs in several worker processes, a
    worker with a thread per core waits at every parallel region for
    threads the others keep off the cores (tenfold slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_warn_state():
    for mod in (J_failover, P_failover):
        mod._WARNED.clear()
    yield
    for mod in (J_failover, P_failover):
        mod._WARNED.clear()


def _systems(kind, backend):
    """(port system, reference system) for ``kind``; the hybrid pair is
    compiled by each package at hub threshold 4 for the sparse backends,
    and the dense ones step the same system's dense encoding."""
    if kind == "pi":
        return _port(PI), PI
    if kind == "chain":
        return _port(nd_chain(4)), nd_chain(4)
    if backend in ("sparse", "sparse_cuda"):
        return (P.compile_system_sparse(_port(HYBRID), hub_threshold=4,
                                        device=CPU),
                J.compile_system_sparse(HYBRID, hub_threshold=4))
    return P.compile_system(_port(HYBRID), device=CPU), \
        J.compile_system(HYBRID)


# name -> (system kind, batch, policy, steps, max_branches): the
# reference's multi-device cases (16 and 5 seeds: the pad path) and a
# hybrid encoding
CASES = {
    "pi-16-random": ("pi", 16, "random", 10, 16),
    "pi-5-random": ("pi", 5, "random", 10, 16),
    "chain-8-first": ("chain", 8, "first", 10, 16),
    "hybrid-7-random": ("hybrid", 7, "random", 9, 64),
}


def _assert_same(got, want):
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), np.asarray(y))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_traces_equal_reference_run_traces(case, R, backend):
    kind, B, policy, steps, T = CASES[case]
    port_sys, ref_sys = _systems(kind, backend)
    kw = dict(steps=steps, seeds=list(range(B)), policy=policy,
              max_branches=T)
    got = run_traces_distributed(port_sys, mesh=[CPU] * R, backend=backend,
                                 **kw)
    assert got.configs.shape[0] == B and got.configs.device.type == "cpu"
    _assert_same(got, J.run_traces(ref_sys, **kw))


_SCRIPT = """
import json, sys
import numpy as np
import jax
import repro.core.distributed as dist

def _shard_map(f, mesh=None, in_specs=None, out_specs=None, check_rep=None,
               **kw):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)

dist.shard_map = _shard_map
from repro.core import paper_pi

kw, out = json.loads(sys.argv[1])
assert len(jax.devices()) == 8
r = dist.run_traces_distributed(paper_pi(True), **kw)
np.savez(out, *[np.asarray(x) for x in r])
"""


def test_equals_the_reference_run_traces_distributed_on_8_devices(
        tmp_path):
    kw = dict(steps=10, seeds=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
              policy="random", max_branches=16)
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SCRIPT),
         json.dumps([kw, str(out)])], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        want = [z[f"arr_{i}"] for i in range(4)]
    got = run_traces_distributed(_port(PI), mesh=[CPU] * 8, backend="cuda",
                                 **kw)
    _assert_same(got, want)


def _message(fn, **kw):
    with pytest.raises(ValueError) as e:
        fn(**kw)
    return str(e.value)


@pytest.mark.parametrize("bad", ["policy", "shards", "seeds"])
def test_refusals_carry_the_reference_messages(bad):
    """The reference refuses before it builds its mesh, so it runs in
    this process; both raise ``ValueError`` with the same message, in the
    same order (a bad policy first)."""
    kw = dict(steps=4, seeds=[[0, 1]],
              policy="greedy" if bad == "policy" else "first")
    if bad == "shards":
        want = _message(J_run_traces_distributed, system=PI,
                        plan=J.SystemPlan(num_shards=2), **kw)
        got = _message(run_traces_distributed, system=_port(PI),
                       plan=P.SystemPlan(num_shards=2), mesh=[CPU], **kw)
    else:
        want = _message(J_run_traces_distributed, system=PI, **kw)
        got = _message(run_traces_distributed, system=_port(PI),
                       mesh=[CPU], **kw)
    assert got == want
    assert {"policy": "policy", "shards": "num_shards",
            "seeds": "1-D"}[bad] in got


def test_device_must_be_the_first_of_the_mesh():
    kw = dict(steps=4, seeds=[0, 1, 2], policy="random", max_branches=16)
    with pytest.raises(ValueError, match="first device"):
        run_traces_distributed(_port(PI), mesh=["meta", CPU], device=CPU,
                               backend="ref", **kw)
    with pytest.raises(ValueError, match="no device"):
        run_traces_distributed(_port(PI), mesh=[], backend="ref", **kw)
    # the first device, named either way, is the home of the result
    a = run_traces_distributed(_port(PI), mesh=[CPU] * 2, device="cpu",
                               backend="ref", **kw)
    b = run_traces_distributed(_port(PI), device=CPU, backend="ref", **kw)
    _assert_same(a, [x.numpy() for x in b])


def test_a_chosen_backend_degrades_and_a_named_one_raises(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))

    def broken(self, *a, **kw):
        raise RuntimeError(f"forced failure of {self.name!r}")

    for cls in (P.CudaBackend, P.SparseCudaBackend):
        monkeypatch.setattr(cls, "expand", broken)
    events = []
    P_failover.add_degrade_listener(events.append)
    kw = dict(steps=6, seeds=list(range(5)), policy="random",
              max_branches=16, mesh=[CPU] * 3)
    try:
        with pytest.warns(RuntimeWarning, match="degrading"):
            got = run_traces_distributed(_port(PI), **kw)
    finally:
        P_failover.remove_degrade_listener(events.append)
    assert events and events[-1].to_backend in ("sparse", "ref")
    _assert_same(got, J.run_traces(PI, steps=6, seeds=list(range(5)),
                                   policy="random", max_branches=16))
    with pytest.raises(RuntimeError, match="forced failure of 'cuda'"):
        run_traces_distributed(_port(PI), backend="cuda", **kw)


def test_make_trace_runner_with_a_mesh_is_the_mesh_runner():
    runner = make_trace_runner(mesh=[CPU] * 3)
    assert isinstance(runner, functools.partial)
    assert runner.func is run_traces_distributed
    assert runner.keywords == {"mesh": [CPU] * 3}
    assert make_trace_runner() is P.run_traces
    kw = dict(steps=5, seeds=[7, 8], policy="random", max_branches=16,
              backend="ref")
    _assert_same(runner(_port(PI), device=CPU, **kw),
                 [x.numpy() for x in P.run_traces(_port(PI), device=CPU,
                                                  **kw)])


def test_entry_point_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_traces_distributed(_port(PI), steps=2, seeds=[0])
