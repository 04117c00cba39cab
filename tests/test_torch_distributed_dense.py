"""The port's dense-row hash-partitioned ``explore_distributed`` against
the reference's, on the CPU: archives equal in discovery order (the
reference's own order, rank by rank), with the same counts, levels and
flags, at R = 2, 4 and 8 ranks (``mesh=["cpu"] * R``), through all four
port backends; the cases of ``tests/test_distributed.py`` (the paper's Π,
a random system, frontier overflow, the finite tree, send overflow),
``init=``, an ELL and a hybrid plan, and the reference's Pallas kernel in
interpret mode on one case.  Also: the single-device set equality, a
killed-and-resumed run, and the refusals, the delayed plan's beside the
reference's own failure.

The reference's distributed runs need ``R`` devices: each rank count runs
in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=R``
(all started together), with the reference module's ``shard_map`` name
rebound to pass ``check_vma=False`` in place of the ``check_rep`` the
installed jax refuses, as ``tests/test_torch_distributed.py`` does; no
reference file changes.  Archives come back through ``np.savez``."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.core.distributed import explore_distributed  # noqa: E402
from repro_torch.runtime import FaultInjector, run_supervised  # noqa: E402
from repro_torch.sharding import neuron_axis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BACKENDS = ("ref", "cuda", "sparse", "sparse_cuda")
SPARSE = ("sparse", "sparse_cuda")

# the caps of tests/test_distributed.py's cases (the random system's at
# half its frontier, still without overflow)
PI = dict(max_steps=12, frontier_cap=32, visited_cap=256, max_branches=16)
OVF = dict(max_steps=6, frontier_cap=8, visited_cap=512, max_branches=64)
TREE = dict(max_steps=32, frontier_cap=64, visited_cap=512, max_branches=64)
SEND = dict(max_steps=6, frontier_cap=32, visited_cap=512, max_branches=64,
            send_cap=8)
PL = dict(max_steps=5, frontier_cap=64, visited_cap=1024, max_branches=32)


def _rand(R):
    """8 levels of the random system, whose largest level has 1,152 new
    configurations: no rank's frontier overflows at 2,048 // R rows."""
    return dict(max_steps=8, frontier_cap=2048 // R,
                visited_cap=16384 // R, max_branches=64)


RAND9 = "random_system(9, 2, 0.3, seed=1)"
HYBRID = {"encoding": "hybrid", "hub_threshold": 2}
ELL = {"encoding": "ell"}
# name -> (R, system expr, caps, init, plan fields, reference backend)
CASES = {
    "pi-R2": (2, "paper_pi(True)", PI, None, None, "ref"),
    "pi-R4": (4, "paper_pi(True)", PI, None, None, "ref"),
    "pi-R8": (8, "paper_pi(True)", PI, None, None, "ref"),
    "rand9-R2": (2, RAND9, _rand(2), None, None, "ref"),
    "rand9-R4": (4, RAND9, _rand(4), None, None, "ref"),
    "rand9-R8": (8, RAND9, _rand(8), None, None, "ref"),
    "rand9-R4-overflow": (4, RAND9, OVF, None, None, "ref"),
    "tree9-R4": (4, "random_system(9, 2, 0.3, seed=9)", TREE, None, None,
                 "ref"),
    "rand9-R4-send-overflow": (4, RAND9, SEND, None, None, "ref"),
    "rand9-R8-send-overflow": (8, RAND9, SEND, None, None, "ref"),
    "pi-R2-init": (2, "paper_pi(True)", PI, (2, 1, 3), None, "ref"),
    "rand9-R8-init": (8, RAND9, _rand(8), (1, 0, 2, 1, 0, 1, 2, 0, 1), None,
                      "ref"),
    "rand9-R2-ell": (2, RAND9, _rand(2), None, ELL, "sparse"),
    "pl26-R4-hybrid": (4, "power_law(26, 3, seed=6)", PL, None, HYBRID,
                       "sparse"),
    "pl26-R8-hybrid": (8, "power_law(26, 3, seed=6)", PL, None, HYBRID,
                       "sparse"),
    "pi-R2-pallas": (2, "paper_pi(True)", PI, None, None, "pallas"),
}
DELAYED = dict(max_steps=4, frontier_cap=8, visited_cap=64, max_branches=8)

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
from repro.core import SystemPlan, paper_pi
from repro.core.generators import power_law, random_system

R, cases, delayed, out = json.loads(sys.argv[1])
assert len(jax.devices()) == R
arrays = {}
for name, expr, caps, init, plan, backend in cases:
    r = dist.explore_distributed(
        eval(expr), backend=backend, init=init,
        plan=None if plan is None else SystemPlan(**plan), **caps)
    arrays[name + "/configs"] = np.asarray(r.configs)
    arrays[name + "/meta"] = np.asarray(
        [r.num_discovered, r.steps, r.exhausted, r.branch_overflow,
         r.frontier_overflow, r.visited_overflow], np.int64)
if delayed is not None:
    try:
        dist.explore_distributed(paper_pi(True),
                                 plan=SystemPlan(semantics="delays"),
                                 **delayed)
        err = ""
    except Exception as e:
        err = f"{type(e).__name__}: {e}"
    arrays["delayed/error"] = np.asarray(err)
np.savez(out, **arrays)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``{case: {configs, meta}}`` from the reference's dense-row runs,
    one subprocess per rank count, all started together; the R = 2 one
    also tries the delayed plan and returns its error."""
    tmp = tmp_path_factory.mktemp("ref_dense")
    procs = []
    for R in sorted({c[0] for c in CASES.values()}):
        cases = [(name, expr, caps, init, plan, be)
                 for name, (r, expr, caps, init, plan, be) in CASES.items()
                 if r == R]
        out = tmp / f"R{R}.npz"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={R}",
                   PYTHONPATH=os.path.join(REPO, "src"))
        arg = json.dumps([R, cases, DELAYED if R == 2 else None, str(out)])
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_SCRIPT), arg], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    got = {}
    for out, proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with np.load(out) as z:
            for key in z.files:
                name, what = key.split("/")
                got.setdefault(name, {})[what] = z[key]
    return got


def _port_system(expr):
    from repro.core.generators import power_law, random_system  # noqa
    paper_pi = J.paper_pi  # noqa: F841
    return system_from_spec(dataclasses.asdict(eval(expr)))


def _meta(r):
    return [r.num_discovered, r.steps, r.exhausted, r.branch_overflow,
            r.frontier_overflow, r.visited_overflow]


def _run(case, backend, **kw):
    """The port's run of ``case`` on ``R`` CPU ranks.  A plan's encoding
    goes to the sparse backends; the dense ones step the dense encoding
    of the same system, whose archive is the same."""
    R, expr, caps, init, plan, _ = CASES[case]
    plan = P.SystemPlan(**plan) if plan and backend in SPARSE else None
    return explore_distributed(_port_system(expr), mesh=[CPU] * R,
                               backend=backend, init=init, plan=plan,
                               **{**caps, **kw})


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_row_explore_matches_reference_in_order(reference, case,
                                                      backend):
    got = _run(case, backend)
    want = reference[case]
    np.testing.assert_array_equal(got.configs, want["configs"])
    assert _meta(got) == want["meta"].tolist()


def test_the_cases_reach_what_they_name(reference):
    """Each case exercises its condition (in the reference's run)."""
    meta = {k: v["meta"].tolist() for k, v in reference.items()
            if "meta" in v}
    assert meta["rand9-R4-overflow"][4] and not meta["rand9-R4-overflow"][2]
    assert meta["tree9-R4"][0] == 6 and meta["tree9-R4"][2]
    for case in ("rand9-R4-send-overflow", "rand9-R8-send-overflow"):
        assert meta[case][3], case       # the send overflow is a branch flag
    for case in ("pi-R2", "pi-R8", "rand9-R2", "rand9-R8", "pl26-R8-hybrid"):
        assert not any(meta[case][3:]), case
    comp = P.compile_system_sparse(_port_system("power_law(26, 3, seed=6)"),
                                   hub_threshold=2, device=CPU)
    assert comp.coo_src.shape[0] > 0            # the hybrid plan has hubs


@pytest.mark.parametrize("R", [2, 8])
def test_dense_row_equals_single_device_as_a_set(R):
    """tests/test_distributed.py's ``test_distributed_matches_single_device``
    on the port: no overflow, and the archive of the single-device
    explore as a set."""
    for expr, caps, single in (
            ("paper_pi(True)", PI, dict(PI, frontier_cap=256,
                                        visited_cap=2048)),
            (RAND9, _rand(R), dict(_rand(1)))):
        system = _port_system(expr)
        rd = explore_distributed(system, mesh=[CPU] * R, backend="cuda",
                                 **caps)
        rs = P.explore(system, device=CPU, **single)
        assert not (rd.branch_overflow or rd.frontier_overflow
                    or rd.visited_overflow or rs.frontier_overflow)
        assert {tuple(r) for r in rd.configs} == \
            {tuple(r) for r in rs.configs}
        assert rd.num_discovered == rs.num_discovered


def test_one_rank_on_the_device_equals_a_mesh_of_one(reference):
    system = _port_system(RAND9)
    a = explore_distributed(system, device=CPU, backend="sparse_cuda",
                            **_rand(4))
    b = explore_distributed(system, mesh=[CPU], backend="ref", **_rand(4))
    np.testing.assert_array_equal(a.configs, b.configs)
    assert _meta(a) == _meta(b)
    # a plan of one shard is the dense-row scheme on its encoding
    c = explore_distributed(system, plan=neuron_axis(1), device=CPU,
                            **_rand(4))
    np.testing.assert_array_equal(a.configs, c.configs)


@pytest.mark.parametrize("caps", [_rand(8), OVF, SEND])
@pytest.mark.parametrize("backend", ["cuda", "sparse"])
def test_one_rank_equals_explore_row_for_row(caps, backend):
    """One rank receives its valid candidates in index order (the owner
    sort is stable), so its archive is the single-device hash-dedup
    explore's, row for row, frontier overflow and all, when its send
    slots hold the wave."""
    system = _port_system(RAND9)
    caps = {k: v for k, v in caps.items() if k != "send_cap"}
    a = explore_distributed(system, device=CPU, backend=backend, **caps)
    b = P.explore(system, device=CPU, backend=backend, dedup="hash", **caps)
    np.testing.assert_array_equal(a.configs, b.configs)
    assert _meta(a) == _meta(b)


@pytest.mark.parametrize("backend", ["ref", "sparse_cuda"])
def test_killed_and_resumed_equals_uninterrupted(reference, tmp_path,
                                                 backend):
    """Checkpointed every 2 levels, killed at its second chunk and resumed
    under ``run_supervised``: the uninterrupted archive, and the
    reference's."""
    want = _run("rand9-R4", backend)
    d = str(tmp_path / "ckpt")
    inj = FaultInjector(fail_calls=(2,))
    got, restarts = run_supervised(
        lambda: _run("rand9-R4", backend, checkpoint_dir=d,
                     checkpoint_every=2, fault_injector=inj),
        max_restarts=3)
    assert restarts == 1
    np.testing.assert_array_equal(got.configs, want.configs)
    assert _meta(got) == _meta(want)
    np.testing.assert_array_equal(got.configs,
                                  reference["rand9-R4"]["configs"])
    # a finished run's snapshots resume to the same result at once
    again = _run("rand9-R4", backend, checkpoint_dir=d, checkpoint_every=2)
    np.testing.assert_array_equal(again.configs, want.configs)


def test_delayed_plan_is_refused_where_the_reference_fails(reference):
    err = str(reference["delayed"]["error"])
    assert err.startswith("ValueError") and "Incompatible shapes" in err, err
    system = _port_system("paper_pi(True)")
    with pytest.raises(ValueError, match="delay-free"):
        explore_distributed(system, plan=P.SystemPlan(semantics="delays"),
                            mesh=[CPU] * 2, **DELAYED)
    comp = P.compile_system(P.with_delays(system, 1), semantics="delays",
                            device=CPU)
    with pytest.raises(ValueError, match="delay-free"):
        explore_distributed(comp, device=CPU, **DELAYED)


def test_refusals():
    system = _port_system("paper_pi(True)")
    with pytest.raises(ValueError, match="raise send_cap"):
        explore_distributed(system, mesh=[CPU] * 2, send_cap=4,
                            frontier_cap=16)
    with pytest.raises(ValueError, match="not both"):
        explore_distributed(system, mesh=[CPU] * 2, device=CPU)
    with pytest.raises(ValueError, match="no device"):
        explore_distributed(system, mesh=[])
    with pytest.raises(ValueError, match="checkpoint_every"):
        explore_distributed(system, device=CPU, checkpoint_dir="ckpt",
                            checkpoint_every=0)
    # the smallest send_cap that takes the frontier runs
    r = explore_distributed(system, mesh=[CPU] * 2, send_cap=8,
                            frontier_cap=16, max_steps=4, backend="ref")
    assert r.steps == 4 and r.num_discovered > 1


def test_entry_point_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        explore_distributed(_port_system("paper_pi(True)"))
    with pytest.raises(RuntimeError, match="CUDA"):
        explore_distributed(_port_system("paper_pi(True)"),
                            mesh=["cuda"] * 2)
