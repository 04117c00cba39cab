"""The port's neuron-sharded ``explore_distributed`` against the
reference's, on the CPU: archives equal in discovery order, with the same
flags, counts and levels, through all four port backends, both partitions,
the overflow case and ``init=``; and the port's own refusals.

The reference's distributed runs need ``S`` devices: each shard count runs
in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=S``
(the subprocesses of all shard counts start together).  Under the
installed jax the reference's ``shard_map`` call passes ``check_rep``, which
``jax.shard_map`` no longer takes, so the subprocess rebinds the
reference module's ``shard_map`` name to a wrapper passing
``check_vma=False`` instead; no reference file changes.  It returns its
archives through ``np.savez``.  The reference runs its plain backends, and
two cases its Pallas kernels in interpret mode (every reference backend
gives the same archive)."""

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
from repro_torch.sharding import neuron_axis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BACKENDS = ("ref", "cuda", "sparse", "sparse_cuda")

# name -> (shards, system expr, partition, caps, init, reference backend);
# the systems and caps are test_sharded_frontier.py's (its 8-shard
# equivalence cases and its 4-shard overflow case)
PI = dict(max_steps=16, frontier_cap=64, visited_cap=512, max_branches=16)
RAND = dict(max_steps=8, frontier_cap=256, visited_cap=2048, max_branches=64)
PL = dict(max_steps=4, frontier_cap=128, visited_cap=1024, max_branches=32)
OVF = dict(max_steps=6, frontier_cap=8, visited_cap=512, max_branches=64)
CASES = {
    "pi-S8": (8, "paper_pi(True)", "contiguous", PI, None, "ref"),
    "pi-S8-degree": (8, "paper_pi(True)", "degree", PI, None, "sparse"),
    "rand9-S8": (8, "random_system(9, 2, 0.3, seed=1)", "contiguous", RAND,
                 None, "ref"),
    "rand9-S8-degree": (8, "random_system(9, 2, 0.3, seed=1)", "degree",
                        RAND, None, "sparse"),
    "pl26-S8": (8, "power_law(26, 3, seed=6)", "contiguous", PL, None,
                "ref"),
    "pl26-S8-degree": (8, "power_law(26, 3, seed=6)", "degree", PL, None,
                       "ref"),
    "rand9-S4-overflow": (4, "random_system(9, 2, 0.3, seed=1)",
                          "contiguous", OVF, None, "ref"),
    "pi-S4-init": (4, "paper_pi(True)", "contiguous", PI, (2, 1, 3), "ref"),
    "rand9-S4-degree-init": (4, "random_system(9, 2, 0.3, seed=1)",
                             "degree", RAND, (1, 0, 2, 1, 0, 1, 2, 0, 1),
                             "sparse"),
    "pi-S4-pallas": (4, "paper_pi(True)", "degree", PI, None, "pallas"),
    "pl26-S4-sparse-pallas": (4, "power_law(26, 3, seed=6)", "degree", PL,
                              None, "sparse_pallas"),
}

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
from repro.core.generators import power_law, random_system
from repro.sharding import neuron_axis

cases, out = json.loads(sys.argv[1]), sys.argv[2]
assert len(jax.devices()) == cases[0][1]
arrays = {}
for name, S, expr, part, caps, init, backend in cases:
    r = dist.explore_distributed(eval(expr), plan=neuron_axis(S, partition=part),
                                 backend=backend, init=init, **caps)
    arrays[name + "/configs"] = np.asarray(r.configs)
    arrays[name + "/meta"] = np.asarray(
        [r.num_discovered, r.steps, r.exhausted, r.branch_overflow,
         r.frontier_overflow, r.visited_overflow], np.int64)
np.savez(out, **arrays)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``{case: (configs, meta)}`` from the reference's sharded runs, one
    subprocess per shard count, all started together."""
    tmp = tmp_path_factory.mktemp("ref_sharded")
    procs = []
    for S in sorted({c[0] for c in CASES.values()}):
        cases = [(name, S, expr, part, caps, init, be)
                 for name, (s, expr, part, caps, init, be) in CASES.items()
                 if s == S]
        out = tmp / f"S{S}.npz"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={S}",
                   PYTHONPATH=os.path.join(REPO, "src"))
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_SCRIPT),
             json.dumps(cases), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
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


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_explore_matches_reference_in_order(reference, case,
                                                    backend):
    S, expr, part, caps, init, _ = CASES[case]
    got = explore_distributed(_port_system(expr),
                              plan=neuron_axis(S, partition=part),
                              backend=backend, init=init, device=CPU, **caps)
    want = reference[case]
    np.testing.assert_array_equal(got.configs, want["configs"])
    assert _meta(got) == want["meta"].tolist()
    if case == "rand9-S4-overflow":
        assert got.frontier_overflow and not got.exhausted


def test_mesh_of_devices_equals_one_device():
    system = _port_system("random_system(9, 2, 0.3, seed=1)")
    kw = dict(plan=neuron_axis(3, partition="degree"), backend="sparse_cuda",
              **PL)
    a = explore_distributed(system, device=CPU, **kw)
    b = explore_distributed(system, mesh=[CPU] * 3, **kw)
    np.testing.assert_array_equal(a.configs, b.configs)
    assert _meta(a) == _meta(b)


def test_a_sharded_compiled_and_one_shard_equal_explore():
    """A pre-lowered ``ShardedCompiled`` runs without a plan; over one
    shard it is the single-device explore, row for row."""
    system = _port_system("random_system(9, 2, 0.3, seed=1)")
    comp = P.compile_sharded(system, neuron_axis(1), device=CPU)
    for backend in BACKENDS:
        got = explore_distributed(comp, backend=backend, device=CPU, **RAND)
        want = P.explore(system, backend="ref", device=CPU, **RAND)
        np.testing.assert_array_equal(got.configs, want.configs)
        assert _meta(got) == _meta(want)


def test_refusals():
    system = _port_system("paper_pi(True)")
    plan = neuron_axis(2)
    # without a sharded plan (one shard is none) the dense-row scheme
    # runs (tests/test_torch_distributed_dense.py), and refuses what the
    # reference cannot run
    dense = explore_distributed(system, device=CPU, **PI)
    one = explore_distributed(system, plan=neuron_axis(1), device=CPU, **PI)
    np.testing.assert_array_equal(dense.configs, one.configs)
    assert dense.num_discovered > 1
    with pytest.raises(ValueError, match="raise send_cap"):
        explore_distributed(system, mesh=[CPU] * 2, send_cap=1,
                            frontier_cap=4)
    with pytest.raises(ValueError, match="delay-free"):
        explore_distributed(system, plan=P.SystemPlan(semantics="delays"),
                            device=CPU)
    with pytest.raises(ValueError, match="checkpoint_every"):
        explore_distributed(system, plan=plan, device=CPU,
                            checkpoint_dir="ckpt", checkpoint_every=0)
    with pytest.raises(ValueError, match="single-device encoding"):
        explore_distributed(P.compile_system_sparse(system, device=CPU),
                            plan=plan, backend="sparse", device=CPU)
    with pytest.raises(ValueError, match="mesh device count"):
        explore_distributed(system, plan=plan, mesh=[CPU] * 3)
    with pytest.raises(ValueError, match="not both"):
        explore_distributed(system, plan=plan, mesh=[CPU] * 2, device=CPU)
    with pytest.raises(ValueError, match="hybrid"):
        explore_distributed(system, plan=neuron_axis(2, encoding="hybrid"),
                            device=CPU)
    with pytest.raises(ValueError, match="delays"):
        explore_distributed(P.with_delays(system, 1),
                            plan=P.SystemPlan(num_shards=2,
                                              semantics="delays"),
                            device=CPU)

    @dataclasses.dataclass(frozen=True)
    class Unsharded(P.SparseBackend):
        name: str = "unsharded"

        def supported_encodings(self, semantics="no_delays"):
            return ("ell",)

    with pytest.raises(ValueError, match="'sharded'"):
        explore_distributed(system, plan=plan, backend=Unsharded(),
                            device=CPU)


def test_entry_point_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        explore_distributed(_port_system("paper_pi(True)"),
                            plan=neuron_axis(2))
