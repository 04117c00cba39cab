"""The port's checkpoints and checkpointed explores against the JAX
package's.

* ``repro_torch.checkpoint``: the four contracts of the reference's
  ``tests/test_substrates.py`` (round trip, corruption, atomicity, the
  async checkpointer's garbage collection), and one layout: a nested tree
  of int32/float32 arrays written by either package is read by the other.
* ``explore`` checkpointed while healthy, and killed and resumed under
  ``run_supervised``, equals the uninterrupted run and the reference's
  ``explore`` of Π (12 levels) bit for bit: both dedup modes, both
  semantics tiers, through ``"ref"`` and ``"sparse"``.
* ``explore_distributed`` over ``neuron_axis(2)``, killed and resumed,
  equals the port's uninterrupted run.  (The reference's sharded explore
  fails under the installed jax, ROADMAP §3.)
"""

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import conftest  # noqa: E402
import repro.checkpoint as J_ckpt  # noqa: E402
import repro.core as J  # noqa: E402
import repro.runtime.faults as J_faults  # noqa: E402
import repro_torch.checkpoint as P_ckpt  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import random_system  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.core.distributed import explore_distributed  # noqa: E402
from repro_torch.runtime import FaultInjector, run_supervised  # noqa: E402
from repro_torch.sharding import neuron_axis  # noqa: E402

CPU = "cpu"
PI = J.paper_pi(True)
CAPS = dict(max_steps=12, max_branches=64)


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


# ---------------------------------------------------------------------------
# the checkpoint contracts
# ---------------------------------------------------------------------------

class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def _tree():
    return {"params": {"w": torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4) / 7,
                       "layers": (torch.arange(5, dtype=torch.int32),
                                  torch.ones(2, 2))},
            "pair": Pair(torch.tensor([1, -2], dtype=torch.int32),
                         torch.zeros(3, dtype=torch.bool)),
            "step": 7, "x": torch.arange(5)}


def _zeros_like(tree):
    leaves = [torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0
              for _, v in P_ckpt.checkpoint._leaves(tree)]
    return P_ckpt.checkpoint._rebuild(tree, iter(leaves))


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    P_ckpt.save_checkpoint(d, 7, tree, extra={"note": "x"})
    assert P_ckpt.latest_step(d) == 7
    got, step, extra = P_ckpt.restore_checkpoint(d, _zeros_like(tree))
    assert step == 7 and extra == {"note": "x"}
    assert isinstance(got["pair"], Pair) and got["step"] == 7
    for (k, a), (k2, b) in zip(P_ckpt.checkpoint._leaves(got),
                               P_ckpt.checkpoint._leaves(tree)):
        assert k == k2
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
        keys = set(json.load(f)["arrays"])
    assert keys == {"params/w", "params/layers/0", "params/layers/1",
                    "pair/.a", "pair/.b", "step", "x"}


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    path = P_ckpt.save_checkpoint(d, 1, {"w": torch.arange(32.0)})
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["w"][3] = 999.0
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        P_ckpt.restore_checkpoint(d, {"w": torch.zeros(32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        P_ckpt.restore_checkpoint(d, {"w": torch.zeros(31)}, verify=False)


def test_checkpoint_atomicity_partial_write_ignored(tmp_path):
    d = str(tmp_path / "ckpt")
    P_ckpt.save_checkpoint(d, 1, {"w": torch.zeros(4)})
    os.makedirs(os.path.join(d, "step_00000002.tmp"))   # a crashed writer
    assert P_ckpt.latest_step(d) == 1
    assert P_ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        P_ckpt.restore_checkpoint(str(tmp_path / "none"), {})


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = P_ckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.full((4,), s)})
    ck.wait()
    assert P_ckpt.latest_step(d) == 3
    assert sorted(int(x.split("_")[1]) for x in os.listdir(d)) == [2, 3]
    got, _, _ = P_ckpt.restore_checkpoint(
        d, {"w": torch.zeros(4, dtype=torch.int64)})
    assert got["w"].tolist() == [3, 3, 3, 3]


def _np_tree(rng):
    return {"enc": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                    "ids": rng.integers(-9, 9, (4,)).astype(np.int32)},
            "stack": (rng.integers(0, 99, (2, 3)).astype(np.int32),
                      rng.standard_normal(6).astype(np.float32)),
            "bias": rng.standard_normal(()).astype(np.float32)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_checkpoints(writer, tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _np_tree(np.random.default_rng(3))
    if writer == "port":
        P_ckpt.save_checkpoint(d, 4, jax.tree.map(torch.from_numpy, tree))
        got, step, _ = J_ckpt.restore_checkpoint(
            d, jax.tree.map(np.zeros_like, tree))
        got = jax.tree.map(np.asarray, got)
    else:
        J_ckpt.save_checkpoint(d, 4, jax.tree.map(jnp.asarray, tree))
        template = jax.tree.map(lambda a: torch.zeros(a.shape, dtype={
            np.dtype(np.float32): torch.float32,
            np.dtype(np.int32): torch.int32}[a.dtype]), tree)
        got, step, _ = P_ckpt.restore_checkpoint(d, template)
        got = jax.tree.map(lambda t: t.numpy(), got)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpointed explores
# ---------------------------------------------------------------------------

_REF = {}


def _reference(semantics, dedup):
    key = (semantics, dedup)
    if key not in _REF:
        system = conftest.delayed_variant(PI) if semantics == "delays" \
            else PI
        _REF[key] = J.explore(system, backend="ref", dedup=dedup,
                              plan=J.SystemPlan(semantics=semantics), **CAPS)
    return _REF[key]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.configs),
                                  np.asarray(b.configs))
    assert (int(a.num_discovered), int(a.steps), bool(a.exhausted),
            bool(a.branch_overflow), bool(a.frontier_overflow),
            bool(a.visited_overflow)) == \
        (int(b.num_discovered), int(b.steps), bool(b.exhausted),
         bool(b.branch_overflow), bool(b.frontier_overflow),
         bool(b.visited_overflow))


@pytest.mark.parametrize("backend", ["ref", "sparse"])
@pytest.mark.parametrize("dedup", ["hash", "sort"])
@pytest.mark.parametrize("semantics", ["no_delays", "delays"])
def test_explore_checkpointed_and_resumed_equals_reference(
        semantics, dedup, backend, tmp_path):
    system = conftest.delayed_variant(PI) if semantics == "delays" else PI
    kw = dict(backend=backend, dedup=dedup, device=CPU,
              plan=P.SystemPlan(semantics=semantics), **CAPS)
    port = _port(system)
    plain = P.explore(port, **kw)
    _same(plain, _reference(semantics, dedup))

    healthy = P.explore(port, checkpoint_dir=str(tmp_path / "healthy"),
                        checkpoint_every=3, **kw)
    _same(healthy, plain)

    inj = FaultInjector(fail_calls=(2,))
    resumed, restarts = run_supervised(
        lambda: P.explore(port, checkpoint_dir=str(tmp_path / "killed"),
                          checkpoint_every=1, fault_injector=inj, **kw),
        max_restarts=3)
    assert restarts == 1
    _same(resumed, plain)
    # snapshots hold the archive's filled prefix only
    step, manifest = P_ckpt.read_manifest(str(tmp_path / "killed"))
    assert step == plain.steps
    assert manifest["arrays"][".archive"]["shape"] == \
        list(plain.configs.shape)


def test_injector_kills_the_same_chunk_as_the_reference(tmp_path):
    """One ``on_device_call`` before an uninterrupted run and one per
    chunk, as in the reference: the same schedule restarts both the same
    number of times, and kills an uninterrupted run at call 1."""
    runs = {"port": (P.explore, _port(PI), FaultInjector, dict(device=CPU)),
            "reference": (J.explore, PI, J_faults.FaultInjector, {})}
    seen = {}
    for name, (explore, system, injector, kw) in runs.items():
        inj = injector(fail_calls=(1, 3))
        _, restarts = run_supervised(
            lambda: explore(system, checkpoint_dir=str(tmp_path / name),
                            checkpoint_every=4, fault_injector=inj,
                            backend="ref", **kw, **CAPS), max_restarts=5)
        with pytest.raises(Exception, match="device call 1"):
            explore(system, fault_injector=injector(fail_calls=(1,)),
                    backend="ref", **kw, **CAPS)
        seen[name] = (restarts, inj.calls)
    assert seen["port"] == seen["reference"]


def test_resume_refuses_other_capacities(tmp_path):
    port = _port(PI)
    d = str(tmp_path / "ckpt")
    P.explore(port, backend="ref", device=CPU, checkpoint_dir=d,
              checkpoint_every=4, **CAPS)
    with pytest.raises(ValueError, match="shape mismatch"):
        P.explore(port, backend="ref", device=CPU, checkpoint_dir=d,
                  frontier_cap=128, **CAPS)
    with pytest.raises(ValueError, match="checkpoint_every"):
        P.explore(port, backend="ref", device=CPU, checkpoint_dir=d,
                  checkpoint_every=0, **CAPS)


def test_planned_explore_raises_caller_errors_without_degrading(tmp_path):
    """With the backend left to the entry point (degradable), a snapshot
    of other capacities and a bad interval raise their ``ValueError`` at
    once: no degradation, no re-run on another backend."""
    import warnings

    from repro_torch.core import failover
    port = _port(PI)
    d = str(tmp_path / "ckpt")
    P.explore(port, device=CPU, checkpoint_dir=d, checkpoint_every=4,
              **CAPS)
    events = []
    failover.add_degrade_listener(events.append)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            with pytest.raises(ValueError, match="shape mismatch"):
                P.explore(port, device=CPU, checkpoint_dir=d,
                          frontier_cap=128, **CAPS)
            with pytest.raises(ValueError, match="checkpoint_every"):
                P.explore(port, device=CPU, checkpoint_dir=d,
                          checkpoint_every=0, **CAPS)
    finally:
        failover.remove_degrade_listener(events.append)
    assert events == []


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    inj = FaultInjector(fail_calls=(1, 2, 3, 4, 5, 6))
    with pytest.raises(RuntimeError, match="exceeded max_restarts"):
        run_supervised(
            lambda: P.explore(_port(PI), backend="ref", device=CPU,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=1, fault_injector=inj,
                              **CAPS),
            max_restarts=2)


@pytest.mark.parametrize("backend", ["ref", "sparse", "cuda",
                                     "sparse_cuda"])
def test_explore_distributed_killed_and_resumed_matches(backend, tmp_path):
    port = _port(random_system(9, 2, 0.3, seed=1))
    kw = dict(plan=neuron_axis(2), backend=backend, device=CPU,
              max_steps=8, frontier_cap=32, visited_cap=512,
              max_branches=32)
    plain = explore_distributed(port, **kw)
    assert plain.steps >= 4
    healthy = explore_distributed(port, checkpoint_dir=str(tmp_path / "h"),
                                  checkpoint_every=3, **kw)
    _same(healthy, plain)
    inj = FaultInjector(fail_calls=(3,))
    resumed, restarts = run_supervised(
        lambda: explore_distributed(
            port, checkpoint_dir=str(tmp_path / "k"), checkpoint_every=1,
            fault_injector=inj, **kw), max_restarts=5)
    assert restarts == 1
    _same(resumed, plain)
    _, manifest = P_ckpt.read_manifest(str(tmp_path / "k"))
    assert manifest["arrays"][".archive/1"]["shape"][0] == \
        plain.num_discovered
