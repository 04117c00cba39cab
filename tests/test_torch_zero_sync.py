"""The port's zero-host-sync BFS, on the CPU, in process.

The twin of ``tests/test_zero_sync.py:41-74`` (whose reference cells are
red here for the ``shard_map`` reason in ROADMAP.md §3; the reference side
is its in-process ``repro.core.explore(dedup="sort")``, as that test's own
in-process cell uses):

* the three level functions (``engine._explore_level``,
  ``distributed._dense_level``, ``distributed._sharded_level``) run with
  ``host_read``/``host_read_all``/``host_copy`` raising, and under a
  dispatch mode that refuses every operation that waits on the card
  (``.item()``, ``nonzero``, boolean indexing, ``bincount``, ``unique``,
  ``repeat_interleave`` without ``output_size``, tensors made from host
  data): what runs on the card as one CUDA graph reads nothing back;
* the counted reads of an un-checkpointed run are at most 2 and the same
  at 6 and 12 levels, for ``explore``, dense rows at R = 2 and 4 and
  ``neuron_axis(2)``/``(4)`` in both partitions; the fault injector's
  device calls are 1 without checkpointing and ``ceil(steps / 4)`` with
  ``checkpoint_every=4``, at one read a chunk;
* the overflow regime still reports its flags with a sound archive, and
  ``paper_pi(True)`` archives and flags equal the reference's;
* H1's and H2's plain versions (:mod:`repro_torch.kernels.hashtable.ref`)
  hold their contract against the reference's probe loops: equal keys in
  one batch (the lowest index wins), forged keys that share one base slot,
  a full table.
"""

import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.core as J  # noqa: E402
from repro.core import generators as jgen  # noqa: E402
from repro.core import hashtable as jht  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import device as devmod  # noqa: E402
from repro_torch.core import distributed, engine, graph_loop  # noqa: E402
from repro_torch.core.distributed import explore_distributed  # noqa: E402
from repro_torch.core.generators import power_law  # noqa: E402
from repro_torch.kernels.hashtable import ops as ht_ops  # noqa: E402
from repro_torch.kernels.hashtable import ref as ht_ref  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402
from repro_torch.sharding import neuron_axis  # noqa: E402

CPU = "cpu"
KW = dict(frontier_cap=32, visited_cap=512, max_branches=16)
SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many small ops a level: a thread per core only adds overhead here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# no read inside a level
# ---------------------------------------------------------------------------


_SYNCING = {"_local_scalar_dense", "nonzero", "masked_select", "bincount",
            "_unique2", "unique_dim", "unique_consecutive", "equal",
            "is_nonzero", "lift_fresh", "lift_fresh_copy", "allclose"}


class _NoWait(TorchDispatchMode):
    """Refuse every operation that, on a CUDA tensor, waits on the card
    (or copies from host data); ``paused`` lets the hash-table kernels'
    plain versions (each a kernel on the card) loop on the CPU."""

    paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            name = func.overloadpacket.__name__
            bool_index = name in ("index", "index_put", "index_put_") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ()) or ())
            if name in _SYNCING or bool_index or (
                    name == "repeat_interleave"
                    and kwargs.get("output_size") is None
                    and isinstance(args[0], torch.Tensor)):
                raise AssertionError(f"{func} waits on the card")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _levels_read_nothing(monkeypatch):
    """Wrap the three level functions: inside one, a counted read raises
    and so does any operation that would wait on the card.  Yields the
    calls of each level function."""
    calls = {"explore": 0, "dense": 0, "sharded": 0}
    inside = []

    def guard(fn):
        def read(*a, **kw):
            if inside:
                raise AssertionError("a host read inside a BFS level")
            return fn(*a, **kw)
        return read

    for mod in (devmod, engine, distributed, graph_loop):
        for name in ("host_read", "host_read_all", "host_copy"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, guard(getattr(mod, name)))

    mode = _NoWait()

    def paused(fn):
        def run(*a, **kw):
            mode.paused = True
            try:
                return fn(*a, **kw)
            finally:
                mode.paused = False
        return run

    monkeypatch.setattr(ht_ops, "lookup_ref", paused(ht_ops.lookup_ref))
    monkeypatch.setattr(ht_ops, "claim_ref", paused(ht_ops.claim_ref))

    def level(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            inside.append(1)
            try:
                with mode:
                    return fn(*a, **kw)
            finally:
                inside.pop()
        return run

    monkeypatch.setattr(engine, "_explore_level",
                        level("explore", engine._explore_level))
    monkeypatch.setattr(distributed, "_dense_level",
                        level("dense", distributed._dense_level))
    monkeypatch.setattr(distributed, "_sharded_level",
                        level("sharded", distributed._sharded_level))
    yield calls


@pytest.mark.parametrize("backend", ["ref", "cuda", "sparse",
                                     "sparse_cuda"])
def test_levels_make_no_host_read(backend, monkeypatch):
    system = P.paper_pi(True)
    kw = dict(max_steps=4, backend=backend, **KW)

    def runs():
        return {
            "explore": P.explore(system, dedup="hash", device=CPU, **kw),
            "dense": explore_distributed(system, mesh=[CPU] * 2, **kw),
            "sharded": explore_distributed(system, plan=neuron_axis(2),
                                           device=CPU, **kw)}

    want = runs()
    with _levels_read_nothing(monkeypatch) as calls:
        got = runs()
        # the sort dedup's level too, and a hybrid encoding's COO tail
        P.explore(system, dedup="sort", device=CPU, **kw)
        if backend.startswith("sparse"):
            P.explore(power_law(26, 3, seed=6), dedup="hash", device=CPU,
                      plan=P.SystemPlan(encoding="hybrid", hub_threshold=2),
                      **dict(kw, max_steps=2))
    assert calls["explore"] >= 4 + 4 and calls["dense"] == 4
    assert calls["sharded"] == 4
    for k in want:
        np.testing.assert_array_equal(got[k].configs, want[k].configs)
        assert got[k].steps == want[k].steps == 4


# ---------------------------------------------------------------------------
# counted reads a run, device calls a run
# ---------------------------------------------------------------------------


def _runs():
    system = P.paper_pi(True)
    yield "explore", lambda **kw: P.explore(system, device=CPU, **kw)
    for R in (2, 4):
        yield f"dense-R{R}", lambda R=R, **kw: explore_distributed(
            system, mesh=[CPU] * R, **kw)
    for S in (2, 4):
        for part in ("contiguous", "degree"):
            yield f"sharded-S{S}-{part}", (
                lambda S=S, part=part, **kw: explore_distributed(
                    system, plan=neuron_axis(S, partition=part),
                    device=CPU, **kw))


@pytest.mark.parametrize("name", [n for n, _ in _runs()])
def test_reads_a_run_do_not_grow_with_levels(name, monkeypatch):
    run = dict(_runs())[name]
    reads = {}
    for steps in (6, 12):
        monkeypatch.setattr(devmod, "host_reads", 0)
        inj = FaultInjector()
        r = run(max_steps=steps, fault_injector=inj, **KW)
        assert r.steps == steps and inj.calls == 1
        reads[steps] = devmod.host_reads
    assert reads[6] == reads[12] <= 2, reads


@pytest.mark.parametrize("name", ["explore", "dense-R2",
                                  "sharded-S2-degree"])
def test_checkpointed_run_reads_once_a_chunk(name, tmp_path, monkeypatch):
    run = dict(_runs())[name]
    plain = run(max_steps=12, **KW)
    monkeypatch.setattr(devmod, "host_reads", 0)
    inj = FaultInjector()
    r = run(max_steps=12, checkpoint_dir=str(tmp_path), checkpoint_every=4,
            fault_injector=inj, **KW)
    chunks = math.ceil(r.steps / 4)
    assert inj.calls == chunks == 3
    assert devmod.host_reads == chunks + 2
    np.testing.assert_array_equal(r.configs, plain.configs)


def test_overflow_is_flagged_and_sound():
    hard = power_law(26, 3, seed=6)
    truth = {tuple(r) for r in J.explore(
        jgen.power_law(26, 3, seed=6), backend="ref", dedup="sort",
        max_steps=6, frontier_cap=4096, visited_cap=65536,
        max_branches=64).configs}
    kw = dict(max_steps=6, frontier_cap=8, visited_cap=512, max_branches=64)
    for r in (explore_distributed(hard, device=CPU, **kw),
              P.explore(hard, device=CPU, **kw)):
        assert r.frontier_overflow and not r.exhausted
        assert {tuple(c) for c in r.configs} <= truth


def test_paper_pi_equals_the_reference():
    kw = dict(max_steps=12, **KW)
    want = J.explore(J.paper_pi(True), dedup="sort", **kw)
    wset = {tuple(r) for r in np.asarray(want.configs)}
    flags = (want.branch_overflow, want.frontier_overflow,
             want.visited_overflow)
    single = P.explore(P.paper_pi(True), dedup="sort", device=CPU, **kw)
    np.testing.assert_array_equal(single.configs, np.asarray(want.configs))
    for got in (single,
                explore_distributed(P.paper_pi(True), device=CPU, **kw),
                explore_distributed(P.paper_pi(True), mesh=[CPU] * 2, **kw),
                explore_distributed(P.paper_pi(True), plan=neuron_axis(2),
                                    device=CPU, **kw)):
        assert {tuple(r) for r in got.configs} == wset
        assert got.num_discovered == want.num_discovered
        assert got.steps == want.steps
        assert (got.branch_overflow, got.frontier_overflow,
                got.visited_overflow) == flags


# ---------------------------------------------------------------------------
# H1 / H2 plain versions against the reference's probe loops
# ---------------------------------------------------------------------------


def _fmix(x):
    x = np.uint64(x)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(SENT)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(SENT)
    return int(x ^ (x >> np.uint64(16)))


def _base(hi, lo, S):
    return _fmix(int(hi) ^ ((int(lo) * 0x9E3779B1) & SENT)) & (S - 1)


def _forged(S, n, rng, slot=3):
    """``n`` distinct keys whose chains all start at ``slot``."""
    keys = []
    while len(keys) < n:
        hi, lo = (int(v) for v in rng.integers(0, SENT, size=2))
        if _base(hi, lo, S) == slot:
            keys.append((hi, lo))
    return keys


def _cases():
    rng = np.random.default_rng(5)
    S = 64
    # equal keys in one batch: the lowest index of each group wins
    base = [tuple(int(v) for v in rng.integers(0, SENT, size=2))
            for _ in range(5)]
    equal = [base[i] for i in (3, 1, 3, 0, 1, 4, 3, 2, 0)]
    yield "equal-keys", S, [], equal, 64
    # forged keys on one base slot, some already in the table
    forged = _forged(S, 12, rng)
    yield "forged-base", S, forged[:5], forged[3:], 64
    # a full table: every slot taken, new keys overflow at D probes
    full = [tuple(int(v) for v in rng.integers(0, SENT, size=2))
            for _ in range(S)]
    fresh = [tuple(int(v) for v in rng.integers(0, SENT, size=2))
             for _ in range(6)]
    yield "full-table", S, full, fresh + full[:3], 64
    # a short probe bound on the forged chain
    yield "forged-short", S, forged[:6], forged, 4


def _tables(S, present):
    """The reference's and the port's table after inserting ``present``."""
    jt = jht.make_table(S // 2)
    pt = P.make_table(S // 2, device=CPU)
    if present:
        hi, lo = (np.array(x, np.uint32) for x in zip(*present))
        valid = np.ones(len(present), bool)
        pay = np.arange(100, 100 + len(present), dtype=np.int32)
        jt, _, _ = jht.insert_unique(jt, jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(valid), jnp.asarray(pay))
        pt, _, _ = P.insert_unique(pt, hi, lo, valid, pay)
    return jt, pt


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_probe_plain_versions_hold_the_reference_contract(case):
    _, S, present, batch, D = next(c for c in _cases() if c[0] == case)
    jt, pt = _tables(S, present)
    assert pt.num_slots == S
    hi = np.array([k[0] for k in batch], np.uint32)
    lo = np.array([k[1] for k in batch], np.uint32)
    valid = np.ones(len(batch), bool)
    valid[-1] = False
    pay = np.arange(len(batch), dtype=np.int32)
    t = lambda x: torch.from_numpy(x.astype(np.int64))  # noqa: E731
    chi, clo = (torch.where(torch.from_numpy(valid), t(x), SENT)
                for x in (hi, lo))
    # H1
    jf, jp = jht.lookup(jt, jnp.asarray(hi), jnp.asarray(lo),
                        jnp.asarray(valid), max_probes=D)
    pf, pp = ht_ref.lookup_ref(pt.slots_hi, pt.slots_lo, pt.slot_payload,
                               chi, clo, torch.from_numpy(valid), D)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    # H2, on the table and on a scratch one (first occurrence)
    jh, jl = jht._canonical(jnp.asarray(hi), jnp.asarray(lo),
                            jnp.asarray(valid))
    want = jht._claim_loop(jt.slots_hi, jt.slots_lo, jt.slot_payload, jh,
                           jl, jnp.asarray(valid), jnp.asarray(pay), D)
    got = ht_ref.claim_ref(pt.slots_hi, pt.slots_lo, pt.slot_payload, chi,
                           clo, torch.from_numpy(valid),
                           torch.from_numpy(pay), D)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    jfirst, jovf = jht.first_occurrence(jnp.asarray(hi), jnp.asarray(lo),
                                        jnp.asarray(valid), max_probes=D)
    pfirst, povf = P.first_occurrence(hi, lo, valid, max_probes=D)
    np.testing.assert_array_equal(pfirst.numpy(), np.asarray(jfirst))
    assert bool(povf) == bool(jovf)
    if case == "equal-keys":      # the lowest index of each group wins
        assert np.flatnonzero(pfirst.numpy()).tolist() == [0, 1, 3, 5, 7]
    if case == "full-table":
        assert bool(got[5]) and not got[3].any()


_SOURCES = {
    "dense": ("snp_step", "snp_step_dense.cu"),
    "dense_delay": ("snp_step", "snp_step_dense_delay.cu"),
    "sparse": ("snp_step", "snp_step_sparse.cu"),
    "hashtable": ("hashtable", "hashtable.cu"),
}


@pytest.mark.parametrize("source", sorted(_SOURCES))
def test_every_kernel_counts_its_own_launches(source):
    """A graph replay runs no Python, so each kernel of the BFS level
    (B1-B7, H1, H2) adds one to the counter it is given from one thread of
    its first block, before anything else: every ``__global__`` body of
    the source starts with that count, and its C entries take the
    counter."""
    import re
    from pathlib import Path

    import repro_torch.kernels as K

    pkg, name = _SOURCES[source]
    text = (Path(K.__file__).parent / pkg / "csrc" / name).read_text()
    bodies = re.findall(r"__global__[^{]*\{\n((?:.*\n){4})", text)
    assert bodies
    for body in bodies:
        assert "blockIdx.x == 0 && threadIdx.x == 0" in body, body
        assert "atomicAdd(" in body and "launches, 1ull)" in body, body
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    launching = [(n, a) for n, a in entries if "stream" in a]
    assert launching
    assert all("void* launches, void* stream" in " ".join(a.split())
               for _, a in launching)


def test_launch_counts_sum_by_kernel():
    """``by_kernel`` sums a read's shapes by kernel; without a card no
    counter exists, so no launch is counted."""
    from repro_torch.kernels import launch_counts

    assert launch_counts.by_kernel(
        {("B1", 16, 256): 3, ("B1", 8, 256): 2, ("H2",): 5}) == \
        {"B1": 5, "H2": 5}
    if not torch.cuda.is_available():
        assert launch_counts.read() == {} and launch_counts.launches() == 0
