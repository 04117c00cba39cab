"""The BFS level's dedup through kernels H1 and H2, on the CPU.

* ``core/hashtable._hash_lookup`` (H1's rows body on the card) runs, on
  CPU tensors, ``config_hash``, the canonical lanes and ``lookup``'s plain
  version: it equals the reference's ``config_hash`` -> ``lookup`` on
  seeded rows at widths 1, 31, 2,046 and 6,138, with negative entries,
  invalid rows, a table holding some rows' keys and ``max_probes`` 1, 2
  and the default;
* H1's rows and hash bodies hash a row as chunks of 4 entries dealt to the
  row's threads, each thread running Horner's rule over its own chunks
  with the step ``P^(4L)`` and scaling its sum once, the entries before a
  row's first 16-byte boundary and after its last chunk taken one a
  thread: that arithmetic, emulated here in numpy, equals
  ``config_hash_ref`` at every alignment and both row shapes;
* ``ops.claim_route`` picks H2's route from the sizes ``(K, S, D)`` and
  whether the table starts empty, sends a given table or a long probe
  bound past the cluster route, and refuses what it cannot route;
* the plain versions count their calls under the keys the card's
  counters use, and those are what ``chip_smoke.py`` expects of a run;
* the engine's level through ``_hash_lookup`` still gives the paper's §5
  run (``tests/test_paper_repro.py``), row for row the reference's.
"""

import functools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import hashtable as jht  # noqa: E402
from repro.core.hashing import config_hash as jhash  # noqa: E402
from repro.core.matrix import compile_system as jcompile  # noqa: E402
from repro.core.system import paper_pi as jpaper_pi  # noqa: E402

import chip_smoke  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import hashtable as pht  # noqa: E402
from repro_torch.core.distributed import explore_distributed  # noqa: E402
from repro_torch.core.hashing import SENTINEL, config_hash_ref  # noqa: E402
from repro_torch.kernels.hashtable import ops  # noqa: E402
from repro_torch.sharding import neuron_axis  # noqa: E402

M32 = (1 << 32) - 1
GOLDEN, MIX, P1, P2 = 0x9E3779B9, 0x85EBCA6B, 0x01000193, 0x85EBCA77


def _table_from(jt):
    return pht.HashTable(
        torch.from_numpy(np.asarray(jt.slots_hi).astype(np.int64)),
        torch.from_numpy(np.asarray(jt.slots_lo).astype(np.int64)),
        torch.from_numpy(np.asarray(jt.slot_payload).astype(np.int32)),
        torch.tensor(int(jt.count), dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _reference_rows(w):
    """Seeded rows of width ``w`` (negative entries, a repeated row,
    invalid rows), the reference's lanes and a small reference table
    holding every other valid row's key (and so chains)."""
    rng = np.random.default_rng(w)
    K = 24
    rows = rng.integers(-2**31, 2**31, size=(K, w), dtype=np.int64)
    rows = rows.astype(np.int32)
    rows[5] = rows[2]
    valid = rng.random(K) < 0.75
    valid[2] = valid[5] = True
    jh, jl = (np.asarray(x) for x in jhash(jnp.asarray(rows)))
    held = valid & (np.arange(K) % 2 == 0)
    jt, _, _ = jht.insert_if_absent(jht.make_table(12), jh, jl, held,
                                    payload=np.arange(K, dtype=np.int32))
    return rows, valid, jh, jl, held, jt


@pytest.mark.parametrize("max_probes", [None, 1, 2])
@pytest.mark.parametrize("w", [1, 31, 2046, 6138])
def test_hash_lookup_equals_the_reference(w, max_probes):
    rows, valid, jh, jl, held, jt = _reference_rows(w)
    jfound, _ = jht.lookup(jt, jh, jl, valid, max_probes)
    hi, lo, found = pht._hash_lookup(_table_from(jt), torch.from_numpy(rows),
                                     torch.from_numpy(valid), max_probes)
    want_hi = np.where(valid, jh.astype(np.int64), SENTINEL)
    want_lo = np.where(valid, jl.astype(np.int64), SENTINEL)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    if max_probes is None:
        assert found.numpy()[held].all() and found.numpy()[5]


def test_hash_lookup_remaps_the_empty_marker(monkeypatch):
    """A valid row whose lanes are both the empty marker is looked up as
    ``(SENTINEL, SENTINEL - 1)``, as the reference's lookup remaps it."""
    rows = torch.zeros((3, 4), dtype=torch.int32)
    table = pht.make_table(4, device="cpu")

    def forged(x):
        hi, lo = config_hash_ref(x)
        return torch.full_like(hi, SENTINEL), torch.full_like(lo, SENTINEL)

    monkeypatch.setattr(ops, "config_hash_ref", forged)
    hi, lo, found = pht._hash_lookup(table, rows,
                                     torch.tensor([True, False, True]))
    assert hi.tolist() == [SENTINEL] * 3
    assert lo.tolist() == [SENTINEL - 1, SENTINEL, SENTINEL - 1]
    assert not found.any()


def _fmix(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _emulated_row(row, misalign, L):
    """H1's lanes of one row as the kernel computes them: the row starts
    ``misalign`` entries past a 16-byte boundary, ``L`` threads share it."""
    w = len(row)
    x = row.astype(np.int64) & M32
    j = np.arange(w, dtype=np.int64)
    y = (((x + j * GOLDEN) & M32).astype(np.uint64)
         * np.uint64(MIX)) & np.uint64(M32)
    y = (y ^ (y >> np.uint64(16))).astype(np.int64)
    pw1 = [pow(P1, w - 1 - k, 1 << 32) for k in range(w)]
    pw2 = [pow(P2, w - 1 - k, 1 << 32) for k in range(w)]
    head = min(w, (4 - misalign) % 4)
    nch = (w - head) // 4
    step1, step2 = pow(P1, 4 * L, 1 << 32), pow(P2, 4 * L, 1 << 32)
    s1 = s2 = 0
    for t in range(L):
        a1 = a2 = 0
        last = None
        for c in range(t, nch, L):
            ys = [int(v) for v in y[head + 4 * c: head + 4 * c + 4]]
            c1 = c2 = 0
            for v in ys:
                c1 = (c1 * P1 + v) & M32
                c2 = (c2 * P2 + (v ^ GOLDEN)) & M32
            a1 = (a1 * step1 + c1) & M32
            a2 = (a2 * step2 + c2) & M32
            last = c
        if last is not None:
            k = head + 4 * last + 3
            s1 += a1 * pw1[k]
            s2 += a2 * pw2[k]
    for k in list(range(head)) + list(range(head + 4 * nch, w)):
        s1 += int(y[k]) * pw1[k]
        s2 += (int(y[k]) ^ GOLDEN) * pw2[k]
    hi = _fmix((s1 & M32) ^ w)
    lo = _fmix((s2 + w * GOLDEN) & M32)
    return hi, lo


@pytest.mark.parametrize("L", [32, 256])
@pytest.mark.parametrize("w", [1, 3, 5, 31, 2046, 6138])
def test_h1_row_arithmetic_equals_config_hash(w, L):
    rng = np.random.default_rng(w + L)
    rows = rng.integers(-2**31, 2**31, size=(2, w), dtype=np.int64)
    rows = rows.astype(np.int32)
    hi, lo = config_hash_ref(torch.from_numpy(rows))
    for r in range(2):
        for misalign in range(4):
            assert _emulated_row(rows[r], misalign, L) == \
                (int(hi[r]), int(lo[r])), (r, misalign)


def test_row_threads_rule():
    assert ops.row_threads(32768) == 32
    assert ops.row_threads(ops.FILL_WARPS) == 32
    assert ops.row_threads(ops.FILL_WARPS - 1) == ops.THREADS
    assert ops.row_threads(1) == ops.THREADS


@pytest.mark.parametrize("K,S,D,fresh,route", [
    (32768, 65536, 64, True, ("cluster", 16)),  # the wave's first occurrence
    (32768, 65536, 64, False, ("grid", 0)),     # ... into a given table
    (512, 524288, 64, False, ("cta", 1)),       # the level's insert, F = 512
    (512, 524288, 64, True, ("cta", 1)),
    (1, 524288, 64, False, ("cta", 1)),         # the initial insert
    (1024, 2048, 64, True, ("cta", 1)),
    (1025, 2048, 64, True, ("cluster", 16)),
    (1025, 2048, 64, False, ("grid", 0)),
    (8192, 16384, 64, True, ("cluster", 16)),   # a dense-row rank's first
    (4096, 8192, 64, True, ("cluster", 16)),    # occurrence
    (16385, 32768, 64, True, ("cluster", 16)),
    (65536, 131072, 64, True, ("cluster", 16)),
    (131072, 262144, 64, True, ("cluster", 16)),  # 128 KB a block
    (131073, 262144, 64, True, ("grid", 0)),    # 8,193 candidates a block
    (262144, 524288, 64, True, ("grid", 0)),
    (32768, 524288, 64, True, ("cluster", 16)),  # 144 KB a block
    (1025, 1 << 20, 64, True, ("grid", 0)),     # 256 KB of claim words
    (32768, 524288, 64, False, ("grid", 0)),    # the wave's insert into V's
    (100000, 524288, 64, False, ("grid", 0)),   # table
])
def test_claim_route_by_size(K, S, D, fresh, route):
    assert tuple(ops.claim_route(K, S, D, fresh)) == route
    if route[0] != "grid":
        blocks, threads = ops.claim_block_shape(K, S, D, fresh)
        assert blocks == route[1] and threads <= ops.CTA_MAX
        if route[0] == "cluster":
            per = -(-K // route[1])
            assert S // route[1] * ops.CLUSTER_SLOT_BYTES + \
                per * ops.CLUSTER_KEY_BYTES <= ops.CLUSTER_SMEM
            assert per <= ops.CLUSTER_ITEMS * ops.CTA_MAX


@pytest.mark.parametrize("K,S,D,route", [
    (32768, 65536, ops.CLUSTER_MAX_PROBES, ("cluster", 16)),
    (32768, 65536, ops.CLUSTER_MAX_PROBES + 1, ("grid", 0)),
    (16384, 32768, 32768, ("grid", 0)),
    (1025, 2048, 2 ** 20, ("grid", 0)),
    (512, 524288, 524288, ("cta", 1)),
])
def test_claim_route_sends_long_probe_bounds_past_the_cluster(K, S, D, route):
    """The cluster route's claim words keep the round in 15 bits, so a
    first occurrence whose 2·D + 1 rounds do not fit takes the grid."""
    assert 2 * ops.CLUSTER_MAX_PROBES + 1 < 2 ** 15
    assert tuple(ops.claim_route(K, S, D, True)) == route


def test_first_occurrence_at_a_long_probe_bound_takes_the_grid():
    """``first_occurrence`` at 20,000 probes into 32,768 slots: the plain
    version runs under the grid route's key and equals the default bound's
    answer (no chain is that long)."""
    rng = np.random.default_rng(12)
    K = 16384
    keys = rng.integers(0, 2**32, size=(2, K // 2), dtype=np.uint64)
    keys = keys[:, rng.integers(0, K // 2, size=K)].astype(np.int64)
    hi, lo = torch.from_numpy(keys[0]), torch.from_numpy(keys[1])
    valid = torch.from_numpy(rng.random(K) < 0.9)
    ops.plain_calls.clear()
    first, ovf = pht.first_occurrence(hi, lo, valid, max_probes=20000)
    assert ops.plain_calls == Counter({("H2", "grid"): 1})
    want, want_ovf = pht.first_occurrence(hi, lo, valid)
    assert ops.plain_calls == Counter({("H2", "grid"): 1,
                                       ("H2", "cluster"): 1})
    assert torch.equal(first, want) and not bool(ovf) and not bool(want_ovf)


@pytest.mark.parametrize("K,S,D", [(-1, 16, 64), (4, 0, 64), (4, 24, 64),
                                   (4, 3, 64), (4, 16, -1)])
def test_claim_route_refuses_what_it_cannot_route(K, S, D):
    with pytest.raises(ValueError, match="no claim route"):
        ops.claim_route(K, S, D, True)


def test_first_occurrence_equals_a_claim_into_an_empty_table():
    """``first_claim`` (a table of the kernel's own) against ``claim_`` into
    an empty table, the route the counters use, and the plain calls'
    keys."""
    rng = np.random.default_rng(11)
    K = 2048
    pool = rng.integers(0, 2**32, size=(2, 300), dtype=np.uint64)
    pick = rng.integers(0, 300, size=K)
    hi = torch.from_numpy(pool[0, pick].astype(np.int64))
    lo = torch.from_numpy(pool[1, pick].astype(np.int64))
    pend = torch.from_numpy(rng.random(K) < 0.9)
    S = pht.table_slots(K)
    ops.plain_calls.clear()
    won, dup, ovf = ops.first_claim(hi, lo, pend, S, 64)
    table = tuple(x.clone() for x in pht._empty(S, 0, "cpu"))
    want = ops.claim_(*table, hi, lo, pend, torch.zeros(K, dtype=torch.int32),
                      64)
    for g, w in zip((won, dup, ovf), want):
        assert torch.equal(g, w)
    assert ops.plain_calls == Counter({("H2", "cluster"): 1,
                                       ("H2", "grid"): 1})


def _plain_run(run):
    ops.plain_calls.clear()
    res = run()
    return res, Counter({k: n for k, n in ops.plain_calls.items() if n})


@pytest.mark.parametrize("scheme", ["explore", "sort", "dense", "sharded"])
def test_plain_calls_are_what_the_smoke_expects(scheme):
    """A CPU run counts its plain calls under the card's keys, as many as
    ``chip_smoke._probe_launches`` expects of the same run on the card."""
    F, T, V = 128, 16, 512
    system = P.paper_pi(True)
    kw = dict(max_steps=5, frontier_cap=F, max_branches=T, visited_cap=V)
    if scheme in ("explore", "sort"):
        res, calls = _plain_run(lambda: P.explore(
            system, device="cpu", dedup="hash" if scheme == "explore"
            else "sort", **kw))
        want = chip_smoke._probe_launches(scheme, F, T, V)
    elif scheme == "dense":
        R = 2
        res, calls = _plain_run(lambda: explore_distributed(
            system, mesh=["cpu"] * R, **kw))
        want = chip_smoke._probe_launches("dense", F, T, V, R,
                                          chip_smoke._send_cap(kw, R))
    else:
        S = 2
        res, calls = _plain_run(lambda: explore_distributed(
            system, plan=neuron_axis(S), device="cpu", **kw))
        want = chip_smoke._probe_launches("sharded", F, T, V, S)
    assert res.steps == 5
    assert calls == +want(res.steps)
    assert set(calls) <= set(ops.KEYS)


def test_paper_run_through_the_new_level(monkeypatch):
    """``tests/test_paper_repro.py``'s §5 run: every level hashes and looks
    its rows up through ``_hash_lookup``, and the archive is the
    reference's, in discovery order."""
    calls = []
    real = engine._hash_lookup

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(engine, "_hash_lookup", spy)
    kw = dict(max_steps=16, frontier_cap=128, visited_cap=2048,
              max_branches=16, dedup="hash")
    res = P.explore(P.paper_pi(True), device="cpu", **kw)
    ref = jengine.explore(jcompile(jpaper_pi(covering=True)), **kw)
    assert len(calls) == res.steps == ref.steps
    np.testing.assert_array_equal(res.configs, np.asarray(ref.configs))
    paper = list(dict.fromkeys(chip_smoke.PAPER_ALLGENCK))
    assert res.as_strings()[:45] == paper[:45]
    assert set(paper) <= set(res.as_strings())
    for flag in ("branch_overflow", "frontier_overflow", "visited_overflow"):
        assert bool(getattr(res, flag)) == bool(getattr(ref, flag)), flag
