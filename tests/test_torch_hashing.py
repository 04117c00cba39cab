"""The port's ``config_hash`` and open-addressing table against the
reference: the same ``(hi, lo)`` lanes (negative entries included), and
after the same insert sequence the same slots, payloads, counts, verdicts
and overflow flags (scenarios modelled on ``tests/test_hashtable.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import hashtable as jht  # noqa: E402
from repro.core.hashing import SENTINEL as JSENTINEL  # noqa: E402
from repro.core.hashing import config_hash as jhash  # noqa: E402
from repro_torch.core import hashtable as pht  # noqa: E402
from repro_torch.core.hashing import SENTINEL, config_hash  # noqa: E402


def _keys(rng, n):
    return (rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("shape,lo,hi", [
    ((64, 7), -2**31, 2**31),          # full int32 range, negatives included
    ((3, 4, 5), -3, 4),                # leading batch dims
    ((9, 1), 0, 5),                    # m = 1
    ((16, 2046), 0, 4),                # the full-width neuron count
])
def test_config_hash_lanes_match_reference(shape, lo, hi):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(lo, hi, size=shape).astype(np.int32)
    jh, jl = jhash(jnp.asarray(x))
    ph, pl = config_hash(torch.from_numpy(x))
    assert ph.dtype == torch.int64 and ph.shape == shape[:-1]
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl).astype(np.int64))


def test_sentinel_and_sizing_match_reference():
    assert SENTINEL == int(JSENTINEL)
    for cap in (1, 4, 5, 100, 2048, 4097, 262144):
        assert pht.table_slots(cap) == jht.table_slots(cap)
    with pytest.raises(ValueError, match="capacity"):
        pht.table_slots(0)


def _assert_same_table(pt, jt):
    np.testing.assert_array_equal(pt.slots_hi.numpy(),
                                  np.asarray(jt.slots_hi).astype(np.int64))
    np.testing.assert_array_equal(pt.slots_lo.numpy(),
                                  np.asarray(jt.slots_lo).astype(np.int64))
    np.testing.assert_array_equal(pt.slot_payload.numpy(),
                                  np.asarray(jt.slot_payload))
    assert int(pt.count) == int(jt.count)


def _scenario(name):
    """(capacity, [(hi, lo, valid, payload), ...]) insert batches."""
    rng = np.random.default_rng(7)
    if name == "first-occurrence":
        hi = np.array([1, 2, 1, 3, 2, 1], np.uint32)
        lo = np.full(6, 9, np.uint32)
        b = (hi, lo, np.ones(6, bool), None)
        return 16, [b, b]
    if name == "invalid-lanes":
        k = np.array([5, 6, 7], np.uint32)
        return 8, [(k, k, np.array([True, False, True]), None)]
    if name == "sentinel-key":
        s = np.full(2, JSENTINEL, np.uint32)
        return 8, [(s, s, np.ones(2, bool), None),
                   (s[:1], (s - 1)[:1], np.ones(1, bool), None)]
    if name == "wraparound":
        return 12, [(*_keys(rng, 12), np.ones(12, bool), None),
                    (*_keys(rng, 12), np.ones(12, bool), None)]
    if name == "overflow-at-capacity":
        return 4, [(*_keys(rng, 64), np.ones(64, bool), None)]
    if name == "payloads":
        return 32, [(*_keys(rng, 20), np.ones(20, bool),
                     np.arange(100, 120, dtype=np.int32))]
    if name == "duplicates-across-batches":
        pool_hi, pool_lo = _keys(rng, 6)
        batches = []
        for _ in range(4):
            pick = rng.integers(0, 6, size=10)
            batches.append((pool_hi[pick], pool_lo[pick],
                            rng.random(10) < 0.8, None))
        return 64, batches
    raise KeyError(name)


SCENARIOS = ["first-occurrence", "invalid-lanes", "sentinel-key",
             "wraparound", "overflow-at-capacity", "payloads",
             "duplicates-across-batches"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_insert_sequence_matches_reference(name):
    cap, batches = _scenario(name)
    jt = jht.make_table(cap)
    pt = pht.make_table(cap, device="cpu")
    _assert_same_table(pt, jt)
    for hi, lo, valid, payload in batches:
        jt, jnew, jovf = jht.insert_if_absent(jt, hi, lo, valid,
                                              payload=payload)
        pt, pnew, povf = pht.insert_if_absent(pt, hi, lo, valid,
                                              payload=payload)
        np.testing.assert_array_equal(pnew.numpy(), np.asarray(jnew))
        assert bool(povf) == bool(jovf)
        _assert_same_table(pt, jt)
        jfound, jpay = jht.lookup(jt, hi, lo, valid)
        pfound, ppay = pht.lookup(pt, hi, lo, valid)
        np.testing.assert_array_equal(pfound.numpy(), np.asarray(jfound))
        np.testing.assert_array_equal(ppay.numpy(), np.asarray(jpay))
    if name == "overflow-at-capacity":
        assert bool(povf)


@pytest.mark.parametrize("max_probes", [None, 2])
def test_first_occurrence_matches_reference(max_probes):
    rng = np.random.default_rng(3)
    hi, lo = _keys(rng, 8)
    pick = rng.integers(0, 8, size=40)
    valid = rng.random(40) < 0.9
    jfirst, jovf = jht.first_occurrence(hi[pick], lo[pick], valid,
                                        max_probes)
    pfirst, povf = pht.first_occurrence(hi[pick], lo[pick], valid,
                                        max_probes)
    np.testing.assert_array_equal(pfirst.numpy(), np.asarray(jfirst))
    assert bool(povf) == bool(jovf)


def test_claim_ties_go_to_the_lowest_index():
    """Equal keys in one batch: only the lowest index is new — the rule
    that fixes archive order, whatever order the card applies updates."""
    hi = np.array([7, 7, 7, 8, 7], np.uint32)
    lo = np.array([1, 1, 1, 2, 1], np.uint32)
    valid = np.array([False, True, True, True, True])
    _, new, _ = pht.insert_if_absent(pht.make_table(8, device="cpu"),
                                     hi, lo, valid)
    np.testing.assert_array_equal(new.numpy(),
                                  [False, True, False, True, False])
