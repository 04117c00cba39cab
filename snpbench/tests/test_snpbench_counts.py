"""The yardstick's arithmetic worked by hand, and the per-layer readers on
a hand-made trace."""

import pytest

from snpb import counts
from snpb.manifest import reader
from snpb.trace import Explore, Interval, TraceContext, union

# the paper's Π: 3 neurons, 5 rules, 4 synapses
PI = {"num_neurons": 3, "num_rules": 5, "num_synapses": 4}


def test_step_bytes_by_hand():
    # F = 2 rows of 3 entries read (24 B), 5 rules of 24 B, 4 synapses of
    # 8 B, 2·4 candidates of 12 B + a validity byte + a 4-byte emission
    assert counts.step_bytes(PI, 2, 4) == 24 + 120 + 32 + 8 * 17 == 312


def test_explore_bytes_by_hand():
    # 10 rows of 12 B: 10 - 2 read as frontier, 10 written as frontier,
    # 10 into the archive; 10 keys of 8 B; the system (152 B) 5 times
    assert counts.explore_io_bytes(PI, 2, 10, 5) == \
        12 * (8 + 20) + 80 + 5 * 152 == 1176
    assert counts.archive_bytes(PI, 10) == 120
    assert counts.explore_least_s(PI, 2, 10, 5) == pytest.approx(
        max(1176 / 3.35e12, 120 / 64e9))


def test_powerlaw8192_step_bound():
    sizes = {"num_neurons": 8192, "num_rules": 16384, "num_synapses": 32768}
    b = counts.step_bytes(sizes, 512, 64)
    assert b == 512 * 8192 * 4 + 16384 * 24 + 32768 * 8 \
        + 32768 * (8192 * 4 + 5)
    assert b / counts.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.3258,
                                                             abs=1e-4)


def _ctx():
    """Two explores of 2 levels each on a made-up timeline (µs), each
    traced over its own span: a step kernel, H1, an elementwise kernel a
    level, then the counts' read and the archive's copy-out."""
    ev = []
    for base in (0.0, 1000.0):
        ev += [Interval("aten::zero_ fill", base, base + 10, "kernel"),
               Interval("void snp_step_dense_kernel<8>(int*)", base + 20,
                        base + 120, "kernel"),
               Interval("h1_kernel(H1Args)", base + 120, base + 150,
                        "kernel"),
               Interval("elementwise_kernel", base + 150, base + 170,
                        "kernel"),
               Interval("void snp_step_dense_kernel<8>(int*)", base + 200,
                        base + 300, "kernel"),
               Interval("h1_kernel(H1Args)", base + 300, base + 330,
                        "kernel"),
               Interval("Memset (Device)", base + 330, base + 340, "fill"),
               Interval("Memcpy DtoH (Device -> Pageable)", base + 400,
                        base + 401, "dtoh"),
               Interval("Memcpy DtoH (Device -> Pageable)", base + 410,
                        base + 810, "dtoh")]
    explores = [Explore(0, 900, 2, 5), Explore(1000, 1900, 2, 5)]
    return TraceContext(device=ev, host=[], explores=explores, sizes=PI,
                        traffic={"frontier_cap": 2, "max_branches": 4})


def test_readers_on_a_hand_made_trace():
    ctx = _ctx()
    assert reader("level_device_ms").read(ctx) == pytest.approx(
        2 * 320 / 1e3 / 4)
    assert reader("dedup_ms_per_level").read(ctx) == pytest.approx(
        4 * 30 / 1e3 / 4)
    assert reader("bookkeeping_ms_per_level").read(ctx) == pytest.approx(
        2 * (20 + 10) / 1e3 / 4)
    assert reader("copyout_ms_per_explore").read(ctx) == pytest.approx(
        2 * 401 / 1e3 / 2)
    busy = 2 * (10 + 150 + 140 + 1 + 400)
    assert reader("idle_share").read(ctx) == pytest.approx(
        100 * (1 - busy / 1800))
    least = 4 * 312 / counts.HBM_BYTES_PER_S
    assert reader("step_roofline").read(ctx) == pytest.approx(
        100 * least / 400e-6)
    assert reader("level_mfu").read(ctx) == pytest.approx(
        100 * 2 * counts.explore_least_s(PI, 2, 5, 2) / 1800e-6)


def test_readers_find_nothing_in_an_empty_trace():
    ctx = TraceContext(device=[], host=[], explores=[], sizes=PI,
                       traffic={"frontier_cap": 2, "max_branches": 4})
    for name in ("level_device_ms", "dedup_ms_per_level", "step_roofline",
                 "bookkeeping_ms_per_level", "copyout_ms_per_explore",
                 "idle_share", "level_mfu"):
        assert reader(name).read(ctx) is None


def test_breakdown_names_gaps_by_host_events():
    ctx = _ctx()
    ctx.host = [Interval("cudaGraphInstantiate", 850, 990, "host"),
                Interval("snpbench.explore", 0, 900, "host")]
    b = ctx.breakdown()
    assert b["device_ops"][0][0] == "Memcpy DtoH"
    assert b["idle_gaps"][0] == ["cudaGraphInstantiate", pytest.approx(
        (900 - 810) / 1e6)]
    assert len(b["idle_gaps"]) == 10


def test_union():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
