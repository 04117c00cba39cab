"""The port's neuron-axis sharded lowering against the reference's, array
for array: ``partition_neurons``/``partition_stats``, ``compile_sharded``,
``lower_shard_dense`` and ``shard_view``; the plan's validation and
refusals; ``SystemPlan.for_system(num_shards=)``; and the sharded route of
the backends' lowering."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import (power_law, random_system,  # noqa: E402
                                   ring_lattice)
from repro.core.plan import shard_view as jshard_view  # noqa: E402
from repro.sharding import neuron_axis as jneuron_axis  # noqa: E402
from repro_torch.core import plan as PP  # noqa: E402
from repro_torch.core.convert import (sharded_from_arrays,  # noqa: E402
                                      system_from_spec)
from repro_torch.sharding import neuron_axis  # noqa: E402

CPU = "cpu"
SYSTEMS = {
    "paper-pi": J.paper_pi(True),
    "random-10": random_system(10, 2, 0.4, seed=2),
    "power-law-400": power_law(400, 3, seed=2),
    "ring-lattice-24": ring_lattice(24, 4, seed=1),
}
SHARDS = (1, 2, 3, 4, 8)
PARTITIONS = ("contiguous", "degree")
# The port's own ShardArrays fields (B7's sliced lists): no reference
# field, checked against in_idx instead.
OWN = ("sell_start", "sell_src")
REF_FIELDS = tuple(f for f in P.ShardArrays._fields if f not in OWN)


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _plans(name, S, partition):
    """The (reference, port) plans of one case: the auto plan
    (``for_system(num_shards=S)``) where it picks this partition for the
    heavy-tailed graph, else an ELL plan with the partition asked for."""
    system = SYSTEMS[name]
    if name == "power-law-400" and S > 1:
        jp = J.SystemPlan.for_system(system, num_shards=S, mode="static")
        if jp.partition == partition:
            return jp, P.SystemPlan.for_system(_port(system), num_shards=S)
    return (J.SystemPlan(encoding="ell", num_shards=S, partition=partition),
            P.SystemPlan(encoding="ell", num_shards=S, partition=partition))


def _assert_arrays(port, ref, fields):
    for k in fields:
        a, b = getattr(port, k).numpy(), np.asarray(getattr(ref, k))
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("partition", PARTITIONS)
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_compile_sharded_matches_reference(name, S, partition):
    jp, pp = _plans(name, S, partition)
    assert (pp.encoding, pp.num_shards, pp.partition) == \
        (jp.encoding, jp.num_shards, jp.partition)
    system = SYSTEMS[name]
    ref = J.lower_shard_dense(J.compile_sharded(system, jp))
    got = P.lower_shard_dense(P.compile_sharded(_port(system), pp,
                                                device=CPU))
    _assert_arrays(got.arrays, ref.arrays, REF_FIELDS)
    assert (got.num_neurons, got.num_rules, got.shard_size, got.num_shards,
            got.halo_width) == (ref.num_neurons, ref.num_rules,
                                ref.shard_size, ref.num_shards,
                                ref.halo_width)
    assert got.halo_width >= 1
    np.testing.assert_array_equal(got.occupancy, ref.occupancy)
    np.testing.assert_array_equal(got.init_config.numpy(),
                                  np.asarray(ref.init_config))
    # the dense view: M_local and hadj, and the reference's one-hot is the
    # port's rule_neuron on the real (applicable-at-all) rules
    _assert_arrays(got.dense, ref.dense, ("M_local", "hadj"))
    assert got.dense.hadj.dtype == torch.int8
    rn = got.arrays.rule_neuron.numpy()
    real = got.arrays.regex_base.numpy() != PP._NEVER_BASE
    onehot = np.zeros(np.asarray(ref.dense.onehot).shape, np.int8)
    d, i = np.nonzero(real)
    onehot[d, i, rn[d, i]] = 1
    np.testing.assert_array_equal(onehot, np.asarray(ref.dense.onehot))
    # one shard's view
    for shard in {0, S - 1}:
        jv = jshard_view(type(ref.arrays)(*(
            x if k == "rule_slots" else x[shard:shard + 1]
            for k, x in ref.arrays._asdict().items())))
        pv = P.plan.shard_view(got.arrays, shard)
        _assert_arrays(pv, jv, jv._fields)
        assert (pv.num_rules, pv.num_neurons) == (jv.num_rules,
                                                  jv.num_neurons)


@pytest.mark.parametrize("partition", PARTITIONS)
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_partition_neurons_and_stats_match_reference(name, S, partition):
    system = SYSTEMS[name]
    ref = J.partition_neurons(system, S, partition)
    got = P.partition_neurons(_port(system), S, partition)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert P.partition_stats(got[3]) == J.partition_stats(ref[3])


def test_partition_stats_edges_match_reference():
    for occ in (np.zeros((0,)), np.zeros((3,)), np.array([5, 1, 3])):
        assert P.partition_stats(occ) == J.partition_stats(occ)


@pytest.mark.parametrize("kwargs,match", [
    (dict(num_shards=0), "num_shards"),
    (dict(num_shards=-2), "num_shards"),
    (dict(num_shards=2, partition="random"), "partition"),
])
def test_plan_validation_matches_reference(kwargs, match):
    with pytest.raises(ValueError, match=match):
        J.SystemPlan(**kwargs)
    with pytest.raises(ValueError, match=match):
        P.SystemPlan(**kwargs)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_for_system_num_shards_matches_reference(name, S):
    system = SYSTEMS[name]
    ref = J.SystemPlan.for_system(system, num_shards=S, mode="static")
    got = P.SystemPlan.for_system(_port(system), num_shards=S)
    assert (got.encoding, got.hub_threshold, got.num_shards,
            got.partition) == (ref.encoding, ref.hub_threshold,
                               ref.num_shards, ref.partition)
    for plan in (J, P):
        with pytest.raises(ValueError, match="delays"):
            plan.SystemPlan.for_system(
                system if plan is J else _port(system), num_shards=2,
                semantics="delays")


def test_neuron_axis_matches_reference():
    for kw in ({}, dict(partition="degree"), dict(encoding="hybrid",
                                                   hub_threshold=3)):
        ref, got = jneuron_axis(4, **kw), neuron_axis(4, **kw)
        assert (got.encoding, got.hub_threshold, got.num_shards,
                got.partition) == (ref.encoding, ref.hub_threshold,
                                   ref.num_shards, ref.partition)


@pytest.mark.parametrize("plan_kw,match", [
    (dict(encoding="hybrid"), "hybrid"),
    (dict(encoding="dense"), "dense"),
    (dict(semantics="delays"), "delays"),
])
def test_compile_sharded_refusals_match_reference(plan_kw, match):
    system = J.paper_pi(True)
    if plan_kw.get("semantics") == "delays":
        system = J.with_delays(system, 1)
    with pytest.raises(ValueError, match=match):
        J.compile_sharded(system, J.SystemPlan(num_shards=2, **plan_kw))
    with pytest.raises(ValueError, match=match):
        P.compile_sharded(_port(system), P.SystemPlan(num_shards=2,
                                                      **plan_kw),
                          device=CPU)


def test_backends_lower_sharded_plans():
    """Every backend declares ``"sharded"`` for the delay-free tier only;
    its ``compile`` of a sharded plan is the sharded lowering, with the
    dense shard operands for ``"cuda"`` only; the single-device entry
    points refuse a sharded plan."""
    system = _port(SYSTEMS["random-10"])
    plan = neuron_axis(3)
    want = P.compile_sharded(system, plan, device=CPU)
    for name in ("ref", "cuda", "sparse", "sparse_cuda"):
        be = P.get_backend(name)
        assert P.supports_sharded(be)
        assert "sharded" in be.supported_encodings()
        assert "sharded" not in be.supported_encodings(semantics="delays")
        comp = be.compile(system, plan, device=CPU)
        assert P.is_sharded(comp)
        _assert_arrays(comp.arrays, want.arrays, REF_FIELDS)
        assert (comp.dense is not None) == (name == "cuda")
        with pytest.raises(ValueError, match="sharded"):
            be.compile(system, P.SystemPlan(num_shards=2,
                                            semantics="delays"), device=CPU)
        with pytest.raises(ValueError, match="explore_distributed"):
            P.explore(system, backend=name, plan=plan, device=CPU)
        with pytest.raises(ValueError, match="explore_distributed"):
            P.run_traces(system, steps=1, seeds=[0], backend=name, plan=plan,
                         device=CPU)


def test_lower_shard_dense_is_idempotent():
    comp = P.lower_shard_dense(P.compile_sharded(
        _port(SYSTEMS["paper-pi"]), neuron_axis(2), device=CPU))
    assert P.lower_shard_dense(comp) is comp


@pytest.mark.parametrize("dense", [False, True])
def test_sharded_from_arrays_carries_the_reference_lowering(dense):
    system = SYSTEMS["power-law-400"]
    ref = J.compile_sharded(system, J.SystemPlan(num_shards=4,
                                                 partition="degree"))
    if dense:
        ref = J.lower_shard_dense(ref)
    got = sharded_from_arrays(
        {k: np.asarray(v) for k, v in ref.arrays._asdict().items()},
        None if not dense else {k: np.asarray(v)
                                for k, v in ref.dense._asdict().items()},
        num_neurons=ref.num_neurons, num_rules=ref.num_rules,
        shard_size=ref.shard_size, num_shards=ref.num_shards,
        halo_width=ref.halo_width, partition="degree",
        occupancy=ref.occupancy, device=CPU)
    _assert_arrays(got.arrays, ref.arrays, REF_FIELDS)
    assert got.arrays.covering.dtype == torch.bool
    if dense:
        _assert_arrays(got.dense, ref.dense, ("M_local", "hadj"))
    own = P.compile_sharded(_port(system), neuron_axis(4, partition="degree"),
                            device=CPU)
    _assert_arrays(got.arrays, own.arrays, P.ShardArrays._fields)
    with pytest.raises(ValueError, match="unknown"):
        sharded_from_arrays(
            {**{k: np.asarray(v) for k, v in ref.arrays._asdict().items()},
             "bogus": np.zeros(1)},
            num_neurons=1, num_rules=1, shard_size=1, num_shards=4,
            halo_width=1, device=CPU)


def _assert_shard_lists(arrays, zero):
    """Every shard's ``sell_start``/``sell_src`` hold its extended-space
    ``in_idx`` rows in slices of 32 local neurons (entry k of neuron 32s +
    l at ``sell_start[d, s] + 32k + l``), each slice as wide as its
    longest row, padded with the zero slot, and ``sell_src`` padded with
    it past the shard's end."""
    in_idx = arrays.in_idx.numpy()
    start, src = arrays.sell_start.numpy(), arrays.sell_src.numpy()
    S, mloc, _ = in_idx.shape
    assert start.dtype == src.dtype == np.int32
    assert start.shape == (S, -(-mloc // 32) + 1) and src.shape[0] == S
    assert src.shape[1] == max(1, int(start[:, -1].max()))
    for d in range(S):
        assert start[d, 0] == 0 and (np.diff(start[d]) % 32 == 0).all()
        assert (src[d, start[d, -1]:] == zero).all()
        for s in range(start.shape[1] - 1):
            block = src[d, start[d, s]:start[d, s + 1]].reshape(-1, 32).T
            rows = in_idx[d, 32 * s:32 * s + 32]
            real = rows != zero
            assert (real.sum(1) == (real * np.arange(1, real.shape[1] + 1)
                                    ).max(1)).all()   # entries come first
            n = real.sum(1)
            assert block.shape[1] == (n.max() if n.size else 0)
            for lane, row in enumerate(rows):
                np.testing.assert_array_equal(block[lane, :n[lane]],
                                              row[:n[lane]])
                assert (block[lane, n[lane]:] == zero).all()
            assert (block[rows.shape[0]:] == zero).all()   # lanes past mloc


@pytest.mark.parametrize("partition", PARTITIONS)
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_shard_sliced_lists_hold_in_idx(name, S, partition):
    """B7's per-shard sliced lists match each shard's ``in_idx`` in the
    extended space ``[local | halo | zero]``, padded with the zero slot
    ``mloc + S·Hmax`` (``paper_pi`` over 8 shards: empty shards, whose
    lists are all padding); ``sharded_from_arrays`` of the reference's
    lowering derives the same lists."""
    jp, pp = _plans(name, S, partition)
    system = SYSTEMS[name]
    got = P.compile_sharded(_port(system), pp, device=CPU)
    zero = got.shard_size + S * got.halo_width
    _assert_shard_lists(got.arrays, zero)
    if name == "paper-pi" and S == 8:
        assert got.num_neurons < S and (got.arrays.sell_start[-1] == 0).all()
    ref = J.compile_sharded(system, jp)
    carried = sharded_from_arrays(
        {k: np.asarray(v) for k, v in ref.arrays._asdict().items()},
        num_neurons=ref.num_neurons, num_rules=ref.num_rules,
        shard_size=ref.shard_size, num_shards=ref.num_shards,
        halo_width=ref.halo_width, partition=partition, device=CPU)
    _assert_arrays(carried.arrays, got.arrays, OWN)

