"""The port's delayed tier at the encoding layer, against the reference:
``compile_system`` / ``compile_system_sparse(semantics="delays")`` array
for array, ``delayed_weight_matrix`` entry for entry, the delayed
encodings carried across by ``compiled_from_arrays``, ``SystemPlan``'s
``semantics`` field and ``for_system(semantics=)``, and the refusals the
reference makes.  Every comparison is exact (tolerance 0)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import power_law, scaled_pi  # noqa: E402
from repro.core.semantics import delayed_weight_matrix as jweight  # noqa: E402
from repro_torch.core.convert import (compiled_from_arrays,  # noqa: E402
                                      system_from_spec)

SYSTEMS = {**{k: conftest.delayed_variant(s)
              for k, (s, _) in conftest.EQUIV_SYSTEMS.items()},
           "pi-x5": conftest.delayed_variant(scaled_pi(5)),
           "pi-uniform-2": J.with_delays(J.paper_pi(), 2)}


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _ref_fields(comp):
    return {k: (v if k == "rule_order" or v is None else np.asarray(v))
            for k, v in comp._asdict().items()}


# The sparse encoding's own fields: the sliced in-lists (every encoding)
# and hub neurons (hybrid only) the sliced-list kernel reads
# (tests/test_torch_sparse_matrix.py holds them against in_idx and
# hub_slot).
SLICED = ("sell_start", "sell_src", "hub_neuron")


def _assert_sliced_lists_present(port):
    assert port.sell_start is not None and port.sell_src is not None
    assert (port.hub_neuron is not None) == port.is_hybrid


def _assert_fields_equal(port, ref, skip=()):
    for f in port._fields:
        if f in skip:
            continue
        # a field the reference lacks is None here (B1's column lists:
        # a delayed encoding carries none)
        a, b = getattr(port, f), getattr(ref, f, None)
        if f == "rule_order":
            assert a == tuple(b)
            continue
        if b is None:
            assert a is None, f
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# The dense delayed encoding's own fields beside adj_in: its sliced lists,
# which B4 walks.
DENSE_SLICED = ("sell_start", "sell_src")


def _assert_dense_sliced_lists(port):
    """``sell_start``/``sell_src`` are ``sliced_in_lists(adj_in)``, int32,
    padded with m."""
    start, src = P.matrix.sliced_in_lists(port.adj_in.numpy())
    assert port.sell_start.dtype == port.sell_src.dtype == torch.int32
    np.testing.assert_array_equal(port.sell_start.numpy(), start)
    np.testing.assert_array_equal(port.sell_src.numpy(), src)


def _assert_adj_in(port, adjacency):
    """``adj_in`` row j is j's in-neighbours in ``adjacency``, ascending,
    padded with m."""
    adj = np.asarray(adjacency)
    m = adj.shape[0]
    adj_in = port.adj_in.numpy()
    assert adj_in.dtype == np.int32
    assert adj_in.shape == (m, max(1, int(adj.sum(0).max())))
    for j in range(m):
        src = np.flatnonzero(adj[:, j])
        np.testing.assert_array_equal(adj_in[j, :src.size], src)
        assert (adj_in[j, src.size:] == m).all()


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_dense_delayed_encoding_matches_reference(name):
    system = SYSTEMS[name]
    ref = J.compile_system(system, semantics="delays")
    port = P.compile_system(_port(system), semantics="delays", device="cpu")
    _assert_fields_equal(port, ref, skip=("adj_in",) + DENSE_SLICED)
    _assert_adj_in(port, ref.adjacency)
    _assert_dense_sliced_lists(port)
    m = system.num_neurons
    assert port.state_width == ref.state_width == 3 * m
    assert P.is_delayed(port) and J.is_delayed(ref)
    np.testing.assert_array_equal(port.init_config[m:].numpy(), 0)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_weight_matrix_equals_reference_entry_for_entry(name):
    system = SYSTEMS[name]
    ref = jweight(J.compile_system(system, semantics="delays"))
    port = P.delayed_weight_matrix(
        P.compile_system(_port(system), semantics="delays", device="cpu"))
    assert port.dtype == torch.float32 and tuple(port.shape) == ref.shape
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h", [None, 1, 4], ids=["ell", "h1", "h4"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_sparse_delayed_encoding_matches_reference(name, h):
    system = SYSTEMS[name]
    ref = J.compile_system_sparse(system, hub_threshold=h,
                                  semantics="delays")
    port = P.compile_system_sparse(_port(system), hub_threshold=h,
                                   semantics="delays", device="cpu")
    assert tuple(f for f in port._fields if f not in SLICED) == tuple(
        f for f in ref._fields if f != "coo_dst")
    _assert_fields_equal(port, ref, skip=SLICED)
    _assert_sliced_lists_present(port)
    assert port.state_width == ref.state_width
    packed_e, packed_d = P.delayed_packed_actions(port)
    jpe, jpd = J.semantics.delayed_packed_actions(ref)
    np.testing.assert_array_equal(packed_e.numpy(), np.asarray(jpe))
    np.testing.assert_array_equal(packed_d.numpy(), np.asarray(jpd))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_delayed_reference_encoding_carries_across(sparse):
    system = SYSTEMS["power-law-40"]
    ref = J.compile_system_sparse(system, hub_threshold=2,
                                  semantics="delays") if sparse \
        else J.compile_system(system, semantics="delays")
    carried = compiled_from_arrays(_ref_fields(ref), device="cpu")
    assert P.is_delayed(carried)
    _assert_fields_equal(carried, ref, skip=("adj_in",) + SLICED
                         + DENSE_SLICED)
    if sparse:
        # the sliced lists derived here equal the compiler's own
        own = P.compile_system_sparse(_port(system), hub_threshold=2,
                                      semantics="delays", device="cpu")
        for f in SLICED:
            assert torch.equal(getattr(carried, f), getattr(own, f)), f
    if not sparse:
        # the port's in-neighbour lists, derived from the adjacency,
        # equal the compiler's own
        _assert_adj_in(carried, ref.adjacency)
        own = P.compile_system(_port(system), semantics="delays",
                               device="cpu")
        assert torch.equal(carried.adj_in, own.adj_in)
        # and so are its sliced lists, which B4 walks
        _assert_dense_sliced_lists(carried)
        for f in DENSE_SLICED:
            assert torch.equal(getattr(carried, f), getattr(own, f)), f


@pytest.mark.parametrize("name", ["paper-pi", "power-law-40", "pi-x5"])
def test_dense_delayed_sliced_lists_move_with_the_encoding(name):
    """The dense delayed encoding's sliced lists of ``adj_in`` are
    ``sliced_in_lists(adj_in)``, a delay-free dense encoding has none, and
    ``.to()`` moves them with the rest (here to the meta device and
    back)."""
    system = SYSTEMS[name]
    port = P.compile_system(_port(system), semantics="delays", device="cpu")
    _assert_dense_sliced_lists(port)
    assert port.sell_start.shape == (-(-system.num_neurons // 32) + 1,)
    free = P.compile_system(_port(conftest.EQUIV_SYSTEMS["paper-pi"][0]),
                            device="cpu")
    assert free.sell_start is None and free.sell_src is None
    moved = port.to(torch.device("meta"))
    assert moved.sell_start.device.type == moved.sell_src.device.type \
        == "meta"
    assert moved.sell_src.shape == port.sell_src.shape
    assert port.to("cpu") is port


def test_no_delays_still_refuses_a_delayed_system():
    system = SYSTEMS["nd-chain-4"]
    port = _port(system)
    for compile_ in (J.compile_system, J.compile_system_sparse):
        with pytest.raises(ValueError, match="semantics=\"delays\""):
            compile_(system)
    for compile_ in (P.compile_system, P.compile_system_sparse):
        with pytest.raises(ValueError, match="semantics=\"delays\""):
            compile_(port, device="cpu")
        with pytest.raises(ValueError, match="semantics must be one of"):
            compile_(port, semantics="lazy", device="cpu")
    # the entry points compile under the default plan, which is no_delays
    for backend in ("ref", "cuda", "sparse", "sparse_cuda"):
        with pytest.raises(ValueError, match="delay"):
            P.explore(port, backend=backend, max_steps=1, device="cpu")


def test_plan_semantics_validation_matches_reference():
    for kwargs in (dict(semantics="lazy"),
                   dict(encoding="ell", semantics="Delays")):
        with pytest.raises(ValueError, match="semantics"):
            J.SystemPlan(**kwargs)
        with pytest.raises(ValueError, match="semantics"):
            P.SystemPlan(**kwargs)
    assert P.SystemPlan().semantics == J.SystemPlan().semantics \
        == "no_delays"
    with pytest.raises(ValueError, match="semantics"):
        P.SystemPlan.for_system(_port(SYSTEMS["paper-pi"]), semantics="x")


@pytest.mark.parametrize("system", [
    conftest.delayed_variant(power_law(8192, 4, seed=2)),
    SYSTEMS["ring-lattice-12"], SYSTEMS["power-law-40"]],
    ids=["power-law-8192", "ring-lattice-12", "power-law-40"])
def test_for_system_under_delays_matches_reference(system):
    ref = J.SystemPlan.for_system(system, mode="static", semantics="delays")
    got = P.SystemPlan.for_system(_port(system), semantics="delays")
    assert (got.encoding, got.hub_threshold, got.semantics) == \
        (ref.encoding, ref.hub_threshold, ref.semantics)


def test_delayed_power_law_8192_plans_hybrid():
    """The hybrid delayed main path: the same plan as the delay-free one,
    under delays."""
    system = _port(conftest.delayed_variant(power_law(8192, 4, seed=2)))
    plan = P.SystemPlan.for_system(system, semantics="delays")
    assert (plan.encoding, plan.hub_threshold, plan.semantics) == \
        ("hybrid", 36, "delays")
