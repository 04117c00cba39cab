"""The port's ``compile_system_sparse`` against the reference's, array for
array (values and dtypes): pure ELL and hybrid (``hub_threshold=1``, 4
and the auto threshold), on ``EQUIV_SYSTEMS`` and ``power_law(512)``; a
reference encoding carried across by ``compiled_from_arrays``; the
port's own sliced in-lists (every encoding) and hub neurons (hybrid)
against lists rebuilt from ``in_idx`` and ``hub_slot``; and the
compiler's refusals."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import power_law  # noqa: E402
from repro_torch.core.convert import (compiled_from_arrays,  # noqa: E402
                                      system_from_spec)

SYSTEMS = {**{k: s for k, (s, _) in conftest.EQUIV_SYSTEMS.items()},
           "power-law-512": power_law(512, 4, seed=2)}


def _thresholds(system):
    return {"ell": None, "h1": 1, "h4": 4,
            "auto": J.SystemPlan(encoding="hybrid")
            .resolved_hub_threshold(system)}


# The port's own fields, derived from in_idx (every encoding) and
# hub_slot (hybrid only).
PORT_FIELDS = ("sell_start", "sell_src", "hub_neuron")


def _assert_sliced_lists(port):
    """``sell_start``/``sell_src`` hold ``in_idx``'s rows in slices of 32
    neurons, entry k of neuron 32s + l at ``sell_start[s] + 32k + l``,
    each slice as wide as its longest row and padded with m, on every
    encoding; ``hub_neuron`` inverts ``hub_slot`` on a hybrid one and is
    ``None`` on a pure-ELL one and where the COO metadata is missing."""
    in_idx = port.in_idx.numpy()
    m = in_idx.shape[0]
    start, src = port.sell_start.numpy(), port.sell_src.numpy()
    assert start.dtype == src.dtype == np.int32
    assert start.shape == (-(-m // 32) + 1,) and start[0] == 0
    assert start[-1] == src.size and (np.diff(start) % 32 == 0).all()
    for s in range(start.size - 1):
        block = src[start[s]:start[s + 1]].reshape(-1, 32).T   # (32, width)
        rows = in_idx[32 * s:32 * s + 32]
        lengths = (rows != m).sum(1)
        assert block.shape[1] == (lengths.max() if lengths.size else 0)
        for lane, row in enumerate(rows):
            np.testing.assert_array_equal(block[lane, :lengths[lane]],
                                          row[:lengths[lane]])
            assert (row[lengths[lane]:] == m).all()
        assert (block[rows.shape[0]:] == m).all()   # lanes past m
        for lane, n in enumerate(lengths):
            assert (block[lane, n:] == m).all()
    if not port.is_hybrid or port.coo_bounds is None:
        assert port.hub_neuron is None
        return
    hubs, slot = port.hub_neuron.numpy(), port.hub_slot.numpy()
    assert hubs.dtype == np.int32 and hubs.shape == (np.size(
        port.coo_bounds.numpy()) - 1,)
    np.testing.assert_array_equal(slot[hubs], np.arange(hubs.size))
    assert (np.diff(hubs) > 0).all()


def _assert_same_encoding(port, ref):
    assert tuple(f for f in port._fields if f not in PORT_FIELDS) == tuple(
        f for f in ref._fields if f != "coo_dst")
    _assert_sliced_lists(port)
    # the reference's per-entry tail targets are the port's per-hub runs
    if port.coo_bounds is not None:
        bounds, slot = port.coo_bounds.numpy(), port.hub_slot.numpy()
        hubs = np.flatnonzero(slot < bounds.shape[0] - 1)
        np.testing.assert_array_equal(
            np.repeat(hubs, np.diff(bounds)).astype(np.int32),
            np.asarray(ref.coo_dst))
    for f in port._fields:
        if f in PORT_FIELDS:           # the port's own; checked above
            continue
        a, b = getattr(port, f), getattr(ref, f)
        if f == "rule_order":
            assert a == tuple(b)
            continue
        if b is None:                  # the delay of a delay-free encoding
            assert a is None, f
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("enc", ["ell", "h1", "h4", "auto"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_sparse_encoding_matches_reference(name, enc):
    system = SYSTEMS[name]
    h = _thresholds(system)[enc]
    port = P.compile_system_sparse(
        system_from_spec(dataclasses.asdict(system)), hub_threshold=h,
        device="cpu")
    ref = J.compile_system_sparse(system, hub_threshold=h)
    _assert_same_encoding(port, ref)
    assert port.is_hybrid == ref.is_hybrid
    assert (port.max_nnz_per_rule, port.max_rules_per_neuron,
            port.max_in_degree) == (ref.max_nnz_per_rule,
                                    ref.max_rules_per_neuron,
                                    ref.max_in_degree)


def test_power_law_512_auto_plan_is_hybrid_with_a_tail():
    system = SYSTEMS["power-law-512"]
    plan = J.SystemPlan.for_system(system, mode="static")
    assert plan.encoding == "hybrid"
    port = P.compile_system_sparse(
        system_from_spec(dataclasses.asdict(system)),
        hub_threshold=plan.hub_threshold, device="cpu")
    assert port.is_hybrid and port.coo_bounds.shape[0] > 1


@pytest.mark.parametrize("enc", ["ell", "h1"])
def test_reference_sparse_encoding_carries_across(enc):
    system = SYSTEMS["power-law-40"]
    h = _thresholds(system)[enc]
    ref = J.compile_system_sparse(system, hub_threshold=h)
    fields = {k: (v if k == "rule_order" or v is None else np.asarray(v))
              for k, v in ref._asdict().items()}
    carried = compiled_from_arrays(fields, device="cpu")
    assert isinstance(carried, P.CompiledSparseSNP)
    _assert_same_encoding(carried, ref)
    # a hand-built encoding without the COO metadata keeps it absent (and
    # so lacks hub_neuron); its sliced lists are in_idx's
    bare = compiled_from_arrays({**fields, "coo_bounds": None,
                                 "hub_slot": None}, device="cpu")
    assert bare.coo_bounds is None and bare.hub_slot is None
    assert bare.hub_neuron is None
    _assert_sliced_lists(bare)


def _empty_slice_system():
    """48 neurons (m not a multiple of 32) whose neurons 0..31 have no
    in-synapse (slice 0 of the sliced lists has width 0), and neuron 40 a
    hub fed by every neuron below 32."""
    rules = tuple(J.Rule(neuron=i, consume=1, produce=1, regex_base=1,
                         regex_period=1) for i in range(48))
    syn = tuple((i, 32 + (i + k) % 16) for i in range(48) for k in (1, 2)
                if i != 32 + (i + k) % 16)
    syn = tuple(sorted(set(syn) | {(i, 40) for i in range(32)}))
    return J.SNPSystem(48, (1,) * 48, rules, syn, output_neuron=47,
                       name="empty-slice-48")


def _sliced_case(case):
    """(port encoding, reference encoding or None) for each case of the
    sliced-lists tests."""
    if case == "carried":
        system = SYSTEMS["random-17"]
        ref = J.compile_system_sparse(system, hub_threshold=2)
        fields = {k: (v if k == "rule_order" or v is None else np.asarray(v))
                  for k, v in ref._asdict().items()}
        return compiled_from_arrays(fields, device="cpu"), ref
    system, h = {"m45-h2": (J.generators.random_system(45, 3, 0.1, seed=5),
                            2),
                 "empty-slice-h3": (_empty_slice_system(), 3),
                 "paper-pi-h1": (SYSTEMS["paper-pi"], 1),
                 "power-law-512-auto": (SYSTEMS["power-law-512"], "auto")
                 }[case]
    if h == "auto":
        h = J.SystemPlan(encoding="hybrid").resolved_hub_threshold(system)
    port = P.compile_system_sparse(
        system_from_spec(dataclasses.asdict(system)), hub_threshold=h,
        device="cpu")
    return port, J.compile_system_sparse(system, hub_threshold=h)


@pytest.mark.parametrize("case", ["m45-h2", "empty-slice-h3", "paper-pi-h1",
                                  "power-law-512-auto", "carried"])
def test_sliced_in_lists_hold_in_idx(case):
    port, ref = _sliced_case(case)
    assert port.is_hybrid
    _assert_same_encoding(port, ref)
    start = port.sell_start.numpy()
    if case == "empty-slice-h3":
        assert port.num_neurons % 32 and start[1] == start[0] == 0
    if case == "m45-h2":
        assert port.num_neurons % 32
    # the lists match those the lowering builds from the same in_idx
    own_start, own_src = P.matrix.sliced_in_lists(port.in_idx.numpy())
    np.testing.assert_array_equal(own_start, start)
    np.testing.assert_array_equal(own_src, port.sell_src.numpy())


@pytest.mark.parametrize("semantics", ["no_delays", "delays"])
@pytest.mark.parametrize("enc", ["ell", "h1"])
@pytest.mark.parametrize("name", ["paper-pi", "random-17",
                                  "power-law-512"])
def test_every_encoding_carries_sliced_lists(name, enc, semantics):
    """ELL and delayed-ELL encodings carry sliced lists too (the lists the
    sliced-list kernel walks for B5's ELL body), as hybrid ones do: the
    same entries per neuron as ``in_idx``, padded with m, each slice as
    wide as its longest row; ``compiled_from_arrays`` of the reference's
    encoding derives lists equal to the port's own lowering."""
    system = SYSTEMS[name]
    if semantics == "delays":
        system = conftest.delayed_variant(system)
    h = _thresholds(system)[enc]
    port = P.compile_system_sparse(
        system_from_spec(dataclasses.asdict(system)), hub_threshold=h,
        semantics=semantics, device="cpu")
    _assert_sliced_lists(port)
    assert port.is_hybrid == (h is not None)
    assert P.is_delayed(port) == (semantics == "delays")
    ref = J.compile_system_sparse(system, hub_threshold=h,
                                  semantics=semantics)
    carried = compiled_from_arrays(
        {k: (v if k == "rule_order" or v is None else np.asarray(v))
         for k, v in ref._asdict().items()}, device="cpu")
    for f in PORT_FIELDS:
        a, b = getattr(carried, f), getattr(port, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_sliced_in_lists_of_a_hand_made_in_idx():
    """33 neurons (a second slice of one neuron), rows of lengths 0..3 and
    one whole row: widths 3 and 1, lanes past m padded."""
    m = 33
    in_idx = np.full((m, 3), m, np.int32)
    in_idx[1, :1] = [5]
    in_idx[2, :3] = [0, 4, 9]
    in_idx[32, :1] = [7]
    start, src = P.matrix.sliced_in_lists(in_idx)
    np.testing.assert_array_equal(start, [0, 96, 128])
    first = src[:96].reshape(3, 32)
    np.testing.assert_array_equal(first[:, 2], [0, 4, 9])
    np.testing.assert_array_equal(first[:, 1], [5, m, m])
    assert (np.delete(first, [1, 2], axis=1) == m).all()
    np.testing.assert_array_equal(src[96:], [7] + [m] * 31)
    np.testing.assert_array_equal(
        P.matrix.hub_neurons(np.array([2, 0, 2, 1]), 2), [1, 3])


def test_carrying_a_delayed_sparse_encoding_raises():
    """A delayed reference encoding carries across whole; one whose state
    width contradicts its delay field (half of a delayed encoding) raises
    instead of stepping under the wrong tier."""
    system = conftest.delayed_variant(SYSTEMS["paper-pi"])
    ref = J.compile_system_sparse(system, semantics="delays")
    fields = {k: (v if k == "rule_order" or v is None else np.asarray(v))
              for k, v in ref._asdict().items()}
    _assert_same_encoding(compiled_from_arrays(fields, device="cpu"), ref)
    m = system.num_neurons
    with pytest.raises(ValueError, match="delay"):
        compiled_from_arrays({**fields, "init_config": np.asarray(
            system.initial_spikes, np.int32)}, device="cpu")
    with pytest.raises(ValueError, match="init_config"):
        compiled_from_arrays({**fields, "delay": None}, device="cpu")
    assert np.asarray(ref.init_config).shape == (3 * m,)


def test_sparse_compile_refuses_what_the_reference_refuses():
    big = P.SNPSystem(2, (0, 0), (P.Rule(neuron=0, consume=1,
                                         produce=1 << 16, regex_base=1),),
                      ((0, 1),))
    with pytest.raises(ValueError, match="2\\^16"):
        P.compile_system_sparse(big, device="cpu")
    with pytest.raises(ValueError, match="hub_threshold"):
        P.compile_system_sparse(P.paper_pi(True), hub_threshold=0,
                                device="cpu")
    delayed = system_from_spec(dataclasses.asdict(
        conftest.delayed_variant(SYSTEMS["paper-pi"])))
    with pytest.raises(ValueError, match="delay"):
        P.compile_system_sparse(delayed, device="cpu")


def test_sparse_compile_never_builds_dense_arrays():
    system = system_from_spec(dataclasses.asdict(SYSTEMS["power-law-512"]))
    sp = P.compile_system_sparse(system, hub_threshold=4, device="cpu")
    n, m = sp.num_rules, sp.num_neurons
    for f in sp._fields:
        x = getattr(sp, f)
        if isinstance(x, torch.Tensor):
            assert x.numel() < n * m / 4, f


def test_dense_compile_is_unchanged_by_the_shared_lowering():
    for name in sorted(SYSTEMS):
        system = SYSTEMS[name]
        port = P.compile_system(system_from_spec(dataclasses.asdict(system)),
                                device="cpu")
        ref = J.compile_system(system)
        for f in ("M", "rule_neuron", "consume", "produce", "regex_base",
                  "regex_period", "covering", "env_produce", "init_config"):
            np.testing.assert_array_equal(getattr(port, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        assert port.rule_order == tuple(ref.rule_order)
