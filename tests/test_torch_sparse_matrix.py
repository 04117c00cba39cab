"""The port's ``compile_system_sparse`` against the reference's, array for
array (values and dtypes): pure ELL and hybrid (``hub_threshold=1``, 4
and the auto threshold), on ``EQUIV_SYSTEMS`` and ``power_law(512)``; a
reference encoding carried across by ``compiled_from_arrays``; and the
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


def _assert_same_encoding(port, ref):
    assert port._fields == tuple(f for f in ref._fields if f != "coo_dst")
    # the reference's per-entry tail targets are the port's per-hub runs
    if port.coo_bounds is not None:
        bounds, slot = port.coo_bounds.numpy(), port.hub_slot.numpy()
        hubs = np.flatnonzero(slot < bounds.shape[0] - 1)
        np.testing.assert_array_equal(
            np.repeat(hubs, np.diff(bounds)).astype(np.int32),
            np.asarray(ref.coo_dst))
    for f in port._fields:
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
    # a hand-built encoding without the COO metadata keeps it absent
    bare = compiled_from_arrays({**fields, "coo_bounds": None,
                                 "hub_slot": None}, device="cpu")
    assert bare.coo_bounds is None and bare.hub_slot is None


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
