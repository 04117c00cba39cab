"""The port's plain sparse semantics against the reference's:
``sparse_branch_info``, ``packed_rule_table`` and ``sparse_next_configs``
on every entry (valid or not) for pure-ELL and hybrid encodings, and
against the port's dense ``next_configs`` on valid entries; with the edge
cases a sparse step can get wrong (rule-heavy neurons, ruleless neurons,
rules with no out-synapse, branch overflow, n-d batches)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import nd_chain, random_system  # noqa: E402
from repro.core.semantics import (packed_rule_table as jtable,  # noqa: E402
                                  sparse_branch_info as jinfo,
                                  sparse_next_configs as jstep)
from repro.core.system import Rule, SNPSystem  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402

ENCODINGS = {"ell": None, "h1": 1, "h4": 4}


def _both(system, h):
    port = P.compile_system_sparse(
        system_from_spec(dataclasses.asdict(system)), hub_threshold=h,
        device="cpu")
    return port, J.compile_system_sparse(system, hub_threshold=h)


def _assert_all_entries_equal(got, want):
    for f in ("configs", "valid", "emissions", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.spiking is None


@pytest.mark.parametrize("enc", sorted(ENCODINGS))
@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_sparse_step_matches_reference_on_every_entry(name, enc):
    system, T = conftest.EQUIV_SYSTEMS[name]
    pc, jc = _both(system, ENCODINGS[enc])
    configs = conftest.random_states(system, "no_delays", 7, seed=11,
                                     high=5)
    got = P.sparse_next_configs(torch.from_numpy(configs), pc, T)
    _assert_all_entries_equal(got, jstep(jnp.asarray(configs), jc, T))
    # and the dense oracle on valid entries
    dense = P.compile_system(system_from_spec(dataclasses.asdict(system)),
                             device="cpu")
    conftest.assert_same_step(
        got, P.next_configs(torch.from_numpy(configs), dense, T))


@pytest.mark.parametrize("name", ["power-law-40", "random-17", "paper-pi"])
def test_branch_info_and_rule_table_match_reference(name):
    system, _ = conftest.EQUIV_SYSTEMS[name]
    pc, jc = _both(system, None)
    configs = conftest.random_states(system, "no_delays", 9, seed=4)
    got = P.sparse_branch_info(torch.from_numpy(configs), pc)
    want = jinfo(jnp.asarray(configs), jc)
    app = got.app.numpy()
    np.testing.assert_array_equal(app, np.asarray(want.app))
    np.testing.assert_array_equal(np.where(app, got.rank.numpy(), -9),
                                  np.where(app, np.asarray(want.rank), -9))
    for f in ("choices", "stride", "psi", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(P.packed_rule_table(got, pc).numpy(),
                                  np.asarray(jtable(want, jc)))


def _rule_heavy():
    """One neuron with 12 rules (R > 8, the reference's gather branch)."""
    rules = tuple(Rule(neuron=0, consume=1, produce=1 + i % 2, regex_base=1,
                       covering=True) for i in range(12)) + (
        Rule(neuron=1, consume=1, produce=1, regex_base=1, covering=True),)
    return SNPSystem(3, (3, 1, 0), rules, ((0, 1), (0, 2), (1, 2)),
                     output_neuron=2, name="rule-heavy")


def _edge_systems():
    return {
        "rule-heavy": (_rule_heavy(), 32),
        "no-out-synapse": (SNPSystem(
            3, (1, 1, 1),
            (Rule(neuron=0, consume=1, produce=1, regex_base=1),
             Rule(neuron=2, consume=1, produce=2, regex_base=1)),
            ((0, 1),), output_neuron=2, name="no-out"), 8),
        "ruleless-neurons": (SNPSystem(
            4, (2, 0, 1, 0),
            (Rule(neuron=0, consume=1, produce=1, regex_base=1,
                  covering=True),
             Rule(neuron=2, consume=1, produce=1, regex_base=1)),
            ((0, 1), (0, 3), (2, 3), (2, 1)), name="ruleless"), 8),
        "branch-overflow": (nd_chain(9), 64),
        "odd-shape": (random_system(13, 3, 0.35, seed=9), 21),
    }


@pytest.mark.parametrize("enc", ["ell", "h1"])
@pytest.mark.parametrize("name", sorted(_edge_systems()))
def test_sparse_step_edge_cases_match_reference(name, enc):
    system, T = _edge_systems()[name]
    pc, jc = _both(system, ENCODINGS[enc])
    configs = conftest.random_states(system, "no_delays", 5, seed=2, high=4)
    if name == "branch-overflow":
        configs = np.ones_like(configs)
    got = P.sparse_next_configs(torch.from_numpy(configs), pc, T)
    _assert_all_entries_equal(got, jstep(jnp.asarray(configs), jc, T))
    if name == "branch-overflow":
        assert bool(got.overflow.all())


def test_sparse_step_keeps_nd_batch_dims():
    system, T = conftest.EQUIV_SYSTEMS["ring-lattice-12"]
    pc, jc = _both(system, 1)
    configs = conftest.random_states(system, "no_delays", 6, seed=3
                                     ).reshape(2, 3, -1)
    got = P.sparse_next_configs(torch.from_numpy(configs), pc, T)
    assert tuple(got.configs.shape) == (2, 3, T, system.num_neurons)
    _assert_all_entries_equal(got, jstep(jnp.asarray(configs), jc, T))


def test_large_spike_counts_stay_exact():
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc, jc = _both(system, 4)
    rng = np.random.default_rng(5)
    configs = rng.integers(2 ** 22 - 4, 2 ** 22 + 4,
                           size=(3, system.num_neurons)).astype(np.int32)
    got = P.sparse_next_configs(torch.from_numpy(configs), pc, T)
    _assert_all_entries_equal(got, jstep(jnp.asarray(configs), jc, T))
