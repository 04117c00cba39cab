"""The port's dense ``compile_system`` against the reference encoding,
field for field, and ``convert.compiled_from_arrays`` on a reference
``CompiledSNP``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
from repro.core import compile_system as jcompile  # noqa: E402
from repro.core.generators import scaled_pi, with_delays  # noqa: E402
from repro_torch.core import CompiledSNP  # noqa: E402
from repro_torch.core import compile_system as pcompile  # noqa: E402
from repro_torch.core.convert import (compiled_from_arrays,  # noqa: E402
                                      system_from_spec)
from repro_torch.core.matrix import sliced_in_lists  # noqa: E402

SYSTEMS = {**{k: s for k, (s, _) in conftest.EQUIV_SYSTEMS.items()},
           "pi-x5": scaled_pi(5)}


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _fields(comp):
    return {k: np.asarray(v) for k, v in comp._asdict().items()
            if v is not None and k != "rule_order"}


# The port's own fields, derived from the reference's.
PORT_FIELDS = ("adj_in", "col_start", "col_rule", "col_val", "sell_start",
               "sell_src")


def _assert_column_lists(port, M, env):
    """``col_*`` hold the nonzeros of ``[M | env]`` column by column, rules
    ascending, and nothing else."""
    full = np.concatenate([M, env[:, None]], 1)
    start, rule, val = (getattr(port, k).numpy()
                        for k in ("col_start", "col_rule", "col_val"))
    assert start.dtype == rule.dtype == val.dtype == np.int32
    assert start.shape == (full.shape[1] + 1,) and start[-1] == rule.size
    for j in range(full.shape[1]):
        want = np.flatnonzero(full[:, j])
        np.testing.assert_array_equal(rule[start[j]:start[j + 1]], want)
        np.testing.assert_array_equal(val[start[j]:start[j + 1]],
                                      full[want, j])


def _assert_same_encoding(port, ref):
    ref_f = _fields(ref)
    for k in CompiledSNP._fields:
        if k == "rule_order":
            assert port.rule_order == tuple(ref.rule_order)
            continue
        if k in PORT_FIELDS:           # the port's own; checked below
            continue
        if getattr(port, k) is None:   # a delay field, delay-free
            assert k not in ref_f, k
            continue
        got = getattr(port, k).numpy()
        assert got.dtype == ref_f[k].dtype, k
        np.testing.assert_array_equal(got, ref_f[k], err_msg=k)
    # the reference's rule->neuron one-hot is what the port gathers by
    onehot = np.zeros_like(ref_f["neuron_onehot"])
    onehot[np.arange(port.num_rules), port.rule_neuron.numpy()] = 1
    np.testing.assert_array_equal(onehot, ref_f["neuron_onehot"])
    # without delays the column lists rebuild [M | env_produce]; a delayed
    # encoding carries none (B4 reads adj_in's sliced lists, not M)
    if "adjacency" not in ref_f:
        _assert_column_lists(port, ref_f["M"], ref_f["env_produce"])
        assert port.adj_in is None
        assert port.sell_start is None and port.sell_src is None
        return
    assert (port.col_start, port.col_rule, port.col_val) == (None,) * 3
    start, src = sliced_in_lists(port.adj_in.numpy())
    np.testing.assert_array_equal(port.sell_start.numpy(), start)
    np.testing.assert_array_equal(port.sell_src.numpy(), src)
    # adj_in lists each neuron's in-neighbours in the reference adjacency
    adj, m = ref_f["adjacency"], port.num_neurons
    adj_in = port.adj_in.numpy()
    assert adj_in.shape == (m, max(1, int(adj.sum(0).max())))
    for j in range(m):
        want = np.flatnonzero(adj[:, j])
        np.testing.assert_array_equal(adj_in[j, :want.size], want)
        assert (adj_in[j, want.size:] == m).all()


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_compile_system_matches_reference(name):
    system = SYSTEMS[name]
    ref = jcompile(system)
    port = pcompile(_port(system), device="cpu")
    _assert_same_encoding(port, ref)
    assert (port.num_rules, port.num_neurons) == (ref.num_rules,
                                                  ref.num_neurons)


@pytest.mark.parametrize("name", ["paper-pi", "power-law-40", "pi-x5"])
def test_compiled_from_arrays_carries_reference_encoding(name):
    ref = jcompile(SYSTEMS[name])
    fields = {k: (v if k == "rule_order" or v is None else np.asarray(v))
              for k, v in ref._asdict().items()}
    port = compiled_from_arrays(fields, device="cpu")
    _assert_same_encoding(port, ref)
    assert port.device == torch.device("cpu")


def test_compiled_from_arrays_refuses_delayed_and_unknown_fields():
    """A delay field alone (no adjacency or output neuron, a delay-free
    state width) is refused; a whole delayed encoding carries across."""
    ref = jcompile(SYSTEMS["paper-pi"])
    fields = {k: (v if k == "rule_order" else np.asarray(v))
              for k, v in ref._asdict().items() if v is not None}
    with pytest.raises(ValueError, match="delay"):
        compiled_from_arrays({**fields, "delay": np.zeros(5, np.int32)},
                             device="cpu")
    delayed = with_delays(SYSTEMS["paper-pi"], lambda k, r: k % 3)
    dref = jcompile(delayed, semantics="delays")
    dfields = {k: (v if k == "rule_order" else np.asarray(v))
               for k, v in dref._asdict().items() if v is not None}
    _assert_same_encoding(compiled_from_arrays(dfields, device="cpu"), dref)
    with pytest.raises(ValueError, match="unknown"):
        compiled_from_arrays({**fields, "bogus": np.zeros(1)}, device="cpu")


def test_delayed_systems_refused_like_the_reference():
    delayed = with_delays(SYSTEMS["nd-chain-4"], 1)
    with pytest.raises(ValueError, match="delay"):
        jcompile(delayed)
    with pytest.raises(ValueError, match="delay"):
        pcompile(_port(delayed), device="cpu")
    # delay 0 everywhere compiles exactly like the undelayed system
    zero = with_delays(SYSTEMS["nd-chain-4"], 0)
    _assert_same_encoding(pcompile(_port(zero), device="cpu"), jcompile(zero))


def test_encoding_moves_between_devices_without_copying_twice():
    comp = pcompile(_port(SYSTEMS["paper-pi"]), device="cpu")
    assert comp.to("cpu") is comp
    assert comp.to(torch.device("cpu")).M.device.type == "cpu"
