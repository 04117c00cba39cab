"""The delayed tier's property tests (``tests/test_delays_properties.py``)
ported to the port, on Hypothesis-drawn small systems and arbitrary
(also unreachable) delayed states:

* **backend × encoding agreement** — every port lowering of the delayed
  step (dense plain, B4's plain version, sparse ELL and hybrid plain, B5's
  plain version on ELL and hybrid) gives the JAX package's successor set;
* **oracle** — successors equal the pure-Python oracle's;
* **zero-delay collapse** — an all-zero-delay system under ``delays``
  steps like the delay-free path (it compiles ``sys0``, the zero-delay
  copy: the reference's version of this property compiles the delayed
  ``system`` under ``no_delays``, which raises);
* **closed-neuron invariant** — a neuron that stays closed keeps its
  spikes, counts down and keeps its pending spikes.

No example database is kept (``database=None``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.kernels.snp_step import ops, sparse_ops  # noqa: E402

T = 128  # max_branches everywhere here

# the reference step, jitted (eager JAX compiles every primitive per shape)
j_delayed = jax.jit(J.delayed_next_configs, static_argnums=2)


@st.composite
def delayed_systems(draw):
    m = draw(st.integers(1, 4))
    rules = []
    for _ in range(draw(st.integers(1, 6))):
        consume = draw(st.integers(1, 3))
        rules.append(J.Rule(
            neuron=draw(st.integers(0, m - 1)), consume=consume,
            produce=draw(st.integers(0, 2)),
            regex_base=draw(st.integers(consume, consume + 2)),
            regex_period=draw(st.sampled_from([0, 0, 1, 2])),
            covering=draw(st.booleans()),
            delay=draw(st.sampled_from([0, 0, 1, 2, 3]))))
    pairs = [(i, j) for i in range(m) for j in range(m) if i != j]
    syn = tuple(p for p in pairs if draw(st.booleans()))
    init = tuple(draw(st.integers(0, 3)) for _ in range(m))
    return J.SNPSystem(num_neurons=m, initial_spikes=init, rules=tuple(rules),
                       synapses=syn, output_neuron=m - 1, name="hyp-delays")


@st.composite
def systems_and_states(draw):
    system = draw(delayed_systems())
    m = system.num_neurons
    state = tuple(draw(st.integers(0, 3)) for _ in range(m)) \
        + tuple(draw(st.integers(0, 3)) for _ in range(m)) \
        + tuple(draw(st.integers(0, 2)) for _ in range(m))
    return system, state


def _rows(configs, valid, emissions):
    """(successor row, emission) pairs of the valid branches."""
    configs = np.asarray(configs).reshape(-1, configs.shape[-1])
    valid = np.asarray(valid).reshape(-1)
    emissions = np.asarray(emissions).reshape(-1)
    return {(tuple(int(v) for v in configs[t]), int(emissions[t]))
            for t in np.nonzero(valid)[0]}


def _port(system):
    return system_from_spec(dataclasses.asdict(system))


def _port_lowerings(system, state):
    """Successor sets of one delayed step through every port lowering."""
    ps = _port(system)
    x = torch.tensor([state], dtype=torch.int32)
    dense = P.compile_system(ps, semantics="delays", device="cpu")
    sparse = {h: P.compile_system_sparse(ps, hub_threshold=h,
                                         semantics="delays", device="cpu")
              for h in (None, 1)}
    o = P.delayed_next_configs(x[0], dense, T)
    out = {"ref": _rows(o.configs, o.valid, o.emissions)}
    c, v, e, _ = ops.snp_step(x, dense, max_branches=T)
    out["cuda"] = _rows(c, v, e)
    for h, comp in sparse.items():
        tag = "ell" if h is None else "hybrid"
        o = P.sparse_delayed_next_configs(x[0], comp, T)
        out[f"sparse/{tag}"] = _rows(o.configs, o.valid, o.emissions)
        c, v, e, _ = sparse_ops.snp_step_sparse(x, comp, max_branches=T)
        out[f"sparse_cuda/{tag}"] = _rows(c, v, e)
    return out


@settings(max_examples=25, deadline=None, database=None)
@given(systems_and_states())
def test_backend_encoding_matrix_agreement(sys_state):
    system, state = sys_state
    o = j_delayed(jnp.asarray(state, jnp.int32),
                  J.compile_system(system, semantics="delays"), T)
    want = _rows(o.configs, o.valid, o.emissions)
    for name, got in _port_lowerings(system, state).items():
        assert got == want, name


@settings(max_examples=40, deadline=None, database=None)
@given(systems_and_states())
def test_successors_match_oracle_from_arbitrary_states(sys_state):
    system, state = sys_state
    m = system.num_neurons
    tri = (state[:m], state[m:2 * m], state[2 * m:])
    want = {(oracle.flatten(s), e) for s, e in oracle.successors(tri, system)}
    o = P.delayed_next_configs(
        torch.tensor(state, dtype=torch.int32),
        P.compile_system(_port(system), semantics="delays", device="cpu"), T)
    assert _rows(o.configs, o.valid, o.emissions) == want


@settings(max_examples=30, deadline=None, database=None)
@given(delayed_systems())
def test_zero_delay_is_bit_identical_to_no_delays(system):
    sys0 = _port(J.with_delays(system, 0))
    m = system.num_neurons
    cfg = torch.tensor(system.initial_spikes, dtype=torch.int32)
    base = P.next_configs(cfg, P.compile_system(sys0, device="cpu"), T)
    want = _rows(base.configs, base.valid, base.emissions)
    state = torch.cat([cfg, torch.zeros(2 * m, dtype=torch.int32)])
    o = P.delayed_next_configs(
        state, P.compile_system(sys0, semantics="delays", device="cpu"), T)
    got = _rows(o.configs, o.valid, o.emissions)
    # spikes slice identical, countdown/pending identically zero
    assert {(r[:m], e) for r, e in got} == want
    assert all(not any(r[m:]) for r, _ in got)


@settings(max_examples=40, deadline=None, database=None)
@given(systems_and_states())
def test_closed_neuron_invariant(sys_state):
    """While a neuron's countdown stays nonzero it neither fires nor
    receives: spikes unchanged, countdown decremented, pending untouched
    — on every successor branch, through both kernel wrappers."""
    system, state = sys_state
    m = system.num_neurons
    spikes, cd = state[:m], state[m:2 * m]
    lowered = _port_lowerings(system, state)
    for name in ("ref", "cuda", "sparse_cuda/hybrid"):
        for row, _ in lowered[name]:
            sp2, cd2, pd2 = row[:m], row[m:2 * m], row[2 * m:]
            for j in range(m):
                if cd[j] > 1:  # closed before, still closed after
                    assert sp2[j] == spikes[j], name
                    assert cd2[j] == cd[j] - 1, name
                    assert pd2[j] == state[2 * m + j], name
