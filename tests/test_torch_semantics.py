"""The port's plain semantics against the reference: ``branch_info`` and
``next_configs`` on ``random_states`` batches, and the overflow cases —
Ψ > T, saturated (+inf) strides, large spike counts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
from repro.core import compile_system as jcompile  # noqa: E402
from repro.core import semantics as jsem  # noqa: E402
from repro.core.generators import nd_chain, scaled_pi  # noqa: E402
from repro.core.system import Rule, SNPSystem, paper_pi  # noqa: E402
from repro_torch.core import compile_system as pcompile  # noqa: E402
from repro_torch.core import semantics as psem  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402


# jitted once per shape: op-by-op dispatch of the reference is slow on CPU
_jnext = jax.jit(jsem.next_configs, static_argnums=2)
_jinfo = jax.jit(jsem.branch_info)


def _pair(system):
    port = pcompile(system_from_spec(dataclasses.asdict(system)),
                    device="cpu")
    return jcompile(system), port


def _assert_same_info(ji, pi, exact_below=2.0 ** 24):
    app = np.asarray(ji.app)
    np.testing.assert_array_equal(pi.app.numpy(), app)
    np.testing.assert_array_equal(np.where(app, pi.rank.numpy(), 0),
                                  np.where(app, np.asarray(ji.rank), 0))
    np.testing.assert_array_equal(pi.choices.numpy(), np.asarray(ji.choices))
    np.testing.assert_array_equal(pi.alive.numpy(), np.asarray(ji.alive))
    # radix products are exact below 2^24; past it both saturate (above
    # 2^24 or +inf), which decodes and validates identically for T < 2^23
    for a, b in ((pi.stride.numpy(), np.asarray(ji.stride)),
                 (pi.psi.numpy(), np.asarray(ji.psi))):
        small = (a < exact_below) | (b < exact_below)
        np.testing.assert_array_equal(a[small], b[small])
        assert (a[~small] >= exact_below).all()
        assert (b[~small] >= exact_below).all()


def _step_both(system, configs, T):
    jc, pc = _pair(system)
    ref = _jnext(jnp.asarray(configs), jc, T)
    port = psem.next_configs(torch.from_numpy(configs), pc, T)
    return jc, pc, ref, port


@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_branch_info_and_step_match_reference(name):
    system, T = conftest.EQUIV_SYSTEMS[name]
    configs = conftest.random_states(system, "no_delays", 8, seed=17)
    jc, pc, ref, port = _step_both(system, configs, T)
    _assert_same_info(_jinfo(jnp.asarray(configs), jc),
                      psem.branch_info(torch.from_numpy(configs), pc))
    conftest.assert_same_step(port, ref)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(
        np.where(valid[..., None], port.spiking.numpy(), 0),
        np.where(valid[..., None], np.asarray(ref.spiking), 0))


def test_nd_batch_dims_match_reference():
    system, T = conftest.EQUIV_SYSTEMS["random-17"]
    configs = conftest.random_states(system, "no_delays", 6, seed=3)
    configs = configs.reshape(2, 3, -1)
    _, _, ref, port = _step_both(system, configs, T)
    assert tuple(port.configs.shape) == (2, 3, T, system.num_neurons)
    conftest.assert_same_step(port, ref)


def test_psi_above_t_overflows_like_reference():
    system = nd_chain(8)                       # Ψ = 2^8 = 256 > T
    configs = np.ones((3, 8), np.int32)
    _, _, ref, port = _step_both(system, configs, 32)
    assert port.overflow.all() and port.valid.all()
    conftest.assert_same_step(port, ref)


def _wide_choice_system(k):
    """k neurons, three rules each, all applicable at one spike: every
    suffix product of the radix strides is a power of 3, so past 3^15 the
    f32 products round, and past 3^80 they overflow to +inf."""
    rules = tuple(Rule(neuron=i, consume=1, produce=p, regex_base=1,
                       covering=True)
                  for i in range(k) for p in (0, 1, 2))
    syn = tuple((i, i + 1) for i in range(k - 1))
    return SNPSystem(k, (1,) * k, rules, syn, output_neuron=k - 1,
                     name=f"three-way-{k}")


@pytest.mark.parametrize("k", [12, 30, 100])
def test_saturated_strides_decode_like_reference(k):
    system = _wide_choice_system(k)
    configs = np.ones((2, k), np.int32)
    configs[1, ::3] = 0                        # some neurons have no rule
    jc, pc, ref, port = _step_both(system, configs, 64)
    ji = _jinfo(jnp.asarray(configs), jc)
    pi = psem.branch_info(torch.from_numpy(configs), pc)
    _assert_same_info(ji, pi)
    if k == 100:
        assert np.isinf(pi.psi.numpy()[0]) and np.isinf(pi.stride.numpy()).any()
    conftest.assert_same_step(port, ref)
    # clamped int strides agree exactly wherever the decode can see them
    js = np.minimum(np.asarray(ji.stride), 2.0 ** 30).astype(np.int32)
    ps = psem.clamp_stride(pi.stride).numpy()
    np.testing.assert_array_equal(np.minimum(ps, 64), np.minimum(js, 64))


@pytest.mark.parametrize("configs", [
    [[2 ** 22, 1, 2 ** 20]],
    [[2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1], [0, 2 ** 23, 3]],
])
def test_large_spike_counts_match_reference(configs):
    configs = np.asarray(configs, np.int32)
    _, _, ref, port = _step_both(paper_pi(True), configs, 16)
    conftest.assert_same_step(port, ref)


def test_scaled_pi_wave_matches_reference():
    system = scaled_pi(6)
    configs = conftest.random_states(system, "no_delays", 5, seed=9, high=3)
    _, _, ref, port = _step_both(system, configs, 64)
    conftest.assert_same_step(port, ref)
