"""The port's whole-step oracle ``repro_torch.kernels.snp_step.snp_step_ref``
(the twin of ``tests/test_kernel_snp_step.py``): the step wrapper
``snp_step`` (on CPU tensors, B1's plain version) equals it on every valid
entry for the same systems, frontiers and branch caps, and it equals the
reference's ``snp_step_ref`` on the same inputs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import compile_system as jcompile  # noqa: E402
from repro.core.generators import (nd_chain, random_system, ring,  # noqa: E402
                                   scaled_pi)
from repro.core.system import paper_pi  # noqa: E402
from repro.kernels.snp_step import snp_step_ref as jstep_ref  # noqa: E402
from repro_torch.core import compile_system as pcompile  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.kernels.snp_step import snp_step, snp_step_ref  # noqa: E402

SYSTEMS = {
    "paper-pi": (paper_pi(True), 16),
    "paper-pi-exact": (paper_pi(False), 16),
    "ring-9": (ring(9), 8),
    "nd-chain-6": (nd_chain(6), 64),
    "random-17": (random_system(17, 3, 0.3, seed=3), 32),
    "random-33": (random_system(33, 2, 0.15, seed=7), 32),
    "pi-x5": (scaled_pi(5), 64),
    "non-divisible": (random_system(11, 3, 0.4, seed=5), 17),
    "branch-overflow": (nd_chain(8), 32),
}


def _port(system):
    return pcompile(system_from_spec(dataclasses.asdict(system)),
                    device="cpu")


def _assert_match(a, b):
    """Two steps' outputs equal on valid entries (the reference test's
    ``_assert_match``)."""
    o1, v1, e1, f1 = (np.asarray(x) for x in a)
    o2, v2, e2, f2 = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(np.where(v1[..., None], o1, 0),
                                  np.where(v2[..., None], o2, 0))
    np.testing.assert_array_equal(np.where(v1, e1, 0), np.where(v2, e2, 0))
    np.testing.assert_array_equal(f1, f2)


def _configs(name, m):
    if name == "branch-overflow":
        return np.ones((2, m), np.int32)
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, 5, size=(6, m)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_step_matches_the_oracle(name):
    system, T = SYSTEMS[name]
    comp = _port(system)
    cfgs = torch.from_numpy(_configs(name, comp.num_neurons))
    _assert_match([x.numpy() for x in snp_step(cfgs, comp, max_branches=T)],
                  [x.numpy() for x in snp_step_ref(cfgs, comp, T)])


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_oracle_matches_the_reference_oracle(name):
    system, T = SYSTEMS[name]
    cfgs = _configs(name, system.num_neurons)
    port = snp_step_ref(torch.from_numpy(cfgs), _port(system), T)
    ref = jstep_ref(jnp.asarray(cfgs), jcompile(system), T)
    _assert_match([x.numpy() for x in port], ref)


def test_large_spike_counts_exact():
    """The oracle and the step stay exact at 2^22-scale spike counts."""
    comp = _port(paper_pi(True))
    cfgs = torch.tensor([[2 ** 22, 1, 2 ** 20]], dtype=torch.int32)
    _assert_match([x.numpy() for x in snp_step(cfgs, comp, max_branches=8)],
                  [x.numpy() for x in snp_step_ref(cfgs, comp, 8)])
