"""The port's step-backend registry against the reference's
(``repro.core.backend``): ``register_backend`` (a duplicate refused unless
``overwrite=True``), a duck-typed backend (``name`` and ``expand`` only)
passing through ``get_backend``, a registered one seen by
``available_backends`` and the query planner's candidates, the tolerant
helpers ``supported_under`` and ``compile_with_plan``, and a minimal
third-party backend driven through ``explore`` on the CPU, equal to the
same backend under the reference.  The twin of
``tests/test_backend.py:38-51``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.core import semantics as J_sem  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import autotune as P_tune  # noqa: E402
from repro_torch.core import backend as P_backend  # noqa: E402
from repro_torch.core import semantics as P_sem  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402

CPU = "cpu"


@pytest.fixture
def registry(monkeypatch):
    """The port's registry, restored after the test."""
    monkeypatch.setattr(P_backend, "_REGISTRY", dict(P_backend._REGISTRY))
    return P_backend._REGISTRY


class _PortMinimal:
    """A third-party backend of the oldest protocol: ``name`` and
    ``expand`` (the plain dense semantics) only."""

    name = "minimal"

    def expand(self, configs, comp, max_branches):
        return P_sem.next_configs(configs, comp, max_branches)


class _RefMinimal:
    name = "minimal"

    def expand(self, configs, comp, max_branches):
        return J_sem.next_configs(configs, comp, max_branches)


def test_registry_contents_and_lookup(registry):
    assert {"ref", "cuda", "sparse", "sparse_cuda"} \
        <= set(P.available_backends())
    assert P.get_backend("ref") == P.RefBackend()
    assert P.get_backend("cuda").name == "cuda"
    assert P.get_backend("sparse") == P.SparseBackend()
    assert P.get_backend("sparse_cuda").name == "sparse_cuda"
    # instances pass through unchanged
    be = P.CudaBackend(block_t=16)
    assert P.get_backend(be) is be
    with pytest.raises(ValueError, match="unknown step backend"):
        P.get_backend("no-such-backend")
    with pytest.raises(ValueError, match="already registered"):
        P.register_backend(P.RefBackend())
    P.register_backend(P.RefBackend(), overwrite=True)
    assert P.get_backend("ref") == P.RefBackend()
    with pytest.raises(TypeError, match="expected backend name"):
        P.get_backend(object())


def test_duck_typed_backend_passes_through_as_in_the_reference():
    port, ref = _PortMinimal(), _RefMinimal()
    assert J.get_backend(ref) is ref
    assert P.get_backend(port) is port
    # the hooks it lacks: no encodings under any tier, lowering is the
    # identity, not sharded
    assert P.supported_under(port, "no_delays") == () == \
        J.supported_under(ref, "no_delays")
    comp = P.compile_system(P.paper_pi(True), device=CPU)
    assert P.lower_with_backend(port, comp, None) is comp
    assert not P.supports_sharded(port)


def test_supported_under_tolerates_old_signatures():
    class NoSemantics:
        name = "old"

        def expand(self, configs, comp, max_branches):
            raise AssertionError

        def supported_encodings(self):
            return ("dense",)

    for mod in (P, J):
        old = NoSemantics()
        assert mod.supported_under(old, "no_delays") == ("dense",)
        assert mod.supported_under(old, "delays") == ()
    assert P.supported_under(P.get_backend("cuda"), "delays") == \
        ("dense",)


def test_compile_with_plan_tolerates_old_compile_signatures():
    class NoPlanNoDevice(_PortMinimal):
        name = "old-compile"

        def compile(self, system):
            return P.compile_system(system, device=CPU)

    system = P.paper_pi(True)
    got = P.compile_with_plan(NoPlanNoDevice(), system, None, CPU)
    want = P.compile_with_plan(P.get_backend("ref"), system,
                               P.SystemPlan(), CPU)
    np.testing.assert_array_equal(got.M.numpy(), want.M.numpy())
    assert got.device == torch.device(CPU)


def test_registered_backend_is_seen_by_the_planner(registry):
    @dataclasses.dataclass(frozen=True)
    class Mine(P.RefBackend):
        name: str = "mine"

    P.register_backend(Mine())
    assert "mine" in P.available_backends()
    sig = P_tune.WorkloadSignature(m=7, n=13, kin=3, B=4, T=8)
    names = {c.backend for c in P_tune.default_candidates(sig, device=CPU)}
    assert "mine" in names
    # on the card only the kernel backends are candidates
    assert "mine" not in P_tune._names("cuda")


def test_minimal_backend_explores_equal_to_the_reference(registry):
    P.register_backend(_PortMinimal())
    system = J.paper_pi(True)
    port_system = system_from_spec(dataclasses.asdict(system))
    kw = dict(max_steps=10, frontier_cap=32, visited_cap=512,
              max_branches=16)
    want = J.explore(J.compile_system(system), backend=_RefMinimal(), **kw)
    for backend in ("minimal", _PortMinimal()):
        got = P.explore(P.compile_system(port_system, device=CPU),
                        backend=backend, device=CPU, **kw)
        np.testing.assert_array_equal(got.configs, np.asarray(want.configs))
        assert (got.steps, got.exhausted, got.frontier_overflow) == \
            (int(want.steps), want.exhausted, want.frontier_overflow)
