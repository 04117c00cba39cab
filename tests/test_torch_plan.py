"""The port's ``SystemPlan`` against the reference's: the same validation
of the fields it carries, the same static degree heuristic, the same auto
hub threshold."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import power_law, ring_lattice  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402

SYSTEMS = {**{k: s for k, (s, _) in conftest.EQUIV_SYSTEMS.items()},
           "ring-lattice-64": ring_lattice(64, 4, seed=0),
           "power-law-400": power_law(400, 3, seed=0),
           "power-law-8192": power_law(8192, 4, seed=2)}

FIELDS = ("encoding", "hub_threshold")


def _fields(plan):
    return {f: getattr(plan, f) for f in FIELDS}


@pytest.mark.parametrize("kwargs,match", [
    (dict(encoding="csr"), "encoding"),
    (dict(encoding="hybrid", hub_threshold=0), "hub_threshold"),
    (dict(encoding="ell", hub_threshold=-3), "hub_threshold"),
])
def test_plan_validation_matches_reference(kwargs, match):
    with pytest.raises(ValueError, match=match):
        J.SystemPlan(**kwargs)
    with pytest.raises(ValueError, match=match):
        P.SystemPlan(**kwargs)


def test_default_plan_equals_reference_default():
    assert _fields(P.SystemPlan()) == _fields(J.SystemPlan())


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_for_system_static_matches_reference(name):
    system = SYSTEMS[name]
    port_system = system_from_spec(dataclasses.asdict(system))
    ref = J.SystemPlan.for_system(system, mode="static")
    got = P.SystemPlan.for_system(port_system)
    assert _fields(got) == _fields(ref)
    for plan in (got, P.SystemPlan(encoding="hybrid"),
                 P.SystemPlan(encoding="hybrid", hub_threshold=3),
                 P.SystemPlan(encoding="ell")):
        jplan = J.SystemPlan(**_fields(plan))
        assert plan.resolved_hub_threshold(port_system) == \
            jplan.resolved_hub_threshold(system)


def test_power_law_8192_plans_hybrid():
    """The slice's main-path system: an unbounded hub (in-degree 1,585)
    against an auto threshold of 36, so the plan is hybrid."""
    system = system_from_spec(dataclasses.asdict(SYSTEMS["power-law-8192"]))
    plan = P.SystemPlan.for_system(system)
    assert (plan.encoding, plan.hub_threshold) == ("hybrid", 36)


@pytest.mark.parametrize("degrees", [
    [], [0, 0, 0], [1], [3, 0, 5], [1, 1, 1, 1], [2] * 7 + [900],
    list(range(40))])
def test_auto_hub_threshold_matches_reference(degrees):
    deg = np.asarray(degrees, np.int64)
    assert P.auto_hub_threshold(deg) == J.auto_hub_threshold(deg)
