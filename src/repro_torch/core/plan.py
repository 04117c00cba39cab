"""Encoding plan: one :class:`SystemPlan` in front of compile.

The port of ``repro.core.plan``'s single-device half.  A plan decides the
storage layout a backend lowers a system to:

* ``"dense"`` — the paper's ``M_Π`` (:func:`~.matrix.compile_system`);
* ``"ell"`` — ELL rows and the ELL in-adjacency
  (:func:`~.matrix.compile_system_sparse`);
* ``"hybrid"`` — ELL capped at a hub threshold, with the tail synapses of
  heavy neurons in a COO segment;
* ``"auto"`` — the backend's native layout;

and the semantics tier it compiles under: ``"no_delays"`` (the paper's
``C' = C + S·M``) or ``"delays"`` (rules carry a firing delay; state rows
widen to ``[spikes | countdown | pending]``, :mod:`.matrix`).  Every
backend runs both tiers on all its encodings.

Decision rule of :meth:`SystemPlan.for_system`, the reference's
``mode="static"``: with ``mean`` the mean nonzero in-degree and ``Kin``
the max, the hub threshold is ``H = max(4, 4·ceil(mean))``; hybrid iff
``Kin > 2·H``, else plain ELL.

The reference's other plan fields (``num_shards``, ``mode``, ``backend``,
``kernel``, ``partition``) arrive with the ROADMAP items that give them a
second value: the planner (queue 1, items 3 and 5) and sharding (item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .system import SNPSystem

__all__ = ["SystemPlan", "auto_hub_threshold"]

_ENCODINGS = ("auto", "dense", "ell", "hybrid")
_SEMANTICS = ("no_delays", "delays")


@dataclasses.dataclass(frozen=True)
class SystemPlan:
    """How to lay an SNP system out on the card.

    * ``encoding`` — ``"auto"``, ``"dense"``, ``"ell"`` or ``"hybrid"``;
    * ``hub_threshold`` — ELL in-degree cap of the hybrid encoding
      (``None``: :func:`auto_hub_threshold`);
    * ``semantics`` — ``"no_delays"`` or ``"delays"``.
    """

    encoding: str = "auto"
    hub_threshold: Optional[int] = None
    semantics: str = "no_delays"

    def __post_init__(self) -> None:
        if self.encoding not in _ENCODINGS:
            raise ValueError(
                f"unknown encoding {self.encoding!r}; one of {_ENCODINGS}")
        if self.semantics not in _SEMANTICS:
            raise ValueError(
                f"unknown semantics {self.semantics!r}; one of {_SEMANTICS}")
        if self.hub_threshold is not None and self.hub_threshold < 1:
            raise ValueError(
                f"hub_threshold must be >= 1, got {self.hub_threshold}")

    @staticmethod
    def for_system(system: SNPSystem, *,
                   semantics: str = "no_delays") -> "SystemPlan":
        """Concrete plan for ``system`` by the degree heuristic (module
        docstring): hybrid iff the max in-degree is heavy-tailed against
        the mean, else plain ELL; under ``semantics``."""
        if semantics not in _SEMANTICS:
            raise ValueError(
                f"unknown semantics {semantics!r}; one of {_SEMANTICS}")
        in_deg = _in_degrees(system)
        h = auto_hub_threshold(in_deg)
        kin = int(in_deg.max()) if in_deg.size else 0
        if kin > 2 * h:
            return SystemPlan(encoding="hybrid", hub_threshold=h,
                              semantics=semantics)
        return SystemPlan(encoding="ell", semantics=semantics)

    def resolved_hub_threshold(self, system: SNPSystem) -> Optional[int]:
        """The hub threshold ``compile_system_sparse`` caps ELL rows at:
        ``None`` unless this plan asks for the hybrid encoding."""
        if self.encoding != "hybrid":
            return None
        if self.hub_threshold is not None:
            return self.hub_threshold
        return auto_hub_threshold(_in_degrees(system))


def _in_degrees(system: SNPSystem) -> np.ndarray:
    syn = np.asarray(system.synapses, np.int64).reshape(-1, 2)
    return np.bincount(syn[:, 1], minlength=system.num_neurons) \
        if syn.size else np.zeros((system.num_neurons,), np.int64)


def auto_hub_threshold(in_deg: np.ndarray) -> int:
    """``max(4, 4·ceil(mean nonzero in-degree))`` — see module docstring."""
    in_deg = np.asarray(in_deg)
    nz = in_deg[in_deg > 0]
    mean = float(nz.mean()) if nz.size else 0.0
    return max(4, 4 * math.ceil(mean))
