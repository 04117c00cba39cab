"""Step backends: one transition API behind every consumer.

The port of ``repro.core.backend``'s protocol and registry, with the two
backends ported so far:

* :class:`RefBackend` (``"ref"``) — the plain PyTorch semantics
  (:func:`~repro_torch.core.semantics.next_configs`) on any device; the
  reference's ``"ref"``.
* :class:`CudaBackend` (``"cuda"``) — the hand-written dense step kernel
  through :func:`repro_torch.kernels.snp_step.ops.snp_step`; the
  counterpart of the reference's ``"pallas"``.  On CPU tensors the
  wrapper runs the kernel's plain version.

:data:`REFERENCE_NAME` writes the pairing down for the parity tests.
``backend=None`` resolves to ``"cuda"`` (the planner is not ported yet).
All backends agree bit for bit on the valid entries of a :class:`StepOut`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Protocol, Union, runtime_checkable

import torch

from .matrix import CompiledSNP
from .semantics import StepOut, next_configs

__all__ = ["StepBackend", "RefBackend", "CudaBackend", "REFERENCE_NAME",
           "DEFAULT_BACKEND", "get_backend"]

DEFAULT_BACKEND = "cuda"

#: port backend name -> the reference backend it must match bit for bit
REFERENCE_NAME = {"ref": "ref", "cuda": "pallas"}


@runtime_checkable
class StepBackend(Protocol):
    """One synchronous SNP transition step.  ``expand(configs (..., m),
    comp, max_branches)`` returns a :class:`StepOut` with ``configs``
    (..., T, m), ``valid``/``emissions`` (..., T), ``overflow`` (...,)."""

    name: str

    def expand(self, configs: torch.Tensor, comp: CompiledSNP,
               max_branches: int) -> StepOut:
        ...


@dataclass(frozen=True)
class RefBackend:
    """Plain PyTorch reference semantics (the port's oracle)."""

    name: str = "ref"

    def expand(self, configs, comp, max_branches):
        return next_configs(configs, comp, max_branches)


@dataclass(frozen=True)
class CudaBackend:
    """The hand-written dense step kernel (decode + S·M + C in one launch);
    ``StepOut.spiking`` is ``None``, as for the reference's ``"pallas"``."""

    name: str = "cuda"

    def expand(self, configs, comp, max_branches):
        # Imported here: the kernels package imports core.semantics, and
        # core's __init__ imports this module.
        from ..kernels.snp_step.ops import snp_step

        batch, m = configs.shape[:-1], configs.shape[-1]
        out, valid, emis, overflow = snp_step(
            configs.reshape(-1, m), comp, max_branches=max_branches)
        T = max_branches
        return StepOut(configs=out.reshape(*batch, T, m),
                       valid=valid.reshape(*batch, T),
                       emissions=emis.reshape(*batch, T),
                       overflow=overflow.reshape(batch), spiking=None)


_REGISTRY: Dict[str, StepBackend] = {"ref": RefBackend(),
                                     "cuda": CudaBackend()}

BackendLike = Union[str, StepBackend, None]


def get_backend(name: BackendLike = None) -> StepBackend:
    """Resolve a backend by name (``None`` -> ``"cuda"``), or pass an
    instance through."""
    if name is None:
        name = DEFAULT_BACKEND
    if isinstance(name, str):
        try:
            return _REGISTRY[name]
        except KeyError:
            raise ValueError(f"unknown step backend {name!r}; "
                             f"available: {sorted(_REGISTRY)}") from None
    if isinstance(name, StepBackend):
        return name
    raise TypeError(f"expected backend name or StepBackend, got {type(name)}")
