"""Step backends: one transition API behind every consumer.

The port of ``repro.core.backend``'s protocol, lowering template and
registry, with four backends, each the counterpart of one reference
backend (:data:`REFERENCE_NAME`):

* :class:`RefBackend` (``"ref"``) — the plain dense semantics
  (:func:`~repro_torch.core.semantics.next_configs`);
* :class:`CudaBackend` (``"cuda"``, ↔ ``"pallas"``) — the hand-written
  dense step kernel through :func:`repro_torch.kernels.snp_step.ops.snp_step`;
* :class:`SparseBackend` (``"sparse"``) — the plain sparse semantics
  (:func:`~repro_torch.core.semantics.sparse_next_configs`) on the
  ELL/hybrid encoding;
* :class:`SparseCudaBackend` (``"sparse_cuda"``, ↔ ``"sparse_pallas"``) —
  the hand-written sparse step kernel (ELL body, and the COO stage for a
  hybrid encoding) through
  :func:`repro_torch.kernels.snp_step.sparse_ops.snp_step_sparse`.

On CPU tensors the kernel backends' wrappers run the kernels' plain
versions.  All backends agree bit for bit on the valid entries of a
:class:`StepOut`.  Each runs both semantics tiers: ``expand`` takes the
delayed step (``3m``-wide state rows; the kernel backends through B4 and
B5) for an encoding compiled under ``semantics="delays"``.

Each backend owns its lowering: ``supported_encodings(semantics)`` lists
the plan encodings its step realizes under a semantics tier (first =
native, what ``encoding="auto"`` resolves to; ``"sharded"`` = it can step
a neuron shard, delay-free only), ``lower(compiled, plan)`` checks a
built encoding, and ``compile(system, plan, device)`` is the shared
template :func:`_registry_compile`, which compiles under the plan's
semantics, or to a :class:`~.plan.ShardedCompiled` for a plan with
``num_shards > 1`` (``"cuda"``'s ``lower`` attaches the dense shard
operands B6 reads).  A plan a backend cannot honour raises; it is never
reinterpreted.

The kernel backends carry a block shape (``block_t``, ``threads``; ``None``
= the library's rule), which :func:`resolve_kernel` folds in from a plan's
:class:`~.plan.KernelConfig` and ``expand`` and the shard steps pass to
the wrappers.  :func:`resolve_entry_info` asks the query planner
(:mod:`.autotune`) when the caller leaves the choice open.
"""

from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Tuple, Union, runtime_checkable

import torch

from .device import DeviceLike, resolve_device
from .matrix import (CompiledAny, CompiledSNP, CompiledSparseSNP,
                     check_coo_metadata, compile_system,
                     compile_system_sparse, is_delayed)
from .plan import (SystemPlan, compile_sharded, is_sharded,
                   lower_shard_dense)
from .semantics import (StepOut, delayed_next_configs, next_configs,
                        sparse_delayed_next_configs, sparse_next_configs)
from .system import SNPSystem

__all__ = ["StepBackend", "RefBackend", "CudaBackend", "SparseBackend",
           "SparseCudaBackend", "REFERENCE_NAME", "available_backends",
           "get_backend", "register_backend", "supported_under",
           "compile_with_plan", "resolve_kernel", "resolve_entry",
           "resolve_entry_info", "lower_with_backend", "supports_sharded"]

#: port backend name -> the reference backend it must match bit for bit
REFERENCE_NAME = {"ref": "ref", "cuda": "pallas", "sparse": "sparse",
                  "sparse_cuda": "sparse_pallas"}


@runtime_checkable
class StepBackend(Protocol):
    """One synchronous SNP transition step.  ``expand(configs (..., w),
    comp, max_branches)`` returns a :class:`StepOut` with ``configs``
    (..., T, w), ``valid``/``emissions`` (..., T), ``overflow`` (...,);
    ``w`` is ``comp.state_width`` (``m``, or ``3m`` under delays)."""

    name: str

    def supported_encodings(self, semantics: str = "no_delays"
                            ) -> Tuple[str, ...]:
        ...

    def lower(self, compiled: CompiledAny, plan: SystemPlan) -> CompiledAny:
        ...

    def compile(self, system: SNPSystem, plan: Optional[SystemPlan] = None,
                device: DeviceLike = None) -> CompiledAny:
        ...

    def expand(self, configs: torch.Tensor, comp: CompiledAny,
               max_branches: int) -> StepOut:
        ...


def _registry_compile(backend: StepBackend, system: SNPSystem,
                      plan: Optional[SystemPlan],
                      device: DeviceLike) -> CompiledAny:
    """The ``compile`` every backend delegates to: resolve the plan's
    encoding against ``supported_encodings()`` under the plan's semantics
    tier, build it on ``device`` (``None`` = the card) under that tier,
    hand it to ``lower``.  A plan with ``num_shards > 1`` lowers through
    :func:`~.plan.compile_sharded` (which validates its encoding) for a
    backend that declares ``"sharded"``."""
    plan = SystemPlan() if plan is None else plan
    _check_kernel_plan(backend, plan)
    sup = backend.supported_encodings(semantics=plan.semantics)
    if plan.num_shards > 1:
        if "sharded" not in sup:
            raise ValueError(
                f"backend {backend.name!r} cannot realize a neuron-axis "
                f"sharded plan under semantics={plan.semantics!r} "
                f"(supported encodings: {sup}); pick a backend whose "
                "lowering supports 'sharded' there")
        return backend.lower(compile_sharded(system, plan, device), plan)
    enc = sup[0] if plan.encoding == "auto" else plan.encoding
    if enc not in sup:
        raise ValueError(
            f"backend {backend.name!r} cannot realize plan encoding "
            f"{plan.encoding!r} under semantics={plan.semantics!r} "
            f"(supported: {sup}); pick a matching backend or drop the plan")
    if enc == "dense":
        built = compile_system(system, semantics=plan.semantics,
                               device=device)
    else:
        built = compile_system_sparse(
            system, hub_threshold=plan.resolved_hub_threshold(system),
            semantics=plan.semantics, device=device)
    return backend.lower(built, plan)


def _require(comp, cls, backend_name: str):
    if not isinstance(comp, cls):
        raise TypeError(
            f"backend {backend_name!r} needs a {cls.__name__} (use "
            f"backend.compile), got {type(comp).__name__}")
    return comp


def _flat_expand(step, configs, comp, max_branches, be) -> StepOut:
    """Run a kernel wrapper ``step`` on the flattened batch at ``be``'s
    block shape and restore the leading dims (``spiking`` is ``None``, as
    for the reference's Pallas backends)."""
    batch, w = configs.shape[:-1], configs.shape[-1]   # w = m, or 3m
    out, valid, emis, overflow = step(configs.reshape(-1, w), comp,
                                      max_branches=max_branches,
                                      rows=be.block_t, threads=be.threads)
    T = max_branches
    return StepOut(configs=out.reshape(*batch, T, w),
                   valid=valid.reshape(*batch, T),
                   emissions=emis.reshape(*batch, T),
                   overflow=overflow.reshape(batch), spiking=None)


@dataclass(frozen=True)
class _Dense:
    def supported_encodings(self, semantics: str = "no_delays"
                            ) -> Tuple[str, ...]:
        # the halo exchange carries spike counts only: no sharded delays
        return ("dense",) if semantics == "delays" else ("dense", "sharded")

    def lower(self, compiled: CompiledAny, plan: SystemPlan) -> CompiledAny:
        return compiled

    def compile(self, system: SNPSystem, plan: Optional[SystemPlan] = None,
                device: DeviceLike = None) -> CompiledAny:
        return _registry_compile(self, system, plan, device)


@dataclass(frozen=True)
class _Sparse(_Dense):
    def supported_encodings(self, semantics: str = "no_delays"
                            ) -> Tuple[str, ...]:
        return ("ell", "hybrid") if semantics == "delays" \
            else ("ell", "hybrid", "sharded")

    def lower(self, compiled: CompiledAny, plan: SystemPlan) -> CompiledAny:
        # Only a hand-built encoding can lack the COO metadata the step's
        # tail stage reads: refuse it here, never downgrade.
        if isinstance(compiled, CompiledSparseSNP):
            check_coo_metadata(compiled, self.name)
        return compiled


@dataclass(frozen=True)
class RefBackend(_Dense):
    """Plain PyTorch dense semantics (the port's oracle)."""

    name: str = "ref"

    def expand(self, configs, comp, max_branches):
        comp = _require(comp, CompiledSNP, self.name)
        if is_delayed(comp):
            return delayed_next_configs(configs, comp, max_branches)
        return next_configs(configs, comp, max_branches)


@dataclass(frozen=True)
class CudaBackend(_Dense):
    """The hand-written dense step kernels: decode + S·M + C in one launch
    (B1), or the delayed step (B4) for a delayed encoding.  A neuron shard
    steps through B6, on the dense operands ``lower`` attaches.
    ``block_t``/``threads``: the kernels' block shape (``None``: the
    library's rule; :func:`resolve_kernel`)."""

    name: str = "cuda"
    block_t: Optional[int] = None
    threads: Optional[int] = None

    def lower(self, compiled: CompiledAny, plan: SystemPlan) -> CompiledAny:
        if is_sharded(compiled):
            return lower_shard_dense(compiled)
        return compiled

    def expand(self, configs, comp, max_branches):
        # Imported here: the kernels package imports core.semantics, and
        # core's __init__ imports this module.
        from ..kernels.snp_step.ops import snp_step
        return _flat_expand(snp_step, configs,
                            _require(comp, CompiledSNP, self.name),
                            max_branches, self)


@dataclass(frozen=True)
class SparseBackend(_Sparse):
    """Plain PyTorch sparse semantics: digit decode, fired-rule lookup and
    a gather over the in-adjacency, ``O(B·T·m·degree)``."""

    name: str = "sparse"

    def expand(self, configs, comp, max_branches):
        comp = _require(comp, CompiledSparseSNP, self.name)
        if is_delayed(comp):
            return sparse_delayed_next_configs(configs, comp, max_branches)
        return sparse_next_configs(configs, comp, max_branches)


@dataclass(frozen=True)
class SparseCudaBackend(_Sparse):
    """The hand-written sparse step kernel: the ELL body, with the COO
    segment-sum stage for a hybrid encoding (B2, B3), and with the delay
    stage for a delayed encoding (B5); ``block_t``/``threads`` as for
    :class:`CudaBackend`."""

    name: str = "sparse_cuda"
    block_t: Optional[int] = None
    threads: Optional[int] = None

    def expand(self, configs, comp, max_branches):
        from ..kernels.snp_step.sparse_ops import snp_step_sparse
        return _flat_expand(snp_step_sparse, configs,
                            _require(comp, CompiledSparseSNP, self.name),
                            max_branches, self)


_REGISTRY: Dict[str, StepBackend] = {}

BackendLike = Union[str, StepBackend, None]


def register_backend(backend: StepBackend, *, overwrite: bool = False
                     ) -> None:
    """Register ``backend`` under ``backend.name``, so every entry point,
    :func:`available_backends` and the query planner's candidates pick it
    up by name.  A name already registered is refused unless
    ``overwrite``."""
    if not overwrite and backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend


def supported_under(backend: StepBackend, semantics: str
                    ) -> Tuple[str, ...]:
    """``backend.supported_encodings`` under a semantics tier, tolerating
    third-party backends that predate the semantics parameter (they keep
    answering for ``"no_delays"`` and are declared incapable, an empty
    tuple, of anything else) or the lowering registry (an empty tuple)."""
    sup_fn = getattr(backend, "supported_encodings", None)
    if sup_fn is None:
        return ()
    try:
        return tuple(sup_fn(semantics=semantics))
    except TypeError:
        return tuple(sup_fn()) if semantics == "no_delays" else ()


def supports_sharded(backend: StepBackend) -> bool:
    """Whether ``backend`` declares the ``"sharded"`` encoding (for the
    delay-free tier), so it may step a neuron shard."""
    return "sharded" in supported_under(backend, "no_delays")


def available_backends() -> Tuple[str, ...]:
    """The registry's backend names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_backend(name: BackendLike) -> StepBackend:
    """Resolve a backend by registry name, or pass an instance through.

    Instances are duck-checked against the core of the protocol (``name``
    and ``expand``), not the whole :class:`StepBackend`, so a third-party
    backend without the lowering hooks resolves too; the tolerant helpers
    (:func:`supported_under`, :func:`lower_with_backend`,
    :func:`compile_with_plan`) cover the missing methods."""
    if isinstance(name, str):
        try:
            return _REGISTRY[name]
        except KeyError:
            raise ValueError(f"unknown step backend {name!r}; "
                             f"available: {available_backends()}") from None
    if hasattr(name, "expand") and hasattr(name, "name"):
        return name
    raise TypeError(f"expected backend name or StepBackend, got {type(name)}")


def compile_with_plan(backend: StepBackend, system: SNPSystem,
                      plan: Optional[SystemPlan],
                      device: DeviceLike = None) -> CompiledAny:
    """``backend.compile`` with an optional plan, on ``device``, tolerating
    third-party backends that predate the plan parameter (they only see
    the default plan, which is the identity) or take no ``device`` (their
    encoding is moved there)."""
    kw = {} if plan is None or plan == SystemPlan() else {"plan": plan}
    params = inspect.signature(backend.compile).parameters
    if "device" in params or any(p.kind == p.VAR_KEYWORD
                                 for p in params.values()):
        return backend.compile(system, device=device, **kw)
    return backend.compile(system, **kw).to(resolve_device(device))


def lower_with_backend(backend: StepBackend, compiled: CompiledAny,
                       plan: Optional[SystemPlan]) -> CompiledAny:
    """``backend.lower`` of a built encoding under ``plan`` (``None``: the
    default plan), the identity for a third-party backend that predates
    the lowering registry.  The trace service re-lowers a chunk's encoding
    through it when it degrades a backend."""
    lower = getattr(backend, "lower", None)
    if lower is None:
        return compiled
    return lower(compiled, SystemPlan() if plan is None else plan)


register_backend(RefBackend())
register_backend(CudaBackend())
register_backend(SparseBackend())
register_backend(SparseCudaBackend())


def _kernel_of(backend: StepBackend, plan: SystemPlan) -> Tuple[str, tuple,
                                                             tuple]:
    """The kernel a plan runs on a kernel backend, with the ``block_t``
    and ``threads`` values it takes (the wrappers' sets)."""
    from ..kernels.snp_step import ops, sparse_ops
    rows, threads = sparse_ops.ROWS, sparse_ops.THREADS
    if isinstance(backend, SparseCudaBackend):
        return ("B7" if plan.num_shards > 1 else "the sliced-list kernel",
                rows, threads)
    if plan.num_shards > 1:
        return "B6", rows, (ops.THREADS,)
    if plan.semantics == "delays":
        return "B4", rows, threads
    return "B1", ops.B1_ROWS, (ops.THREADS,)


def _check_kernel_plan(backend: StepBackend, plan: SystemPlan) -> None:
    """A ``plan.kernel`` field the backend, or the kernel the plan runs on
    it, cannot honour is a ``ValueError`` with a real message, never a
    silently ignored field.  Whether a shape's stage fits is the wrappers'
    check (it needs the system's width)."""
    cfg = plan.kernel
    if cfg is None:
        return
    if not isinstance(backend, (CudaBackend, SparseCudaBackend)):
        raise ValueError(
            f"backend {backend.name!r} has no kernel block parameters; "
            f"drop SystemPlan.kernel={cfg} or pick a kernel backend "
            "('cuda', 'sparse_cuda')")
    kernel, rows, threads = _kernel_of(backend, plan)
    if cfg.block_t is not None and cfg.block_t not in rows:
        raise ValueError(
            f"plan kernel sets block_t={cfg.block_t}, but {kernel}, which "
            f"this plan runs on {backend.name!r}, takes {rows} rows a block")
    if cfg.threads is not None and cfg.threads not in threads:
        raise ValueError(
            f"plan kernel sets threads={cfg.threads}, but {kernel}, which "
            f"this plan runs on {backend.name!r}, runs "
            f"{' or '.join(map(str, threads))} threads a block; drop "
            "threads")


def resolve_kernel(backend: StepBackend,
                   plan: Optional[SystemPlan]) -> StepBackend:
    """``backend`` with ``plan.kernel`` folded in: a new (frozen,
    hashable) instance carrying the plan's block shape, so two shapes are
    two distinct backends.  Identity when the plan carries no kernel
    config; ``ValueError`` when the backend cannot honour it
    (:func:`_check_kernel_plan`).  A ``None`` field keeps the backend's
    own."""
    if plan is None or plan.kernel is None:
        return backend
    _check_kernel_plan(backend, plan)
    fields = {f: v for f in ("block_t", "threads")
              if (v := getattr(plan.kernel, f)) is not None}
    return dataclasses.replace(backend, **fields) if fields else backend


def resolve_entry_info(system, backend: BackendLike,
                       plan: Optional[SystemPlan], *,
                       workload: Optional[Tuple[int, int]] = None,
                       device: DeviceLike = None,
                       ) -> Tuple[StepBackend, Optional[SystemPlan], bool]:
    """:func:`resolve_entry` and who chose: ``(backend, plan, planned)``.

    The backend is the one named by the caller, else by ``plan.backend``.
    Otherwise, for an :class:`SNPSystem` whose plan is open — ``mode``
    ``"auto"`` or ``"measure"``, no encoding and no kernel pinned — the
    query planner decides (:meth:`~.plan.SystemPlan.for_system` with
    ``workload=(B, T)``, the batch and branch cap the entry point is
    about to run, on ``device``: the autotune cache, the seed rows, the
    cost model, or, for ``"measure"``, a timing of the candidates) and
    its plan is returned.  When the planner has nothing to say, or the
    plan is not open, the port's encoding rule picks: ``"sparse_cuda"``
    for a sparse encoding or an ``"ell"``/``"hybrid"`` plan, else
    ``"cuda"``.  ``planned`` is True exactly when the plan was open —
    the cases where the reference's query planner picks; a failure may
    then degrade down :data:`~.failover.DEGRADE_ORDER`.  A pinned
    backend's failure raises.  An open plan comes back with the chosen
    backend pinned; otherwise the caller's plan comes back unchanged.
    Either way the plan's kernel config is folded into the backend
    (:func:`resolve_kernel`)."""
    if backend is not None:
        return resolve_kernel(get_backend(backend), plan), plan, False
    if plan is not None and plan.backend is not None:
        return resolve_kernel(get_backend(plan.backend), plan), plan, False
    planned = isinstance(system, SNPSystem) and (plan is None or (
        plan.mode in ("auto", "measure") and plan.encoding == "auto"
        and plan.kernel is None))
    if planned:
        base = SystemPlan() if plan is None else plan
        chosen = SystemPlan.for_system(
            system, num_shards=base.num_shards, workload=workload,
            mode=base.mode, semantics=base.semantics, device=device)
        if chosen.backend is not None:
            return (resolve_kernel(get_backend(chosen.backend), chosen),
                    chosen, True)
        plan = base
    sparse = isinstance(system, CompiledSparseSNP) or (
        plan is not None and plan.encoding in ("ell", "hybrid"))
    be = get_backend("sparse_cuda" if sparse else "cuda")
    if planned:
        plan = dataclasses.replace(plan, backend=be.name)
    return resolve_kernel(be, plan), plan, planned


def resolve_entry(system, backend: BackendLike,
                  plan: Optional[SystemPlan], *,
                  workload: Optional[Tuple[int, int]] = None,
                  device: DeviceLike = None) -> StepBackend:
    """The backend an entry point runs (:func:`resolve_entry_info`'s
    first element)."""
    return resolve_entry_info(system, backend, plan, workload=workload,
                              device=device)[0]
