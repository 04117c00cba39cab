"""Sharding plan: parameter / batch / cache partition specs and activation
constraints for FSDP + TP (+ EP when the expert count divides an axis, + SP
options), the port of the JAX package's ``repro.sharding.specs``.

Axes convention (:mod:`repro_torch.launch.mesh`):

* single pod: ``(data, model)`` = (16, 16)
* multi pod:  ``(pod, data, model)`` = (2, 16, 16); ``pod`` joins the
  FSDP/batch axes (hierarchical DP), and the same plan covers both.

Parameters are sharded 2-D (FSDP over ``data`` (+ ``pod``) on the
reduction dim, TP over ``model`` on heads/ff/experts).  The reference runs
its plan through GSPMD; the port runs the same specs through DTensor: one
process a device, a :class:`torch.distributed.device_mesh.DeviceMesh`
with the same axis names, and :meth:`ShardingPlan.named` turning a spec
into DTensor placements.  :meth:`ShardingPlan.constrain` is the
reference's ``with_sharding_constraint`` table applied with
``DTensor.redistribute``.

The rule table sees each parameter as the reference holds it: the
reference stacks a pattern position's layers along a leading period axis
(``stack/pos0/attn/wq`` is ``(num_periods, d, H, hd)``), the port holds
one tensor a layer (``blocks.<l>.attn.wq``), so a layer parameter is
named by its reference path and ranked with the period axis
(:func:`repro_torch.models.convert.reference_ndims`), and the period
entry is dropped from its spec.  The reference shards that entry only
where a rule written for a rank-3 weight meets a stacked rank-2 one of
the same name, which it then takes as its own rank: RWKV's ``wk`` and
``wv`` (the attention projections' ``P(f, t, None)``: periods over the
FSDP axes) and a MoE's shared expert (``moe/shared/wg``, ``wu``, ``wd``,
the routed experts' rule: periods over ``model``).  The port cannot put
a layer's tensor on some ranks only; it keeps those layers whole along
that axis, and their other dims as the reference's spec says.

``param_specs``, ``batch_specs``, ``cache_specs`` and ``fit`` need no
process group: they take an :class:`AbstractMesh` (axis names and sizes)
as the reference's tests take ``jax.sharding.AbstractMesh``.

:func:`neuron_axis` and :func:`trace_mesh` are the SNP plans (the
reference's ``ShardingPlan.neuron_axis`` and ``ShardingPlan.trace_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.plan import SystemPlan

__all__ = ["P", "AbstractMesh", "ShardingPlan", "make_plan", "neuron_axis",
           "trace_mesh"]


class P(tuple):
    """A partition spec, the port's ``jax.sharding.PartitionSpec``: one
    entry a tensor dim, each ``None`` (replicated), a mesh axis name, or a
    tuple of names (major to minor).  A tuple, so it compares with the
    reference's specs entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh without devices or a process group: axis names and sizes
    (``jax.sharding.AbstractMesh``'s counterpart), enough for the specs."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def _names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _param_rule(path: str, ndim: int, f, t, ep_ok: bool) -> P:
    """The reference's parameter rule (``ShardingPlan.param_specs.rule``)
    for the leaf at ``path`` (its tree path, ``/``-joined) of ``ndim``
    dims, as the reference holds it."""
    def pad(spec: P) -> P:
        # stack params carry the leading periods axis
        if "stack/" in path and len(spec) < ndim:
            return P(*((None,) + tuple(spec)))
        return spec

    name = path.rsplit("/", 1)[-1]
    # --- embeddings / head
    if name == "embed":
        return P(t, f) if ndim == 2 else P(None, t, f)
    if name == "head":
        return P(f, t) if ndim == 2 else P(None, f, t)
    # --- 1-d (norm scales, biases on vectors)
    base_ndim = ndim - (1 if "stack/" in path else 0)
    if base_ndim <= 1:
        return pad(P(None))
    # --- attention
    if name in ("wq", "wk", "wv"):
        return pad(P(f, t, None))
    if name == "wo" and "attn" in path:
        return pad(P(t, None, f))
    if name in ("bq", "bk", "bv"):
        return pad(P(t, None))
    if name in ("wdq", "wdkv"):
        return pad(P(f, None))
    if name in ("wuq", "wuk", "wuv"):
        return pad(P(None, t, None))
    # --- moe
    if name == "router":
        return pad(P(f, None))
    if "moe" in path and name in ("wg", "wu"):
        return pad(P(t, f, None) if ep_ok else P(None, f, t))
    if "moe" in path and name == "wd":
        return pad(P(t, None, f) if ep_ok else P(None, t, f))
    # --- dense mlp
    if name in ("wg", "wu"):
        return pad(P(f, t))
    if name == "wd":
        return pad(P(t, f))
    # --- mamba
    if name == "in_proj":
        return pad(P(f, t))
    if name == "conv_w":
        return pad(P(None, t))
    if name == "x_proj":
        return pad(P(t, None))
    if name == "dt_proj_w":
        return pad(P(None, t))
    if name == "a_log":
        return pad(P(t, None))
    if name == "out_proj":
        return pad(P(t, f))
    # --- rwkv
    if name in ("wr", "wk", "wv", "wg", "cm_wk", "cm_wr"):
        return pad(P(f, t))
    if name in ("wo", "cm_wv"):
        return pad(P(t, f))
    if name == "maa_w1":
        return pad(P(f, None))
    if name == "maa_w2":
        return pad(P(None, None, f))
    if name == "decay_w1":
        return pad(P(f, None))
    if name == "decay_w2":
        return pad(P(None, f))
    if name == "bonus":
        return pad(P(t, None))
    if name == "maa_rkvwg":
        return pad(P(None, None))
    # fallback: replicate
    return pad(P(*([None] * ndim)))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any                     # DeviceMesh or AbstractMesh
    fsdp: Tuple[str, ...]         # ('data',) or ('pod', 'data')
    tp: str                       # 'model'
    # options (hillclimb knobs)
    seq_shard_activations: bool = False   # SP: shard S of the residual stream
    shard_kv_seq: bool = True             # serving: KV cache S over tp

    # ---- divisibility fitting --------------------------------------------
    def _axes_size(self, axes) -> int:
        sizes = _sizes(self.mesh)
        out = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out *= sizes[a]
        return out

    def fit(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Drop mesh axes from dims they don't divide (e.g. 5 KV heads on a
        16-way model axis fall back to replication; batch 1 on a 32-way DP
        axis keeps only the divisible sub-axes).  Tuples shed their
        outermost axis first ('pod' before 'data')."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, entry in zip(shape, entries):
            if entry is None:
                out.append(None)
                continue
            axes = _entry_axes(entry)
            while axes and dim % self._axes_size(axes) != 0:
                axes = axes[1:]
            out.append(axes if len(axes) > 1 else
                       (axes[0] if axes else None))
        return P(*out)

    # ---- sizes -----------------------------------------------------------
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.fsdp

    @property
    def tp_size(self) -> int:
        return _sizes(self.mesh)[self.tp]

    @property
    def dp_size(self) -> int:
        out = 1
        for a in self.fsdp:
            out *= _sizes(self.mesh)[a]
        return out

    # ---- parameter specs ---------------------------------------------------
    def param_specs(self, cfg, params, *,
                    names: Optional[Sequence[str]] = None):
        """The spec of each parameter: ``params`` an LM (-> {name: spec}
        in the order of ``named_parameters()``), or a sequence of tensors
        in that order (AdamW's moments, the error-feedback residual: the
        reference's rule gives them their parameter's spec) with their
        ``names`` or the config's (-> a list of specs)."""
        from ..models.convert import _path
        f, t = self.fsdp, self.tp
        ep_ok = bool(cfg.num_experts
                     and cfg.num_experts % self.tp_size == 0)
        if isinstance(params, torch.nn.Module):
            named = list(params.named_parameters())
        else:
            if names is None:
                from ..models.model import LM
                names = [n for n, _ in
                         LM(None, cfg, "meta").named_parameters()]
            named = list(zip(names, params))
            if len(named) != len(params):
                raise ValueError(f"{len(params)} tensors for "
                                 f"{len(names)} names")
        P_ = len(cfg.layer_pattern)
        specs = {}
        for name, tensor in named:
            path, period = _path(name, P_)
            stacked = period >= 0
            ndim = tensor.dim() + stacked
            shape = ((cfg.num_periods,) if stacked else ()) \
                + tuple(tensor.shape)
            spec = self.fit(_param_rule("/".join(path), ndim, f, t, ep_ok),
                            shape)
            if stacked:
                # one tensor a layer: the period entry goes (module
                # docstring: the few leaves whose rule shards it)
                spec = P(*spec[1:])
            specs[name] = spec
        if isinstance(params, torch.nn.Module):
            return specs
        return list(specs.values())

    # ---- batch specs -------------------------------------------------------
    def batch_specs(self, cfg, batch: Mapping[str, Any]) -> Dict[str, P]:
        """{name: spec} of a batch dict (tensors, or anything with
        ``.shape``)."""
        f = self.fsdp
        out = {}
        for name, leaf in batch.items():
            nd = len(leaf.shape)
            if name in ("tokens", "labels"):
                s = P(f, None, None) if nd == 3 else P(f, None)
            elif name == "positions":
                s = P(None, f, None) if nd == 3 else P(f, None)
            elif name == "frontend_embeds":
                s = P(f, None, None)
            elif name == "embed_mask":
                s = P(f, None)
            else:
                s = P(*([None] * nd))
            out[name] = self.fit(s, tuple(leaf.shape))
        return out

    # ---- cache specs -------------------------------------------------------
    def cache_specs(self, cfg, cache: Sequence[Mapping[str, Any]]
                    ) -> List[Dict[str, P]]:
        """One {name: spec} a layer of the port's per-layer caches.  The
        reference's cache leaves carry the leading period axis; its rule
        is applied at that rank and the (never sharded) period entry
        dropped."""
        f, t = self.fsdp, self.tp
        seq = t if self.shard_kv_seq else None

        def spec(name, shape):
            nd = len(shape) + 1   # the reference's leading periods axis
            if name in ("k", "v"):           # (P,B,S,Hk,hd)
                s = P(None, f, seq, None, None)
            elif name == "ckv":              # (P,B,S,rank)
                s = P(None, f, seq, None)
            elif name == "k_rope":           # (P,B,S,1,dr)
                s = P(None, f, seq, None, None)
            elif name == "len":
                s = P(None, f)
            elif name == "conv":             # (P,B,dconv-1,din)
                s = P(None, f, None, t)
            elif name == "ssm":              # (P,B,din,n)
                s = P(None, f, t, None)
            elif name == "state":            # (P,B,H,hs,hs)
                s = P(None, f, t, None, None)
            elif name in ("tm_shift", "cm_shift"):   # (P,B,D)
                s = P(None, f, None)
            else:
                s = P(*([None] * nd))
            return P(*self.fit(s, (cfg.num_periods,) + tuple(shape))[1:])

        return [{name: spec(name, tuple(leaf.shape))
                 for name, leaf in layer.items()} for layer in cache]

    # ---- activation constraints ---------------------------------------------
    def constrain(self, x, kind: str):
        """Place activation ``x`` as the reference's table says for
        ``kind`` (``DTensor.redistribute``; differentiable).  A plain
        tensor, or a kind or rank the table lacks, comes back as it is."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        f, t = self.fsdp, self.tp
        seq = t if self.seq_shard_activations else None
        table = {
            "hidden": P(f, seq, None),
            "heads": P(f, None, t, None),
            "heads_v": P(f, None, t, None),
            "logits": P(f, None, t),
            # expert activations: E over model when divisible; D over the
            # FSDP axes so expert-weight contractions reduce activations
            # instead of all-gathering the weights
            "expert_in": P(t, None, f) if self._ep_ok_cached(x) else
                         P(None, None, t),
            "mamba_inner": P(f, None, t),
            "moe_chunks": P(None, f, None),   # (n_chunks, Tc, D)
            "moe_tokens": P(f, None),         # (T, D)
            # decode (single-token) residual stream: shard D over the FSDP
            # axes so weight contractions reduce tiny activations instead
            # of all-gathering weight shards every step
            "hidden_decode": P(None, None, f),
        }
        spec = table.get(kind)
        if spec is None or len(spec) != x.ndim:
            return x
        placements = self.named(self.fit(spec, tuple(x.shape)))
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(x.device_mesh, placements)

    def _ep_ok_cached(self, x) -> bool:
        return x.shape[0] % self.tp_size == 0

    def named(self, spec: P):
        """The DTensor placements of ``spec`` on the plan's mesh: one a
        mesh dim, ``Shard(d)`` on each mesh dim that tensor dim ``d``'s
        entry names (a tuple of axes shards ``d`` on each of them, in
        mesh-dim order: the major-to-minor order the tuple means),
        ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        names = _names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            axes = _entry_axes(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"{spec}: the axes of dim {d} must follow "
                                 f"the mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return out

    # ---- SNP partition planning ---------------------------------------------
    def neuron_axis(self, *, encoding: str = "ell",
                    hub_threshold: Optional[int] = None,
                    partition: str = "contiguous") -> SystemPlan:
        """Neuron-axis :class:`~repro_torch.core.plan.SystemPlan` sized to
        this plan's mesh: every device of it (the model axis too: SNP
        exploration is pure data parallelism) holds one neuron shard."""
        size = self.mesh.size if isinstance(self.mesh, AbstractMesh) \
            else self.mesh.size()
        return neuron_axis(int(size), encoding=encoding,
                           hub_threshold=hub_threshold, partition=partition)

    # ---- SNP trace serving --------------------------------------------------
    def trace_mesh(self) -> List[torch.device]:
        """The devices of the plan's mesh flattened onto one ``traces``
        axis (:func:`trace_mesh`): a CUDA mesh's ranks as the cards they
        run on, a CPU mesh's as the CPU.  Needs a concrete mesh."""
        if isinstance(self.mesh, AbstractMesh):
            raise ValueError("an abstract mesh has no devices")
        ranks = self.mesh.mesh.reshape(-1).tolist()
        if self.mesh.device_type == "cuda":
            n = torch.cuda.device_count()
            return trace_mesh([torch.device("cuda", r % n) for r in ranks])
        return trace_mesh([torch.device(self.mesh.device_type)] * len(ranks))


def make_plan(mesh, **opts) -> ShardingPlan:
    """The plan of ``mesh`` (a ``DeviceMesh`` or :class:`AbstractMesh`):
    FSDP over ``("pod", "data")`` when the mesh has ``pod``, else
    ``("data",)``; TP over ``model``."""
    names = _names(mesh)
    if "pod" in names:
        fsdp: Tuple[str, ...] = ("pod", "data")
    else:
        fsdp = ("data",)
    return ShardingPlan(mesh=mesh, fsdp=fsdp, tp="model", **opts)


def neuron_axis(num_shards: int, *, encoding: str = "ell",
                hub_threshold: Optional[int] = None,
                partition: str = "contiguous") -> SystemPlan:
    """A :class:`~repro_torch.core.plan.SystemPlan` that partitions the
    neuron axis over ``num_shards`` shards: the plan
    :func:`~repro_torch.core.distributed.explore_distributed` takes for
    its neuron-sharded frontier.  ``encoding="hybrid"`` with
    ``num_shards > 1`` is refused at compile time (the shards are ELL);
    ``partition="degree"`` spreads hubs across shards
    (:func:`~repro_torch.core.plan.partition_neurons`)."""
    return SystemPlan(encoding=encoding, hub_threshold=hub_threshold,
                      num_shards=num_shards, partition=partition)


def trace_mesh(devices=None) -> List[torch.device]:
    """The one-axis serving mesh of
    :func:`~repro_torch.core.distributed.run_traces_distributed`: every
    visible card (``cuda:0 .. cuda:N-1``), or the given devices, a nested
    sequence flattened in order, as the reference flattens every axis of
    its mesh onto one ``traces`` axis (trace serving is pure data
    parallelism).  Without ``devices`` and without a card it raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass the devices (e.g. "
                "['cpu']) to build a trace mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    flat = np.empty(np.shape(devices), dtype=object)
    flat[...] = devices
    mesh = [torch.device(d) for d in flat.reshape(-1)]
    if not mesh:
        raise ValueError("a trace mesh needs at least one device")
    return mesh
