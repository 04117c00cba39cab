"""Carry a language model's weights and training state across from the JAX
package, and back to its layout.

:func:`params_from_jax` takes the reference's parameter tree (from its
``init_params`` or a checkpoint) as nested dicts of numpy arrays and
returns the port's :class:`~repro_torch.models.model.LM` holding the same
weights, so both packages compute the same function.  The reference
stacks each pattern position's layers along a leading period axis
(``stack/pos0/attn/wq`` is ``(num_periods, d, H, hd)``, a MoE's shared
expert ``stack/pos0/moe/shared/wg``); layer ``l`` of the port is period
``l // P``, position ``l % P`` of a pattern of length ``P``, and its
parameter ``moe.shared.wg`` that path.  The port keeps the reference's
layouts, so no tensor is transposed.

A tree congruent with the parameters (AdamW's moments, the error-feedback
residual, gradients) comes across as a list of tensors in the order of
``LM.parameters()`` (:func:`tensors_from_jax`); :func:`params_tree` goes
the other way, from such a list (or the LM) to the reference's layout,
which is what the port's checkpoints hold (:mod:`repro_torch.train`), so
each package restores the other's.  :func:`train_state_from_jax` carries
a whole reference ``TrainState`` across.

Given a :class:`~repro_torch.sharding.ShardingPlan` (``plan=``), each
tensor comes across as a DTensor on the plan's mesh with the placements
``plan.param_specs`` gives it, the counterpart of the reference's
``jax.device_put(tree, shardings)`` (:func:`place` does it to an LM
already built); :func:`params_tree` gathers such tensors whole
(``full_tensor()``, a collective: every rank calls it).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..sharding import P
from .model import LM

__all__ = ["params_from_jax", "tensors_from_jax", "params_tree",
           "train_state_from_jax", "reference_ndims", "place"]


def _put(param: torch.Tensor, arr, where: str) -> None:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(a.shape)} does not match "
                         f"the port's {tuple(param.shape)}")
    # f32 holds every bf16 value exactly; the cast back is exact too
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    with torch.no_grad():
        param.copy_(t.to(device=param.device, dtype=param.dtype))


def _leaf(tree: Mapping, path: Sequence[str]):
    for part in path:
        tree = tree[part]
    return tree


def _path(name: str, P: int) -> Tuple[List[str], int]:
    """The reference's tree path of the port's parameter ``name`` and its
    period (``-1``: not stacked)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return parts, -1
    period, pos = divmod(int(parts[1]), P)
    return ["stack", f"pos{pos}"] + parts[2:], period


def _arrays(tree: Mapping, cfg: ArchConfig,
            names: Iterable[str]) -> Iterator[Tuple[str, np.ndarray]]:
    """``(where, array)`` for each parameter name in turn, from the
    reference's tree; raises if the tree has tensors the port lacks."""
    P = len(cfg.layer_pattern)
    used = 0
    for name in names:
        path, period = _path(name, P)
        where = "/".join(path) + (f"[{period}]" if period >= 0 else "")
        try:
            src = _leaf(tree, path)
        except (KeyError, TypeError):
            raise ValueError(f"{where}: not in the tree") from None
        used += period <= 0
        yield where, np.asarray(src)[period] if period >= 0 else src
    leaves = _count_leaves(tree)
    if used != leaves:
        raise ValueError(f"the tree has {leaves} tensors, the port's "
                         f"{cfg.name} takes {used}")


def _distribute(t: torch.Tensor, plan, spec) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, plan.mesh, plan.named(spec))


def place(params: LM, cfg: ArchConfig, plan, *,
          replicate: bool = False) -> LM:
    """Replace each parameter of ``params`` (plain tensors, on the mesh's
    device) by a DTensor parameter on ``plan``'s mesh with the placements
    of ``plan.param_specs`` (``replicate``: whole on every rank, as the
    reference's serve launcher leaves its weights); returns ``params``."""
    specs = {n: P() for n, _ in params.named_parameters()} if replicate \
        else plan.param_specs(cfg, params)
    with torch.no_grad():
        for name, p in list(params.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = params.get_submodule(owner) if owner else params
            setattr(module, leaf, torch.nn.Parameter(
                _distribute(p.detach(), plan, specs[name]),
                requires_grad=p.requires_grad))
    return params


def params_from_jax(tree: Mapping, cfg: ArchConfig, *, device=None,
                    plan=None) -> LM:
    """The port's parameters holding the weights of the reference's tree
    (numpy arrays, f32 or bf16): every family's, the codebook tables
    too.  ``device=None`` is the card; with ``plan``, DTensors on its mesh
    (:func:`place`)."""
    params = LM(None, cfg, resolve_device(device))
    named = dict(params.named_parameters())
    for (where, arr), param in zip(list(_arrays(tree, cfg, named)),
                                   named.values()):
        _put(param, arr, where)
    return params if plan is None else place(params, cfg, plan)


def tensors_from_jax(tree: Mapping, cfg: ArchConfig, *, device=None,
                     plan=None) -> List[torch.Tensor]:
    """A tree congruent with the reference's parameters (AdamW's ``m`` or
    ``v``, the error-feedback residual, gradients) as one f32 tensor a
    parameter, in the order of ``LM.parameters()``; with ``plan``, each a
    DTensor placed as its parameter is."""
    dev = resolve_device(device)
    names = [n for n, _ in LM(None, cfg, "meta").named_parameters()]
    out = [torch.from_numpy(np.array(a, np.float32)).to(dev)
           for _, a in _arrays(tree, cfg, names)]
    if plan is None:
        return out
    specs = plan.param_specs(cfg, out, names=names)
    return [_distribute(t, plan, s) for t, s in zip(out, specs)]


def params_tree(params, cfg: ArchConfig, *,
                names: Sequence[str] = None) -> dict:
    """The reference's layout of ``params`` (an :class:`LM`, or a list of
    tensors in the order of its parameters, with their ``names`` or the
    config's): nested dicts of host f32 tensors (copies), each position's
    layers stacked along a leading period axis."""
    if isinstance(params, torch.nn.Module):
        named = list(params.named_parameters())
    else:
        if names is None:
            names = [n for n, _ in LM(None, cfg, "meta").named_parameters()]
        named = list(zip(names, params))
    P = len(cfg.layer_pattern)
    tree: dict = {}
    stacked: dict = {}
    for name, t in named:
        path, period = _path(name, P)
        if hasattr(t, "full_tensor"):         # a DTensor: gather it whole
            t = t.full_tensor()
        # a copy, never a view of the live tensor, which a train step
        # updates in place while a checkpoint writer reads this tree
        host = t.detach().to("cpu", torch.float32, copy=True)
        if period < 0:
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = host
        else:
            stacked.setdefault(tuple(path), []).append((period, host))
    for path, rows in stacked.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.stack([t for _, t in sorted(
            rows, key=lambda r: r[0])])
    return tree


def reference_ndims(params: LM) -> List[int]:
    """Each parameter's dims as the reference holds it, in order: a
    layer's parameters carry the leading period axis there."""
    return [p.dim() + (n.startswith("blocks.")) for n, p in
            params.named_parameters()]


def train_state_from_jax(state, cfg: ArchConfig, *, device=None,
                         plan=None):
    """The port's :class:`~repro_torch.train.TrainState` holding the
    reference's ``TrainState`` (or a checkpoint of one restored into the
    layout :func:`params_tree` gives): the parameters by
    :func:`params_from_jax`, ``opt.m``, ``opt.v`` and ``ef`` (when not
    None) by :func:`tensors_from_jax`, ``opt.count`` and ``step`` as
    int32 scalars.  ``device=None`` is the card; with ``plan``, the
    parameters, moments and residual are DTensors on its mesh, placed by
    ``plan.param_specs`` (the count and step stay plain scalars)."""
    from ..train import AdamWState, TrainState
    dev = resolve_device(device)

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)

    def tensors(tree):
        return tensors_from_jax(tree, cfg, device=dev, plan=plan)

    return TrainState(
        params=params_from_jax(state.params, cfg, device=dev, plan=plan),
        opt=AdamWState(tensors(state.opt.m), tensors(state.opt.v),
                       scalar(state.opt.count)),
        ef=None if state.ef is None else tensors(state.ef),
        step=scalar(state.step))


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1
