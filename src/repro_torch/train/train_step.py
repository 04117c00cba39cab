"""The train step, the port of the JAX package's
``repro.train.train_step``: microbatched gradient accumulation, the
remat policy, f32 gradients, optional int8 gradient compression, AdamW.

``make_train_step(...)`` returns ``train_step(state, batch) -> (state,
metrics)``.  The gradients come from ``loss.backward()`` on the port's
model, cast to f32; with ``microbatches = k`` the batch is split into k
slices along its batch axis (M-RoPE positions ``(3, B, S)`` along their
second), each slice's gradients are summed in f32 and the sum divided by
k, and the loss and statistics averaged, as the reference's
``lax.scan`` does.  The update writes the parameters and the optimizer's
moments in place (:mod:`.optimizer`; weight decay by each parameter's
dims in the reference's stacked layout, as the reference decays); the
metrics are 0-dim tensors on the parameters' device, read by the caller
when it wants them.

A state's checkpoint holds :func:`train_state_tree`, the reference's
layout, so either package restores the other's (:func:`restore_train_state`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..checkpoint import restore_checkpoint
from ..configs.base import ArchConfig
from ..models.convert import (params_tree, reference_ndims,
                              train_state_from_jax)
from ..models.layers import _identity
from ..sharding.placement import meshed, replicated, unsharded
from ..models.model import loss_fn

from .compression import compress_grads, ef_init
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "train_state_tree", "restore_train_state"]


class TrainState(NamedTuple):
    params: nn.Module               # the LM, updated in place
    opt: AdamWState
    ef: Optional[List[torch.Tensor]]   # error-feedback residual
    step: torch.Tensor              # int32, 0-dim


def init_train_state(params: nn.Module, opt_cfg: AdamWConfig,
                     compression: bool = False) -> TrainState:
    dev = next(params.parameters()).device
    return TrainState(
        params=params, opt=adamw_init(params),
        ef=ef_init(params) if compression else None,
        step=torch.zeros((), dtype=torch.int32, device=dev))


def _split_microbatches(batch: Dict, k: int) -> List[Dict]:
    """(B, ...) -> k dicts of (B/k, ...) slices; positions with a leading
    plane dim (3, B, S) split along their batch axis.  A DTensor's batch
    dim is gathered whole first (a slice need not divide over the data
    axes; the plan's constraints shard each microbatch again)."""

    def split(name, x):
        if name == "positions" and x.dim() == 3 and x.shape[0] == 3:
            x = unsharded(x, 1)
            return x.reshape(3, k, x.shape[1] // k,
                             *x.shape[2:]).movedim(1, 0)
        x = unsharded(x, 0)
        return x.reshape(k, x.shape[0] // k, *x.shape[1:])

    parts = {name: split(name, x) for name, x in batch.items()}
    return [{name: x[i] for name, x in parts.items()} for i in range(k)]


def _f32_grads(ps: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's gradient in f32 (zeros where none reached it),
    the ``.grad`` fields cleared."""
    out = []
    for p in ps:
        out.append(torch.zeros_like(p, dtype=torch.float32)
                   if p.grad is None else p.grad.float())
        p.grad = None
    return out


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    remat: str = "full",
    attn_impl: str = "ref",
    constrain: Callable = _identity,
    compression: bool = False,
    aux_loss_weight: float = 0.01,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``:
    ``metrics`` holds ``loss``, ``ce``, ``load_balance_loss``,
    ``drop_frac``, ``grad_norm`` and ``lr``.  ``attn_impl`` is the port's
    name of the attention: ``"cuda"`` (kernel B8, whose backward is the
    plain attention's, recomputed; on a CPU tensor its plain version),
    ``"ref"`` (the plain attention) or ``"chunked"``."""

    def loss(params, mb):
        l, metrics = loss_fn(params, cfg, mb, attn_impl=attn_impl,
                             constrain=constrain, remat=remat,
                             aux_loss_weight=aux_loss_weight)
        l.backward()
        # on a mesh a loss can be a partial sum: the metrics read whole
        return replicated(l.detach()), {k: replicated(v.detach())
                                        for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict):
        # on a mesh: the plain tensors the step makes join as replicated
        with meshed(state.params.embed):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Dict):
        params = state.params
        ps = list(params.parameters())
        for p in ps:
            p.grad = None
        if microbatches == 1:
            l, metrics = loss(params, batch)
            grads = _f32_grads(ps)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            lsum = torch.zeros((), device=ps[0].device)
            ms = []
            for mb in _split_microbatches(batch, microbatches):
                lm, m = loss(params, mb)
                grads = [a + b for a, b in zip(grads, _f32_grads(ps))]
                lsum = lsum + lm
                ms.append(m)
            grads = [g / microbatches for g in grads]
            l = lsum / microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        ef = state.ef
        if compression:
            grads, ef = compress_grads(grads, ef)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state.opt, params,
            ndims=reference_ndims(params))
        metrics = {**metrics, **opt_metrics, "loss": l}
        return TrainState(new_params, new_opt, ef, state.step + 1), metrics

    return train_step


def train_state_tree(state: TrainState, cfg: ArchConfig) -> TrainState:
    """``state`` in the reference's layout on the host: the parameters,
    moments and residual as :func:`~repro_torch.models.params_tree` gives
    them (f32), the count and step as int32 scalars.  What the port's
    checkpoints hold."""
    names = [n for n, _ in state.params.named_parameters()]

    def tree(ts):
        return params_tree(ts, cfg, names=names)

    return TrainState(
        params=params_tree(state.params, cfg),
        opt=AdamWState(tree(state.opt.m), tree(state.opt.v),
                       state.opt.count.detach().cpu()),
        ef=None if state.ef is None else tree(state.ef),
        step=state.step.detach().cpu())


def restore_train_state(directory: str, like: TrainState, cfg: ArchConfig,
                        *, step: Optional[int] = None, device=None,
                        plan=None) -> Tuple[TrainState, int]:
    """The checkpoint at ``step`` (the latest if None) of ``directory``,
    written by either package, as a new state shaped like ``like`` on
    ``device`` (``None``: the card); with ``plan``, placed on its mesh by
    ``plan.param_specs`` whatever mesh wrote it (every rank reads the
    checkpoint).  Returns (state, step)."""
    tree, s, _ = restore_checkpoint(directory, _template(like, cfg),
                                    step=step)
    return train_state_from_jax(tree, cfg, device=device, plan=plan), s


def _template(state: TrainState, cfg: ArchConfig) -> TrainState:
    """The layout of :func:`train_state_tree` without gathering: each
    leaf a zero host tensor of its global shape (a restore's template)."""
    names = [n for n, _ in state.params.named_parameters()]

    def zeros(ts):
        return params_tree([torch.zeros(t.shape) for t in ts], cfg,
                           names=names)

    return TrainState(
        params=zeros(list(state.params.parameters())),
        opt=AdamWState(zeros(state.opt.m), zeros(state.opt.v),
                       torch.zeros((), dtype=torch.int32)),
        ef=None if state.ef is None else zeros(state.ef),
        step=torch.zeros((), dtype=torch.int32))
