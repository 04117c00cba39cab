"""AdamW with global-norm clipping and the LR schedules (cosine, WSD,
constant), the port of the JAX package's ``repro.train.optimizer``.

The optimizer state is one f32 first and second moment a parameter, in
the order of ``params.parameters()``, and the step count.  The update
runs under ``torch.no_grad()`` and writes in place: the parameters
(their own dtype), and ``m`` and ``v``; :func:`adamw_update` returns the
same parameters and moment tensors with a new count, so a caller that
wants to keep a state copies it first.  Every number is the reference's:
the update in f32 with the bias corrections in f32, decoupled weight
decay on tensors of two dims or more only, cast back to the parameter's
dtype.  The dims are those of the tensor as the reference holds it
(``ndims``): the reference stacks each layer's parameters along a
leading period axis, so there every layer parameter, norm scales and
biases too, has two dims or more and decays, and only the model's
top-level vectors (``ln_f``) do not; the train step passes
:func:`repro_torch.models.convert.reference_ndims`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch import nn

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "make_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1       # WSD: fraction of steps in final decay


class AdamWState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: torch.Tensor           # int32, 0-dim


Params = Union[nn.Module, Sequence[torch.Tensor]]


def _tensors(params: Params) -> List[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


def adamw_init(params: Params) -> AdamWState:
    ps = _tensors(params)
    zeros = [torch.zeros_like(p, dtype=torch.float32,
                              memory_format=torch.contiguous_format)
             for p in ps]
    return AdamWState(
        m=zeros, v=[torch.zeros_like(z) for z in zeros],
        count=torch.zeros((), dtype=torch.int32, device=ps[0].device))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tensors))


def make_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                 torch.Tensor]:
    """``step -> lr`` (f32): warmup by ``step / warmup_steps``, then the
    schedule's shape."""
    w, total = cfg.warmup_steps, cfg.total_steps

    def cosine(step):
        frac = torch.clamp((step - w) / max(total - w, 1), 0.0, 1.0)
        return 0.5 * (1 + torch.cos(math.pi * frac))

    def wsd(step):
        # warmup -> stable plateau -> short decay tail (MiniCPM)
        decay_steps = max(int(total * cfg.decay_frac), 1)
        start = total - decay_steps
        frac = torch.clamp((step - start) / decay_steps, 0.0, 1.0)
        return torch.where(step < start, 1.0, 1.0 - frac * (1.0 - 0.1))

    def constant(step):
        return torch.ones_like(step, dtype=torch.float32)

    shape_fn = {"cosine": cosine, "wsd": wsd,
                "constant": constant}[cfg.schedule]

    def schedule(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(w, 1), 0.0, 1.0)
        return cfg.lr * warm * shape_fn(step)

    return schedule


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, grads: Sequence[torch.Tensor], state: AdamWState,
    params: Params, *, ndims: Optional[Sequence[int]] = None,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping, in place (module
    docstring).  ``grads`` holds one tensor a parameter, in order;
    ``ndims`` each parameter's dims for the weight-decay rule (default:
    its own).  Returns (params, new_state, {"grad_norm", "lr"})."""
    ps = _tensors(params)
    if ndims is None:
        ndims = [p.dim() for p in ps]
    if not len(grads) == len(ps) == len(state.m) == len(state.v):
        raise ValueError(f"{len(ps)} parameters, {len(grads)} gradients, "
                         f"{len(state.m)}/{len(state.v)} moments")
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = make_schedule(cfg)(count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())
    for g, m, v, p, nd in zip(grads, state.m, state.v, ps, ndims):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if nd >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(state.m, state.v, count), metrics
