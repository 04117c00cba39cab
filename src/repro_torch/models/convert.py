"""Carry a language model's weights across from the JAX package.

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
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from .model import LM

__all__ = ["params_from_jax"]


def _put(param: torch.Tensor, arr, where: str) -> None:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(a.shape)} does not match "
                         f"the port's {tuple(param.shape)}")
    # f32 holds every bf16 value exactly; the cast back is exact too
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    with torch.no_grad():
        param.copy_(t.to(device=param.device, dtype=param.dtype))


def _leaf(tree: Mapping, path: str):
    """The tree's entry at a dotted parameter name (``moe.shared.wg``)."""
    for part in path.split("."):
        tree = tree[part]
    return tree


def params_from_jax(tree: Mapping, cfg: ArchConfig, *, device=None) -> LM:
    """The port's parameters holding the weights of the reference's tree
    (numpy arrays, f32 or bf16): every family's, the codebook tables
    too.  ``device=None`` is the card."""
    params = LM(None, cfg, resolve_device(device))
    used = 0
    _put(params.embed, tree["embed"], "embed")
    _put(params.ln_f.scale, tree["ln_f"]["scale"], "ln_f/scale")
    used += 2
    if params.head is not None:
        _put(params.head, tree["head"], "head")
        used += 1
    P = len(cfg.layer_pattern)
    for i, block in enumerate(params.blocks):
        period, pos = divmod(i, P)
        for name, param in block.named_parameters():
            where = f"stack/pos{pos}/{name.replace('.', '/')}[{period}]"
            try:
                src = _leaf(tree["stack"][f"pos{pos}"], name)
            except KeyError:
                raise ValueError(f"{where}: not in the tree") from None
            _put(param, np.asarray(src)[period], where)
            used += 1 if period == 0 else 0
    leaves = _count_leaves(tree)
    if used != leaves:
        raise ValueError(f"the tree has {leaves} tensors, the port's "
                         f"{cfg.name} takes {used}")
    return params


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1
