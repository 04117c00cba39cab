"""Abstract inputs of the dry run: tensors without memory in place of
every model input and state (the port of the JAX package's
``repro.launch.specs``).

The reference's ``ShapeDtypeStruct``s become tensors on the ``meta``
device (the default ``device``): they carry shape, dtype and, given a
:class:`~repro_torch.sharding.ShardingPlan`, DTensor placements, but no
memory, so the 314B- and 398B-parameter trees exist only as metadata.
They are built by the port's own ``init_params``, ``init_train_state``
and ``init_cache`` (weights left unset: ``init_params(None, ...)``), so
the trees are the ones a real run holds.  Meta tensors, not a
``FakeTensorMode``'s: DTensor computes a strided shard's offsets from
an index tensor it makes and reads (``_StridedShard``), which under a
``FakeTensorMode`` has no value, while meta tensors leave DTensor's own
index tensors real.  (Any ``device`` works: ``"cuda"`` under a
``FakeTensorMode`` gives fake tensors of the card.)

``input_specs(cfg, shape)`` is the batch of a shape cell;
``decode_input_specs`` one decode step's; ``abstract_params``,
``abstract_train_state`` and ``abstract_cache`` the parameter,
optimizer and cache trees.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeSpec

__all__ = ["input_specs", "abstract_params", "abstract_train_state",
           "abstract_cache", "decode_input_specs"]


def _place(batch, cfg, plan):
    if plan is None:
        return batch
    from torch.distributed.tensor import distribute_tensor
    specs = plan.batch_specs(cfg, batch)
    # every rank makes the same abstract batch: nothing to scatter
    return {k: distribute_tensor(v, plan.mesh, plan.named(specs[k]),
                                 src_data_rank=None)
            for k, v in batch.items()}


def input_specs(cfg: ArchConfig, spec: ShapeSpec, with_labels: bool = True,
                *, device="meta", plan=None) -> Dict[str, Any]:
    """Training/prefill batch (tokens/positions/labels + frontend
    stubs), placed by ``plan.batch_specs`` when a plan is given."""
    B, S = spec.global_batch, spec.seq_len
    tok_shape = (B, cfg.codebooks, S) if cfg.codebooks else (B, S)

    def t(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    batch = {
        "tokens": t(tok_shape, torch.int32),
        "positions": t((3, B, S) if cfg.mrope_sections else (B, S),
                       torch.int32),
    }
    if with_labels:
        batch["labels"] = t(tok_shape, torch.int32)
    if cfg.frontend != "none" and not cfg.codebooks:
        batch["frontend_embeds"] = t((B, S, cfg.d_model),
                                     getattr(torch, cfg.dtype))
        batch["embed_mask"] = t((B, S), torch.bool)
    return _place(batch, cfg, plan)


def decode_input_specs(cfg: ArchConfig, spec: ShapeSpec, *, device="meta",
                       plan=None) -> Dict[str, Any]:
    """Decode-step batch: one new token against a ``seq_len``-deep
    cache."""
    B = spec.global_batch
    tok_shape = (B, cfg.codebooks, 1) if cfg.codebooks else (B, 1)
    batch = {
        "tokens": torch.zeros(tok_shape, dtype=torch.int32, device=device),
        "positions": torch.zeros(
            (3, B, 1) if cfg.mrope_sections else (B, 1), dtype=torch.int32,
            device=device),
    }
    return _place(batch, cfg, plan)


def abstract_params(cfg: ArchConfig, *, device="meta", plan=None):
    """The parameters (an :class:`~repro_torch.models.LM`), placed by
    ``plan.param_specs`` when a plan is given."""
    from ..models import init_params
    from ..models.convert import place
    params = init_params(None, cfg, device=device)
    return params if plan is None else place(params, cfg, plan)


def abstract_train_state(cfg: ArchConfig, opt_cfg, compression: bool = False,
                         *, device="meta", plan=None):
    """A :class:`~repro_torch.train.TrainState`: the parameters, AdamW's
    f32 moments (placed as their parameters), the count and step."""
    from ..train import init_train_state
    return init_train_state(abstract_params(cfg, device=device, plan=plan),
                            opt_cfg, compression)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                   device="meta", plan=None):
    """One cache a layer, laid out by ``plan.cache_specs`` when a plan is
    given."""
    from ..models import init_cache
    return init_cache(cfg, batch, max_len, device=device, plan=plan)
