"""Serving steps: LM prefill/decode factories and the SNP trace runner (the
port of the JAX package's ``repro.serve.serve_step``).

``prefill_step`` consumes a (B, S) request batch ((B, C, S) with parallel
codebooks) and returns the last-position logits and the filled caches;
``decode_step`` advances every sequence one token (greedy, or sampled with a threefry key as the
reference samples).  Both run without
autograd.  ``make_trace_runner`` is the SNP counterpart: the device call
of each :class:`~repro_torch.serve.SNPTraceService` flush, the
single-device :func:`~repro_torch.core.engine.run_traces` or, given a
mesh, :func:`~repro_torch.core.distributed.run_traces_distributed` over
its devices.  ``constrain`` is a plan's activation constraint
(:meth:`~repro_torch.sharding.ShardingPlan.constrain`: parameters and
caches that are DTensors on its mesh), the identity without one.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..core import prng
from ..models import forward, init_cache
from ..models.layers import _identity
from ..sharding.placement import meshed, replicated

__all__ = ["make_prefill_step", "make_decode_step", "sample_token",
           "make_trace_runner"]


def make_trace_runner(*, mesh=None) -> Callable:
    """The device call :class:`~repro_torch.serve.SNPTraceService` runs a
    flush: :func:`~repro_torch.core.engine.run_traces` itself when
    ``mesh`` is ``None``, else
    :func:`~repro_torch.core.distributed.run_traces_distributed` over
    ``mesh`` (a sequence of torch devices, e.g.
    :func:`repro_torch.sharding.trace_mesh`), which splits each flush's
    batch over the mesh's ranks and gathers it on ``mesh[0]``.  The two
    give the same traces bit for bit, so a service can be pointed at a
    mesh without its callers seeing a difference."""
    # imported here: the LM entry points load this module without the
    # SNP core
    if mesh is None:
        from ..core.engine import run_traces
        return run_traces
    from ..core.distributed import run_traces_distributed
    return functools.partial(run_traces_distributed, mesh=mesh)


def sample_token(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits (..., V) -> token ids (...,) int32.  temperature 0 = greedy;
    otherwise ``jax.random.categorical(key, logits / temperature)`` as the
    reference draws it (:func:`repro_torch.core.prng.categorical`, a
    threefry ``key``; a token of logit -inf is never drawn)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    # a 0-d divisor on the logits' device: a true division on the card too
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return prng.categorical(key, logits.float() / t).to(torch.int32)


def make_prefill_step(cfg: ArchConfig, *, max_len: int,
                      attn_impl: str = "ref",
                      constrain: Callable = _identity, plan=None):
    """``prefill_step(params, batch) -> (last logits, cache)``; with a
    :class:`~repro_torch.sharding.ShardingPlan` the new cache is laid out
    on its mesh by ``plan.cache_specs`` (the reference leaves the layout
    to its compiler)."""
    @torch.no_grad()
    def prefill_step(params, batch: Dict):
        tokens = batch["tokens"]
        cache = init_cache(cfg, tokens.shape[0], max_len=max_len,
                           device=tokens.device, plan=plan)
        logits, cache, _ = forward(
            params, cfg, batch, cache=cache, mode="prefill",
            attn_impl=attn_impl, constrain=constrain, logits_slice="last")
        return replicated(logits), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, temperature: float = 0.0,
                     constrain: Callable = _identity,
                     activation_stationary: bool = True):
    if activation_stationary:
        base = constrain

        def constrain(t, kind, _base=base):  # noqa: F811
            return _base(t, "hidden_decode" if kind == "hidden" else kind)

    @torch.no_grad()
    def decode_step(params, cache, tokens, positions,
                    key: Optional[torch.Tensor] = None):
        """tokens (B, 1), or (B, C, 1) with codebooks; ``key`` a threefry
        key (for temperature > 0); returns (next_tokens of the tokens'
        shape, logits, cache).  The KV caches' tensors are written in
        place."""
        batch = {"tokens": tokens, "positions": positions}
        logits, cache, _ = forward(
            params, cfg, batch, cache=cache, mode="decode",
            constrain=constrain)
        # on a mesh: the logits whole on every rank, so every rank draws
        # the same token
        logits = replicated(logits)
        last = logits[:, :, -1, :] if cfg.codebooks else logits[:, -1, :]
        with meshed(logits):
            nxt = sample_token(last, key, temperature)
        return nxt[..., None], logits, cache

    return decode_step
