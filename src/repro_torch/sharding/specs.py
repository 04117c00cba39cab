"""The port of ``repro.sharding.specs``' SNP plans: :func:`neuron_axis`
and :func:`trace_mesh` (the reference's ``ShardingPlan.neuron_axis`` and
``ShardingPlan.trace_mesh``).  (The reference module's ``ShardingPlan``
and ``make_plan`` serve the LM substrate, ROADMAP item 9.)"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.plan import SystemPlan

__all__ = ["neuron_axis", "trace_mesh"]


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
