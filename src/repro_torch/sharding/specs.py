"""The port of ``repro.sharding.specs.neuron_axis``.  (The reference
module's ``ShardingPlan`` and ``make_plan`` serve the LM substrate,
ROADMAP item 9.)"""

from __future__ import annotations

from typing import Optional

from ..core.plan import SystemPlan

__all__ = ["neuron_axis"]


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
