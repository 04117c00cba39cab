"""Sharding plans of the port: :class:`ShardingPlan` and :func:`make_plan`,
the LM's partition specs and activation constraints over a DTensor mesh
(:mod:`.specs`), :func:`neuron_axis`, the plan of the neuron-sharded
frontier, and :func:`trace_mesh`, the devices of the distributed trace
runner."""

from .specs import (P, AbstractMesh, ShardingPlan, make_plan, neuron_axis,
                    trace_mesh)

__all__ = ["P", "AbstractMesh", "ShardingPlan", "make_plan", "neuron_axis",
           "trace_mesh"]
