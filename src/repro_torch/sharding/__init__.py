"""Sharding plans of the port: :func:`neuron_axis`, the plan of the
neuron-sharded frontier, and :func:`trace_mesh`, the devices of the
distributed trace runner (:mod:`.specs`)."""

from .specs import neuron_axis, trace_mesh

__all__ = ["neuron_axis", "trace_mesh"]
