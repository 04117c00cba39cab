"""Sharding plans of the port: so far :func:`neuron_axis`, the plan of the
neuron-sharded frontier (:mod:`.specs`)."""

from .specs import neuron_axis

__all__ = ["neuron_axis"]
