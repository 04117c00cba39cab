"""Roofline analysis of eager steps at H100 rates (the port of the JAX
package's ``repro.roofline``): :mod:`.counter` counts a step's per-device
FLOPs, bytes and collectives as it runs, :mod:`.analysis` turns them into
the three terms, :mod:`.attribution` and :mod:`.report` tabulate them."""

from .analysis import (HW, CollectiveStats, analyze_step, collective_stats,
                       roofline_terms)
from .counter import StepCounter

__all__ = ["HW", "CollectiveStats", "analyze_step", "collective_stats",
           "roofline_terms", "StepCounter"]
