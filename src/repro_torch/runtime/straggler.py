"""Straggler detection and mitigation policy (a copy, in the port, of the
JAX package's ``repro.runtime.straggler``, which is numpy only).

On a synchronous mesh a straggling host delays every collective; the
mitigation ladder implemented here (the decision logic; the actuation
hooks belong to the supervisor):

1. detect: per-step durations beyond ``threshold`` x rolling median for
   ``patience`` consecutive steps,
2. mitigate-soft: shrink the straggler's microbatch share (bounded-staleness
   gradient accumulation — returns a rebalanced share map),
3. mitigate-hard: recommend eviction, then a re-mesh and restore.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List

import numpy as np

__all__ = ["StragglerConfig", "StragglerDetector", "rebalance_shares"]


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    window: int = 32          # rolling-median window
    threshold: float = 1.5    # x median counts as straggling
    patience: int = 3         # consecutive slow steps before flagging
    evict_after: int = 10     # flagged steps before recommending eviction


class StragglerDetector:
    def __init__(self, cfg: StragglerConfig, num_hosts: int):
        self.cfg = cfg
        self.history = [deque(maxlen=cfg.window) for _ in range(num_hosts)]
        self.slow_streak = np.zeros(num_hosts, int)
        self.flagged_steps = np.zeros(num_hosts, int)

    def observe(self, host_times: List[float]) -> Dict[str, object]:
        """Feed one step's per-host durations; returns the decision."""
        for h, t in enumerate(host_times):
            self.history[h].append(t)
        med = np.median([t for dq in self.history for t in dq])
        slow = np.array([t > self.cfg.threshold * med for t in host_times])
        self.slow_streak = np.where(slow, self.slow_streak + 1, 0)
        flagged = self.slow_streak >= self.cfg.patience
        self.flagged_steps += flagged.astype(int)
        evict = np.nonzero(self.flagged_steps >= self.cfg.evict_after)[0]
        return {
            "median": float(med),
            "stragglers": np.nonzero(flagged)[0].tolist(),
            "evict": evict.tolist(),
        }


def rebalance_shares(base_microbatches: int, num_hosts: int,
                     stragglers: List[int],
                     slowdown: float = 2.0) -> List[int]:
    """Bounded-staleness share rebalance: stragglers get fewer microbatches,
    fast hosts absorb them; total preserved (gradient stays unbiased under
    re-weighting by actual share)."""
    shares = [base_microbatches] * num_hosts
    if not stragglers or len(stragglers) >= num_hosts:
        return shares
    give = 0
    for h in stragglers:
        reduced = max(1, int(base_microbatches / slowdown))
        give += shares[h] - reduced
        shares[h] = reduced
    fast = [h for h in range(num_hosts) if h not in stragglers]
    for i in range(give):
        shares[fast[i % len(fast)]] += 1
    assert sum(shares) == base_microbatches * num_hosts
    return shares
