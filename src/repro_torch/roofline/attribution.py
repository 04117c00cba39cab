"""Per-op byte/FLOP attribution of a counted step, the port of the JAX
package's ``roofline/attribution.py`` (which walks the compiled HLO):
the counter's records grouped by (op, shape), so a roofline term's
largest tensors show.

    with StepCounter() as c:
        step(state, batch)
    print(top_table(attribute_bytes(c), unit=1e9, label="GB"))
"""

from __future__ import annotations

import collections
from typing import Counter

from .counter import StepCounter

__all__ = ["attribute_bytes", "attribute_flops", "top_table"]


def _attribute(counter: StepCounter, field: str) -> Counter:
    agg: Counter = collections.Counter()
    for (op, shape, dtype), rec in counter.records.items():
        v = getattr(rec, field)
        if v:
            agg[(op, f"{dtype}[{shape}]"[:48])] += v
    return agg


def attribute_bytes(counter: StepCounter) -> Counter:
    return _attribute(counter, "bytes")


def attribute_flops(counter: StepCounter) -> Counter:
    return _attribute(counter, "flops")


def top_table(agg: Counter, n: int = 15, unit: float = 1e12,
              label: str = "TB") -> str:
    total = sum(agg.values())
    lines = [f"total = {total / unit:.2f} {label}"]
    for (op, sh), v in agg.most_common(n):
        lines.append(f"  {v / unit:8.2f} {label} "
                     f"{100 * v / max(total, 1e-30):5.1f}%  {op:22s} {sh}")
    return "\n".join(lines)
