"""The comparison that decides ``correct``: an explore's result against the
reference's, every number beside its limit.

All four are exact comparisons, so every limit is 0:

* ``rows_differing`` — archive positions whose rows differ, plus the
  rows one side has and the other lacks (rows and their order: the step,
  the dedup, the frontier selection and the append order);
* ``discovered_gap`` — ``|num_discovered|`` apart;
* ``steps_gap`` — levels run, apart;
* ``flags_differing`` — of branch, frontier and visited overflow, how
  many differ.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

LIMITS = {"rows_differing": 0, "discovered_gap": 0, "steps_gap": 0,
          "flags_differing": 0}
_BLOCK_ROWS = 4096

Check = Tuple[str, int, int]


def rows_differing(program_rows: np.ndarray, ref_rows: torch.Tensor) -> int:
    n = min(len(program_rows), ref_rows.shape[0])
    if n and program_rows.shape[1] != ref_rows.shape[1]:
        return max(len(program_rows), ref_rows.shape[0])
    diff = abs(len(program_rows) - ref_rows.shape[0])
    for i in range(0, n, _BLOCK_ROWS):
        a = torch.from_numpy(np.ascontiguousarray(
            program_rows[i:i + _BLOCK_ROWS])).to(ref_rows.device)
        diff += int((a != ref_rows[i:i + a.shape[0]]).any(1).sum())
    return diff


def compare(program, ref) -> List[Check]:
    """``[(name, value, limit)]`` of a program result (``ExploreResult``:
    host ``configs``) against a :class:`~.reference.RefResult`."""
    flags = ("branch_overflow", "frontier_overflow", "visited_overflow")
    values = {
        "rows_differing": rows_differing(program.configs, ref.configs),
        "discovered_gap": abs(int(program.num_discovered)
                              - ref.num_discovered),
        "steps_gap": abs(int(program.steps) - ref.steps),
        "flags_differing": sum(bool(getattr(program, f)) != getattr(ref, f)
                               for f in flags),
    }
    return [(k, v, LIMITS[k]) for k, v in values.items()]


def passed(checks: List[Check]) -> bool:
    return all(v <= lim for _, v, lim in checks)
