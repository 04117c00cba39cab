"""One run of one cell: the manifest's entries resolved, the traffic's
driver run, and the result line assembled.

A driver (``snpbench/drivers/<driver>.py``) takes a :class:`Cell` and
returns an :class:`Outcome`; this module adds the units, picks the
metrics the manifest lists for the cell (end-to-end ones with
``--trace 0``, per-layer ones with ``--trace 1``) and puts the compared
numbers last.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import manifest as mf


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float                    # the process's start, for setup_s
    per_layer: List[str]              # reader names, for --trace 1
    log: Callable = log


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    per_layer: Dict[str, float]
    checks: List[Tuple[str, int, int]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def make_cell(m: mf.Manifest, workload: str, *, seed: int, seconds: float,
              trace: bool, device: str, t_start: Optional[float] = None
              ) -> Tuple[Cell, str]:
    """The cell and its driver's name."""
    w = m.workload(workload)
    traffic = m.traffic(w["traffic"])
    cell = Cell(workload, m.config(w["config"]), traffic, int(seed),
                float(seconds), bool(trace), device,
                time.perf_counter() if t_start is None else t_start,
                [x["name"] for x in m.per_layer(workload)])
    return cell, traffic["driver"]


def result_line(m: mf.Manifest, cell: Cell, out: Outcome,
                device_info: dict) -> dict:
    """The last line of standard output."""
    spec = m.per_layer(cell.name) if cell.trace else m.end_to_end()
    values = out.per_layer if cell.trace else out.end_to_end
    metrics = {s["name"]: {"value": values[s["name"]], "unit": s["unit"]}
               for s in spec if values.get(s["name"]) is not None}
    device = dict(device_info, memory_peak_bytes=out.memory_peak_bytes)
    if cell.trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
    line = {"correct": all(v <= lim for _, v, lim in out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if cell.trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in out.checks}
    return line
