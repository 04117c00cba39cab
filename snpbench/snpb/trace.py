"""From ``torch.profiler`` traces of the window's explores to what the
per-layer metric readers read.

:func:`collect` turns a profiler session's events into device intervals
(kernels, copies, fills) and host intervals on one clock (microseconds
from a reference instant); :class:`TraceContext` holds them with each
explore's host span and result, the kernel groups of
``snpbench/layers/`` and the cell's sizes, and offers the reductions the
readers share.  A reader that finds nothing to read returns ``None``.
"""

from __future__ import annotations

import bisect
import functools
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

LAYERS = Path(__file__).resolve().parent.parent / "layers"
SPAN_PREFIX = "snpbench."


@dataclass(frozen=True)
class Interval:
    name: str
    start: float      # microseconds on the trace's clock
    end: float
    kind: str         # kernel, dtoh, htod, copy, fill; host for host events


@dataclass
class Explore:
    start: float      # host span of the explore call
    end: float
    steps: int
    rows: int


def _kind(name: str) -> str:
    if name.startswith("Memcpy DtoH"):
        return "dtoh"
    if name.startswith("Memcpy HtoD"):
        return "htod"
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def collect(prof, t0: int) -> Tuple[List[Interval], List[Interval]]:
    """``(device, host)`` intervals of a finished profile, each sorted by
    start, in microseconds from ``t0`` (nanoseconds on the profiler's
    clock).  Read from the profiler's raw events (building its event tree
    takes minutes at a window's hundreds of thousands of kernels)."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    dev, host = [], []
    for e in res.events():
        name = e.name()
        s, t = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):   # a span's device shadow
                dev.append(Interval(name, s, t, _kind(name)))
        else:
            host.append(Interval(name, s, t, "host"))
    dev.sort(key=lambda x: x.start)
    host.sort(key=lambda x: x.start)
    return dev, host


def load_groups(folder: Path = LAYERS) -> Dict[str, List[re.Pattern]]:
    """Kernel-name groups: every ``<group>.<part>.json`` holding
    ``{"kernels": [regex, ...]}``, merged by group."""
    groups: Dict[str, List[re.Pattern]] = {}
    for path in sorted(folder.glob("*.json")):
        group = path.name.split(".")[0]
        pats = json.loads(path.read_text())["kernels"]
        groups.setdefault(group, []).extend(re.compile(p) for p in pats)
    return groups


@functools.lru_cache(maxsize=None)
def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:120]


def union(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` pairs sorted by start."""
    out: List[List[float]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceContext:
    """The traced window is the explores' own spans, each traced by a
    profiler session of its own (one session over many explores lost
    the card; the sessions' start and stop between explores are the
    instrumentation's, not the program's)."""
    device: List[Interval]
    host: List[Interval]
    explores: List[Explore]
    sizes: dict                       # num_neurons, num_rules, num_synapses
    traffic: dict
    groups: Dict[str, List[re.Pattern]] = field(default_factory=load_groups)

    def __post_init__(self) -> None:
        self._group_cache: Dict[str, Optional[str]] = {}
        self._starts = [d.start for d in self.device]
        self._spans: Optional[List[Tuple[float, float, Explore]]] = None

    @property
    def spans(self) -> List[Tuple[float, float]]:
        return [(x.start, x.end) for x in self.explores]

    @property
    def window_us(self) -> float:
        return sum(e - s for s, e in self.spans)

    @property
    def levels(self) -> int:
        return sum(x.steps for x in self.explores)

    def group_of(self, name: str) -> Optional[str]:
        if name not in self._group_cache:
            self._group_cache[name] = next(
                (g for g, pats in self.groups.items()
                 if any(p.search(name) for p in pats)), None)
        return self._group_cache[name]

    def between(self, start: float, end: float) -> List[Interval]:
        """Device intervals that start in ``[start, end)``."""
        lo = bisect.bisect_left(self._starts, start)
        hi = bisect.bisect_left(self._starts, end)
        return self.device[lo:hi]

    def loop_spans(self) -> List[Tuple[float, float, Explore]]:
        """Each explore's level loop on the device: from the start of its
        first step kernel to the end of the last kernel or fill before its
        first copy to the host after it (the counts read).  Explores with
        no step kernel in the trace are left out."""
        if self._spans is not None:
            return self._spans
        out = []
        for x in self.explores:
            evs = self.between(x.start, x.end)
            first = next((i for i, d in enumerate(evs)
                          if self.group_of(d.name) == "step"), None)
            if first is None:
                continue
            stop = next((i for i in range(first, len(evs))
                         if evs[i].kind == "dtoh"), len(evs))
            body = [d for d in evs[first:stop] if d.kind in ("kernel",
                                                              "fill")]
            out.append((evs[first].start, max(d.end for d in body), x))
        self._spans = out
        return out

    def loop_events(self) -> List[Interval]:
        """Kernels and fills inside the explores' level loops."""
        out = []
        for s, e, _ in self.loop_spans():
            out += [d for d in self.between(s, e) if d.kind in ("kernel",
                                                                  "fill")]
        return out

    def busy(self) -> List[Tuple[float, float]]:
        """The union of every device interval, clipped to the spans."""
        out = []
        for w0, w1 in self.spans:
            out += union((d.start, min(d.end, w1))
                         for d in self.between(w0, w1))
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest
        idle gaps, each gap named by the host event that overlaps it
        most (the benchmark's own spans aside)."""
        by: Dict[str, float] = {}
        for d in self.device:
            key = short_name(d.name)
            by[key] = by.get(key, 0.0) + (d.end - d.start)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy()
        gaps = []
        for w0, w1 in self.spans:
            inside = [se for se in busy if w0 <= se[0] and se[1] <= w1]
            edges = [w0] + [x for se in inside for x in se] + [w1]
            gaps += [(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        hs = [h.start for h in self.host]
        named = []
        for s, e in gaps:
            best, label = 0.0, "host code outside any profiled op"
            hi = bisect.bisect_left(hs, e)
            for h in self.host[:hi]:
                if h.end <= s or h.name.startswith(SPAN_PREFIX):
                    continue
                ov = min(e, h.end) - max(s, h.start)
                if ov > best:
                    best, label = ov, h.name
            named.append([label, (e - s) / 1e6])
        return {"device_ops": [[n, v / 1e6] for n, v in ops],
                "idle_gaps": named}
