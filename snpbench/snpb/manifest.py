"""``BENCHMARK.json`` and the files it names, found by name.

* a workload's configuration: the ``file`` of its ``configs`` entry;
* its traffic mix: ``snpbench/traffic/<traffic>.json``;
* the traffic's driver: ``snpbench/drivers/<driver>.py``, whose
  ``run(cell)`` runs one cell once;
* a per-layer metric: ``snpbench/metrics/<name>.py``, whose ``read(ctx)``
  returns the metric or ``None``;
* kernel groups: ``snpbench/layers/<group>.*.json`` (:mod:`.trace`).

A later PR adds a configuration, a mix, a driver, a metric or a group as
new files and entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def _load(path: Path, what: str):
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "snpb_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, path: Path = MANIFEST) -> None:
        self.data = _load(path, "the benchmark's manifest")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _load(ROOT / c["file"], f"configuration {name}")
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load(BENCH / "traffic" / f"{name}.json", f"traffic {name}")

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics, which every workload reports."""
        return self.data["end_to_end"]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics this workload reports: those listing it,
        and those without a list."""
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload])]


def driver(name: str):
    return _module(BENCH / "drivers" / f"{name}.py", "driver_" + name)


def reader(metric: str):
    return _module(BENCH / "metrics" / f"{metric}.py", "metric_" + metric)
