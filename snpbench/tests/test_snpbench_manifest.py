"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found where the harness looks for it."""

import json
import re
from pathlib import Path

import pytest

from snpb import manifest as mf

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in DATA["workloads"]]


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["snpbench"]
    cmd = DATA["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert all((ROOT / w).is_file() for w in cmd if "/" in w)
    assert all(w.startswith("snpbench/") for w in cmd if "/" in w)
    assert isinstance(DATA["run_seconds"], int)
    assert 1 <= DATA["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [x["name"] for x in DATA[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_are_unique_across_kinds():
    names = [x["name"] for k in ("end_to_end", "per_layer")
             for x in DATA[k]]
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(DATA["configs"]) <= 24
    used = {w["config"] for w in DATA["workloads"]}
    files = set()
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used, f"{c['name']} keeps no cell"
        # a public paper or page, or the upstream's own document and the
        # part of it that defines the deployment
        assert c["source"].startswith("https://") or \
            (ROOT / c["source"].split()[0].rstrip(",;:")).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("snpbench/configs/")
        assert (ROOT / c["file"]).is_file()
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []
    assert len(files) == len(DATA["configs"])


def test_workloads():
    assert 1 <= len(DATA["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in DATA["configs"]}
    four = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert four <= max(1, len(DATA["workloads"]) // 4)
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()


@pytest.mark.parametrize("traffic", sorted(
    p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_inits_are_named_draws(traffic):
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    names = [x["name"] for x in t["inits"]]
    assert names and len(names) == len(set(names))
    assert all(NAME.match(n) and "kind" in x and LINE.match(x["why"])
               for n, x in zip(names, t["inits"]))


def test_end_to_end_metrics():
    names = {m["name"] for m in DATA["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in DATA["end_to_end"]:
        # every cell reports every end-to-end metric
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in DATA["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["per_layer"]])
def test_per_layer_metric(metric):
    m = next(x for x in DATA["per_layer"] if x["name"] == metric)
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and LINE.match(m["layer"])
    assert m["moves"] in {x["name"] for x in DATA["end_to_end"]}
    assert all(cell in CELLS for cell in m.get("workloads", CELLS))
    assert (BENCH / "metrics" / f"{metric}.py").is_file()
    assert callable(mf.reader(metric).read)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    m = mf.Manifest()
    e2e = [x["name"] for x in m.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert m.per_layer(cell)


def test_kernel_group_files_load():
    from snpb.trace import load_groups
    groups = load_groups()
    assert {"step", "dedup"} <= set(groups)
    assert all(p.name.count(".") >= 2 for p in (BENCH / "layers").iterdir())


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_manifest_is_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
