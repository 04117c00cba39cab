"""The explore driver's run end to end (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` has to come
out false for each fault an explore cell can have.  At a small size on
the CPU; a step that leaves out half its batch also at the cells' own
sizes on the card.  One card and no exchange between chips: that fault
does not apply."""

import time

import pytest
import torch

from snpb import manifest as mf
from snpb.cell import Cell, make_cell, result_line

SMALL = {
    "powerlaw8192": ({"m": 64, "attach": 4, "rules_per_neuron": 2,
                      "max_spikes": 3, "seed": 2, "max_in": None}, 8),
}


def small_cell(workload: str, trace: bool = False, seconds: float = 0.3):
    """The cell's own files, its system and caps shrunk."""
    from snpb import systems
    m = mf.Manifest()
    w = m.workload(workload)
    cfg, trf = m.config(w["config"]), m.traffic(w["traffic"])
    params, hub = SMALL[w["config"]]
    cfg["params"] = params
    cfg["program"]["plan"]["hub_threshold"] = hub
    s = systems.build(cfg)
    cfg["sizes"] = {"num_neurons": s.num_neurons, "num_rules": s.num_rules,
                    "num_synapses": s.num_synapses,
                    "row_width": s.num_neurons}
    trf.update(frontier_cap=32, max_branches=16, max_steps=10,
               visited_cap=4096 if trf["dedup"] == "hash" else 512)
    return Cell(workload, cfg, trf, seed=2 ** 31 + 17, seconds=seconds,
                trace=trace, device="cpu", t_start=time.perf_counter(),
                per_layer=[x["name"] for x in m.per_layer(workload)],
                log=lambda *a: None), m


def run(cell):
    return mf.driver(cell.traffic["driver"]).run(cell)


CELLS = [w["name"] for w in mf.Manifest().data["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    cell, m = small_cell(workload)
    out = run(cell)
    line = result_line(m, cell, out, {"platform": "cpu"})
    assert line["correct"] and out.attempted >= 1 and out.failed == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"configs_per_s", "peak_mem_gb",
                                    "setup_s"}


def test_a_traced_run_reports_per_layer_metrics_only():
    cell, m = small_cell(CELLS[0], trace=True)
    out = run(cell)
    line = result_line(m, cell, out, {"platform": "cpu"})
    assert line["correct"]
    # the CPU has no device trace: only the host-clock metric is there
    assert set(line["metrics"]) == {"level_mfu"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _backend(cell):
    from repro_torch.core import get_backend
    return get_backend(cell.config["program"]["backend"])


def _unchanged(real):
    """A step whose successors are its configurations, unchanged."""
    def expand(configs, comp, T):
        out = real(configs, comp, T)
        return out._replace(configs=configs[:, None, :].expand_as(
            out.configs).contiguous())
    return expand


def _half_batch(first: bool):
    """A step that leaves out one half of its batch of ``F`` frontier
    rows: their successors are all invalid."""
    def wrap(real):
        def expand(configs, comp, T):
            out = real(configs, comp, T)
            half = torch.arange(configs.shape[0], device=configs.device) \
                < configs.shape[0] // 2
            return out._replace(valid=out.valid & (~half if first
                                                   else half)[:, None])
        return expand
    return wrap


FAULTS = {"unchanged": _unchanged, "first_half": _half_batch(True),
          "second_half": _half_batch(False)}


def _break_step(cell, fault, monkeypatch):
    cls = type(_backend(cell))    # a frozen dataclass: patch its class
    real = cls.expand
    wrap = FAULTS[fault]
    monkeypatch.setattr(cls, "expand", lambda self, c, comp, T: wrap(
        lambda *a: real(self, *a))(c, comp, T))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    cell, m = small_cell(workload)
    _break_step(cell, fault, monkeypatch)
    out = run(cell)
    assert not result_line(m, cell, out, {"platform": "cpu"})["correct"]
    assert out.failed >= 1


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_step_leaving_out_its_second_half_is_not_correct_at_the_cells_size(
        workload, card, monkeypatch):
    """At the cell's own system, ``F``, ``T`` and ``V``, one turn of its
    kinds: the kind whose levels' new candidates stay near ``F`` sees
    the rows that the second half's successors would have added."""
    m = mf.Manifest()
    cell, _ = make_cell(m, workload, seed=2 ** 31 + 4242, seconds=0.0,
                        trace=False, device=card)
    cell.log = print
    _break_step(cell, "second_half", monkeypatch)
    out = run(cell)
    print(workload, out.checks)
    assert not result_line(m, cell, out, {"platform": "gpu"})["correct"]
    checks = {k: v for k, v, _ in out.checks}
    assert checks["rows_differing.core"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_row_is_not_correct(workload, monkeypatch):
    import repro_torch.core.engine as engine
    real = engine.host_copy

    def altered(x):
        y = real(x).clone()
        y[y.shape[0] // 2, 0] += 1
        return y

    monkeypatch.setattr(engine, "host_copy", altered)
    cell, m = small_cell(workload)
    out = run(cell)
    checks = {k: v for k, v, _ in out.checks}
    assert checks["rows_differing.spread"] == 1
    assert checks["rows_differing.core"] == 1
    assert not result_line(m, cell, out, {"platform": "cpu"})["correct"]
