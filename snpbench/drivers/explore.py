"""The explore driver: full-width BFS explores back to back, one caller.

Set-up (counted in ``setup_s``, from the process's start): the system
built by its family's frozen generator, handed to the port and lowered
once under the configuration's pinned backend and plan, then one short
explore at the traffic's own ``F``, ``T``, ``V`` (:data:`WARMUP_LEVELS`
levels: the kernels' libraries load, or build on a checkout's first run,
the allocator and the level loop's graph capture warm up).

The window: a closed loop of ``repro_torch.core.explore`` calls, the
traffic's kinds of initial configuration (``inits``) in turn, each
explore's configuration drawn from ``(seed, index)``, each returning its
archive on the host.  It holds every explore that started while the
clock was under ``--seconds``, completed to a whole turn of the kinds
(one turn at least), and ends when the last returns; ``configs_per_s`` is all their archived
rows over all that time.  With ``--trace 1`` the first explores run under
a profiler session each (:data:`TRACE_EVENTS`), and the per-layer metrics
read their spans.

The check: one explore of each kind, drawn from the seed by reservoir
sampling, is explored again by the plain reference (after the window,
with the program's state freed and the memory peak read) and compared
(:mod:`snpb.compare`); each compared number carries its kind's name.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from snpb import compare, systems
from snpb.cell import Outcome
from snpb.manifest import reader
from snpb.program import Program
from snpb.reference import Reference
from snpb.trace import Explore, TraceContext, collect


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sizes(system: systems.PlainSystem, config: dict) -> dict:
    """The system's sizes, which must be the configuration file's."""
    sizes = {"num_neurons": system.num_neurons,
             "num_rules": system.num_rules,
             "num_synapses": system.num_synapses}
    stated = {k: config["sizes"][k] for k in sizes}
    if stated != sizes:
        raise ValueError(f"the generator built {sizes}, the configuration "
                         f"states {stated}")
    return sizes


# With --trace 1 the window's first explores are traced, each in a profiler
# session of its own, until the sessions hold this many events; the rest
# run untraced.  A process whose sessions record some 350,000 device
# events of the level loop's graphs stops getting kernel records and then
# loses the card to an illegal address (NVIDIA H100, torch 2.11, CUDA 12.8).
TRACE_EVENTS = 150_000

# Levels of the set-up's explore: enough to capture the level loop once.
WARMUP_LEVELS = 2


def _profiler(on: bool, device: str):
    if not on:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def run(cell) -> Outcome:
    cfg, trf, dev = cell.config, cell.traffic, cell.device
    system = systems.build(cfg)
    sizes = _sizes(system, cfg)
    prog = Program(system, cfg, dev)
    prog.explore(trf, system.init, max_steps=WARMUP_LEVELS)
    _sync(dev)
    setup_s = time.perf_counter() - cell.t_start
    cell.log(f"[snpbench] {cell.name}: set-up {setup_s:.3f} s")

    kinds = trf["inits"]

    def init_of(i):
        return systems.draw_init(cfg, kinds[i % len(kinds)], system,
                                 cell.seed, i)

    picks = [np.random.default_rng(np.random.SeedSequence(
        [cell.seed % (1 << 64), 1 << 32, k])) for k in range(len(kinds))]
    kept, meta, traced, events = [None] * len(kinds), [], [], 0
    t0 = time.perf_counter()
    while (not meta or len(meta) % len(kinds)
           or time.perf_counter() - t0 < cell.seconds):
        i = len(meta)
        k, turn = i % len(kinds), i // len(kinds)
        on = cell.trace and events < TRACE_EVENTS
        with _profiler(on, dev) as prof:
            with _span("snpbench.explore", on):
                res = prog.explore(trf, init_of(i))
        meta.append((res.steps, res.num_discovered))
        if on:
            traced.append((prof, meta[-1]))
            events += len(prof.profiler.kineto_results.events())
        cell.log(f"[snpbench] explore {i} ({kinds[k]['name']}): "
                 f"{res.steps} levels, {res.num_discovered} rows, at "
                 f"{time.perf_counter() - t0:.3f} s")
        if picks[k].integers(0, turn + 1) == 0:
            kept[k] = (i, res)
        del res
    window_s = time.perf_counter() - t0
    rows = sum(r for _, r in meta)
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0
    cell.log(f"[snpbench] {cell.name}: {len(meta)} explores, {rows} rows "
             f"in {window_s:.3f} s; levels {sorted({s for s, _ in meta})}, "
             f"rows per explore {sorted({r for _, r in meta})}")

    out = Outcome(
        end_to_end={"configs_per_s": rows / window_s,
                    "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        per_layer={}, checks=[], attempted=len(meta), failed=0,
        memory_peak_bytes=int(peak))
    if cell.trace:
        _read_trace(cell, traced, sizes, out)
    del prog, traced
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    reference = Reference(system, dev)
    for k, (index, res) in enumerate(kept):
        t = time.perf_counter()
        ref = reference.explore(
            init_of(index), frontier_cap=trf["frontier_cap"],
            max_branches=trf["max_branches"],
            visited_cap=trf["visited_cap"], max_steps=trf["max_steps"])
        checks = compare.compare(res, ref)
        kept[k] = None
        del res, ref
        out.checks += [(f"{name}.{kinds[k]['name']}", v, lim)
                       for name, v, lim in checks]
        out.failed += 0 if compare.passed(checks) else 1
        cell.log(f"[snpbench] {cell.name}: reference of explore {index} "
                 f"in {time.perf_counter() - t:.3f} s")
    return out


def _read_trace(cell, traced, sizes, out) -> None:
    """The per-layer metrics from the traced explores' sessions."""
    t = time.perf_counter()
    ref = traced[0][0].profiler.kineto_results.trace_start_ns()
    device, host, explores = [], [], []
    for prof, (steps, rows) in traced:
        d, h = collect(prof, ref)
        span = next(x for x in h if x.name == "snpbench.explore")
        device += [x for x in d if span.start <= x.start < span.end]
        host += [x for x in h if x.end > span.start and x.start < span.end]
        explores.append(Explore(span.start, span.end, steps, rows))
    ctx = TraceContext(device=device, host=host, explores=explores,
                       sizes=sizes, traffic=cell.traffic)
    for name in cell.per_layer:
        v = reader(name).read(ctx)
        if v is not None:
            out.per_layer[name] = float(v)
    out.busy_s = ctx.busy_us() / 1e6
    out.window_s = ctx.window_us / 1e6
    out.breakdown = ctx.breakdown()
    launches = sum(1 for d in ctx.device if ctx.group_of(d.name) == "step")
    cell.log(f"[snpbench] {cell.name}: {len(traced)} explores traced, "
             f"{len(device)} device and {len(host)} host events read in "
             f"{time.perf_counter() - t:.3f} s; {launches} step-kernel "
             f"events for {ctx.levels} levels; "
             + ", ".join(f"{k} {v}" for k, v in out.per_layer.items()))
