#!/usr/bin/env python3
"""Device milliseconds a BFS level of the four full-width explores, from
any checkout of this repository, so that two trees can be compared in one
call on one card.

    python3 probes/level_device_times.py [--tree DIR] [--label NAME]

on one NVIDIA GPU.  ``--tree`` names the checkout whose ``src/`` is
imported and whose CUDA sources are built (into its own git-ignored build
directory); by default this one.  The explores are ``chip_smoke.py``'s
main paths at full width (F = 512, T = 64, V = 262,144; the delayed
hybrid at V = 65,536, which the engine dedups by sorting):
``scaled_pi(682)`` through ``"cuda"`` (B1), the hybrid
``power_law(8192, 4, seed=2)`` through ``"sparse_cuda"`` (B3), and both
with delays ``k % 3`` (B4, B5's COO body).  Each runs once to warm up,
then once under ``torch.profiler``: the device time of every kernel over
the run, divided by its levels (the run's set-up, such as the archive's
zero fill, included; also without the run's one copy of its archive to
the host), the leading kernels by name, and the wall time a level.  The
last line is one JSON object of the figures, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _profiled(run):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:70]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return res, wall, by


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core import (SystemPlan, compile_system,
                                  compile_system_sparse, explore,
                                  with_delays)
    from repro_torch.core.generators import power_law, scaled_pi

    full = dict(max_steps=8, frontier_cap=512, max_branches=64,
                visited_cap=262144)
    k3 = (lambda k, r: k % 3)
    hubby = power_law(8192, 4, seed=2)
    hplan = SystemPlan.for_system(hubby)
    dhub = with_delays(hubby, k3)
    dplan = SystemPlan.for_system(dhub, semantics="delays")
    runs = [
        ("scaled_pi(682) B1", lambda: compile_system(scaled_pi(682),
                                                     device="cuda"),
         "cuda", full),
        ("power_law(8192) hybrid B3", lambda: compile_system_sparse(
            hubby, hub_threshold=hplan.hub_threshold, device="cuda"),
         "sparse_cuda", full),
        ("scaled_pi(682) delayed B4", lambda: compile_system(
            with_delays(scaled_pi(682), k3), semantics="delays",
            device="cuda"), "cuda", full),
        ("power_law(8192) delayed hybrid B5-COO", lambda:
         compile_system_sparse(dhub, hub_threshold=dplan.hub_threshold,
                               semantics="delays", device="cuda"),
         "sparse_cuda", dict(full, visited_cap=65536)),
    ]
    out = {}
    for name, build, backend, caps in runs:
        comp = build()
        res, wall, by = _profiled(
            lambda: explore(comp, backend=backend, **caps))
        levels = res.steps
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        # the run's one device-to-host copy of its archive is not a level's
        copy = sum(v for n, v in by.items() if n.startswith("Memcpy DtoH"))
        out[name] = dict(levels=levels,
                         device_ms_per_level=sum(by.values()) / levels,
                         device_ms_per_level_without_copy_out=(
                             sum(by.values()) - copy) / levels,
                         wall_ms_per_level=wall * 1e3 / levels,
                         archived=res.num_discovered,
                         leading_ms_per_level={n: v / levels
                                               for n, v in top})
        print(f"{args.label or tree.name} {name}: {levels} levels, "
              f"{out[name]['device_ms_per_level']:.3f} device ms a level "
              f"({out[name]['device_ms_per_level_without_copy_out']:.3f} "
              f"without the archive's copy-out), "
              f"{out[name]['wall_ms_per_level']:.3f} wall ms a level; "
              + "; ".join(f"{n} {v / levels:.3f}" for n, v in top),
              flush=True)
        del comp
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": args.label or str(tree), "card": smi,
                      "torch": torch.__version__, "explores": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
