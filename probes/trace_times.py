#!/usr/bin/env python3
"""Time the batched trace path on the card, from any checkout of this
repository, so that two trees can be compared in one call on one card.

    python3 probes/trace_times.py [--tree DIR] [--label NAME]

on one NVIDIA GPU.  ``--tree`` names the checkout whose ``src/`` is
imported and whose dense step source is built (into its own git-ignored
build directory); by default this one.  The workload is the trace
service's chunk: ``run_traces(scaled_pi(682), steps=64,
seeds=range(256))`` through ``"cuda"`` (B1), pre-compiled, with:

* ``policy="first"`` and ``policy="random"``: host-clock milliseconds
  around a synchronised call, 3 runs each after a warm-up, and the
  card's busy time for one random call (``torch.profiler``, every device
  event), whose share of the call's wall time says how far the host holds
  the card back;
* the random branch draws alone: 64 rounds of ``prng.split`` and
  ``prng.randint`` on 256 keys, as the trace loop draws them;
* where the tree has the trace service, one synchronous
  ``SNPTraceService`` drain of the same 256 requests, split into the
  submits, the runner's own call and the rest; and the host copy of one
  call's four outputs, which each flush makes.

The random traces are held against ``"ref"`` bit for bit.  The last line
is one JSON object of the times, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS, B, RUNS = 64, 256, 3


def _wall_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/ is imported (default: this "
                         "one)")
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    import chip_smoke as cs       # its helpers; it puts ROOT/src on the path
    tree = Path(a.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("trace_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import compile_system, prng, run_traces
    from repro_torch.core.generators import scaled_pi
    from repro_torch.kernels.snp_step import ops
    if not Path(ops.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {ops.__file__}, not from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    label = a.label or tree.name
    dev = torch.device("cuda")
    comp = compile_system(scaled_pi(682), device=dev)
    seeds = np.arange(B)

    def traces(policy, backend="cuda"):
        return run_traces(comp, steps=STEPS, seeds=seeds, policy=policy,
                          backend=backend, device=dev)

    got, want = traces("random"), traces("random", "ref")
    cs.check(all(torch.equal(x, y) for x, y in zip(got, want)),
             f"{label}: random traces differ between 'cuda' and 'ref'")
    del got, want
    rows = {}
    for policy in ("first", "random"):
        traces(policy)
        rows[f"run_traces {policy} ms"] = [
            _wall_ms(lambda p=policy: traces(p)) for _ in range(RUNS)]
    busy = cs.device_ms(lambda: traces("random"), 1)
    rows["run_traces random device busy ms"] = busy

    keys = prng.PRNGKey(torch.from_numpy(seeds.astype(np.int64)).to(dev))
    n_valid = torch.full((B,), 64, dtype=torch.int64, device=dev)

    def draws():
        k = keys
        for _ in range(STEPS):
            k, subs = prng.split(k)
            prng.randint(subs, n_valid)

    draws()
    rows["draws ms"] = [_wall_ms(draws) for _ in range(RUNS)]
    try:
        from repro_torch.serve import SNPTraceService, TraceRequest
    except ImportError:
        SNPTraceService = None
    if SNPTraceService is not None:
        inner = []

        def runner(comp, **kw):
            t0 = time.perf_counter()
            out = run_traces(comp, **kw)    # synchronises on the card
            inner.append((time.perf_counter() - t0) * 1e3)
            return out

        svc = SNPTraceService(batch_size=B, device=dev, runner=runner)
        reqs = [TraceRequest(comp, steps=STEPS, policy="random", seed=s)
                for s in range(B)]
        submits = []

        def drain():
            t0 = time.perf_counter()
            for r in reqs:
                svc.submit(r)
            submits.append((time.perf_counter() - t0) * 1e3)
            svc.drain()

        drain()
        inner.clear()
        submits.clear()
        rows["service drain ms"] = [_wall_ms(drain) for _ in range(RUNS)]
        rows["service submits ms"] = list(submits)
        rows["service runner ms"] = list(inner)
        out = traces("random")
        rows["host copy ms"] = [_wall_ms(lambda: [x.cpu().numpy()
                                                  for x in out])
                                for _ in range(RUNS)]
    for k, v in rows.items():
        cs.log(f"[probe {label}] {k}: "
               + (", ".join(f"{x:.3f}" for x in v) if isinstance(v, list)
                  else f"{v:.3f}"))
    print(json.dumps({"tree": label, "card": card, "times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
