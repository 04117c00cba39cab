#!/usr/bin/env python3
"""H2's first occurrence at the full-width wave, two checkouts in turns on
one NVIDIA GPU.

    python3 probes/h2_pairs.py --parent DIR

``DIR`` is another checkout of this repository (such as the parent
commit, unpacked by ``git archive`` into a git-ignored directory).  This
process makes the inputs once with this checkout, then times each
checkout in a process of its own in the order parent, this, this, parent;
each builds its own ``csrc/hashtable.cu`` into its own git-ignored build
directory.  Two inputs, K = 32,768 keys each into ``table_slots(K)`` =
65,536 slots at 64 probes:

* ``real``: the ``scaled_pi(682)`` wave's candidate block (the last 512
  archived states of the full-width explore, F = 512, T = 64, V =
  262,144, expanded through B1, hashed, canonical under their mask);
* ``synthetic``: the phase-21 synthetic wave of ``chip_smoke.py`` (seed
  21: half the keys drawn from 100,000 held ones, a quarter fresh, a
  quarter repeats, 90% valid), the input H2's earlier figures were taken
  on.

For each checkout and input, device milliseconds of one call (20 calls
captured in a CUDA graph, its replay timed by CUDA events):
``first_occurrence`` as the BFS level calls it (its fills and scratch
included), ``claim_`` into an empty table refilled before each call,
less the refill (the grid route in both checkouts: the earlier figures'
method), the refill alone, and where the checkout has it ``first_claim``
(a table of the kernel's own; its route by ``claim_route``); and the
first-occurrence flags' digest, equal across checkouts.  The last line is
one JSON object of the figures, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FULL_WIDTH = dict(max_steps=8, frontier_cap=512, max_branches=64,
                  visited_cap=262144)
D = 64


def time_ms(fn, iters):
    """Mean milliseconds a call by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def replay_ms(fn, reps=20, iters=10):
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in a
    CUDA graph, its replay timed by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin()
        for _ in range(reps):
            fn()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    ms = time_ms(g.replay, iters) / reps
    g.reset()
    return ms


def make_inputs(path):
    """Both inputs, as CPU tensors, saved to ``path``."""
    import numpy as np
    import torch
    from repro_torch.core import compile_system, explore, get_backend
    from repro_torch.core.generators import scaled_pi
    from repro_torch.core.hashtable import _canonical
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.snp_step import _build, ops

    _build.build_all([ops.SOURCE, ht_ops.SOURCE])
    comp = compile_system(scaled_pi(682), device="cuda")
    res = explore(comp, backend="cuda", **FULL_WIDTH)
    frontier = torch.from_numpy(res.configs[-512:]).to("cuda")
    out = get_backend("cuda").expand(frontier, comp, 64)
    valid = out.valid.reshape(-1)
    hi, lo = _canonical(*ht_ops.config_hash(
        out.configs.reshape(valid.shape[0], -1)), valid)
    cases = {"real": (hi.cpu(), lo.cpu(), valid.cpu())}
    # chip_smoke.py's phase-21 synthetic wave, draw for draw
    rng = np.random.default_rng(21)
    n = 100_000
    keys = rng.integers(0, 2**32, size=(2, n), dtype=np.uint64)
    keys = keys.astype(np.int64)
    K = FULL_WIDTH["frontier_cap"] * FULL_WIDTH["max_branches"]
    fresh = rng.integers(0, 2**32, size=(2, K // 4), dtype=np.uint64)
    pick = rng.integers(0, n, size=K // 2)
    wave = np.concatenate([keys[:, pick], fresh.astype(np.int64)], 1)
    wave = np.concatenate([wave, wave[:, rng.integers(0, wave.shape[1],
                                                      size=K // 4)]], 1)
    wave = np.ascontiguousarray(wave[:, rng.permutation(K)])
    valid = torch.from_numpy(rng.random(K) < 0.9)
    cases["synthetic"] = (torch.from_numpy(wave[0]),
                          torch.from_numpy(wave[1]), valid)
    torch.save(cases, path)


def time_tree(path):
    """This process's checkout (first on ``sys.path``) on both inputs."""
    import torch
    from repro_torch.core.hashtable import (_canonical, _empty,
                                            first_occurrence, table_slots)
    from repro_torch.kernels.hashtable import ops as ht_ops

    dev = torch.device("cuda")
    out = {}
    for name, xs in torch.load(path).items():
        hi, lo, valid = (x.to(dev) for x in xs)
        hi, lo = (x.contiguous() for x in _canonical(hi, lo, valid))
        K = hi.shape[0]
        S = table_slots(K)
        zero = torch.zeros(K, dtype=torch.int32, device=dev)
        sc = _empty(S, 0, dev)

        def refill():
            sc[0].fill_(0xFFFFFFFF)
            sc[1].fill_(0xFFFFFFFF)
            sc[2].zero_()

        first, ovf = first_occurrence(hi, lo, valid)
        fill = replay_ms(refill)
        rec = dict(
            K=K, slots=S, valid=int(valid.sum()), first=int(first.sum()),
            overflow=bool(ovf),
            digest=hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest(),
            first_occurrence_ms=replay_ms(
                lambda: first_occurrence(hi, lo, valid)),
            first_occurrence_event_ms=time_ms(
                lambda: first_occurrence(hi, lo, valid), 50),
            fill_ms=fill,
            claim_into_empty_ms=replay_ms(lambda: (refill(), ht_ops.claim_(
                *sc, hi, lo, valid, zero, D))) - fill)
        if hasattr(ht_ops, "first_claim"):
            rec["first_claim_route"] = list(
                ht_ops.claim_route(K, S, D, True))
            rec["first_claim_ms"] = replay_ms(
                lambda: ht_ops.first_claim(hi, lo, valid, S, D))
        out[name] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        sys.path.insert(0, str(Path(args.time).resolve() / "src"))
        print(json.dumps(time_tree(args.inputs)))
        return 0
    if not args.parent:
        ap.error("--parent DIR is required")
    sys.path.insert(0, str(ROOT / "src"))
    trees = {"parent": Path(args.parent).resolve(), "this": ROOT}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        make_inputs(path)
        for label in ("parent", "this", "this", "parent"):
            proc = subprocess.run(
                [sys.executable, __file__, "--time", str(trees[label]),
                 "--inputs", path], capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
                return proc.returncode
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(dict(tree=label, cases=rec))
            for name, r in rec.items():
                print(f"{label} {name}: " + ", ".join(
                    f"{k} {v}" for k, v in r.items() if k != "digest"),
                    flush=True)
    same = all(r["cases"][c]["digest"] == runs[0]["cases"][c]["digest"]
               for r in runs for c in runs[0]["cases"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "flags_equal": same, "runs": runs}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
