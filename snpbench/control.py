#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place
with its dedup key cut from 64 bits to 32 and trusted unconfirmed, as a
program that halved its visited set's keys would (the nearest lower
precision of a 64-bit key), compared with the exact reference by the same
comparison the runs use.

    python3 snpbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--key-bits 32] [--device cuda]

explores, for each seed, the first explore of each kind of initial
configuration in a run of that seed (the traffic's ``inits``, in turn) at
the cell's own sizes, twice (exact, then the control), and prints one
line of the compared numbers a seed, then one JSON object of them.  It is not
part of a benchmark run; ``snpbench/tests/test_snpbench_control.py`` runs
it at a small size on the CPU, and on the card at the cells' sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from snpb import compare, systems  # noqa: E402
from snpb.reference import Reference  # noqa: E402


def as_program(res) -> SimpleNamespace:
    """A reference result in the shape of the program's (host rows)."""
    return SimpleNamespace(configs=res.configs.cpu().numpy(),
                           num_discovered=res.num_discovered,
                           steps=res.steps,
                           branch_overflow=res.branch_overflow,
                           frontier_overflow=res.frontier_overflow,
                           visited_overflow=res.visited_overflow)


def control_checks(config: dict, traffic: dict, seed: int, device: str,
                   key_bits: int = 32):
    """The control's compared numbers for the first explore of each kind
    in a run of ``seed``: ``[(name, value, limit)]``, named as a run
    names them."""
    system = systems.build(config)
    caps = dict(frontier_cap=traffic["frontier_cap"],
                max_branches=traffic["max_branches"],
                visited_cap=traffic["visited_cap"],
                max_steps=traffic["max_steps"])
    out = []
    for index, spec in enumerate(traffic["inits"]):
        init = systems.draw_init(config, spec, system, seed, index)
        exact = Reference(system, device).explore(init, **caps)
        low = Reference(system, device, key_bits=key_bits,
                        verify=False).explore(init, **caps)
        out += [(f"{name}.{spec['name']}", v, lim) for name, v, lim
                in compare.compare(as_program(low), exact)]
        del exact, low
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--key-bits", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from snpb.manifest import Manifest
    m = Manifest()
    w = m.workload(args.workload)
    config, traffic = m.config(w["config"]), m.traffic(w["traffic"])
    out = {}
    for seed in args.seeds:
        t = time.perf_counter()
        checks = control_checks(config, traffic, seed, args.device,
                                args.key_bits)
        out[str(seed)] = {k: v for k, v, _ in checks}
        print(f"{args.workload} seed {seed} key_bits {args.key_bits}: "
              + ", ".join(f"{k} {v}" for k, v, _ in checks)
              + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload,
                      "key_bits": args.key_bits, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
