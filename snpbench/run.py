#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 snpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The cell
is an entry of ``BENCHMARK.json``'s ``workloads``; its configuration,
traffic mix, driver and per-layer metrics are files found by name
(``snpbench/README.md``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last); the last lines of
standard error are the compared numbers beside their limits.  Without a
card, or with a module of JAX or of the JAX package loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"

# Caches live at fixed paths inside the checkout, so only a checkout's
# first run builds; the port builds its kernels into its own
# src/repro_torch/kernels/_build/.
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    from snpb import manifest as mf
    from snpb.cell import log, make_cell, result_line

    m = mf.Manifest()
    chips = m.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[snpbench] this cell needs {chips} CUDA card(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(2)
    cell, driver = make_cell(m, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             device="cuda", t_start=T_START)
    out = mf.driver(driver).run(cell)

    found = forbidden_modules()
    if found:
        log(f"[snpbench] forbidden modules loaded: {', '.join(found)}")
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    line = result_line(m, cell, out, info)
    for name, v, lim in out.checks:
        log(f"check {name} {v} limit {lim}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
