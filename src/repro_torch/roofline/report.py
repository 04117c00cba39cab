"""Render the dry run's tables from a results directory (the port of the
JAX package's ``roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report \
        experiments/dryrun_torch
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

__all__ = ["load", "dryrun_table", "roofline_table", "grid_table", "main"]


def load(dirpath: str) -> List[Dict]:
    out = []
    for f in sorted(os.listdir(dirpath)):
        if f.endswith(".json") and f != "summary.json":
            with open(os.path.join(dirpath, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def dryrun_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | mesh | params | per-chip args | temp | "
           "collectives (AR/AG/RS/A2A/CP) | replication | run |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        cc = r.get("collective_counts", {})
        coll = "/".join(str(cc.get(k, 0)) for k in
                        ("all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute"))
        mem = r.get("memory", {})
        rep = r.get("replication")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('param_count', 0) / 1e9:.2f}B | "
            f"{fmt_bytes(mem.get('argument_bytes'))} | "
            f"{fmt_bytes(mem.get('temp_bytes'))} | {coll} | "
            f"{'-' if rep is None else f'{rep:.2f}'} | "
            f"{r.get("run_seconds", 0):.0f}s |")
    return "\n".join(out)


def roofline_table(rows: List[Dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
           "bound | MODEL/counted flops | what would move the bound |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r["shape"] == "explore_step":
            continue
        frac = r.get("useful_flops_frac")
        frac_s = f"{frac:.2f}" if frac else "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['bound']}** | {frac_s} | {_hint(r)} |")
    return "\n".join(out)


def grid_table(rows: List[Dict], mesh: str = "16x16") -> str:
    """One row an arch, one column a shape: the bound's first letter, its
    term in seconds, and the replication (``×``)."""
    shapes = sorted({r["shape"] for r in rows if r["mesh"] == mesh})
    grid: Dict[str, Dict[str, str]] = {}
    for r in rows:
        if r["mesh"] == mesh:
            t = r[f"{r['bound']}_s"]
            grid.setdefault(r["arch"], {})[r["shape"]] = (
                f"{r['bound'][0]} {t:.3g} ×{r.get('replication', 0):.2f}")
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]
    for arch, cells in sorted(grid.items()):
        out.append(f"| {arch} | " + " | ".join(
            cells.get(sh, "-") for sh in shapes) + " |")
    return "\n".join(out)


def _hint(r: Dict) -> str:
    b = r["bound"]
    if b == "memory":
        return ("fuse/remat less, shard activations (SP), bf16 "
                "intermediates")
    if b == "collective":
        return ("overlap collectives w/ compute, int8 grad compression, "
                "reduce resharding, keep the model axis inside a node")
    return "larger per-card tiles, higher tensor-core utilization"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "experiments/dryrun_torch"
    rows = load(d)
    for mesh in ("16x16", "2x16x16"):
        print(f"## Bound, its term (s) and replication, {mesh}\n")
        print(grid_table(rows, mesh) + "\n")
    print("\n## Dry-run records\n")
    print(dryrun_table(rows))
    print("\n## Roofline (single pod, 16x16 = 256 cards)\n")
    print(roofline_table(rows, "16x16"))
    print("\n## Roofline (multi-pod, 2x16x16 = 512 cards)\n")
    print(roofline_table(rows, "2x16x16"))


if __name__ == "__main__":
    main()
