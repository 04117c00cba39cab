#!/usr/bin/env python3
"""SmolLM-360M's first training steps at several peak learning rates, on
one NVIDIA GPU, at full width and depth, through the train launcher.

    python3 probes/train_lr.py [--lrs 3e-5 1e-4 3e-4] [--steps 20]
                               [--warmup 5] [--layers N]

For each rate: ``repro_torch.launch.train.main`` (bf16, batch 8 x 2048,
``--remat full``, weights from ``PRNGKey(0)``, cosine after ``--warmup``
steps; each step a fresh ``make_batch``), then the loss of step 1's
batch under the trained weights beside its loss at step 1.  The batches
are the data pipeline's: Zipf ranks under a token permutation drawn anew
for every batch, so which ids are frequent changes from step to step and
what carries across steps is in-context (about 63% of a batch's tokens
are its rank-1 id).  Printed per rate: every step's loss and grad_norm,
the step-1 batch's loss before and after, and the median step ms; the
last line is one JSON object of these figures with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import loss_fn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[3e-5, 1e-4, 3e-4])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_lr: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    cfg = get_config("smollm-360m")
    b = make_batch(cfg, DataConfig(seed=0), step=0, shard=0, batch=8,
                   seq_len=2048)
    first = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    out = {"card": smi, "runs": {}}
    for lr in args.lrs:
        argv = ["--arch", "smollm-360m", "--batch", "8", "--seq", "2048",
                "--steps", str(args.steps), "--remat", "full", "--lr",
                str(lr), "--warmup", str(args.warmup), "--log-every",
                str(args.steps)]
        if args.layers:
            argv += ["--layers", str(args.layers)]
        state, report = train_main(argv)
        run_cfg = cfg if not args.layers else dataclasses.replace(
            cfg, num_layers=args.layers)
        with torch.no_grad():
            after, _ = loss_fn(state.params, run_cfg, first,
                               attn_impl="cuda", remat="none")
        losses = [report["loss"][s] for s in range(1, args.steps + 1)]
        row = dict(losses=losses,
                   grad_norms=[report["grad_norm"][s]
                               for s in range(1, args.steps + 1)],
                   first_batch_before=losses[0],
                   first_batch_after=float(after),
                   median_step_ms=statistics.median(report["step_ms"][1:]))
        out["runs"][str(lr)] = row
        print(f"[train_lr] lr {lr:g} warmup {args.warmup}: losses "
              + " ".join(f"{x:.3f}" for x in losses)
              + f"; step-1 batch {losses[0]:.4f} -> {float(after):.4f}; "
              f"median step {row['median_step_ms']:.1f} ms", flush=True)
        del state
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
