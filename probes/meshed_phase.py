#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 24 (the meshed launchers) alone, on one
NVIDIA GPU: the kernels' build (phase 1), then phase 23's main path cut to
the 5 steps phase 24 compares with (``train`` on one device, the same
seed, batches and schedule), then phase 24 whole: ``serve_lm`` and
``train()`` on the mesh for the one card at SmolLM-360M's full width and
depth, the f32 twin, the drill through a fresh process.

    python3 probes/meshed_phase.py [--parts serve train twin drill]

Prints the card's name and power limit first; the phases print their own
lines; the last line is one JSON object of phase 24's figures and B8's
launches by path.  About two minutes after the build.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


PARTS = ("serve", "train", "twin", "drill")


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS,
                    help="phase 24's parts to run (default: all, i.e. the "
                         "phase; a subset runs them alone)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("meshed_phase: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    chip_smoke.phase_card_and_build()
    main_path = None
    if "train" in args.parts:
        chip_smoke.TRAIN["steps"] = chip_smoke.MESHED["steps"]
        _, main_path = chip_smoke._train_main_path()
    launches, figures = chip_smoke.phase_meshed({"main_path": main_path},
                                                parts=args.parts)
    print(json.dumps({"card": smi, "launches": launches,
                      "figures": figures, "main_path": main_path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
