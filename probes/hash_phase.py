#!/usr/bin/env python3
"""Build the port's kernels and run the hash-table parts of the smoke on
one NVIDIA GPU: a short check of H1's bodies and H2's routes before the
whole smoke.

    python3 probes/hash_phase.py

Runs ``chip_smoke.py``'s phase 1 (the card, every source built), phase 5
(the full-width ``scaled_pi(682)`` explores through ``"cuda"`` and
``"ref"``, the wave's stage split, and H1 and H2 at the wave's candidate
block, bit for bit against their plain versions, with times and bounds),
then phase 21's (b) drained tree, (c) H1 and H2 on forged and synthetic
inputs (every H2 route), the phase-5 explore inside the sync check with
every launch counted by body, and (d) the checkpointed explore.  Exits
non-zero on any failure; about two minutes of command time.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hash_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    try:
        card = cs.phase_card_and_build()
        _, dense = cs.phase_full_width()
        del dense
        cs._drained_tree()
        errs, rows = cs._probe_kernels()
        from repro_torch.core import compile_system, explore
        from repro_torch.core.generators import scaled_pi
        comp = compile_system(scaled_pi(682), device="cuda")
        fig = cs._synced_run(
            "zero_sync_full_width_explore: explore(scaled_pi(682)) via "
            "'cuda'", lambda: explore(comp, backend="cuda",
                                      **cs.FULL_WIDTH),
            {"B1": lambda w: w}, "scaled_pi(682)",
            cs._probe_launches("explore", cs.FULL_WIDTH["frontier_cap"],
                               cs.FULL_WIDTH["max_branches"],
                               cs.FULL_WIDTH["visited_cap"]))
        cs._checkpointed()
    except Exception:
        traceback.print_exc()
        print("hash_phase: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "max_abs_err": errs, "figures": rows,
                      "explore": fig}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
