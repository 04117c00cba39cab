#!/usr/bin/env python3
"""Smoke phases 25 and 26 alone on the card: the kernels' build (phase
1), every LM family's reduced sibling on the card's (1, 1) plan (phase
25) and the roofline of SmolLM-360M's prefill, decode and train steps
under the step counter, with one dry-run cell in a subprocess (phase
26).  A quick check of those phases without the smoke's other 24.

    python3 probes/family_roofline_phase.py
"""

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import traceback
    card = chip_smoke.phase_card_and_build()
    failed = []
    with tempfile.TemporaryDirectory(prefix="dryrun_") as d:
        dry = chip_smoke._start_dryrun_cell(d)
        try:
            # each phase runs whether or not the other failed
            for name, run in (
                    ("25", chip_smoke.phase_meshed_families),
                    ("26", lambda: chip_smoke.phase_roofline(dry, card))):
                try:
                    run()
                except Exception:
                    traceback.print_exc()
                    failed.append(name)
        finally:
            if dry[0].poll() is None:
                dry[0].kill()
                dry[0].wait()
    print("family_roofline_phase: " + (f"FAILED {failed}" if failed
                                        else "ok"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
