#!/usr/bin/env python3
"""Time kernels B2 and B4 on the card at their main-path waves, from any
checkout of this repository, so that two trees can be compared in one
call on one card.

    python3 probes/step_device_times.py [--tree DIR] [--label NAME]

on one NVIDIA GPU.  ``--tree`` names the checkout whose ``src/`` is
imported and whose CUDA sources are built (into its own git-ignored
build directory); by default this one.  The waves (B=512, T=64, inputs
drawn from fixed seeds):

* B2 at ``scaled_pi(682)`` (m = 2,046) and at ``ring_lattice(32768, 8,
  seed=2)`` (m = 32,768): the phase-6 and phase-15 explores' waves;
* B4 at ``with_delays(scaled_pi(682), k % 3)`` (3m-wide rows): the
  phase-10 explore's wave.

Each launch goes through the tree's own launcher with the inputs its
wrapper gives it on a CUDA tensor (``sparse_ref.kernel_inputs(...,
lists=True)``; ``ops.delay_inputs``, with ``lists=True`` where the tree
takes it), is held against the tree's plain version bit for bit, and is
timed by CUDA events (the launcher's host time included) and by
``torch.profiler`` (the kernel's own device time, filtered by name), a
mean over 20 launches after a warm-up.  The last line is one JSON object
of the times, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _waves(dev):
    """(kernel, wave, kernel name to filter by, launch, plain) for each
    wave; ``launch`` and ``plain`` take no argument."""
    import numpy as np
    import torch
    from repro_torch.core import (compile_system, compile_system_sparse,
                                  with_delays)
    from repro_torch.core.generators import ring_lattice, scaled_pi
    from repro_torch.kernels.snp_step import ops, sparse_ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_delay_ref
    from repro_torch.kernels.snp_step.sparse_ref import (kernel_inputs,
                                                         snp_step_sparse_ref)

    rng = np.random.default_rng(21)
    B, T = 512, 64

    def rand(m, hi):
        return torch.from_numpy(rng.integers(0, hi, size=(B, m)).astype(
            np.int32)).to(dev)

    for wave, system, hi in (("scaled_pi(682)", scaled_pi(682), 3),
                             ("ring_lattice(32768,8)",
                              ring_lattice(32768, 8, seed=2), 4)):
        comp = compile_system_sparse(system, device=dev)
        configs = rand(comp.num_neurons, hi)
        kargs, kextra, _ = kernel_inputs(configs, comp, lists=True)
        pargs, pextra, _ = kernel_inputs(configs, comp)
        yield ("B2", wave, "snp_step_sparse",
               lambda kargs=kargs, kextra=kextra:
               sparse_ops.snp_step_sparse_cuda(*kargs, **kextra,
                                               max_branches=T),
               lambda pargs=pargs, pextra=pextra:
               snp_step_sparse_ref(*pargs, **pextra, max_branches=T))
        del comp, configs

    system = with_delays(scaled_pi(682), lambda k, r: k % 3)
    comp = compile_system(system, semantics="delays", device=dev)
    m = comp.num_neurons
    states = torch.from_numpy(np.concatenate(
        [rng.integers(0, 3, (B, m)), rng.integers(0, 4, (B, m)),
         rng.integers(0, 3, (B, m))], 1).astype(np.int32)).to(dev)
    lists = "lists" in inspect.signature(ops.delay_inputs).parameters
    kargs, _ = ops.delay_inputs(states, comp,
                                **({"lists": True} if lists else {}))
    pargs, _ = ops.delay_inputs(states, comp)
    yield ("B4", "delayed scaled_pi(682)", "snp_step_dense_delay",
           lambda: ops.snp_step_dense_delay(*kargs, T),
           lambda: snp_step_dense_delay_ref(*pargs, T))


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
    import torch
    if not torch.cuda.is_available():
        print("step_device_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.snp_step import _build, ops, sparse_ops
    if not Path(sparse_ops.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {sparse_ops.__file__}, not from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build_all([sparse_ops.SOURCE, ops.DELAY_SOURCE])
    label = a.label or tree.name
    rows = {}
    for kernel, wave, name, launch, plain in _waves(torch.device("cuda")):
        got, want = launch(), plain()
        torch.cuda.synchronize()
        cs.check(all(torch.equal(x, y) for x, y in zip(got, want)),
                 f"{label}: {kernel} at {wave} differs from its plain "
                 "version")
        del got, want
        ev = cs.time_ms(launch, 20)
        dv = cs.device_ms(launch, 20, name)
        rows[f"{kernel} {wave}"] = dict(events_ms=ev, device_ms=dv)
        cs.log(f"[probe {label}] {kernel} at {wave}: kernel == plain; "
               f"CUDA events {ev:.4f} ms, on the card {dv:.4f} ms")
        torch.cuda.empty_cache()
    print(json.dumps({"tree": label, "card": card, "times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
