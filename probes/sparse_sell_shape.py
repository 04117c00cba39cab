#!/usr/bin/env python3
"""Time the sparse step's sliced-list kernel at 256 and at 1024 threads a
block, at the waves where the choice is made: B5's ELL body at the delayed
``scaled_pi(682)`` wave and B7 (shard 0) at the 4-shard ``scaled_pi(682)``
waves, contiguous and degree, and at the ``ring_lattice(32768, 8)`` wave
(B=512, T=64, the smoke's inputs).

    python3 probes/sparse_sell_shape.py

on one NVIDIA GPU, from the root of a checkout (it reuses the helpers
of ``chip_smoke.py`` that make the waves).  It builds the source as it
is and two copies whose thread rule is forced to 256 and to 1024 (into
the git-ignored build directory), checks that both copies give the
library's outputs bit for bit, and times them in turns (256, 1024, 1024,
256): the kernel's own device time from ``torch.profiler``, a mean over
20 launches after a warm-up each, so that the launcher's host time does
not hide the kernel at the small waves.  The last line is one JSON
object of the times.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

RULE = "int sell_threads(int m) { return m >= 32 * 32 ? 1024 : 256; }"
KERNEL = "snp_step_sparse_sell_kernel"


def _variants():
    from repro_torch.kernels.snp_step import _build, sparse_ops
    text = sparse_ops.SOURCE.read_text()
    if RULE not in text:
        raise SystemExit("the thread rule of the source has changed")
    out = {}
    for nt in (256, 1024):
        path = _build.BUILD_DIR / "variants" / f"snp_step_sparse_nt{nt}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace(
            RULE, f"int sell_threads(int m) {{ return {nt}; }}"))
        out[nt] = path
    _build.build_all(list(out.values()))
    return out


def _waves(dev):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import compile_system_sparse
    from repro_torch.core.generators import ring_lattice, scaled_pi
    from repro_torch.kernels.snp_step import sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import kernel_inputs
    from repro_torch.sharding import neuron_axis

    rng = np.random.default_rng(3)
    for name, system, _, B, T, make in cs._delay_cases(rng, dev):
        if name == "scaled_pi(682) delayed wave":
            comp = compile_system_sparse(system, semantics="delays",
                                         device=dev)
            kargs, kextra, _ = kernel_inputs(make(system.num_neurons), comp,
                                             lists=True)
            yield ("B5-ELL " + name, comp.num_neurons, 0, T,
                   lambda: sparse_ops.snp_step_sparse_cuda(
                       *kargs, **kextra, max_branches=T))

    def rand(m):
        return torch.from_numpy(rng.integers(0, 3, size=(512, m)).astype(
            np.int32)).to(dev)

    for label, system, plan in (
            ("scaled_pi(682) wave S=4", scaled_pi(682), neuron_axis(4)),
            ("scaled_pi(682) degree wave S=4", scaled_pi(682),
             neuron_axis(4, partition="degree")),
            ("ring_lattice(32768,8) wave S=4", ring_lattice(32768, 8, seed=2),
             neuron_axis(4))):
        comp, shards, frontier, lv = cs._shard_level(system, plan, 512, 64,
                                                     rand, dev, dense=False)
        sh = shards[0]
        a7, h7 = cs._b7_args(sh, frontier[0], lv.infos[0], lv.strides[0],
                             lv.psi, lv.tabs[0], lv.halos[0])
        yield ("B7 " + label, comp.shard_size, h7.shape[-1], 64,
               lambda a7=a7, h7=h7, sell=sh.sell: cs._b7(a7, h7, sell, 64))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.snp_step import sparse_ops

    if not torch.cuda.is_available():
        print("sparse_sell_shape: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_card_and_build()
    variants = _variants()
    library = sparse_ops.SOURCE
    dev = torch.device("cuda")
    rows = {}
    for name, m, H, T, fn in _waves(dev):
        want = fn()
        chosen = sparse_ops.sell_block_shape(m, H, T)
        times = {256: [], 1024: []}
        for nt in (256, 1024, 1024, 256):
            sparse_ops.SOURCE = variants[nt]
            try:
                got = fn()
                torch.cuda.synchronize()
                cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                         f"{name}: the {nt}-thread copy differs")
                times[nt].append(cs.device_ms(fn, 20, KERNEL))
            finally:
                sparse_ops.SOURCE = library
        rows[name] = dict(m=m, H=H, chosen=list(chosen),
                          ms_256=times[256], ms_1024=times[1024])
        cs.log(f"[probe] {name}: m={m} H={H}, the library's block "
               f"{chosen[0]} rows x {chosen[1]} threads | on the card, 256 "
               f"threads {times[256]} ms, 1024 threads {times[1024]} ms "
               f"(turns 256, 1024, 1024, 256)")
        del want
        torch.cuda.empty_cache()
    print(json.dumps({"sell_shape": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
