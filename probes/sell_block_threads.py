#!/usr/bin/env python3
"""Time the kernels that walk sliced in-lists at 256 and at 1024 threads
a block, at the waves where the thread rule of ``csrc/sliced_lists.cuh``
(shared by both sources) makes its choice: the sparse source's B2 (the
ELL body) at the ``scaled_pi(682)`` and ``ring_lattice(32768, 8)``
waves, B5's ELL body at the delayed ``scaled_pi(682)`` wave and B7
(shard 0) at the 4-shard ``scaled_pi(682)`` waves, contiguous and
degree, and at the ``ring_lattice(32768, 8)`` wave; the dense delayed
source's B4 at the delayed ``scaled_pi(682)`` wave (B=512, T=64, the
smoke's inputs; B2's drawn here from a fixed seed).

    python3 probes/sell_block_threads.py

on one NVIDIA GPU, from the root of a checkout (it reuses the helpers
of ``chip_smoke.py`` that make the waves).  Each launch passes the
thread count at run time (the wrappers' ``threads=``, the library's
``nt``), at the library's rows; the probe checks that both shapes give
the rule's outputs bit for bit and times them in turns (256, 1024, 1024,
256): the kernel's own device time from ``torch.profiler``, a mean over
20 launches after a warm-up each, so that the launcher's host time does
not hide the kernel at the small waves.  The last line is one JSON
object of the times, with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SPARSE_KERNEL = "snp_step_sparse_sell_kernel"
DELAY_KERNEL = "snp_step_dense_delay_sell_kernel"


def _waves(dev):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import compile_system, compile_system_sparse
    from repro_torch.core.generators import ring_lattice, scaled_pi
    from repro_torch.kernels.snp_step import ops, sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import kernel_inputs
    from repro_torch.sharding import neuron_axis

    rng = np.random.default_rng(3)
    for label, system, hi in (("scaled_pi(682) wave", scaled_pi(682), 3),
                              ("ring_lattice(32768,8) wave",
                               ring_lattice(32768, 8, seed=2), 4)):
        comp = compile_system_sparse(system, device=dev)
        configs = torch.from_numpy(rng.integers(
            0, hi, size=(512, comp.num_neurons)).astype(np.int32)).to(dev)
        kargs, kextra, _ = kernel_inputs(configs, comp, lists=True)
        yield ("B2 " + label, "sparse", comp.num_neurons, 0, 64,
               lambda nt=None, kargs=kargs, kextra=kextra:
               sparse_ops.snp_step_sparse_cuda(*kargs, **kextra,
                                               max_branches=64, threads=nt))
        del comp, configs
    for name, system, _, B, T, make in cs._delay_cases(rng, dev):
        if name == "scaled_pi(682) delayed wave":
            states = make(system.num_neurons)
            comp = compile_system_sparse(system, semantics="delays",
                                         device=dev)
            kargs, kextra, _ = kernel_inputs(states, comp, lists=True)
            yield ("B5-ELL " + name, "sparse", comp.num_neurons, 0, T,
                   lambda nt=None: sparse_ops.snp_step_sparse_cuda(
                       *kargs, **kextra, max_branches=T, threads=nt))
            dense = compile_system(system, semantics="delays", device=dev)
            dargs, _ = ops.delay_inputs(states, dense, lists=True)
            yield ("B4 " + name, "delay", dense.num_neurons, 0, T,
                   lambda nt=None: ops.snp_step_dense_delay(*dargs, T,
                                                            threads=nt))

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
        yield ("B7 " + label, "sparse", comp.shard_size, h7.shape[-1], 64,
               lambda nt=None, a7=a7, h7=h7, sell=sh.sell:
               sparse_ops.snp_step_sparse_cuda(*a7[:5], *sell, a7[6],
                                               halo=h7, max_branches=64,
                                               threads=nt))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.snp_step import ops, sparse_ops

    if not torch.cuda.is_available():
        print("sell_block_threads: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.phase_card_and_build()
    shape = {"sparse": (SPARSE_KERNEL, sparse_ops.sell_block_shape),
             "delay": (DELAY_KERNEL,
                       lambda m, H, T: ops.delay_block_shape(m, T))}
    dev = torch.device("cuda")
    rows = {}
    for name, which, m, H, T, fn in _waves(dev):
        kernel, block = shape[which]
        want = fn()
        chosen = block(m, H, T)
        times = {256: [], 1024: []}
        for nt in (256, 1024, 1024, 256):
            got = fn(nt)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"{name}: {nt} threads differ from the rule's outputs")
            times[nt].append(cs.device_ms(lambda: fn(nt), 20, kernel))
        rows[name] = dict(m=m, H=H, chosen=list(chosen),
                          ms_256=times[256], ms_1024=times[1024])
        cs.log(f"[probe] {name}: m={m} H={H}, the library's block "
               f"{chosen[0]} rows x {chosen[1]} threads | on the card, 256 "
               f"threads {times[256]} ms, 1024 threads {times[1024]} ms "
               f"(turns 256, 1024, 1024, 256)")
        del want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "sell_threads": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
