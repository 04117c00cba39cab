#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result line):

1. card and build — the card's name and power limit, the CUDA kernels
   built from the sources in this checkout (``nvcc``, sm_90a);
2. kernel against its plain version on the card — bit-identical outputs
   on the paper's Π, ``nd_chain(10)`` (Ψ > T), a 2048-neuron random
   system, a ragged shape, spike counts near 2^20 and the full-width
   explore wave; times of the kernel, its plain version and one
   ``torch.matmul`` of a materialised ``S`` with ``M`` (the yardstick,
   timed here only: the port never calls it);
3. the paper's §5 run through the kernel — the allGenCk list and the
   ℕ∖{1} emission-gap result;
4. full width — ``explore(scaled_pi(682))`` (m=2046, n=3410, 512 x 64
   candidates per wave, a 262,144-row archive) through ``"cuda"`` and
   ``"ref"``, archives and flags identical;
5. traces — ``run_traces(scaled_pi(682), steps=64, seeds=range(256))``
   identical through ``"cuda"`` and ``"ref"``;
6. summary — the kernels with their launch counts, then one JSON line of
   per-kernel figures, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every path driven through ``"cuda"`` (the §5 explore, the §5 emission
gaps, the full-width explore, the traces) has the kernel's launch counter
set to 0 just before it and read just after; each count is checked and
reported per path.  The full-width explore is the main path: its count is
the kernels line's ``launches``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the float32 rate outside the tensor cores (the int32/f32 datapath).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The paper's printed allGenCk (§5); it lists '1-0-8' twice.
PAPER_ALLGENCK = """
2-1-1 2-1-2 1-1-2 2-1-3 1-1-3 2-0-2 2-0-1 2-1-4 1-1-4 2-0-3 1-1-1
0-1-2 0-1-1 2-1-5 1-1-5 2-0-4 0-1-3 1-0-2 1-0-1 2-1-6 1-1-6 2-0-5 0-1-4
1-0-3 1-0-0 2-1-7 1-1-7 2-0-6 0-1-5 1-0-4 2-1-8 1-1-8 2-0-7 0-1-6 1-0-5
2-1-9 1-1-9 2-0-8 0-1-7 1-0-6 2-1-10 1-1-10 2-0-9 0-1-8 1-0-7 0-1-9
1-0-8 1-0-8 1-0-9
""".split()

KERNEL = {
    "name": "snp_step_dense",
    "route": "cuda",
    "source": "src/repro_torch/kernels/snp_step/csrc/snp_step_dense.cu",
    "replaces": "src/repro/kernels/snp_step/kernel.py:201",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def time_ms(fn, iters):
    """Mean milliseconds per call, by CUDA events around ``iters`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_card_and_build():
    import torch
    from repro_torch.kernels.snp_step import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"[1] card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on: the plain version's f32 product needs it off")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    ops.load_kernel()
    secs = time.perf_counter() - t0
    log(f"[1] built and loaded {ops.SOURCE.name} in {secs:.2f} s")
    for line in ops.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[1]   {line.strip()}")
    return card


def _step_inputs(comp, configs):
    from repro_torch.core.semantics import branch_info, clamp_stride
    info = branch_info(configs, comp)
    return (configs.contiguous(), info.rank, info.app,
            clamp_stride(info.stride), info.choices, info.psi.contiguous(),
            comp.rule_neuron, comp.M, comp.env_produce), info


def _bound(args, T):
    """Least time for one call (ms), what binds, the operations counted
    and the rules fired, from this call's inputs.  Bytes: each input read once and each output written once,
    over HBM bandwidth.  Operations: what these inputs need, over the
    f32/int32 datapath peak: a digit decode (divide, modulo, compare) per
    neuron and branch, the ``C +`` per output entry, and a multiply-add
    per nonzero of ``M``'s row (and of ``env``) for every rule that fires
    (at most one per neuron; counted from the decoded ``S``), not the
    dense 2·B·T·n·m."""
    import torch
    from repro_torch.core.semantics import decode_spiking
    configs, rank, app, stride, choices, psi, rule_neuron, M, env = args
    B, m = configs.shape
    n = M.shape[0]
    in_bytes = sum(x.numel() * x.element_size() for x in args)
    out_bytes = 4 * B * T * m + 5 * B * T
    S = decode_spiking(app, rank, stride, choices, rule_neuron, T)
    fired = S.sum(dim=(0, 1), dtype=torch.int64)                 # (n,)
    row_nnz = (M != 0).sum(dim=1) + (env != 0)                   # (n,)
    n_ops = 3 * B * T * m + 2 * int((fired * row_nnz).sum())
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (n_ops, int(fired.sum()))


def phase_kernel():
    """Kernel == plain version on the card; returns (max_abs_err, timing
    rows keyed by case name)."""
    import numpy as np
    import torch
    from repro_torch.core import compile_system, next_configs, paper_pi
    from repro_torch.core.generators import nd_chain, random_system, scaled_pi
    from repro_torch.kernels.snp_step import ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_ref

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def rand(B, m, lo, hi):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(B, m)).astype(np.int32)).to(dev)

    cases = [
        ("paper_pi", paper_pi(True), 128, 16, lambda m: rand(128, m, 0, 5)),
        ("nd_chain(10)", nd_chain(10), 16, 64,
         lambda m: torch.ones((16, m), dtype=torch.int32, device=dev)),
        ("random_system(2048)", random_system(2048, 2, 8 / 2048, seed=1),
         64, 32, lambda m: rand(64, m, 0, 4)),
        ("ragged B13 T37", random_system(45, 3, 0.1, seed=5), 13, 37,
         lambda m: rand(13, m, 0, 4)),
        ("spikes~2^20", random_system(64, 2, 0.1, seed=2), 32, 32,
         lambda m: rand(32, m, 2 ** 20 - 8, 2 ** 20 + 8)),
        ("scaled_pi(682) wave", scaled_pi(682), 512, 64,
         lambda m: rand(512, m, 0, 3)),
    ]
    max_err = 0
    rows = {}
    for name, system, B, T, make in cases:
        comp = compile_system(system, device=dev)
        n, m = comp.num_rules, comp.num_neurons
        configs = make(m)
        args, info = _step_inputs(comp, configs)
        k_out, k_valid, k_emis = ops.snp_step_dense(*args, T)
        p_out, p_valid, p_emis = snp_step_dense_ref(*args, T)
        torch.cuda.synchronize()
        err = max(int((k_out - p_out).abs().max()),
                  int((k_emis - p_emis).abs().max()))
        max_err = max(max_err, err)
        check(err == 0 and bool(torch.equal(k_valid, p_valid)),
              f"{name}: kernel disagrees with its plain version "
              f"(max |err| {err})")
        # the wrapper against the reference semantics, on valid entries
        w_out, w_valid, w_emis, w_ovf = ops.snp_step(configs, comp,
                                                     max_branches=T)
        ref = next_configs(configs, comp, T)
        check(torch.equal(w_valid, ref.valid)
              and torch.equal(w_ovf, ref.overflow)
              and torch.equal(torch.where(w_valid[..., None], w_out, 0),
                              torch.where(ref.valid[..., None],
                                          ref.configs, 0))
              and torch.equal(torch.where(w_valid, w_emis, 0),
                              torch.where(ref.valid, ref.emissions, 0)),
              f"{name}: wrapper disagrees with next_configs")
        if name == "nd_chain(10)":
            check(bool(info.psi.min() > T) and bool(w_ovf.all()),
                  "nd_chain(10) should overflow T")

        iters = 5 if B * T * n * m > 1e10 else 50
        k_ms = time_ms(lambda: ops.snp_step_dense(*args, T), iters)
        p_ms = time_ms(lambda: snp_step_dense_ref(*args, T), iters)
        S = ref.spiking.reshape(B * T, n).to(torch.float32)
        Mf = comp.M.to(torch.float32)
        l_ms = time_ms(lambda: torch.matmul(S, Mf), iters)
        b_ms, b_by, b_ops, fired = _bound(args, T)
        rows[name] = dict(B=B, T=T, n=n, m=m, ms=k_ms, plain_ms=p_ms,
                          library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[2] {name:22s} B={B:4d} T={T:3d} n={n:5d} m={m:5d} | "
            f"kernel == plain (max |err| {err}) | kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, matmul(S,M) {l_ms:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}; {fired} fired rules, {b_ops} "
            f"ops needed vs {2 * B * T * n * m} dense) = "
            f"{k_ms / b_ms:.1f}x bound")
        del S, Mf, ref, k_out, p_out, w_out
    return max_err, rows


def phase_paper():
    from repro_torch.core import emission_gaps, explore, paper_pi
    from repro_torch.kernels.snp_step import ops

    launches = {}
    ops.kernel_launches = 0
    res = explore(paper_pi(True), max_steps=16, frontier_cap=128,
                  visited_cap=2048, max_branches=16)
    launches["s5_explore"] = ops.kernel_launches
    check(launches["s5_explore"] == res.steps,
          f"§5 explore: {launches['s5_explore']} kernel launches for "
          f"{res.steps} levels (expected one per level)")
    mine = res.as_strings()
    paper = list(dict.fromkeys(PAPER_ALLGENCK))
    check(mine[:45] == paper[:45], "allGenCk prefix differs from the paper")
    check(set(paper) <= set(mine), "allGenCk misses a paper entry")
    ops.kernel_launches = 0
    gaps = emission_gaps(paper_pi(False), max_time=30, max_gap=14)
    covering = emission_gaps(paper_pi(True), max_time=16, max_gap=8)
    launches["s5_emission_gaps"] = ops.kernel_launches
    check(1 not in gaps and set(range(2, 13)) <= gaps,
          f"exact-mode gaps {sorted(gaps)} are not ℕ∖{{1}} on [2, 12]")
    check(1 in covering, "covering mode should admit gap 1")
    check(launches["s5_emission_gaps"] > 0,
          "emission_gaps did not launch the kernel")
    log(f"[3] §5 run on the card: {res.num_discovered} configs in "
        f"{res.steps} levels, first 45 = paper's allGenCk in order, all 47 "
        f"present; exact-mode gaps ⊇ {{2..12}}, 1 ∉ gaps; kernel launches: "
        f"explore {launches['s5_explore']}, emission_gaps "
        f"{launches['s5_emission_gaps']}")
    return launches


def phase_full_width(kernel_wave_ms):
    import numpy as np
    import torch
    from repro_torch.core import device as devmod
    from repro_torch.core import explore, resolve_dedup
    from repro_torch.core.generators import scaled_pi
    from repro_torch.kernels.snp_step import ops

    system = scaled_pi(682)
    kw = dict(max_steps=8, frontier_cap=512, max_branches=64,
              visited_cap=262144)
    dedup = resolve_dedup("auto", frontier_cap=512, visited_cap=262144,
                          max_branches=64)
    check(dedup == "hash", f"dedup auto resolved to {dedup}")
    results = {}
    for backend in ("cuda", "ref"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counters set to 0 just before, read just after
        ops.kernel_launches = 0
        devmod.host_reads = 0
        t0 = time.perf_counter()
        res = explore(system, backend=backend, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, reads = ops.kernel_launches, devmod.host_reads
        peak = torch.cuda.max_memory_allocated()
        results[backend] = (res, launches)
        waves = res.steps
        cands = waves * kw["frontier_cap"] * kw["max_branches"]
        share = (f"{launches * kernel_wave_ms / (secs * 1e3):.3f}"
                 if backend == "cuda" else "n/a")
        log(f"[4] explore(scaled_pi(682)) via {backend!r}: {waves} waves in "
            f"{secs:.3f} s = {waves / secs:.3f} waves/s, "
            f"{cands / secs:.0f} candidates/s, {res.num_discovered} configs "
            f"archived, flags b/f/v={res.branch_overflow}/"
            f"{res.frontier_overflow}/{res.visited_overflow}, "
            f"kernel launches {launches}, host reads {reads} "
            f"({reads / max(waves, 1):.1f}/wave), kernel share of wave time "
            f"(launches x isolated kernel time) {share}, "
            f"max_memory_allocated {peak / 2**30:.3f} GiB")
        if backend == "cuda":
            check(launches == waves,
                  f"expected one kernel launch per wave, got {launches}")
    (a, launches), (b, _) = results["cuda"], results["ref"]
    check(np.array_equal(a.configs, b.configs)
          and (a.steps, a.branch_overflow, a.frontier_overflow,
               a.visited_overflow, a.exhausted)
          == (b.steps, b.branch_overflow, b.frontier_overflow,
              b.visited_overflow, b.exhausted),
          "full-width archives or flags differ between 'cuda' and 'ref'")
    log(f"[4] archives identical through 'cuda' and 'ref' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} neurons)")
    _wave_breakdown(system, a.configs, kw)
    return launches


def _wave_breakdown(system, archive, kw, dev="cuda"):
    """Host-clock milliseconds (synchronised) of each stage of one hash
    wave at the full-width shape, from a frontier of archived states."""
    import torch
    from repro_torch.core import compile_system, get_backend
    from repro_torch.core.hashing import SENTINEL, config_hash
    from repro_torch.core.hashtable import (first_occurrence, insert_unique,
                                            lookup, make_table)

    dev = torch.device(dev)
    comp = compile_system(system, device=dev)
    F, T, V = kw["frontier_cap"], kw["max_branches"], kw["visited_cap"]
    frontier = torch.from_numpy(archive[-F:]).to(dev)
    table = make_table(V, dev)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, r

    stages = {}
    stages["expand (cuda kernel + bookkeeping)"], out = timed(
        lambda: get_backend("cuda").expand(frontier, comp, T))
    stages["expand (ref plain)"], _ = timed(
        lambda: get_backend("ref").expand(frontier, comp, T))
    cand = out.configs.reshape(F * T, -1)
    valid = out.valid.reshape(-1)
    stages["config_hash"], (hi, lo) = timed(lambda: config_hash(cand))
    hi = torch.where(valid, hi, SENTINEL)
    lo = torch.where(valid, lo, SENTINEL)
    stages["table lookup"], _ = timed(lambda: lookup(table, hi, lo, valid))
    stages["first_occurrence"], (first, _) = timed(
        lambda: first_occurrence(hi, lo, valid))
    stages["compaction sort"], sel = timed(
        lambda: torch.sort((~first).to(torch.uint8),
                           stable=True).indices[:F])
    ins = torch.arange(F, device=dev) < int(first.sum().clamp(max=F))
    stages["table insert"], _ = timed(
        lambda: insert_unique(table, hi[sel], lo[sel], ins))
    log("[4] one full-width hash wave by stage (ms, host clock, "
        "synchronised): " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages.items()))


def phase_traces():
    import torch
    from repro_torch.core import run_traces
    from repro_torch.core.generators import scaled_pi
    from repro_torch.kernels.snp_step import ops

    system = scaled_pi(682)
    steps = 64
    outs = {}
    for backend in ("cuda", "ref"):
        torch.cuda.synchronize()
        ops.kernel_launches = 0
        t0 = time.perf_counter()
        outs[backend] = run_traces(system, steps=steps, seeds=range(256),
                                   policy="first", backend=backend)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.kernel_launches
        log(f"[5] run_traces(scaled_pi(682), {steps} steps, 256 seeds) via "
            f"{backend!r}: {secs:.3f} s = {steps / secs:.2f} steps/s, "
            f"kernel launches {launches}")
        if backend == "cuda":
            check(launches == steps, f"traces: {launches} kernel launches "
                  f"for {steps} steps (expected one per step)")
            cuda_launches = launches
    check(all(torch.equal(x, y) for x, y in zip(outs["cuda"], outs["ref"])),
          "traces differ between 'cuda' and 'ref'")
    log("[5] traces identical through 'cuda' and 'ref'")
    return cuda_launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 1
    try:
        card = phase_card_and_build()
        max_err, rows = phase_kernel()
        by_path = phase_paper()
        wave = rows["scaled_pi(682) wave"]
        launches = by_path["full_width_explore"] = phase_full_width(
            wave["ms"])
        by_path["traces"] = phase_traces()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"[6] ported kernels: {KERNEL['name']} ({KERNEL['route']}, "
        f"{launches} launches on the full-width run; per path "
        f"{json.dumps(by_path)}) | card: {card}")
    figures = dict(KERNEL, launches=launches, max_abs_err=max_err,
                   ms=wave["ms"], plain_ms=wave["plain_ms"],
                   bound_ms=wave["bound_ms"], bound_by=wave["bound_by"],
                   library_ms=wave["library_ms"], launches_by_path=by_path)
    print(json.dumps({"kernels": [figures]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
