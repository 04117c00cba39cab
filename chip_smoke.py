#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result line):

1. card and build — the card's name and power limit, the CUDA kernels
   built from the sources in this checkout (one ``nvcc`` per source, all
   started together, sm_90a);
2. the dense kernel (B1) against its plain version on the card —
   bit-identical outputs on the paper's Π, ``nd_chain(10)`` (Ψ > T), a
   2048-neuron random system, a ragged shape, spike counts near 2^20 and
   the full-width explore wave; times of the kernel, its plain version and
   one ``torch.matmul`` of a materialised ``S`` with ``M`` (the yardstick,
   timed here only: the port never calls it);
3. the sparse kernel's two bodies, ELL (B2) and ELL + COO (B3), against
   their plain version — bit-identical on every entry at Π, ``nd_chain(10)``,
   a ragged shape, a random system with every in-synapse past the first
   in the COO tail, spike counts near 2^20, ``ring_lattice(32768, 8)``,
   ``power_law(32768, max_in=64)`` and the two full-width waves; times of
   the kernel, its plain version and one ``torch.sparse.mm`` of ``S`` as
   CSR with a dense ``M`` (where ``M`` fits 4 GiB);
4. the paper's §5 run through B1 — the allGenCk list and the ℕ∖{1}
   emission-gap result;
5. full width, dense — ``explore(scaled_pi(682))`` (m=2046, n=3410,
   512 x 64 candidates per wave, a 262,144-row archive) through ``"cuda"``
   and ``"ref"``, archives and flags identical;
6. full width, ELL (B2) — the same explore through ``"sparse_cuda"``,
   archive and flags identical to both runs of phase 5;
7. full width, hybrid (B3), the slice's main path —
   ``explore(power_law(8192, 4, seed=2), plan=SystemPlan.for_system(...))``
   through ``"sparse_cuda"`` and ``"sparse"`` at the same caps, identical;
8. traces — ``run_traces(scaled_pi(682), steps=64, seeds=range(256))``
   with ``policy="first"`` and ``"random"`` identical through ``"cuda"``
   and ``"ref"``, and ``run_traces(power_law(8192), policy="random")``
   identical through ``"sparse_cuda"`` and ``"sparse"``;
9. summary — the kernels with their launch counts, then one JSON line of
   per-kernel figures, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every path driven through a kernel backend has every kernel's launch
counter set to 0 just before it and read just after; each count is
checked and reported per path.  The main paths are the full-width
explores: phase 5 for B1, phase 6 for B2 and phase 7 for B3; their counts
are the kernels line's ``launches``.

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

KERNELS = {
    "B1": {"name": "snp_step_dense", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/snp_step_dense.cu",
           "replaces": "src/repro/kernels/snp_step/kernel.py:201"},
    "B2": {"name": "snp_step_sparse_ell", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/"
                     "snp_step_sparse.cu",
           "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
           "body": "_make_kernel(has_coo=False), sparse_kernel.py:71"},
    "B3": {"name": "snp_step_sparse_coo", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/"
                     "snp_step_sparse.cu",
           "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
           "body": "_make_kernel(has_coo=True), sparse_kernel.py:155-167"},
}

# Dense M for the sparse yardstick (torch.sparse.mm) only up to this size.
LIBRARY_M_BYTES = 4 << 30


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


def reset_counts():
    """Every kernel's launch counter to 0 (just before a path)."""
    from repro_torch.kernels.snp_step import ops, sparse_ops
    ops.kernel_launches = 0
    sparse_ops.kernel_launches = sparse_ops.coo_launches = 0


def read_counts():
    """Launches per kernel since :func:`reset_counts` (just after a
    path)."""
    from repro_torch.kernels.snp_step import ops, sparse_ops
    return {"B1": ops.kernel_launches,
            "B2": sparse_ops.kernel_launches - sparse_ops.coo_launches,
            "B3": sparse_ops.coo_launches}


def check_counts(path, counts, **want):
    """Each kernel named in ``want`` launched that many times on ``path``
    (``None``: at least once), every other kernel not at all."""
    for k, n in counts.items():
        w = want.get(k, 0)
        ok = n > 0 if w is None else n == w
        check(ok, f"{path}: {k} launched {n} times, expected "
              f"{'at least one' if w is None else w}")


def phase_card_and_build():
    import torch
    from repro_torch.kernels.snp_step import _build, ops, sparse_ops

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
    sources = [ops.SOURCE, sparse_ops.SOURCE]
    _build.build_all(sources)
    ops.load_kernel()
    sparse_ops.load_kernel()
    secs = time.perf_counter() - t0
    log(f"[1] built (in parallel) and loaded "
        f"{', '.join(s.name for s in sources)} in {secs:.2f} s; the sparse "
        f"kernel takes up to {sparse_ops.max_neurons()} neurons")
    for source in sources:
        for line in _build.build_logs.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line \
                    or "Compiling entry" in line:
                log(f"[1]   {source.name}: {line.strip()}")
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


def _sparse_bound(args, coo, T):
    """Least time for one sparse step call (ms), what binds, and the
    operations counted, from this call's inputs.  Bytes: each input read
    once and each output written once, over HBM bandwidth.  Operations:
    what these inputs need, over the f32/int32 datapath peak: a digit
    decode (divide, floor, modulo) per neuron and branch, the ``C −
    consume`` per output entry, and one add per out-synapse of every
    neuron whose fired rule produces (counted from the decoded fired
    produce), not the ELL padding the kernel also walks."""
    import torch
    from repro_torch.kernels.snp_step.sparse_ref import (decode_digits,
                                                         fired_packed)
    configs, stride, choices, psi, tab, in_idx, out_neuron = args
    B, m = configs.shape
    inputs = list(args) + list(coo.values())
    in_bytes = sum(x.numel() * x.element_size() for x in inputs)
    out_bytes = 4 * B * T * m + 5 * B * T
    out_deg = torch.bincount(in_idx[in_idx < m].to(torch.int64),
                             minlength=m)
    if coo:
        out_deg += torch.bincount(coo["coo_src"].to(torch.int64),
                                  minlength=m)
    fired = (fired_packed(decode_digits(T, stride, choices), tab)
             & 0xFFFF) != 0                                  # (B, T, m)
    adds = int((fired.sum(dim=(0, 1), dtype=torch.int64) * out_deg).sum())
    n_ops = 3 * B * T * m + B * T * m + adds
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (n_ops,)


def _sparse_library_ms(system, comp, configs, info, T, iters):
    """One ``torch.sparse.mm`` of the fired one-hot ``S`` (B·T × n, CSR,
    f32) with a dense f32 ``M``: the yardstick, or ``None`` where ``M``
    exceeds :data:`LIBRARY_M_BYTES`."""
    import torch
    from repro_torch.core import compile_system
    from repro_torch.core.semantics import clamp_stride, decode_spiking
    n, m = comp.num_rules, comp.num_neurons
    if 4 * n * m > LIBRARY_M_BYTES:
        return None
    B = configs.shape[0]
    Mf = compile_system(system, device=configs.device).M.to(torch.float32)
    S = decode_spiking(info.app, info.rank, clamp_stride(info.stride),
                       info.choices, comp.rule_neuron, T)
    S = S.reshape(B * T, n).to(torch.float32).to_sparse_csr()
    ms = time_ms(lambda: torch.sparse.mm(S, Mf), iters)
    del S, Mf
    return ms


def phase_sparse_kernel():
    """B2 (ELL body) and B3 (COO stage) == their plain version on the
    card, on every entry; returns (max |err| per kernel, timing rows keyed
    by case name)."""
    import numpy as np
    import torch
    from repro_torch.core import (SystemPlan, compile_system_sparse,
                                  paper_pi, sparse_next_configs)
    from repro_torch.core.generators import (nd_chain, power_law,
                                             random_system, ring_lattice,
                                             scaled_pi)
    from repro_torch.kernels.snp_step import sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import (kernel_inputs,
                                                         snp_step_sparse_ref)

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    def rand(B, m, lo, hi):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(B, m)).astype(np.int32)).to(dev)

    hybrid_system = power_law(8192, 4, seed=2)
    cases = [
        # (name, system, hub threshold, B, T, configs)
        ("paper_pi", paper_pi(True), None, 128, 16,
         lambda m: rand(128, m, 0, 5)),
        ("nd_chain(10)", nd_chain(10), None, 16, 64,
         lambda m: torch.ones((16, m), dtype=torch.int32, device=dev)),
        ("ragged B13 T37", random_system(45, 3, 0.1, seed=5), None, 13, 37,
         lambda m: rand(13, m, 0, 4)),
        ("random(64) h=1", random_system(64, 2, 0.15, seed=3), 1, 24, 40,
         lambda m: rand(24, m, 0, 4)),
        ("spikes~2^20", random_system(64, 2, 0.1, seed=2), None, 32, 32,
         lambda m: rand(32, m, 2 ** 20 - 8, 2 ** 20 + 8)),
        ("ring_lattice(32768,8)", ring_lattice(32768, 8, seed=2), None, 64,
         64, lambda m: rand(64, m, 0, 4)),
        ("power_law(32768,max_in=64)",
         power_law(32768, 4, seed=2, max_in=64), None, 64, 64,
         lambda m: rand(64, m, 0, 4)),
        ("scaled_pi(682) wave", scaled_pi(682), None, 512, 64,
         lambda m: rand(512, m, 0, 3)),
        ("power_law(8192) hybrid wave", hybrid_system, "auto", 512, 64,
         lambda m: rand(512, m, 0, 4)),
    ]
    max_err = {"B2": 0, "B3": 0}
    rows = {}
    for name, system, h, B, T, make in cases:
        if h == "auto":
            h = SystemPlan.for_system(system).hub_threshold
        comp = compile_system_sparse(system, hub_threshold=h, device=dev)
        kernel = "B3" if comp.is_hybrid else "B2"
        check((h is not None) == comp.is_hybrid,
              f"{name}: expected {'a hybrid' if h else 'an ELL'} encoding")
        n, m = comp.num_rules, comp.num_neurons
        configs = make(m)
        args, coo, info = kernel_inputs(configs, comp)
        k_out, k_valid, k_emis = sparse_ops.snp_step_sparse_cuda(
            *args, **coo, max_branches=T)
        p_out, p_valid, p_emis = snp_step_sparse_ref(*args, **coo,
                                                     max_branches=T)
        torch.cuda.synchronize()
        err = max(int((k_out - p_out).abs().max()),
                  int((k_emis - p_emis).abs().max()))
        max_err[kernel] = max(max_err[kernel], err)
        check(err == 0 and bool(torch.equal(k_valid, p_valid)),
              f"{name}: {kernel} disagrees with its plain version "
              f"(max |err| {err})")
        # the wrapper on the card against the plain step, every entry
        w = sparse_ops.snp_step_sparse(configs, comp, max_branches=T)
        ref = sparse_next_configs(configs, comp, T)
        check(all(torch.equal(a, b) for a, b in zip(
            w, (ref.configs, ref.valid, ref.emissions, ref.overflow))),
            f"{name}: sparse wrapper disagrees with sparse_next_configs")
        del w, ref
        if name == "nd_chain(10)":
            check(bool(info.psi.min() > T), "nd_chain(10) should overflow T")

        big = B * T * m > 1e7
        iters = 5 if big else 50
        k_ms = time_ms(lambda: sparse_ops.snp_step_sparse_cuda(
            *args, **coo, max_branches=T), iters)
        p_ms = time_ms(lambda: snp_step_sparse_ref(
            *args, **coo, max_branches=T), iters)
        del k_out, p_out
        l_ms = _sparse_library_ms(system, comp, configs, info, T, iters)
        b_ms, b_by, b_ops = _sparse_bound(args, coo, T)
        rows[name] = dict(kernel=kernel, B=B, T=T, n=n, m=m,
                          Kin=comp.max_in_degree,
                          Ec=int(comp.coo_src.shape[0]), ms=k_ms,
                          plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                          bound_by=b_by)
        lib = "—" if l_ms is None else f"{l_ms:.4f} ms"
        log(f"[3] {name:27s} {kernel} B={B:4d} T={T:3d} n={n:6d} m={m:6d} "
            f"Kin={comp.max_in_degree:3d} Ec={rows[name]['Ec']:6d} | "
            f"kernel == plain (max |err| {err}) | kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, sparse.mm(S,M) {lib}, bound "
            f"{b_ms:.6f} ms ({b_by}; {b_ops} ops) = {k_ms / b_ms:.1f}x "
            f"bound")
        torch.cuda.empty_cache()
    return max_err, rows


def phase_paper():
    from repro_torch.core import emission_gaps, explore, paper_pi

    launches = {}
    reset_counts()
    res = explore(paper_pi(True), max_steps=16, frontier_cap=128,
                  visited_cap=2048, max_branches=16)
    launches["s5_explore"] = read_counts()["B1"]
    check_counts("§5 explore", read_counts(), B1=res.steps)
    mine = res.as_strings()
    paper = list(dict.fromkeys(PAPER_ALLGENCK))
    check(mine[:45] == paper[:45], "allGenCk prefix differs from the paper")
    check(set(paper) <= set(mine), "allGenCk misses a paper entry")
    reset_counts()
    gaps = emission_gaps(paper_pi(False), max_time=30, max_gap=14)
    covering = emission_gaps(paper_pi(True), max_time=16, max_gap=8)
    counts = read_counts()
    launches["s5_emission_gaps"] = counts["B1"]
    check_counts("§5 emission gaps", counts, B1=None)
    check(1 not in gaps and set(range(2, 13)) <= gaps,
          f"exact-mode gaps {sorted(gaps)} are not ℕ∖{{1}} on [2, 12]")
    check(1 in covering, "covering mode should admit gap 1")
    log(f"[4] §5 run on the card: {res.num_discovered} configs in "
        f"{res.steps} levels, first 45 = paper's allGenCk in order, all 47 "
        f"present; exact-mode gaps ⊇ {{2..12}}, 1 ∉ gaps; B1 launches: "
        f"explore {launches['s5_explore']}, emission_gaps "
        f"{launches['s5_emission_gaps']}")
    return launches


FULL_WIDTH = dict(max_steps=8, frontier_cap=512, max_branches=64,
                  visited_cap=262144)


def _timed_explore(tag, label, system, backend, kernel, plan=None):
    """One full-width explore with its launch counts (set to 0 just
    before, read just after), wall time, host reads and peak memory."""
    import torch
    from repro_torch.core import device as devmod
    from repro_torch.core import explore

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    devmod.host_reads = 0
    t0 = time.perf_counter()
    res = explore(system, backend=backend, plan=plan, **FULL_WIDTH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, reads = read_counts(), devmod.host_reads
    peak = torch.cuda.max_memory_allocated()
    waves = res.steps
    cands = waves * FULL_WIDTH["frontier_cap"] * FULL_WIDTH["max_branches"]
    check_counts(f"{label} via {backend!r}", counts,
                 **({kernel: waves} if kernel else {}))
    log(f"[{tag}] {label} via {backend!r}: {waves} waves in {secs:.3f} s = "
        f"{waves / secs:.3f} waves/s, {cands / secs:.0f} candidates/s, "
        f"{res.num_discovered} configs archived, flags b/f/v="
        f"{res.branch_overflow}/{res.frontier_overflow}/"
        f"{res.visited_overflow}, launches {json.dumps(counts)}, host reads "
        f"{reads} ({reads / max(waves, 1):.1f}/wave), "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    return res, (counts[kernel] if kernel else 0)


def _same_explore(a, b):
    import numpy as np
    return np.array_equal(a.configs, b.configs) and \
        (a.steps, a.branch_overflow, a.frontier_overflow,
         a.visited_overflow, a.exhausted) == \
        (b.steps, b.branch_overflow, b.frontier_overflow,
         b.visited_overflow, b.exhausted)


def phase_full_width():
    from repro_torch.core import compile_system, resolve_dedup
    from repro_torch.core.generators import scaled_pi

    system = scaled_pi(682)
    dedup = resolve_dedup("auto", frontier_cap=512, visited_cap=262144,
                          max_branches=64)
    check(dedup == "hash", f"dedup auto resolved to {dedup}")
    a, launches = _timed_explore("5", "explore(scaled_pi(682))", system,
                                 "cuda", "B1")
    b, _ = _timed_explore("5", "explore(scaled_pi(682))", system, "ref",
                          None)
    check(_same_explore(a, b),
          "full-width archives or flags differ between 'cuda' and 'ref'")
    log(f"[5] archives identical through 'cuda' and 'ref' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} neurons)")
    _wave_breakdown("5", compile_system(system, device="cuda"), a.configs,
                    ("cuda", "ref"))
    return launches, a


def phase_full_width_ell(dense_result):
    from repro_torch.core import compile_system_sparse
    from repro_torch.core.generators import scaled_pi

    system = scaled_pi(682)
    res, launches = _timed_explore("6", "explore(scaled_pi(682))", system,
                                   "sparse_cuda", "B2")
    check(_same_explore(res, dense_result),
          "ELL full-width archive or flags differ from 'cuda' and 'ref'")
    log(f"[6] archive identical through 'sparse_cuda', 'cuda' and 'ref' "
        f"({res.num_discovered} rows)")
    _wave_breakdown("6", compile_system_sparse(system, device="cuda"),
                    res.configs, ("sparse_cuda", "sparse"))
    return launches


def phase_full_width_hybrid():
    from repro_torch.core import SystemPlan, compile_system_sparse
    from repro_torch.core.generators import power_law

    system = power_law(8192, 4, seed=2)
    plan = SystemPlan.for_system(system)
    check(plan.encoding == "hybrid", f"power_law(8192) planned {plan}")
    comp = compile_system_sparse(system, hub_threshold=plan.hub_threshold,
                                 device="cuda")
    hubs = int(comp.coo_bounds.shape[0]) - 1
    log(f"[7] power_law(8192, 4, seed=2): m={comp.num_neurons}, "
        f"n={comp.num_rules}, {len(system.synapses)} synapses, plan "
        f"{plan.encoding} (hub threshold {plan.hub_threshold}), Kin="
        f"{comp.max_in_degree}, Ec={comp.coo_src.shape[0]} over {hubs} hubs, "
        f"R={comp.max_rules_per_neuron}, K={comp.max_nnz_per_rule}")
    a, launches = _timed_explore("7", "explore(power_law(8192))", system,
                                 "sparse_cuda", "B3", plan)
    b, _ = _timed_explore("7", "explore(power_law(8192))", system, "sparse",
                          None, plan)
    check(_same_explore(a, b), "hybrid full-width archives or flags differ "
          "between 'sparse_cuda' and 'sparse'")
    log(f"[7] archives identical through 'sparse_cuda' and 'sparse' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} neurons)")
    _wave_breakdown("7", comp, a.configs, ("sparse_cuda", "sparse"))
    return launches


def _wave_breakdown(tag, comp, archive, backends):
    """Host-clock milliseconds (synchronised) of each stage of one hash
    wave at the full-width shape, from a frontier of archived states (for
    a sparse encoding, the expand's bookkeeping ops and kernel launch
    too, marked ·)."""
    import torch
    from repro_torch.core import (CompiledSparseSNP, applicability,
                                  get_backend, packed_rule_table,
                                  sparse_branch_info)
    from repro_torch.core.hashing import SENTINEL, config_hash
    from repro_torch.core.hashtable import (first_occurrence, insert_unique,
                                            lookup, make_table)
    from repro_torch.kernels.snp_step import sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import kernel_inputs

    dev = comp.device
    F, T = FULL_WIDTH["frontier_cap"], FULL_WIDTH["max_branches"]
    frontier = torch.from_numpy(archive[-F:]).to(dev)
    table = make_table(FULL_WIDTH["visited_cap"], dev)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, r

    stages = {}
    kern, plain = backends
    stages[f"expand ({kern} kernel + bookkeeping)"], out = timed(
        lambda: get_backend(kern).expand(frontier, comp, T))
    stages[f"expand ({plain} plain)"], _ = timed(
        lambda: get_backend(plain).expand(frontier, comp, T))
    if isinstance(comp, CompiledSparseSNP):
        # the sparse expand split: its bookkeeping ops and the launch
        stages["· applicability"], _ = timed(
            lambda: applicability(frontier, comp))
        stages["· sparse_branch_info (with applicability)"], info = timed(
            lambda: sparse_branch_info(frontier, comp))
        stages["· packed_rule_table"], _ = timed(
            lambda: packed_rule_table(info, comp))
        args, coo, _ = kernel_inputs(frontier, comp)
        stages["· kernel launch"], _ = timed(
            lambda: sparse_ops.snp_step_sparse_cuda(*args, **coo,
                                                    max_branches=T))
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
    log(f"[{tag}] one full-width hash wave by stage (ms, host clock, "
        "synchronised): " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages.items()))


def _traces(tag, label, system, policy, backends, kernel, plan=None):
    """``run_traces`` through a kernel backend and its plain twin, with
    the kernel path's launch counts; the two must be identical."""
    import torch
    from repro_torch.core import run_traces

    steps, outs, launches = 64, {}, 0
    for backend in backends:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs[backend] = run_traces(system, steps=steps, seeds=range(256),
                                   policy=policy, backend=backend, plan=plan)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        log(f"[{tag}] run_traces({label}, {steps} steps, 256 seeds, "
            f"policy={policy!r}) via {backend!r}: {secs:.3f} s = "
            f"{steps / secs:.2f} steps/s, launches {json.dumps(counts)}")
        if backend == backends[0]:
            check_counts(f"traces {label} {policy}", counts,
                         **{kernel: steps})
            launches = counts[kernel]
        else:
            check_counts(f"traces {label} {policy} plain", counts)
    a, b = (outs[x] for x in backends)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{policy} traces of {label} differ between {backends}")
    if policy == "random":
        check(len({tuple(r[-1].tolist()) for r in a.configs[:16]}) > 1,
              f"random traces of {label} do not differ across seeds")
    log(f"[{tag}] {policy} traces of {label} identical through "
        f"{backends[0]!r} and {backends[1]!r}")
    return launches


def phase_traces():
    from repro_torch.core import SystemPlan
    from repro_torch.core.generators import power_law, scaled_pi

    pi = scaled_pi(682)
    first = _traces("8", "scaled_pi(682)", pi, "first", ("cuda", "ref"),
                    "B1")
    rand_dense = _traces("8", "scaled_pi(682)", pi, "random",
                         ("cuda", "ref"), "B1")
    hubby = power_law(8192, 4, seed=2)
    rand_hybrid = _traces("8", "power_law(8192)", hubby, "random",
                          ("sparse_cuda", "sparse"), "B3",
                          SystemPlan.for_system(hubby))
    return first, rand_dense, rand_hybrid


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
        dense_err, rows = phase_kernel()
        sparse_err, sparse_rows = phase_sparse_kernel()
        b1 = phase_paper()
        b1["full_width_explore"], dense_res = phase_full_width()
        b2 = {"full_width_ell_explore": phase_full_width_ell(dense_res)}
        del dense_res
        b3 = {"full_width_hybrid_explore": phase_full_width_hybrid()}
        (b1["traces_first"], b1["traces_random"],
         b3["traces_random_hybrid"]) = phase_traces()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    main_path = {"B1": "full_width_explore", "B2": "full_width_ell_explore",
                 "B3": "full_width_hybrid_explore"}
    by_path = {"B1": b1, "B2": b2, "B3": b3}
    waves = {"B1": rows["scaled_pi(682) wave"],
             "B2": sparse_rows["scaled_pi(682) wave"],
             "B3": sparse_rows["power_law(8192) hybrid wave"]}
    errs = {"B1": dense_err, **sparse_err}
    figures = []
    for k, meta in KERNELS.items():
        w = waves[k]
        figures.append(dict(
            meta, id=k, launches=by_path[k][main_path[k]],
            launches_by_path=by_path[k], max_abs_err=errs[k], ms=w["ms"],
            plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
            bound_by=w["bound_by"], library_ms=w["library_ms"]))
        log(f"[9] {k} {meta['name']} ({meta['route']}): "
            f"{figures[-1]['launches']} launches on its main path "
            f"({main_path[k]}); per path {json.dumps(by_path[k])}")
    log(f"[9] card: {card}")
    print(json.dumps({"kernels": figures}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
