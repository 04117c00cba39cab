"""Wrapper around the hand-written dense SNP step kernels.

:func:`snp_step` does the cheap ``O(B·n)`` branch bookkeeping with the
port's :func:`~repro_torch.core.semantics.branch_info` (applicability,
ranks, radix strides clamped to 2^30), then

* on a CPU tensor runs the plain version
  (:func:`~repro_torch.kernels.snp_step.ref.snp_step_dense_ref`);
* on a CUDA tensor launches ``csrc/snp_step_dense.cu`` (B1), or raises.
  There is no fallback.

and masks ``valid`` with ``alive``.  Its outputs equal
:func:`~repro_torch.core.semantics.next_configs` on valid entries.  A
delayed encoding (``3m``-wide state rows) takes the same route through
the delayed step: :func:`~repro_torch.core.semantics.delayed_branch_info`,
then the plain version
(:func:`~repro_torch.kernels.snp_step.ref.snp_step_dense_delay_ref`) or
``csrc/snp_step_dense_delay.cu`` (B4), equal to
:func:`~repro_torch.core.semantics.delayed_next_configs` on valid
entries.

:func:`snp_step_dense_shard` steps one neuron shard of the sharded
frontier (its branch bookkeeping and halo come from the sharded explore,
:mod:`repro_torch.core.distributed`): the plain version
(:func:`~repro_torch.kernels.snp_step.ref.snp_step_dense_shard_ref`) on a
CPU tensor, the shard body of ``csrc/snp_step_dense.cu`` (B6) on a CUDA
tensor, or it raises.

B1 and B6 walk column lists in place of the matrices: their launchers
take the lists (:class:`~repro_torch.core.matrix.CompiledSNP`'s of
``[M | env]``, :meth:`~repro_torch.core.plan.DenseShardArrays.
shard_columns`' of ``M_local`` and ``hadj``; both built at lowering by
:mod:`repro_torch.core.matrix`), not the matrices, so the lists are the
one source of what the kernel adds.  The host checks their shapes; the
kernel skips an entry that points outside the matrix or past the lists'
end, so no list reads out of bounds.  The plain versions read the
matrices.  B4 likewise walks the sliced lists of ``adj_in``
(``CompiledSNP.sell_start``/``sell_src``, :func:`delay_inputs` with
``lists=True``) in place of ``adj_in``, which its plain version reads;
the kernel reads an entry outside ``[0, m]`` as the zero slot and clamps
slice starts to the lists' length.

Block shape.  Every entry takes ``rows`` (branch rows a block) and
``threads``, ``None`` for the library's rule: B1 takes 8, 16 (the rule)
or 32 rows at 256 threads, and its rows are not clipped (a tile past
``max_branches`` is masked, as under the rule); B6 takes 1, 2, 4 or 8
rows at 256 threads (the rule: the most rows whose halo slab fits its
stage); B4 takes 1, 2, 4 or 8 rows and 256 or 1024 threads, its stage of
``rows`` int32 rows of ``m + 1`` values within the 227 KB a block holds
(:func:`delay_block_shape`).  B4's and B6's rows above ``max_branches``
are clipped to the largest power of two at most ``max_branches``.  Any
other shape is a ``ValueError`` before any launch, also on a CPU tensor
(:func:`~.sparse_ops.check_block`), never a silent change.

Counters.  The kernels count their own launches on the card, by
``(kernel, rows, threads)`` with ``kernel`` one of ``"B1"``, ``"B4"``,
``"B6"`` (:mod:`repro_torch.kernels.launch_counts`).  ``plain_calls``,
``delay_plain_calls`` and ``shard_plain_calls`` (plain integers, reset by
callers that measure a run) count calls of B1's, B4's and B6's plain
versions.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.matrix import CompiledSNP, is_delayed
from ...core.semantics import (branch_info, clamp_stride,
                               delayed_branch_info, split_state)
from ..launch_counts import slot
from ..real import require_real
from ._build import load_library
from .ref import (snp_step_dense_delay_ref, snp_step_dense_ref,
                  snp_step_dense_shard_ref)
from .sparse_ops import (_check, _check_shape, _check_sliced_lists,
                         check_block)

__all__ = ["snp_step", "snp_step_dense", "snp_step_dense_delay",
           "snp_step_dense_shard", "snp_step_dense_shard_cuda",
           "delay_inputs", "load_kernel", "load_delay_kernel",
           "delay_max_neurons", "delay_block_shape", "dense_block_shape",
           "shard_block_shape", "SOURCE", "DELAY_SOURCE", "plain_calls",
           "delay_plain_calls", "shard_plain_calls",
           "RULE_CHUNK", "B1_ROWS", "THREADS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "snp_step_dense.cu"
DELAY_SOURCE = SOURCE.with_name("snp_step_dense_delay.cu")

# Rules whose fired-row masks one block of B1/B6 stages at a time (the
# source's RULE_CHUNK); a longer rule axis is walked in chunks.
RULE_CHUNK = 8192

#: Rows a block B1 takes (one bit each in a rule's fired-row mask), and
#: the threads a block of B1 and B6.
B1_ROWS = (8, 16, 32)
THREADS = 256

plain_calls = 0
delay_plain_calls = 0
shard_plain_calls = 0


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    lib = load_library(SOURCE)
    fn = lib.snp_step_dense
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    shard = lib.snp_step_dense_shard
    shard.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p] * 2
    shard.restype = ctypes.c_int
    lib.snp_step_dense_rows.argtypes = []
    lib.snp_step_dense_rows.restype = ctypes.c_int
    lib.snp_step_dense_shard_rows.argtypes = [ctypes.c_int] * 2
    lib.snp_step_dense_shard_rows.restype = ctypes.c_int
    return lib


def load_delay_kernel():
    """Build (at first use) and load B4's shared library."""
    lib = load_library(DELAY_SOURCE)
    fn = lib.snp_step_dense_delay
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.snp_step_dense_delay_max_neurons.argtypes = []
    lib.snp_step_dense_delay_max_neurons.restype = ctypes.c_int
    lib.snp_step_dense_delay_rows.argtypes = [ctypes.c_int] * 2
    lib.snp_step_dense_delay_rows.restype = ctypes.c_int
    lib.snp_step_dense_delay_threads.argtypes = [ctypes.c_int]
    lib.snp_step_dense_delay_threads.restype = ctypes.c_int
    return lib


def delay_max_neurons() -> int:
    """The largest system (neurons) B4 takes: one int32 row of emit-now
    spikes must fit a block's shared memory."""
    return int(load_delay_kernel().snp_step_dense_delay_max_neurons())


def _check_b1(rows, threads):
    return check_block("B1", rows, threads, 0, row_set=B1_ROWS,
                       thread_set=(THREADS,), clip=False)


def _check_b4(m, max_branches, rows, threads):
    return check_block("B4", rows, threads, max_branches, width=m,
                       nbytes=4)


def _check_b6(max_branches, rows, threads):
    return check_block("B6", rows, threads, max_branches,
                       thread_set=(THREADS,))


def delay_block_shape(m: int, max_branches: int, rows=None, threads=None):
    """``(rows, threads)`` a block of B4 runs for ``m`` neurons at
    ``max_branches`` branches: as requested (validated), the library's
    rule for those that are ``None``."""
    rows, threads = _check_b4(m, max_branches, rows, threads)
    if rows is None or threads is None:
        lib = load_delay_kernel()
        if rows is None:
            rows = int(lib.snp_step_dense_delay_rows(m, max_branches))
        if threads is None:
            threads = int(lib.snp_step_dense_delay_threads(m))
    return rows, threads


def dense_block_shape(rows=None, threads=None):
    """``(rows, threads)`` a block of B1 runs: as requested (validated),
    the library's rule for those that are ``None``."""
    rows, threads = _check_b1(rows, threads)
    if rows is None:
        rows = int(load_kernel().snp_step_dense_rows())
    return rows, THREADS if threads is None else threads


def shard_block_shape(n: int, H: int, max_branches: int, rows=None,
                      threads=None):
    """``(rows, threads)`` a block of B6 runs for a shard of ``n`` rules
    and ``H`` halo slots: as requested (validated), the library's rule for
    those that are ``None``."""
    rows, threads = _check_b6(max_branches, rows, threads)
    if rows is None:
        rows = int(load_kernel().snp_step_dense_shard_rows(n, H))
    return rows, THREADS if threads is None else threads


_INPUTS = (("configs", torch.int32, 2), ("rank", torch.int32, 2),
           ("app", torch.bool, 2), ("stride", torch.int32, 2),
           ("choices", torch.int32, 2), ("psi", torch.float32, 1),
           ("rule_neuron", torch.int32, 1))

_DENSE_LISTS = ("col_start", "col_rule", "col_val")
_SHARD_LISTS = _DENSE_LISTS + ("hcol_start", "hcol_slot")


def _check_lists(names, lists, starts, dev):
    """Each list a contiguous 1-D int32 tensor on ``dev``; ``starts`` maps
    a start list's name to the length the output's width implies; a value
    list is as long as the index list before it."""
    if lists is None or len(lists) != len(names):
        raise ValueError(f"expected the column lists {names}, got "
                         f"{'none' if lists is None else len(lists)}")
    for k, (name, x) in enumerate(zip(names, lists)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        want = starts.get(name, lists[k - 1].shape[0]
                          if name == "col_val" else None)
        if want is not None and x.shape[0] != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"({want},)")
    for name, x in zip(names, lists):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {x.device}")


def snp_step_dense(configs, rank, app, stride, choices, psi, rule_neuron,
                   cols, max_branches: int, *, rows=None, threads=None):
    """Launch the kernel on CUDA tensors: ``(out (B,T,m) int32, valid (B,T)
    bool, emis (B,T) int32)``, the plain version's contract for the ``M``
    and ``env`` whose column lists ``cols`` = ``(col_start (m+2,),
    col_rule, col_val)`` holds (:func:`~repro_torch.core.matrix.
    dense_column_lists`), at ``rows`` x ``threads`` a block
    (:func:`dense_block_shape`)."""
    args = (configs, rank, app, stride, choices, psi, rule_neuron)
    dev = configs.device
    B, m = configs.shape
    n = rule_neuron.shape[0]
    T = int(max_branches)
    _check_lists(_DENSE_LISTS, cols, {"col_start": m + 2}, dev)
    for (name, dtype, ndim), x in zip(_INPUTS, args):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {x.device}")
        if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    shapes = {"rank": (B, n), "app": (B, n), "stride": (B, m),
              "choices": (B, m), "psi": (B,)}
    for (name, _, _), x in zip(_INPUTS[1:], args[1:]):
        want = shapes.get(name)
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want}")
    if T < 1:
        raise ValueError(f"max_branches must be >= 1, got {T}")
    require_real("snp_step_dense (B1)", *args, *cols)
    rows, threads = dense_block_shape(rows, threads)
    fn = load_kernel().snp_step_dense
    out = torch.empty((B, T, m), dtype=torch.int32, device=dev)
    valid = torch.empty((B, T), dtype=torch.bool, device=dev)
    emis = torch.empty((B, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in args + tuple(cols)),
                out.data_ptr(), valid.data_ptr(), emis.data_ptr(), B, T, n,
                m, cols[1].shape[0], rows, threads,
                slot(("B1", rows, threads), dev), stream)
    if rc != 0:
        raise RuntimeError(f"snp_step_dense launch failed: CUDA error {rc}")
    return out, valid, emis


def snp_step_dense_delay(spikes, cd, pd, rank, app, stride, choices, psi,
                         rule_bounds, consume, produce, delay, sell_start,
                         sell_src, out_neuron, max_branches: int, *,
                         rows=None, threads=None):
    """Launch B4 on CUDA tensors: ``(out (B,T,3m) int32, valid (B,T) bool,
    emis (B,T) int32)``, the contract of
    :func:`~repro_torch.kernels.snp_step.ref.snp_step_dense_delay_ref` for
    the ``adj_in`` whose sliced lists ``sell_start (ceil(m/32)+1,)`` and
    ``sell_src`` hold (:func:`~repro_torch.core.matrix.sliced_in_lists`),
    taken in ``adj_in``'s place, at ``rows`` x ``threads`` a block
    (:func:`delay_block_shape`)."""
    dev = spikes.device
    B, m = spikes.shape
    n = rank.shape[-1]
    T = int(max_branches)
    i32 = torch.int32
    _check_sliced_lists("B4", "adj_in", sell_start, sell_src)
    checks = (
        ("spikes", spikes, i32, (B, m)), ("cd", cd, i32, (B, m)),
        ("pd", pd, i32, (B, m)), ("rank", rank, i32, (B, n)),
        ("app", app, torch.bool, (B, n)), ("stride", stride, i32, (B, m)),
        ("choices", choices, i32, (B, m)), ("psi", psi, torch.float32, (B,)),
        ("rule_bounds", rule_bounds, i32, (m + 1,)),
        ("consume", consume, i32, (n,)), ("produce", produce, i32, (n,)),
        ("delay", delay, i32, (n,)),
        ("sell_start", sell_start, i32, (-(-m // 32) + 1,)),
        ("sell_src", sell_src, i32, (sell_src.shape[0],)),
        ("out_neuron", out_neuron, i32, (1,)))
    for name, x, dtype, shape in checks:    # every shape, then devices
        _check_shape(name, x, dtype, shape)
    for name, x, dtype, shape in checks:
        _check(name, x, dtype, shape, dev)
    if T < 1:
        raise ValueError(f"max_branches must be >= 1, got {T}")
    require_real("snp_step_dense_delay (B4)", spikes, cd, pd, rank, app,
                 stride, choices, psi, rule_bounds, consume, produce, delay,
                 sell_start, sell_src, out_neuron)
    lib = load_delay_kernel()
    if m > delay_max_neurons():
        raise ValueError(
            f"the dense delayed step kernel takes at most "
            f"{delay_max_neurons()} neurons (one row of emit-now spikes per "
            f"block in shared memory), got m={m}")
    rows, threads = delay_block_shape(m, T, rows, threads)
    out = torch.empty((B, T, 3 * m), dtype=i32, device=dev)
    valid = torch.empty((B, T), dtype=torch.bool, device=dev)
    emis = torch.empty((B, T), dtype=i32, device=dev)
    if B == 0:
        return out, valid, emis
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.snp_step_dense_delay(
            *(x.data_ptr() for x in (
                spikes, cd, pd, rank, app, stride, choices, psi, rule_bounds,
                consume, produce, delay, sell_start, sell_src, out_neuron,
                out, valid, emis)), B, T, n, m, sell_src.shape[0], rows,
            threads, slot(("B4", rows, threads), dev), stream)
    if rc != 0:
        raise RuntimeError(
            f"snp_step_dense_delay launch failed: CUDA error {rc}")
    return out, valid, emis


def snp_step_dense_shard_cuda(configs, rank, app, stride, choices, psi,
                              rule_neuron, cols, halo, max_branches: int, *,
                              rows=None, threads=None):
    """Launch B6 on CUDA tensors: ``out (B,T,mloc) int32``, the contract
    of :func:`~repro_torch.kernels.snp_step.ref.snp_step_dense_shard_ref`
    (``stride`` int32, clamped) for the ``M_local`` and ``hadj`` whose
    column lists ``cols`` = ``(col_start (mloc+1,), col_rule, col_val,
    hcol_start (mloc+1,), hcol_slot)`` holds (:meth:`~repro_torch.core.
    plan.DenseShardArrays.shard_columns`; padding past each list's end is
    ignored), at ``rows`` x ``threads`` a block
    (:func:`shard_block_shape`)."""
    dev = configs.device
    B, m = configs.shape
    n = rank.shape[-1]
    H = halo.shape[-1]
    T = int(max_branches)
    i32 = torch.int32
    _check_lists(_SHARD_LISTS, cols, {"col_start": m + 1,
                                      "hcol_start": m + 1}, dev)
    for name, x, dtype, shape in (
            ("configs", configs, i32, (B, m)), ("rank", rank, i32, (B, n)),
            ("app", app, torch.bool, (B, n)), ("stride", stride, i32, (B, m)),
            ("choices", choices, i32, (B, m)),
            ("psi", psi, torch.float32, (B,)),
            ("rule_neuron", rule_neuron, i32, (n,)),
            ("halo", halo, i32, (B, T, H))):
        _check(name, x, dtype, shape, dev)
    if T < 1:
        raise ValueError(f"max_branches must be >= 1, got {T}")
    require_real("snp_step_dense_shard_cuda (B6)", configs, rank, app,
                 stride, choices, psi, rule_neuron, *cols, halo)
    rows, threads = shard_block_shape(n, H, T, rows, threads)
    fn = load_kernel().snp_step_dense_shard
    out = torch.empty((B, T, m), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in (
            configs, rank, app, stride, choices, psi, rule_neuron) + tuple(
                cols) + (halo, out)), B, T, n, m, H, cols[1].shape[0],
            cols[4].shape[0], rows, threads,
            slot(("B6", rows, threads), dev), stream)
    if rc != 0:
        raise RuntimeError(
            f"snp_step_dense_shard launch failed: CUDA error {rc}")
    return out


def snp_step_dense_shard(configs: torch.Tensor, rank: torch.Tensor,
                         app: torch.Tensor, stride: torch.Tensor,
                         choices: torch.Tensor, psi: torch.Tensor,
                         rule_neuron: torch.Tensor, M_local: torch.Tensor,
                         hadj: torch.Tensor, halo: torch.Tensor, *,
                         max_branches: int, cols=None, rows=None,
                         threads=None) -> torch.Tensor:
    """One shard's candidate slices ``(B, T, mloc)``: ``C + halo·hadj +
    S·M_local``, ``S`` decoded from the shard's local rules (``rank``,
    ``app`` (B, nloc) over ``rule_neuron``) with the cross-shard float32
    ``stride`` (clamped to 2^30 here) and ``choices`` (B, mloc);
    ``halo`` (B, T, S·Hmax) is the exchanged remote produce.  The plain
    version on a CPU tensor (it reads ``M_local`` and ``hadj``), B6 on a
    CUDA tensor (it reads ``cols``, the shard's column lists,
    :meth:`~repro_torch.core.plan.DenseShardArrays.shard_columns`), at
    ``rows`` x ``threads`` a block (validated on both)."""
    global shard_plain_calls
    args = (configs.contiguous(), rank.contiguous(), app.contiguous(),
            clamp_stride(stride).contiguous(), choices.contiguous(),
            psi.contiguous(), rule_neuron, M_local, hadj,
            halo.contiguous())
    if configs.device.type == "cpu":
        _check_b6(max_branches, rows, threads)
        shard_plain_calls += 1
        return snp_step_dense_shard_ref(*args, max_branches)
    return snp_step_dense_shard_cuda(*args[:7], cols, args[9],
                                     max_branches, rows=rows,
                                     threads=threads)


def delay_inputs(configs: torch.Tensor, comp: CompiledSNP, *,
                 lists: bool = False):
    """B4's inputs for state rows ``configs`` (B, 3m) of a delayed dense
    encoding, and the branch info they came from: ``(args, info)``.  The
    plain version's take ``adj_in``; with ``lists`` (what the kernel
    reads) its sliced lists ``sell_start, sell_src`` stand in its place,
    two arguments for one, and an encoding without them raises."""
    if comp.adj_in is None:
        raise ValueError(
            "dense delayed step: this encoding lacks adj_in (the "
            "in-neighbour lists of its adjacency); lower the system "
            "through compile_system / backend.compile")
    adj = (comp.adj_in,)
    if lists:
        if comp.sell_start is None or comp.sell_src is None:
            raise ValueError(
                "dense delayed step kernel: this encoding lacks the sliced "
                "lists of adj_in (sell_start/sell_src) that B4 walks; lower "
                "the system through compile_system or "
                "convert.compiled_from_arrays")
        adj = (comp.sell_start, comp.sell_src)
    spikes, cd, pd = split_state(configs)
    info = delayed_branch_info(configs, comp)
    m = comp.num_neurons
    rule_bounds = torch.searchsorted(
        comp.rule_neuron, torch.arange(m + 1, dtype=torch.int32,
                                       device=configs.device),
        out_int32=True)
    args = (spikes.contiguous(), cd.contiguous(), pd.contiguous(),
            info.rank, info.app, clamp_stride(info.stride), info.choices,
            info.psi.contiguous(), rule_bounds, comp.consume, comp.produce,
            comp.delay, *adj, comp.out_neuron.reshape(1))
    return args, info


def snp_step(configs: torch.Tensor, comp: CompiledSNP, *,
             max_branches: int, rows=None, threads=None):
    """Fused successor expansion of ``configs`` (B, m), or (B, 3m) state
    rows for a delayed encoding: ``(successors (B,T,m|3m) int32, valid
    (B,T) bool, emissions (B,T) int32, overflow (B,) bool)``,
    bit-identical to the reference semantics of ``comp``'s tier on valid
    entries for spike counts < 2^24; B1 or B4 at ``rows`` x ``threads`` a
    block (validated on a CPU tensor too)."""
    global plain_calls, delay_plain_calls
    if configs.dim() != 2:
        raise ValueError(f"configs must be (B, m), got {tuple(configs.shape)}")
    if is_delayed(comp):
        args, info = delay_inputs(configs, comp,
                                  lists=configs.device.type != "cpu")
        if configs.device.type == "cpu":
            _check_b4(comp.num_neurons, max_branches, rows, threads)
            delay_plain_calls += 1
            out, valid, emis = snp_step_dense_delay_ref(*args, max_branches)
        else:
            out, valid, emis = snp_step_dense_delay(
                *args, max_branches, rows=rows, threads=threads)
        return (out, valid & info.alive.unsqueeze(-1), emis,
                info.psi > float(max_branches))
    info = branch_info(configs, comp)
    args = (configs.contiguous(), info.rank, info.app,
            clamp_stride(info.stride), info.choices, info.psi.contiguous(),
            comp.rule_neuron)
    if configs.device.type == "cpu":
        _check_b1(rows, threads)
        plain_calls += 1
        out, valid, emis = snp_step_dense_ref(
            *args, comp.M, comp.env_produce, max_branches)
    else:
        if comp.col_start is None:
            raise ValueError(
                "dense step: this encoding lacks the column lists of [M | "
                "env_produce]; lower the system through compile_system / "
                "backend.compile")
        out, valid, emis = snp_step_dense(
            *args, (comp.col_start, comp.col_rule, comp.col_val),
            max_branches, rows=rows, threads=threads)
    return (out, valid & info.alive.unsqueeze(-1), emis,
            info.psi > float(max_branches))
