"""Wrapper around the hand-written sparse SNP step kernel.

:func:`snp_step_sparse` runs the cheap ``O(B·m·R)`` per-config
bookkeeping (:func:`~.sparse_ref.kernel_inputs`), then

* on a CPU tensor the plain version
  (:func:`~.sparse_ref.snp_step_sparse_ref`);
* on a CUDA tensor ``csrc/snp_step_sparse.cu``'s one kernel, the
  sliced-list kernel, which walks the encoding's sliced in-lists (and a
  hybrid encoding's hub neurons) in place of ``in_idx`` and ``hub_slot``
  (an encoding without them is refused): B2 for a delay-free pure-ELL
  encoding, B3 for a hybrid one, B5 with the delay stage for a delayed
  one — or it raises.  There is no fallback.

and masks ``valid`` with ``alive``.  Its outputs equal
:func:`~repro_torch.core.semantics.sparse_next_configs` (or, for a
delayed encoding,
:func:`~repro_torch.core.semantics.sparse_delayed_next_configs`) on every
entry: under delays, on every state whose pending counts are
below 2^16, which every state a compiled system reaches is (the kernel
stages the emit-now vector as uint16; ``csrc/snp_step_sparse.cu`` gives
the argument).


:func:`snp_step_sparse_shard` steps one neuron shard of the sharded
frontier (its bookkeeping and halo come from the sharded explore,
:mod:`repro_torch.core.distributed`): the plain version over the shard's
``in_idx`` on a CPU tensor, the sliced-list kernel's shard body (B7) over
the shard's sliced lists on a CUDA tensor.

Block shape.  Every entry takes ``rows`` (branch rows a block: 1, 2, 4
or 8) and ``threads`` (256 or 1024), ``None`` for the library's rule
(:func:`sell_block_shape`); the planner's autotuner chooses them
(:mod:`repro_torch.core.autotune`).  Rows above ``max_branches`` are
clipped to the largest power of two at most ``max_branches``, as the rule
clips its own.  A shape outside those sets, or whose stage of ``rows``
uint16 rows of ``m + H + 1`` values passes the 227 KB a block may hold
(:data:`SMEM_LIMIT`; at ``ring_lattice(32768, 8)``, m = 32,768, at most 2
rows), is a ``ValueError`` before any launch, also on a CPU tensor, whose
plain version ignores the shape.  A shape is never changed silently.

Counters.  The kernel counts its own launches on the card, by ``(body,
rows, threads)`` with ``body`` one of ``"B2"`` (ELL), ``"B3"`` (the COO
tail), ``"B5-ELL"`` and ``"B5-COO"`` (the delayed bodies), ``"B7"`` (the
halo) (:mod:`repro_torch.kernels.launch_counts`).  ``plain_calls`` (a
plain integer, reset by callers that measure a run) counts calls of the
plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.matrix import CompiledSparseSNP
from ..launch_counts import slot
from ..real import require_real
from ._build import load_library
from .sparse_ref import kernel_inputs, snp_step_sparse_ref, sparse_step

__all__ = ["snp_step_sparse", "snp_step_sparse_cuda",
           "snp_step_sparse_shard", "load_kernel", "max_neurons",
           "sell_block_shape", "check_block", "SOURCE", "MAX_BRANCHES",
           "SMEM_LIMIT", "ROWS", "THREADS", "plain_calls", "body"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "snp_step_sparse.cu"

# The f32 decode is exact only below this many branches
# (sparse_ref.decode_digits).
MAX_BRANCHES = 1 << 23

#: Shared memory a block may opt in to, the sources' ``sell::SMEM_LIMIT``
#: (227 KB; ``max_neurons()`` is derived from it, and the smoke holds the
#: library to this value).
SMEM_LIMIT = 232448
#: Rows a block and threads a block the sliced-list kernel (and B4) take.
ROWS = (1, 2, 4, 8)
THREADS = (256, 1024)

plain_calls = 0


def body(has_coo: bool, has_delay: bool, has_halo: bool) -> str:
    """The body a launch runs: ``"B2"``, ``"B3"``, ``"B5-ELL"``,
    ``"B5-COO"`` or ``"B7"``."""
    if has_halo:
        return "B7"
    if has_delay:
        return "B5-COO" if has_coo else "B5-ELL"
    return "B3" if has_coo else "B2"


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    lib = load_library(SOURCE)
    fn = lib.snp_step_sparse
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 13 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.snp_step_sparse_max_neurons.argtypes = []
    lib.snp_step_sparse_max_neurons.restype = ctypes.c_int
    lib.snp_step_sparse_sell_rows.argtypes = [ctypes.c_int] * 2
    lib.snp_step_sparse_sell_threads.argtypes = [ctypes.c_int]
    lib.snp_step_sparse_sell_rows.restype = ctypes.c_int
    lib.snp_step_sparse_sell_threads.restype = ctypes.c_int
    return lib


def max_neurons() -> int:
    """The largest system (neurons; for a shard, its neurons plus its halo
    slots) the kernel takes: one row of fired produce must fit a block's
    shared memory."""
    return int(load_kernel().snp_step_sparse_max_neurons())


def check_block(kernel: str, rows, threads, max_branches: int, *,
                width=None, nbytes: int = 2, row_set=ROWS,
                thread_set=THREADS, clip: bool = True):
    """Validate a requested block shape of ``kernel`` (its name, for the
    message): ``rows`` in ``row_set`` (clipped, with ``clip``, to the
    largest power of two at most ``max_branches``) and, with ``width``,
    a stage of ``rows`` rows of ``width + 1`` values of ``nbytes`` bytes
    within :data:`SMEM_LIMIT`; ``threads`` in ``thread_set``.  Returns
    ``(rows, threads)``, ``None`` where the rule decides; raises
    ``ValueError``.  Pure Python: the wrappers check on the CPU too."""
    if threads is not None and threads not in thread_set:
        raise ValueError(f"{kernel} takes {' or '.join(map(str, thread_set))}"
                         f" threads a block, got threads={threads!r}")
    if rows is None:
        return None, threads
    if rows not in row_set:
        raise ValueError(f"{kernel} takes {', '.join(map(str, row_set))} "
                         f"rows a block, got rows={rows!r}")
    while clip and rows > 1 and rows > max_branches:
        rows >>= 1
    if width is not None and rows * (width + 1) * nbytes > SMEM_LIMIT:
        most = max((r for r in row_set
                    if r * (width + 1) * nbytes <= SMEM_LIMIT), default=0)
        raise ValueError(
            f"{kernel}: a stage of {rows} rows of {width + 1} values "
            f"({rows * (width + 1) * nbytes} bytes) passes the "
            f"{SMEM_LIMIT} bytes a block may hold; at this width it takes "
            f"at most {most} rows a block")
    return rows, threads


def sell_block_shape(m: int, halo: int, max_branches: int, rows=None,
                     threads=None):
    """``(rows, threads)`` a block of the sliced-list kernel runs for a
    system of ``m`` neurons (a shard's local ones) and ``halo`` halo slots
    at ``max_branches`` branches: ``rows`` and ``threads`` as requested
    (validated by :func:`check_block`), the library's rule for those
    that are ``None``."""
    rows, threads = check_block("the sliced-list kernel", rows, threads,
                                max_branches, width=m + halo)
    if rows is None or threads is None:
        lib = load_kernel()
        if rows is None:
            rows = int(lib.snp_step_sparse_sell_rows(m + halo,
                                                     max_branches))
        if threads is None:
            threads = int(lib.snp_step_sparse_sell_threads(m))
    return rows, threads


def _check_branches(T: int) -> None:
    if not 1 <= T < MAX_BRANCHES:
        raise ValueError(f"max_branches must be in [1, 2^23) for the exact "
                         f"float32 decode, got {T}")


def _check_shape(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape}, got {x.dtype} {tuple(x.shape)}")


def _check(name, x, dtype, shape, dev):
    if x.device != dev or dev.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                         f"got {x.device}")
    _check_shape(name, x, dtype, shape)


def _check_sliced_lists(kernel, adjacency, sell_start, sell_src):
    """Refuse anything but two 1-D tensors where a launcher takes sliced
    lists (its plain version takes ``adjacency`` there)."""
    def kind(x):
        return (f"a {x.dim()}-D tensor" if isinstance(x, torch.Tensor)
                else type(x).__name__)
    if not all(isinstance(x, torch.Tensor) and x.dim() == 1
               for x in (sell_start, sell_src)):
        raise ValueError(
            f"{kernel} walks the sliced lists sell_start, sell_src (two 1-D "
            f"tensors) in place of {adjacency}; got {kind(sell_start)} and "
            f"{kind(sell_src)}")


def snp_step_sparse_cuda(configs, stride, choices, psi, tab, sell_start,
                         sell_src, out_neuron, coo_src=None, coo_bounds=None,
                         hub_neuron=None, dtab=None, cd=None, pd=None,
                         halo=None, *, max_branches: int, rows=None,
                         threads=None):
    """Launch the kernel on CUDA tensors: ``(out (B,T,m) int32, valid
    (B,T) bool, emis (B,T) int32)``, the plain version's contract.  Every
    body walks the sliced lists ``sell_start``/``sell_src`` in place of
    the plain version's ``in_idx``, two arguments for one
    (``sparse_ref.kernel_inputs(..., lists=True)`` gives them):
    ``coo_src``/``coo_bounds``/``hub_neuron`` (all or none) select the COO
    tail (B3, B5 COO; ``hub_neuron`` in place of the plain version's
    ``hub_slot``), ``dtab``/``cd``/``pd`` (all or none) the delay stage
    (B5), whose rows are ``3m`` wide, ``halo`` (B, T, H) the shard body
    (B7; with neither of the other two, its lists indexing ``[local | halo
    | zero]``, its entries fired produce, below 2^16); none of the three is
    the ELL body (B2).  ``rows`` and ``threads`` set the block shape
    (:func:`sell_block_shape`).  The shapes are checked here; list entries
    out of range are read as the zero slot by the kernel (no host read)."""
    dev = configs.device
    B, m = configs.shape
    R = tab.shape[-1]
    T = int(max_branches)
    _check_sliced_lists("every body of the sparse step kernel (B2 as "
                        "well as those with the COO tail, the delay stage "
                        "or the halo)", "in_idx", sell_start, sell_src)
    has_coo = coo_src is not None
    if has_coo != (coo_bounds is not None) or has_coo != (hub_neuron
                                                         is not None):
        raise ValueError("the COO tail: coo_src, coo_bounds and hub_neuron "
                         "come together")
    has_delay = dtab is not None
    if has_delay != (cd is not None) or has_delay != (pd is not None):
        raise ValueError("dtab, cd and pd come together")
    has_halo = halo is not None
    if has_halo and (has_coo or has_delay):
        raise ValueError("the shard body (halo) has neither a COO nor a "
                         "delay stage")
    Hn = coo_bounds.shape[0] - 1 if has_coo else 0
    H = halo.shape[-1] if has_halo else 0
    i32, f32 = torch.int32, torch.float32
    checks = [("configs", configs, i32, (B, m)),
              ("stride", stride, f32, (B, m)),
              ("choices", choices, i32, (B, m)), ("psi", psi, f32, (B,)),
              ("tab", tab, i32, (B, m, R)),
              ("out_neuron", out_neuron, i32, (1,))]
    E = sell_src.shape[0]
    checks += [("sell_start", sell_start, i32, (-(-m // 32) + 1,)),
               ("sell_src", sell_src, i32, (E,))]
    if has_coo:
        checks += [("coo_src", coo_src, i32, (coo_src.shape[0],)),
                   ("coo_bounds", coo_bounds, i32, (Hn + 1,)),
                   ("hub_neuron", hub_neuron, i32, (Hn,))]
    if has_delay:
        checks += [("dtab", dtab, i32, (B, m, R)), ("cd", cd, i32, (B, m)),
                   ("pd", pd, i32, (B, m))]
    if has_halo:
        checks += [("halo", halo, i32, (B, T, H))]
    for name, x, dtype, shape in checks:    # every shape, then devices
        _check_shape(name, x, dtype, shape)
    for name, x, dtype, shape in checks:
        _check(name, x, dtype, shape, dev)
    _check_branches(T)
    require_real("snp_step_sparse_cuda (B2, B3, B5, B7)",
                 *(x for _, x, _, _ in checks))
    lib = load_kernel()
    if m + H > max_neurons():
        raise ValueError(
            f"the sparse step kernel takes at most {max_neurons()} neurons "
            f"and halo slots (one row of fired produce per block in shared "
            f"memory), got m={m}" + (f" and {H} halo slots" if H else ""))
    rows, threads = sell_block_shape(m, H, T, rows, threads)
    out = torch.empty((B, T, 3 * m if has_delay else m), dtype=i32,
                      device=dev)
    valid = torch.empty((B, T), dtype=torch.bool, device=dev)
    emis = torch.empty((B, T), dtype=i32, device=dev)
    if B == 0:
        return out, valid, emis
    Ec = coo_src.shape[0] if has_coo else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (None if x is None else x.data_ptr() for x in (
            configs, stride, choices, psi, tab, sell_start, sell_src,
            out_neuron, coo_src, coo_bounds, hub_neuron, dtab, cd, pd, halo,
            out, valid, emis))
        rc = lib.snp_step_sparse(*ptrs, B, T, m, R, E, Ec, Hn, H,
                                 int(has_coo), int(has_delay), int(has_halo),
                                 rows, threads, slot((body(
                                     has_coo, has_delay, has_halo), rows,
                                     threads), dev), stream)
    if rc != 0:
        raise RuntimeError(f"snp_step_sparse launch failed: CUDA error {rc}")
    return out, valid, emis


def snp_step_sparse_shard(configs: torch.Tensor, stride: torch.Tensor,
                          choices: torch.Tensor, psi: torch.Tensor,
                          tab: torch.Tensor, in_idx: torch.Tensor,
                          halo: torch.Tensor, *, sell=None,
                          max_branches: int, rows=None,
                          threads=None) -> torch.Tensor:
    """One shard's candidate slices ``(B, T, mloc)``: the local slice
    ``configs`` minus the fired consume plus the produce gathered over
    ``in_idx`` in the extended space ``[local | halo | zero]``, with the
    cross-shard float32 ``stride``, the local ``choices`` and packed table
    ``tab`` (B, mloc, R), and ``halo`` (B, T, S·Hmax) the exchanged remote
    produce.  The emission index is the zero slot (the sharded explore
    judges emissions).  The plain version over ``in_idx`` on a CPU
    tensor; B7 on a CUDA tensor, over ``sell = (sell_start, sell_src)``,
    the shard's sliced lists of ``in_idx`` (``ShardArrays``'; required
    there), at the block shape ``rows`` x ``threads`` (validated on both:
    :func:`check_block`)."""
    global plain_calls
    _check_branches(max_branches)
    mloc, H = configs.shape[-1], halo.shape[-1]
    check_block("B7", rows, threads, max_branches, width=mloc + H)
    zero = torch.full((1,), mloc + H, dtype=torch.int32,
                      device=configs.device)
    args = (configs.contiguous(), stride.contiguous(), choices.contiguous(),
            psi.contiguous(), tab.contiguous())
    if configs.device.type == "cpu":
        plain_calls += 1
        return snp_step_sparse_ref(*args, in_idx, zero,
                                   halo=halo.contiguous(),
                                   max_branches=max_branches)[0]
    if sell is None:
        raise ValueError("B7 walks the shard's sliced lists (sell_start, "
                         "sell_src); this shard carries none (a hand-built "
                         "lowering)")
    return snp_step_sparse_cuda(*args, sell[0], sell[1], zero,
                                halo=halo.contiguous(),
                                max_branches=max_branches, rows=rows,
                                threads=threads)[0]


def snp_step_sparse(configs: torch.Tensor, comp: CompiledSparseSNP, *,
                    max_branches: int, rows=None, threads=None):
    """Fused sparse successor expansion of ``configs`` (B, m), or (B, 3m)
    state rows for a delayed encoding: ``(successors (B,T,m|3m) int32,
    valid (B,T) bool, emissions (B,T) int32, overflow (B,) bool)``,
    bit-identical to the sparse semantics of ``comp``'s tier, pure-ELL and
    hybrid encodings alike, at the block shape ``rows`` x ``threads``
    (validated on a CPU tensor too: :func:`check_block`)."""
    global plain_calls
    if configs.dim() != 2:
        raise ValueError(
            f"configs must be (B, m), got {tuple(configs.shape)}")
    _check_branches(max_branches)
    if configs.device.type == "cpu":
        check_block("the sliced-list kernel", rows, threads, max_branches,
                    width=comp.num_neurons)
        plain_calls += 1
        return sparse_step(configs, comp, max_branches=max_branches)
    args, extra, info = kernel_inputs(configs, comp, lists=True)
    out, valid, emis = snp_step_sparse_cuda(*args, **extra,
                                            max_branches=max_branches,
                                            rows=rows, threads=threads)
    return (out, valid & info.alive[:, None], emis,
            info.psi > float(max_branches))
