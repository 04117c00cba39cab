"""Wrapper around the hand-written sparse SNP step kernel.

:func:`snp_step_sparse` runs the cheap ``O(B·m·R)`` per-config
bookkeeping (:func:`~.sparse_ref.kernel_inputs`), then

* on a CPU tensor the plain version
  (:func:`~.sparse_ref.snp_step_sparse_ref`);
* on a CUDA tensor ``csrc/snp_step_sparse.cu`` — its ELL kernel (B2), or
  its hybrid kernel (B3) for a hybrid encoding, which walks the
  encoding's sliced in-lists and hub neurons in place of ``in_idx`` and
  ``hub_slot`` (an encoding without them is refused); for a delayed
  encoding the same kernels with the delay stage (B5) — or it raises.
  There is no fallback.

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
:mod:`repro_torch.core.distributed`): the plain version with its
``halo`` on a CPU tensor, the kernel's shard body (B7) on a CUDA tensor.

Counters (plain integers, reset by callers that measure a run):
``kernel_launches`` counts launches of the kernel, ``coo_launches`` those
of them that ran the COO stage, ``delay_launches`` those that ran the
delay stage, ``delay_coo_launches`` those that ran both and
``halo_launches`` those of the shard body; ``plain_calls`` counts calls
of the plain version.  :func:`body_counts` splits the launches by body.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.matrix import CompiledSparseSNP
from ._build import load_library
from .sparse_ref import kernel_inputs, snp_step_sparse_ref, sparse_step

__all__ = ["snp_step_sparse", "snp_step_sparse_cuda",
           "snp_step_sparse_shard", "load_kernel", "max_neurons", "SOURCE",
           "MAX_BRANCHES", "kernel_launches", "coo_launches",
           "delay_launches", "delay_coo_launches", "halo_launches",
           "plain_calls", "body_counts"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "snp_step_sparse.cu"

# The f32 decode is exact only below this many branches
# (sparse_ref.decode_digits).
MAX_BRANCHES = 1 << 23

kernel_launches = 0
coo_launches = 0
delay_launches = 0
delay_coo_launches = 0
halo_launches = 0
plain_calls = 0


def body_counts():
    """Launches per body since the counters were last set to 0: ``ell``
    (B2), ``coo`` (B3), ``ell_delay`` and ``coo_delay`` (B5), ``halo``
    (B7)."""
    return {"ell": kernel_launches - coo_launches - delay_launches
            + delay_coo_launches - halo_launches,
            "coo": coo_launches - delay_coo_launches,
            "ell_delay": delay_launches - delay_coo_launches,
            "coo_delay": delay_coo_launches,
            "halo": halo_launches}


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    lib = load_library(SOURCE)
    fn = lib.snp_step_sparse
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.snp_step_sparse_max_neurons.argtypes = []
    lib.snp_step_sparse_max_neurons.restype = ctypes.c_int
    return lib


def max_neurons() -> int:
    """The largest system (neurons; for a shard, its neurons plus its halo
    slots) the kernel takes: one row of fired produce must fit a block's
    shared memory."""
    return int(load_kernel().snp_step_sparse_max_neurons())


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


def snp_step_sparse_cuda(configs, stride, choices, psi, tab, in_idx,
                         out_neuron, coo_src=None, coo_bounds=None,
                         hub_neuron=None, dtab=None, cd=None, pd=None,
                         halo=None, *, sell_start=None, sell_src=None,
                         max_branches: int):
    """Launch the kernel on CUDA tensors: ``(out (B,T,m) int32, valid
    (B,T) bool, emis (B,T) int32)``, the plain version's contract.
    ``in_idx`` (m, Kin) is the ELL and shard bodies' in-adjacency.
    ``coo_src``/``coo_bounds``/``hub_neuron`` (all or none) select the COO
    body (B3, B5 COO), which walks the sliced lists ``sell_start``/
    ``sell_src`` in place of ``in_idx`` (then ``None``) and ``hub_neuron``
    in place of the plain version's ``hub_slot``
    (``sparse_ref.kernel_inputs(..., lists=True)``).
    ``dtab``/``cd``/``pd`` (all or none) select the delay
    stage, whose rows are ``3m`` wide, ``halo`` (B, T, H) the shard body
    (with neither of the other two; its entries are fired produce, below
    2^16).  The shapes are checked here; list entries out of range are
    skipped by the kernel (no host read)."""
    global kernel_launches, coo_launches, delay_launches, delay_coo_launches
    global halo_launches
    dev = configs.device
    B, m = configs.shape
    R = tab.shape[-1]
    T = int(max_branches)
    has_coo = coo_src is not None
    if has_coo != (coo_bounds is not None) or has_coo != (hub_neuron
                                                         is not None):
        raise ValueError("coo_src, coo_bounds and hub_neuron come together")
    has_delay = dtab is not None
    if has_delay != (cd is not None) or has_delay != (pd is not None):
        raise ValueError("dtab, cd and pd come together")
    has_halo = halo is not None
    if has_halo and (has_coo or has_delay):
        raise ValueError("the shard body (halo) has neither a COO nor a "
                         "delay stage")
    if has_coo != (sell_start is not None) or has_coo != (
            sell_src is not None) or has_coo != (in_idx is None):
        raise ValueError(
            "the COO body walks the sliced lists (sell_start, sell_src) in "
            "place of in_idx" if has_coo else
            "the ELL and shard bodies walk in_idx; the sliced lists "
            "(sell_start, sell_src) come with the COO tail (coo_src, "
            "coo_bounds, hub_neuron)")
    Hn = coo_bounds.shape[0] - 1 if has_coo else 0
    H = halo.shape[-1] if has_halo else 0
    i32, f32 = torch.int32, torch.float32
    checks = [("configs", configs, i32, (B, m)),
              ("stride", stride, f32, (B, m)),
              ("choices", choices, i32, (B, m)), ("psi", psi, f32, (B,)),
              ("tab", tab, i32, (B, m, R)),
              ("out_neuron", out_neuron, i32, (1,))]
    if has_coo:
        Kin, E = 0, sell_src.shape[0]
        checks += [("sell_start", sell_start, i32, (-(-m // 32) + 1,)),
                   ("sell_src", sell_src, i32, (E,)),
                   ("coo_src", coo_src, i32, (coo_src.shape[0],)),
                   ("coo_bounds", coo_bounds, i32, (Hn + 1,)),
                   ("hub_neuron", hub_neuron, i32, (Hn,))]
    else:
        Kin, E = in_idx.shape[-1], 0
        checks += [("in_idx", in_idx, i32, (m, Kin))]
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
    lib = load_kernel()
    if m + H > max_neurons():
        raise ValueError(
            f"the sparse step kernel takes at most {max_neurons()} neurons "
            f"and halo slots (one row of fired produce per block in shared "
            f"memory), got m={m}" + (f" and {H} halo slots" if H else ""))
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
            configs, stride, choices, psi, tab, in_idx, sell_start, sell_src,
            out_neuron, coo_src, coo_bounds, hub_neuron, dtab, cd, pd, halo,
            out, valid, emis))
        rc = lib.snp_step_sparse(*ptrs, B, T, m, R, Kin, E, Ec, Hn, H,
                                 int(has_coo), int(has_delay), int(has_halo),
                                 stream)
    if rc != 0:
        raise RuntimeError(f"snp_step_sparse launch failed: CUDA error {rc}")
    kernel_launches += 1
    coo_launches += int(has_coo)
    delay_launches += int(has_delay)
    delay_coo_launches += int(has_coo and has_delay)
    halo_launches += int(has_halo)
    return out, valid, emis


def snp_step_sparse_shard(configs: torch.Tensor, stride: torch.Tensor,
                          choices: torch.Tensor, psi: torch.Tensor,
                          tab: torch.Tensor, in_idx: torch.Tensor,
                          halo: torch.Tensor, *,
                          max_branches: int) -> torch.Tensor:
    """One shard's candidate slices ``(B, T, mloc)``: the local slice
    ``configs`` minus the fired consume plus the produce gathered over
    ``in_idx`` in the extended space ``[local | halo | zero]``, with the
    cross-shard float32 ``stride``, the local ``choices`` and packed table
    ``tab`` (B, mloc, R), and ``halo`` (B, T, S·Hmax) the exchanged remote
    produce.  The emission index is the zero slot (the sharded explore
    judges emissions).  The plain version on a CPU tensor, B7 on a CUDA tensor."""
    global plain_calls
    _check_branches(max_branches)
    mloc, H = configs.shape[-1], halo.shape[-1]
    zero = torch.full((1,), mloc + H, dtype=torch.int32,
                      device=configs.device)
    args = (configs.contiguous(), stride.contiguous(), choices.contiguous(),
            psi.contiguous(), tab.contiguous(), in_idx, zero)
    if configs.device.type == "cpu":
        plain_calls += 1
        launch = snp_step_sparse_ref
    else:
        launch = snp_step_sparse_cuda
    return launch(*args, halo=halo.contiguous(),
                  max_branches=max_branches)[0]


def snp_step_sparse(configs: torch.Tensor, comp: CompiledSparseSNP, *,
                    max_branches: int):
    """Fused sparse successor expansion of ``configs`` (B, m), or (B, 3m)
    state rows for a delayed encoding: ``(successors (B,T,m|3m) int32,
    valid (B,T) bool, emissions (B,T) int32, overflow (B,) bool)``,
    bit-identical to the sparse semantics of ``comp``'s tier, pure-ELL and
    hybrid encodings alike."""
    global plain_calls
    if configs.dim() != 2:
        raise ValueError(
            f"configs must be (B, m), got {tuple(configs.shape)}")
    _check_branches(max_branches)
    if configs.device.type == "cpu":
        plain_calls += 1
        return sparse_step(configs, comp, max_branches=max_branches)
    args, extra, info = kernel_inputs(configs, comp, lists=True)
    out, valid, emis = snp_step_sparse_cuda(*args, **extra,
                                            max_branches=max_branches)
    return (out, valid & info.alive[:, None], emis,
            info.psi > float(max_branches))
