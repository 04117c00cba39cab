"""Wrapper around the hand-written dense SNP step kernel.

:func:`snp_step` does the cheap ``O(B·n)`` branch bookkeeping with the
port's :func:`~repro_torch.core.semantics.branch_info` (applicability,
ranks, radix strides clamped to 2^30), then

* on a CPU tensor runs the plain version
  (:func:`~repro_torch.kernels.snp_step.ref.snp_step_dense_ref`);
* on a CUDA tensor launches ``csrc/snp_step_dense.cu``, or raises.  There
  is no fallback.

and masks ``valid`` with ``alive``.  Its outputs equal
:func:`~repro_torch.core.semantics.next_configs` on valid entries.

Counters (plain integers, reset by callers that measure a run):
``kernel_launches`` counts launches of the kernel, ``plain_calls`` calls
of the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.matrix import CompiledSNP
from ...core.semantics import branch_info, clamp_stride
from ._build import load_library
from .ref import snp_step_dense_ref

__all__ = ["snp_step", "snp_step_dense", "load_kernel", "SOURCE",
           "kernel_launches", "plain_calls"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "snp_step_dense.cu"

kernel_launches = 0
plain_calls = 0


def load_kernel():
    """Build (at first use) and load the kernel's shared library."""
    lib = load_library(SOURCE)
    fn = lib.snp_step_dense
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


_INPUTS = (("configs", torch.int32, 2), ("rank", torch.int32, 2),
           ("app", torch.bool, 2), ("stride", torch.int32, 2),
           ("choices", torch.int32, 2), ("psi", torch.float32, 1),
           ("rule_neuron", torch.int32, 1), ("M", torch.int32, 2),
           ("env", torch.int32, 1))


def snp_step_dense(configs, rank, app, stride, choices, psi, rule_neuron,
                   M, env, max_branches: int):
    """Launch the kernel on CUDA tensors: ``(out (B,T,m) int32, valid (B,T)
    bool, emis (B,T) int32)``, same contract as the plain version."""
    global kernel_launches
    args = (configs, rank, app, stride, choices, psi, rule_neuron, M, env)
    dev = configs.device
    for (name, dtype, ndim), x in zip(_INPUTS, args):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {x.device}")
        if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    B, m = configs.shape
    n = rule_neuron.shape[0]
    T = int(max_branches)
    shapes = {"rank": (B, n), "app": (B, n), "stride": (B, m),
              "choices": (B, m), "psi": (B,), "M": (n, m), "env": (n,)}
    for (name, _, _), x in zip(_INPUTS[1:], args[1:]):
        want = shapes.get(name)
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want}")
    if T < 1:
        raise ValueError(f"max_branches must be >= 1, got {T}")
    fn = load_kernel().snp_step_dense
    out = torch.empty((B, T, m), dtype=torch.int32, device=dev)
    valid = torch.empty((B, T), dtype=torch.bool, device=dev)
    emis = torch.empty((B, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in args), out.data_ptr(),
                valid.data_ptr(), emis.data_ptr(), B, T, n, m, stream)
    if rc != 0:
        raise RuntimeError(f"snp_step_dense launch failed: CUDA error {rc}")
    kernel_launches += 1
    return out, valid, emis


def snp_step(configs: torch.Tensor, comp: CompiledSNP, *,
             max_branches: int):
    """Fused successor expansion of ``configs`` (B, m): ``(successors
    (B,T,m) int32, valid (B,T) bool, emissions (B,T) int32, overflow (B,)
    bool)``, bit-identical to the reference semantics on valid entries
    for spike counts < 2^24."""
    global plain_calls
    if configs.dim() != 2:
        raise ValueError(f"configs must be (B, m), got {tuple(configs.shape)}")
    info = branch_info(configs, comp)
    args = (configs.contiguous(), info.rank, info.app,
            clamp_stride(info.stride), info.choices, info.psi.contiguous(),
            comp.rule_neuron, comp.M, comp.env_produce)
    if configs.device.type == "cpu":
        plain_calls += 1
        out, valid, emis = snp_step_dense_ref(*args, max_branches)
    else:
        out, valid, emis = snp_step_dense(*args, max_branches)
    return (out, valid & info.alive.unsqueeze(-1), emis,
            info.psi > float(max_branches))
