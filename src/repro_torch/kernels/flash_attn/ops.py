"""Wrapper of kernel B8, the forward flash-attention kernel.

:func:`flash_attention` is the counterpart of the JAX package's
``kernels/flash_attn/ops.py::flash_attention``:

* it clips ``kv_len`` to ``min(kv_len, Skv)``;
* on a CUDA tensor it launches ``csrc/flash_attn_fwd.cu`` (B8) on the
  unpadded inputs (the kernel masks its ragged edge: TMA reads rows past
  ``S`` as zeros, ``kv_len`` and the causal mask cover them); on a CPU
  tensor it pads ``Sq``/``Skv`` to multiples of ``min(block, S)`` as the
  reference does (padding keys are masked through ``kv_len``, padding
  queries sliced off) and runs the plain version
  (:func:`.ref.attention_ref`); the two agree, since padding keys are
  masked and padding queries are dropped.  There is no fallback;
* it is the custom operator ``torch.ops.repro_torch.flash_attn_fwd``
  (``torch.library.custom_op``), whose backward recomputes the plain
  attention, as the reference's ``custom_vjp`` does (there is no
  backward kernel in either package); its fake implementation gives the
  output's shape without a launch (the dry run's fake tensors), and its
  FLOP formula (``torch.utils.flop_counter``, causal: half of
  ``4·B·Hq·Sq·Skv·D``) lets ``FlopCounterMode`` and the roofline's
  counter count it on the card.

B8 has two bodies, picked by type and head dim inside the kernel's entry
point (:func:`uses_tensor_cores`), both on the tensor cores: bf16 at D in
{64, 128} runs the wgmma body fed by TMA; f32 at every head dim and bf16
at D in {16, 32} run the split-TF32 body (``mma.sync`` on TF32, every f32
operand split in a hi and a lo term, three products a step, so that f32
inputs keep f32 accuracy).  Counters (plain integers, reset by callers
that measure a run): ``kernel_launches_tc`` counts launches of the wgmma
body, ``kernel_launches`` of the split-TF32 body, ``plain_calls`` calls
of the plain version through this wrapper.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ..real import require_real
from ..snp_step._build import load_library
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_cuda", "load_kernel",
           "uses_tensor_cores", "SOURCE", "HEAD_DIMS", "kernel_launches",
           "kernel_launches_tc", "plain_calls"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn_fwd.cu"

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the split-TF32 body (f32; bf16 at D 16/32)
kernel_launches = 0
#: launches of the wgmma body (bf16 at D 64/128)
kernel_launches_tc = 0
#: calls of the plain version through :func:`flash_attention`
plain_calls = 0


def load_kernel():
    """Build (at first use) and load B8's shared library."""
    lib = load_library(SOURCE)
    fn = lib.flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    body = lib.flash_attn_fwd_tensor_cores
    body.argtypes = [ctypes.c_int, ctypes.c_int]
    body.restype = ctypes.c_int
    return lib


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether B8 runs its wgmma body (bf16 at D 64/128) for this type and
    head dim, rather than its split-TF32 body (the kernel's entry point
    decides; this asks it)."""
    return bool(load_kernel().flash_attn_fwd_tensor_cores(
        head_dim, _DTYPES[dtype]))


def flash_attention_cuda(q, k, v, kv_len, *, causal: bool = True):
    """Launch B8 on CUDA tensors: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
    contiguous, f32 or bf16; ``kv_len`` (B,) int32 with values at most
    ``Skv``.  Returns o (B, Hq, Sq, D) in q's dtype."""
    global kernel_launches, kernel_launches_tc
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {dev}")
    require_real("flash_attention_cuda", q, k, v, kv_len)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    for name, x, shape in (("q", q, (B, Hq, Sq, D)),
                           ("k", k, (B, Hkv, Skv, D)),
                           ("v", v, (B, Hkv, Skv, D))):
        if x.device != dev or x.dtype not in _DTYPES \
                or x.dtype != q.dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {q.dtype} tensor of shape "
                f"{shape} on {dev} (f32 or bf16), got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if kv_len.device != dev or kv_len.dtype != torch.int32 \
            or tuple(kv_len.shape) != (B,) or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be a contiguous int32 tensor of shape "
                         f"({B},) on {dev}, got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs q heads divisible by kv heads, got "
                         f"{Hq} and {Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if Hq > 65535 or B > 65535:
        raise ValueError(f"the grid takes at most 65535 heads and batch "
                         f"rows, got {Hq} and {B}")
    out = torch.empty_like(q)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, int(causal),
            _DTYPES[q.dtype], 1.0 / (D ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {rc}")
    if uses_tensor_cores(q.dtype, D):
        kernel_launches_tc += 1
    else:
        kernel_launches += 1
    return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _forward(q, k, v, kv_len, causal, block_q, block_k):
    global plain_calls
    Sq, Skv = q.shape[2], k.shape[2]
    kl = kv_len.to(device=q.device, dtype=torch.int32).clamp(max=Skv)
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), kl.contiguous(),
                                    causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA (kernel B8) or CPU "
                         f"(its plain version) tensors, got {q.device}")
    Sq_p = _round_up(Sq, min(block_q, Sq)) if Sq else 0
    Skv_p = _round_up(Skv, min(block_k, Skv)) if Skv else 0
    qp = F.pad(q, (0, 0, 0, Sq_p - Sq))
    kp = F.pad(k, (0, 0, 0, Skv_p - Skv))
    vp = F.pad(v, (0, 0, 0, Skv_p - Skv))
    plain_calls += 1
    return attention_ref(qp, kp, vp, kl, causal=causal)[:, :, :Sq]


@torch.library.custom_op("repro_torch::flash_attn_fwd", mutates_args=())
def _flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor, causal: bool, block_q: int,
                    block_k: int) -> torch.Tensor:
    """B8 as a custom operator (so dispatch modes see one op, not a ctypes
    call): on a CUDA tensor the kernel, on a CPU tensor its plain
    version (:func:`_forward`)."""
    return _forward(q, k, v, kv_len, causal, block_q, block_k)


@_flash_attn_fwd.register_fake
def _(q, k, v, kv_len, causal, block_q, block_k):
    # shapes only (the dry run's tensors launch nothing), contiguous as
    # both routes return it
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, kv_len, causal, _, _ = inputs
    ctx.save_for_backward(q, k, v, kv_len)
    ctx.causal = causal


def _backward(ctx, g):
    """The gradient of the plain attention, recomputed (neither package
    has a backward kernel)."""
    q, k, v, kv_len = ctx.saved_tensors
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*qkv, kv_len, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, qkv, g)
    return dq, dk, dv, None, None, None, None


_flash_attn_fwd.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.flash_attn_fwd)
def _flash_attn_flop(q_shape, k_shape, v_shape, kv_len_shape, causal,
                     block_q, block_k, out_shape=None, **kwargs) -> int:
    """B8's FLOPs: the two products ``Q·Kᵀ`` and ``P·V``, 2 each a
    multiply-add, ``4·B·Hq·Sq·Skv·D``; half of it under the causal mask,
    whose upper triangle the kernel skips."""
    B, Hq, Sq, D = q_shape
    flops = 4 * B * Hq * Sq * k_shape[2] * D
    return flops // 2 if causal else flops


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Softmax attention, (B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    ``kv_len`` (B,) masks trailing cache slots (serving); defaults to full.
    ``block_q``/``block_k`` set the CPU route's padding, as in the
    reference; the kernel's own tiles are fixed and mask their ragged
    edge.
    """
    B, Hq = q.shape[:2]
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs q heads divisible by kv heads, got "
                         f"{Hq} and {Hkv}")
    if kv_len is None:
        kv_len = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    return _flash_attn_fwd(q, k, v, kv_len, causal, block_q, block_k)
