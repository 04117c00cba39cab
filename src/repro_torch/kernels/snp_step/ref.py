"""Plain PyTorch version of the dense step kernel.

Takes exactly the kernel's inputs (the branch bookkeeping already done)
and computes its three outputs with the reference semantics' own decode
and transition (:mod:`repro_torch.core.semantics`), so the kernel is held
against the math the rest of the port runs on.  The wrapper uses it for
tensors on the CPU; ``chip_smoke.py`` compares the kernel with it on the
card.
"""

from __future__ import annotations

import torch

from ...core.semantics import decode_spiking, transition

__all__ = ["snp_step_dense_ref"]


def snp_step_dense_ref(configs, rank, app, stride, choices, psi,
                       rule_neuron, M, env, max_branches: int):
    """``(out (B,T,m) int32, valid (B,T) bool, emis (B,T) int32)`` with
    ``out = C + S·M``, ``emis = S·env`` and ``valid = t < psi``, for every
    branch ``t < max_branches`` (``valid`` is not masked by ``alive``)."""
    S = decode_spiking(app, rank, stride, choices, rule_neuron, max_branches)
    out, emis = transition(configs, S, M, env)
    t = torch.arange(max_branches, device=configs.device).to(torch.float32)
    return out, t < psi.unsqueeze(-1), emis
