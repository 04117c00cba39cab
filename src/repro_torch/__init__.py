"""PyTorch and CUDA port of the SNP-system simulator (``repro``), for one
NVIDIA H100.

It imports ``torch`` and numpy only: never JAX and nothing of ``repro``.
Entry points run on the card (``device=None`` means ``"cuda"``) and raise
when there is none; pass ``device="cpu"`` to run the plain versions on the
CPU.  The SNP simulator lives in :mod:`repro_torch.core` (with
:mod:`repro_torch.sharding`) over the step kernels
:mod:`repro_torch.kernels.snp_step`; LM serving in
:mod:`repro_torch.models`, :mod:`repro_torch.serve` and
:mod:`repro_torch.launch` over the attention kernel
:mod:`repro_torch.kernels.flash_attn`, with the configs and data of
:mod:`repro_torch.configs` and :mod:`repro_torch.data`.
"""

from .core import *  # noqa: F401,F403
from .core import __all__  # noqa: F401
