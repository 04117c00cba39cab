"""PyTorch and CUDA port of the SNP-system simulator (``repro``), for one
NVIDIA H100.

It imports ``torch`` and numpy only: never JAX and nothing of ``repro``.
Entry points run on the card (``device=None`` means ``"cuda"``) and raise
when there is none; pass ``device="cpu"`` to run the plain versions on the
CPU.  So far the port covers the paper's §5 path and large systems with
random traces: :mod:`repro_torch.core` and the dense and sparse step
kernels :mod:`repro_torch.kernels.snp_step`.
"""

from .core import *  # noqa: F401,F403
from .core import __all__  # noqa: F401
