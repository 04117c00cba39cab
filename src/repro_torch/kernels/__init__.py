"""Hand-written CUDA kernels of the port, each beside its plain version.

Sources live under ``<kernel>/csrc/`` and are built by ``nvcc`` at first
use (:mod:`repro_torch.kernels.snp_step._build`); nothing here needs CUDA
to import.
"""
