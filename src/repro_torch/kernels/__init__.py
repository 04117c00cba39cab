"""Hand-written CUDA kernels of the port, each beside its plain version:
:mod:`.snp_step` (the SNP step kernels B1–B7) and :mod:`.flash_attn`
(the forward attention kernel B8).

Sources live under ``<kernel>/csrc/`` and are built by ``nvcc`` at first
use (:mod:`repro_torch.kernels.snp_step._build`, which both packages
share); nothing here needs CUDA to import.
"""
