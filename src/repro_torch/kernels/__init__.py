"""Hand-written CUDA kernels of the port, each beside its plain version:
:mod:`.snp_step` (the SNP step kernels B1–B7), :mod:`.hashtable` (the
hash-table probe kernels H1 and H2) and :mod:`.flash_attn` (the forward
attention kernel B8); :mod:`.launch_counts` holds the counters B1-B7, H1
and H2 add on the card each time they run.

Sources live under ``<kernel>/csrc/`` and are built by ``nvcc`` at first
use (:mod:`repro_torch.kernels.snp_step._build`, which both packages
share); nothing here needs CUDA to import.
"""
