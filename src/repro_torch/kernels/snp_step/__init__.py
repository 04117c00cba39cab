"""Dense SNP transition step: the CUDA kernel (``csrc/snp_step_dense.cu``),
its wrapper (:mod:`.ops`) and its plain version (:mod:`.ref`)."""

from .ops import snp_step, snp_step_dense
from .ref import snp_step_dense_ref

__all__ = ["snp_step", "snp_step_dense", "snp_step_dense_ref"]
