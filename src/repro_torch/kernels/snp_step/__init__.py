"""SNP transition step kernels, each beside its wrapper and plain version:

* dense: ``csrc/snp_step_dense.cu``, :mod:`.ops`, :mod:`.ref`;
* sparse (ELL, and the COO stage for hybrid encodings):
  ``csrc/snp_step_sparse.cu``, :mod:`.sparse_ops`, :mod:`.sparse_ref`.
"""

from .ops import snp_step, snp_step_dense
from .ref import snp_step_dense_ref
from .sparse_ops import snp_step_sparse, snp_step_sparse_cuda
from .sparse_ref import snp_step_sparse_ref

__all__ = ["snp_step", "snp_step_dense", "snp_step_dense_ref",
           "snp_step_sparse", "snp_step_sparse_cuda", "snp_step_sparse_ref"]
