"""SNP transition step kernels, each beside its wrapper and plain version:

* dense: ``csrc/snp_step_dense.cu`` (B1, and its shard body B6) and, for
  delayed encodings, ``csrc/snp_step_dense_delay.cu`` (B4); :mod:`.ops`,
  :mod:`.ref`;
* sparse (ELL, the COO stage for hybrid encodings, the delay stage for
  delayed ones and the halo for a neuron shard: B2, B3, B5, B7):
  ``csrc/snp_step_sparse.cu``, :mod:`.sparse_ops`, :mod:`.sparse_ref`.
"""

from .ops import (snp_step, snp_step_dense, snp_step_dense_delay,
                  snp_step_dense_shard)
from .ref import (snp_step_dense_delay_ref, snp_step_dense_ref,
                  snp_step_dense_shard_ref, snp_step_ref)
from .sparse_ops import (snp_step_sparse, snp_step_sparse_cuda,
                         snp_step_sparse_shard)
from .sparse_ref import snp_step_sparse_ref

__all__ = ["snp_step", "snp_step_dense", "snp_step_dense_ref",
           "snp_step_dense_delay", "snp_step_dense_delay_ref",
           "snp_step_dense_shard", "snp_step_dense_shard_ref", "snp_step_ref",
           "snp_step_sparse", "snp_step_sparse_cuda", "snp_step_sparse_ref",
           "snp_step_sparse_shard"]
