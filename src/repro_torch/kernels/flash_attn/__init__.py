"""Flash attention: kernel B8 (``csrc/flash_attn_fwd.cu``, hand-written
CUDA C++ for sm_90a) with its wrapper :mod:`.ops` and plain version
:mod:`.ref`, and the memory-light chunked attention of training
(:mod:`.chunked`, plain torch with a chunked backward, as the reference's
is pure JAX)."""

from .chunked import chunked_attention
from .ops import flash_attention, flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_cuda", "attention_ref",
           "chunked_attention"]
