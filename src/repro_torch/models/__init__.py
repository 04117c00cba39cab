"""Language models (the port of the JAX package's ``repro.models``): every
family's backbone (:mod:`.layers` with GQA and MLA attention, :mod:`.moe`,
:mod:`.mamba`, :mod:`.rwkv`, assembled by :mod:`.transformer`), the public
API of :mod:`.model`, and :func:`.convert.params_from_jax` to carry the
reference's weights across."""

from .convert import params_from_jax
from .model import LM, forward, init_cache, init_params, param_count

__all__ = ["LM", "init_params", "forward", "init_cache", "param_count",
           "params_from_jax"]
