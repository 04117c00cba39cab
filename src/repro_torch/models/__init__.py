"""Language models (the port of the JAX package's ``repro.models``): every
family's backbone (:mod:`.layers` with GQA and MLA attention, :mod:`.moe`,
:mod:`.mamba`, :mod:`.rwkv`, assembled by :mod:`.transformer`), the public
API of :mod:`.model` (serving and the training loss), and :mod:`.convert`
to carry the reference's weights and training state across and back."""

from .convert import params_from_jax, params_tree, tensors_from_jax, \
    train_state_from_jax
from .model import LM, forward, init_cache, init_params, loss_fn, \
    param_count

__all__ = ["LM", "init_params", "forward", "init_cache", "loss_fn",
           "param_count", "params_from_jax", "params_tree",
           "tensors_from_jax", "train_state_from_jax"]
