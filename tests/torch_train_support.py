"""Helpers of the training parity tests (``test_torch_train_*.py``): the
same weights in both packages and the reference's loss and gradients.

Weights are drawn by the port (``init_params(PRNGKey(0))``, the
reference's values), written in the reference's layout by
``params_tree`` and carried back by ``params_from_jax``, so each test
exercises both directions and no test pays the reference's jitted
initialisation.  Batches are ``make_batch``'s (numpy from a seed)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get
from repro.configs.smoke import reduced as jax_reduced
from repro.data import DataConfig, make_batch
from repro.models import loss_fn as jax_loss
from repro_torch.configs import get_config
from repro_torch.configs.smoke import reduced
from repro_torch.core import prng
from repro_torch.models import (init_params, loss_fn, params_from_jax,
                                params_tree, tensors_from_jax)

B, S = 2, 16
#: f32 parity bound, relative to each tensor's largest magnitude
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@functools.lru_cache(maxsize=None)
def setup(arch, B=B, S=S):
    """(reference config, port config, reference tree of numpy arrays,
    the port's LM carried across from it, a numpy batch)."""
    jc = jax_reduced(jax_get(arch))
    pc = reduced(get_config(arch))
    drawn = init_params(prng.PRNGKey(0), pc, device="cpu")
    tree = numpy_tree(params_tree(drawn, pc))
    pp = params_from_jax(tree, pc, device="cpu")
    batch = make_batch(jc, DataConfig(seed=1), step=0, shard=0, batch=B,
                       seq_len=S)
    return jc, pc, tree, pp, batch


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def reference_grads(jc, tree, batch, attn_impl="xla"):
    """The reference's (loss, metrics, grads) by ``jax.value_and_grad``
    of its ``loss_fn`` (jitted, ``remat="none"``)."""
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss(p, jc, b, attn_impl=attn_impl, remat="none"),
        has_aux=True))
    (loss, metrics), grads = f(jax.tree.map(jnp.asarray, tree),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        jax.tree.map(np.asarray, grads)


def port_grads(pc, pp, batch, attn_impl="cuda", remat="none"):
    """The port's (loss, metrics, f32 grads in parameter order)."""
    pp.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(pp, pc, to_torch(batch), attn_impl=attn_impl,
                            remat=remat)
    loss.backward()
    grads = [torch.zeros(p.shape) if p.grad is None else p.grad.float()
             for p in pp.parameters()]
    pp.zero_grad(set_to_none=True)
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def check_against_reference(arch):
    """``loss_fn``'s value, statistics and every gradient leaf through
    ``attn_impl="cuda"`` (B8's plain version on the CPU) against the
    reference's ``jax.value_and_grad``."""
    from repro_torch.kernels.flash_attn import ops
    jc, pc, tree, pp, batch = setup(arch)
    want_l, want_m, want_g = reference_grads(jc, tree, batch)
    calls = ops.plain_calls
    got_l, got_m, got_g = port_grads(pc, pp, batch)
    assert ops.plain_calls - calls == attention_layers(pc)
    close(got_l, want_l)
    for k, v in want_m.items():
        close(got_m[k], v)
    names = [n for n, _ in pp.named_parameters()]
    want_list = tensors_from_jax(want_g, pc, device="cpu")
    assert len(want_list) == len(got_g) == len(names)
    for name, got, want in zip(names, got_g, want_list):
        assert bool(torch.isfinite(got).all()), name
        try:
            close(got, want)
        except AssertionError as e:
            raise AssertionError(f"{arch}: gradient of {name}") from e


def attention_layers(cfg):
    """Layers whose forward goes to B8 under ``attn_impl="cuda"``: the
    GQA attention positions (MLA's heads differ here: none)."""
    if cfg.attention == "mla" or "attn" not in cfg.mixer_kinds:
        return 0
    return cfg.num_periods * sum(k == "attn" for k in cfg.mixer_kinds)
