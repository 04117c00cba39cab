"""The training loss of the port (``repro_torch.models.loss_fn``) against
the JAX package's, part one: jamba's Mamba/MoE hybrid (whose reference
gradient alone takes about 20 s to compile), at its reduced f32
sibling.  The loss, its statistics and
every gradient leaf equal ``jax.value_and_grad`` of the reference's
``loss_fn`` within 1e-4 of each tensor's largest magnitude (f32), the
port's attention through B8's wrapper (its plain version on the CPU),
the reference's through ``"xla"``.

Also here, port against port: remat ``"full"`` and ``"dots"`` leave the
loss, the MoE statistics and every gradient as ``"none"`` gives them,
and run each attention's forward twice (the recompute: on the card, 64
B8 launches a SmolLM-360M step); the attention implementations
``"cuda"``, ``"ref"`` and ``"chunked"`` give the same gradients."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_train_support import (attention_layers,  # noqa: E402,F401
                                 check_against_reference, close,
                                 one_thread, port_grads, setup)

ARCHS = ["jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_equal_the_reference(arch):
    check_against_reference(arch)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_remat_changes_no_number(arch, remat):
    from repro_torch.kernels.flash_attn import ops
    _, pc, _, pp, batch = setup(arch)
    want_l, want_m, want_g = port_grads(pc, pp, batch, remat="none")
    calls = ops.plain_calls
    got_l, got_m, got_g = port_grads(pc, pp, batch, remat=remat)
    assert ops.plain_calls - calls == 2 * attention_layers(pc)
    assert got_l == want_l and got_m == want_m
    for got, want in zip(got_g, want_g):
        close(got, want.numpy(), 1e-6)


@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_attention_impls_give_the_same_gradients(impl):
    _, pc, _, pp, batch = setup("smollm-360m")
    want_l, _, want_g = port_grads(pc, pp, batch, attn_impl="cuda")
    got_l, _, got_g = port_grads(pc, pp, batch, attn_impl=impl)
    close(got_l, want_l, 1e-6)
    for got, want in zip(got_g, want_g):
        close(got, want.numpy(), 2e-5)
