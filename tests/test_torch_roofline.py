"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline`` on the same inputs: the terms at H100 rates, the ring
factors of each collective, the step counter's FLOPs of a plain matmul,
of loops and of checkpointed gradients (the twins of
``tests/test_roofline.py``'s HLO-analyzer tests, where the reference's
``analyze_hlo`` of the JAX versions gives the same counts), the
per-device share of a DTensor product on a (16, 16) mesh of the
``"fake"`` process group, and the reduced SmolLM train step, qwen2-moe
prefill and rwkv6 decode step against ``analyze_hlo`` of the reference's
jitted steps.

The collectives: the all-gather, all-reduce and reduce-scatter are
DTensor redistributions; the all-to-all and the permute are functional
collectives over one mesh dim's group (DTensor's ``Shard(0)`` to
``Shard(1)`` goes through an all-gather on this torch, and it has no
permute).  The reduced qwen2-moe prefill counts the reference's MoE
dispatch and combine (one-hot einsums, dots to XLA) that the port does
by gathers and scatters: the port's FLOPs plus those einsums' are within
2% of the reference's (the rest, 0.65%, are the reference's routing
dots on one-hot masks)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.roofline.analysis as RA  # noqa: E402
from repro.roofline.hlo_analyzer import analyze_hlo  # noqa: E402
from repro_torch.roofline import (HW, StepCounter, collective_stats,  # noqa
                                  roofline_terms)
from repro_torch.roofline.attribution import (attribute_bytes,  # noqa: E402
                                              attribute_flops, top_table)


@pytest.fixture
def fake_mesh():
    """A (16, 16) CPU mesh over the ``"fake"`` group of 256 ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.runtime import build_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield build_mesh((16, 16), device_type="cpu")
    finally:
        dist.destroy_process_group()


# -- terms -------------------------------------------------------------------

TERMS_CASES = [
    (989e12, 0, 0, 1, None), (0, 3.35e12, 0, 1, None),
    (0, 0, 450e9, 1, None), (2e12, 5e11, 7e9, 4, 6e12),
    (1.5e15, 2.2e12, 3.1e10, 256, 4.4e17), (3e9, 1e12, 0, 512, 1e12),
]


@pytest.mark.parametrize("case", TERMS_CASES)
def test_roofline_terms_equal_the_reference_at_h100_rates(monkeypatch,
                                                          case):
    # the reference's HW swapped to the port's rates: bf16, one link class
    monkeypatch.setitem(RA.HW, "flops", HW["flops"]["bfloat16"])
    monkeypatch.setitem(RA.HW, "hbm", HW["hbm"])
    monkeypatch.setitem(RA.HW, "ici", HW["nvlink"])
    want = RA.roofline_terms(*case)
    got = roofline_terms(*case)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_terms_by_dtype_and_link_class():
    t = roofline_terms({"bfloat16": 989e12, "float32": 67e12}, 0,
                       {"nvlink": 450e9, "ib": 50e9}, chips=8)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["memory_s"] == 0 and t["bound"] == "compute"
    t = roofline_terms(0, 3.35e12 * 3, {"ib": 50e9}, chips=1)
    assert t["memory_s"] == pytest.approx(3.0) and t["bound"] == "memory"


def test_roofline_useful_flops_ratio():
    t = roofline_terms(flops=2e12, hbm_bytes=0, link_bytes=0, chips=4,
                       model_flops=6e12)
    assert abs(t["useful_flops_frac"] - (6e12 / 4) / 2e12) < 1e-9


# -- collectives -------------------------------------------------------------

def _counted(fn):
    with StepCounter() as c:
        fn()
    assert len(c.details) == 1, c.details
    return c.details[0]


def test_ring_factors_equal_parse_collectives(fake_mesh):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, group = fake_mesh, fake_mesh.get_group(1)

    def dt(shape, placement, dtype=torch.float32):
        return DTensor.from_local(torch.empty(shape, dtype=dtype,
                                              device="meta"), mesh,
                                  [Replicate(), placement], run_check=False)

    x = dt((256, 1024), Shard(0))
    p = dt((256, 1024), Partial())
    cases = {
        "all-gather": (lambda: x.redistribute(mesh, [Replicate()] * 2),
                       "f32[4096,1024]", "replica_groups=[16,16]<=[256], "
                       "dimensions={0}"),
        "all-reduce": (lambda: p.redistribute(mesh, [Replicate()] * 2),
                       "f32[256,1024]", "replica_groups=[16,16]<=[256], "
                       "to_apply=%add"),
        "reduce-scatter": (lambda: p.redistribute(
            mesh, [Replicate(), Shard(0)]), "f32[256,1024]",
            "replica_groups=[16,16]<=[256], dimensions={0}"),
        "all-to-all": (lambda: funcol.all_to_all_single(
            torch.empty(64, 32, device="meta"), None, None, group),
            "f32[64,32]", "replica_groups=[16,16]<=[256]"),
        "collective-permute": (lambda: funcol.permute_tensor(
            torch.empty(8, 128, dtype=torch.bfloat16, device="meta"),
            [(i + 1) % 16 for i in range(16)], group), "bf16[8,128]",
            "source_target_pairs={{0,1}}"),
    }
    for kind, (fn, shape, attrs) in cases.items():
        detail = _counted(fn)
        assert detail[0] == kind and detail[2] == 16, detail
        line = f"  %c = {shape}{{1,0}} {kind}(%p0), {attrs}"
        want = RA.parse_collectives(line, default_group=256)
        assert want.counts[kind] == 1
        got = collective_stats([detail])
        assert got.counts == want.counts, kind
        assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
        assert got.tensor_bytes[kind] == want.tensor_bytes[kind], kind


# -- the counter against the HLO analyzer ------------------------------------

M = 128
ONE = 2 * M ** 3


def _port_flops(fn, *args):
    with StepCounter() as c:
        fn(*args)
    return c.flops


def _ref_flops(fn, *avals):
    return analyze_hlo(jax.jit(fn).lower(*avals).compile().as_text()).flops


def test_counter_plain_matmul():
    a = jax.ShapeDtypeStruct((2 * M, 2 * M), jnp.float32)
    want = 2 * (2 * M) ** 3
    x = torch.empty(2 * M, 2 * M, device="meta")
    got = _port_flops(lambda x, w: x @ w, x, x)
    ref = _ref_flops(lambda x, w: x @ w, a, a)
    assert abs(got - want) / want < 0.01
    assert abs(ref - want) / want < 0.01


def test_counter_counts_loop_trips_nesting_and_remat():
    from torch.utils.checkpoint import checkpoint
    a = jax.ShapeDtypeStruct((M, M), jnp.float32)
    x = torch.randn(M, M)
    w = torch.randn(M, M)

    def f9(x, w):
        for _ in range(9):
            x = x @ w
        return x

    def j9(x, w):
        return jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                            length=9)[0]

    assert abs(_port_flops(f9, x, w) - 9 * ONE) / (9 * ONE) < 0.01
    assert abs(_ref_flops(j9, a, a) - 9 * ONE) / (9 * ONE) < 0.01

    def nested(x, w):
        x = x @ w
        for _ in range(4):
            for _ in range(5):
                x = x @ w
        return x

    def jnested(x, w):
        def inner(c, _):
            return jax.lax.scan(lambda d, _: (d @ w, None), c, None,
                                length=5)[0], None
        return jax.lax.scan(inner, x @ w, None, length=4)[0]

    assert abs(_port_flops(nested, x, w) - 21 * ONE) / (21 * ONE) < 0.01
    assert abs(_ref_flops(jnested, a, a) - 21 * ONE) / (21 * ONE) < 0.01

    def loss(x, w):
        for _ in range(8):
            x = checkpoint(lambda c: torch.tanh(c @ w), x,
                           use_reentrant=False)
        return (x ** 2).sum()

    def jloss(x, w):
        body = jax.checkpoint(lambda c, _: (jnp.tanh(c @ w), None))
        out, _ = jax.lax.scan(body, x, None, length=8)
        return (out ** 2).sum()

    wg = w.clone().requires_grad_()
    got = _port_flops(lambda: loss(x, wg).backward())
    # 8 x (fwd + remat recompute + 2 bwd dots) = 32 matmuls (the first
    # layer's input needs no gradient: 31 here)
    assert abs(got - 32 * ONE) / (32 * ONE) < 0.05
    ref = _ref_flops(jax.grad(jloss, argnums=1), a, a)
    assert abs(ref - 32 * ONE) / (32 * ONE) < 0.05


def test_flash_attention_counts_through_its_formula():
    from repro_torch.kernels.flash_attn import flash_attention
    B, H, Hk, S, D = 2, 4, 2, 64, 16
    q = torch.randn(B, H, S, D)
    k = torch.randn(B, Hk, S, D)
    with StepCounter() as c:
        flash_attention(q, k, k)
    assert c.flops == 4 * B * H * S * S * D // 2
    assert [k[0] for k, r in c.records.items() if r.flops] == \
        ["flash_attn_fwd"]


def test_per_device_share_on_a_fake_16x16_mesh(fake_mesh):
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    mesh = fake_mesh

    def dt(shape, placements):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 placements, src_data_rank=None)

    a = dt((4096, 4096), [Shard(0), Replicate()])
    b = dt((4096, 8192), [Replicate(), Shard(1)])
    with StepCounter() as c:
        a @ b
    assert c.flops == 2 * 4096 * 4096 * 8192 / 256
    r = dt((512, 512), [Replicate(), Replicate()])
    with StepCounter() as c:
        r @ r
    assert c.flops == 2 * 512 ** 3
    assert not c.details            # no collective for replicated work
    # each device's share of a (Partial) contraction over a sharded K
    k1 = dt((1024, 2048), [Replicate(), Shard(1)])
    k2 = dt((2048, 1024), [Replicate(), Shard(0)])
    with StepCounter() as c:
        k1 @ k2
    assert c.flops == 2 * 1024 * 2048 * 1024 / 16


# -- reduced steps against the reference's analyze_hlo -----------------------

def _reference_step_flops(jc, spec, kind):
    from repro.configs.base import ShapeSpec as JShape
    from repro.launch import specs as JS
    from repro.serve import make_decode_step, make_prefill_step
    from repro.train import AdamWConfig, make_train_step
    s = JShape("cell", spec.seq_len, spec.global_batch, kind)
    if kind == "train":
        opt = AdamWConfig()
        fn = jax.jit(make_train_step(jc, opt, remat="full"))
        low = fn.lower(JS.abstract_train_state(jc, opt), JS.input_specs(jc, s))
    elif kind == "prefill":
        fn = jax.jit(make_prefill_step(jc, max_len=spec.seq_len))
        low = fn.lower(JS.abstract_params(jc),
                       JS.input_specs(jc, s, with_labels=False))
    else:
        b = JS.decode_input_specs(jc, s)
        fn = jax.jit(make_decode_step(jc))
        low = fn.lower(JS.abstract_params(jc),
                       JS.abstract_cache(jc, spec.global_batch,
                                         spec.seq_len),
                       b["tokens"], b["positions"],
                       jax.ShapeDtypeStruct((2,), jnp.uint32))
    return analyze_hlo(low.compile().as_text()).flops


def _moe_dispatch_combine_flops(cfg, tokens):
    """The reference's one-hot dispatch ("tec,td->ecd") and combine
    ("tec,ecd->td") einsums a layer: 2·T·E·C·D each."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = min(max(1, int(tokens * K * cfg.capacity_factor / E + 0.999)),
            tokens)
    moe_layers = sum(1 for i in range(cfg.num_layers)
                     if cfg.layer_pattern[i % len(cfg.layer_pattern)]
                     .endswith(":moe"))
    return moe_layers * 2 * (2 * tokens * E * C * cfg.d_model)


@pytest.mark.parametrize("arch,kind", [
    ("smollm-360m", "train"), ("qwen2-moe-a2.7b", "prefill"),
    ("rwkv6-7b", "decode")])
def test_reduced_steps_count_the_reference_flops(arch, kind):
    from repro.configs import get_config as jax_get
    from repro.configs.smoke import reduced as jax_reduced
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.smoke import reduced
    from repro_torch.launch.dryrun import _step_args
    B, S = 2, 16
    spec = ShapeSpec("cell", S, B, kind)
    pc = reduced(get_config(arch))
    want = _reference_step_flops(jax_reduced(jax_get(arch)), spec, kind)
    step, args = _step_args(pc, spec, None, {}, "full", "ref")
    with StepCounter() as c:
        step(*args)
    got = c.flops
    if pc.num_experts:
        got += _moe_dispatch_combine_flops(pc, B * S)
    assert abs(got - want) / want < 0.02, (got, want)
    assert set(c.flops_by_dtype) == {"float32"}
    # the attribution sees what was counted
    assert sum(attribute_flops(c).values()) == pytest.approx(c.flops)
    assert sum(attribute_bytes(c).values()) == pytest.approx(c.bytes)
    assert top_table(attribute_flops(c), 5, 1e6, "MF").startswith("total")
