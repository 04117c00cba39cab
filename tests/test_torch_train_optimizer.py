"""The port's optimizer and gradient compression (``repro_torch.train``)
against the JAX package's ``repro.train`` on the same inputs, numpy from
a seed.

* schedules (cosine, WSD, constant) at every step of a run, within 1e-6
  of the peak rate (both compute in f32; ``cos`` may round apart by an
  ulp), and the reference's own schedule checks;
* ``adamw_update`` for three steps on random trees (matrices, vectors,
  a 3-d tensor; clipping active and not): parameters, ``m``, ``v``,
  ``grad_norm`` and ``lr`` within 1e-5 relative;
* ``quantize_int8``, ``dequantize_int8`` and ``compress_grads`` bit for
  bit, ragged sizes and an all-zero block included, and the Hypothesis
  twin of the reference's round-trip bound and its error-feedback check.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro.train.compression import compress_grads as jax_compress  # noqa
from repro.train.compression import quantize_int8 as jax_quantize  # noqa
from repro_torch.train import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, make_schedule)
from repro_torch.train.compression import (compress_grads,  # noqa: E402
                                           dequantize_int8, ef_init,
                                           quantize_int8)

SCHEDULES = [
    dict(lr=1.0, warmup_steps=10, total_steps=100, schedule="cosine"),
    dict(lr=3e-3, warmup_steps=20, total_steps=64, schedule="wsd",
         decay_frac=0.2),
    dict(lr=2e-4, warmup_steps=0, total_steps=30, schedule="constant"),
    dict(lr=1e-3, warmup_steps=5, total_steps=5, schedule="cosine"),
]
SHAPES = {"a": (6, 5), "b": (7,), "c": (2, 3, 4), "d": (300,)}


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["schedule"])
def test_schedule_every_step(kw):
    want_fn = jopt.make_schedule(jopt.AdamWConfig(**kw))
    got_fn = make_schedule(AdamWConfig(**kw))
    steps = np.arange(kw["total_steps"] + 3, dtype=np.int32)
    want = np.asarray(want_fn(jnp.asarray(steps)))
    got = got_fn(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6 * kw["lr"], rtol=0)


def test_schedules():
    s = make_schedule(AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                  schedule="cosine"))
    assert float(s(torch.tensor(0))) == 0.0
    assert abs(float(s(torch.tensor(10))) - 1.0) < 1e-6
    assert float(s(torch.tensor(100))) < 1e-6
    wsd = make_schedule(AdamWConfig(lr=1.0, warmup_steps=10,
                                    total_steps=100, schedule="wsd",
                                    decay_frac=0.2))
    assert abs(float(wsd(torch.tensor(50))) - 1.0) < 1e-6
    assert float(wsd(torch.tensor(99))) < 0.2


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _rel(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_equals_the_reference(grad_scale):
    rng = np.random.default_rng(int(grad_scale * 100))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0)
    jcfg, pcfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    params = _tree(rng)
    keys = sorted(SHAPES)       # the reference's leaf order
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.adamw_init(jp)
    pp = [torch.from_numpy(params[k].copy()) for k in keys]
    ps = adamw_init(pp)
    for _ in range(3):
        g = _tree(rng, grad_scale)
        jp, js, jm = jopt.adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        pp, ps, pm = adamw_update(
            pcfg, [torch.from_numpy(g[k]) for k in keys], ps, pp)
        for i, k in enumerate(keys):
            _rel(pp[i].numpy(), jp[k])
            _rel(ps.m[i].numpy(), js.m[k])
            _rel(ps.v[i].numpy(), js.v[k])
        _rel(pm["grad_norm"].numpy(), jm["grad_norm"])
        _rel(pm["lr"].numpy(), jm["lr"])
        assert int(ps.count) == int(js.count)
    # weight decay only on matrices: the vector's update has none
    assert ps.m[keys.index("b")].dtype == torch.float32


SIZES = [1, 256, 1000, 4096 + 17]


@pytest.mark.parametrize("n", SIZES)
def test_quantize_int8_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 10)).astype(np.float32)
    if n >= 512:
        x[256:512] = 0.0            # an all-zero block: scale 0
    wq, ws = jax_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    y = dequantize_int8(q, s, (n,))
    from repro.train.compression import dequantize_int8 as jax_deq
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(jax_deq(wq, ws, (n,))))


def test_compress_grads_bit_for_bit():
    rng = np.random.default_rng(11)
    keys = sorted(SHAPES)
    g_tree = _tree(rng, 3.0)
    e_tree = _tree(rng, 0.01)
    grads = [torch.from_numpy(g_tree[k]) for k in keys]
    ef = [torch.from_numpy(e_tree[k]) for k in keys]
    for _ in range(3):
        wg, we = jax_compress({k: jnp.asarray(v) for k, v in g_tree.items()},
                              {k: jnp.asarray(v) for k, v in e_tree.items()})
        got, ef = compress_grads(grads, ef)
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(wg[k]))
            np.testing.assert_array_equal(ef[i].numpy(), np.asarray(we[k]))
        e_tree = {k: np.asarray(v) for k, v in we.items()}


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 2000))
def test_int8_quantization_roundtrip_bound(seed, n):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(n)
                          * rng.uniform(0.01, 10)).astype(np.float32))
    q, s = quantize_int8(x)
    y = dequantize_int8(q, s, x.shape)
    # block-wise symmetric int8: error <= scale/2 = max|block| / 254
    err = (y - x).abs().max()
    assert float(err) <= float(x.abs().max()) / 254 + 1e-7


def test_error_feedback_preserves_gradient_mass():
    rng = np.random.default_rng(0)
    g = [torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))]
    ef = ef_init(g)
    total = torch.zeros_like(g[0])
    for _ in range(8):
        applied, ef = compress_grads(g, ef)
        total = total + applied[0]
    err = (total - 8 * g[0]).abs().max()
    assert float(err) < float(g[0].abs().max()) / 50
