"""The port's threefry2x32 keys against ``jax.random`` (the installed jax,
``jax_threefry_partitionable`` as configured): ``PRNGKey``, chains of
``split`` and ``randint(key, (), 0, n)``, bit for bit on many seeds and
spans, ``n = 1`` and spans near 2^31 included; and the single-key draws of
the LM path: ``split(key, num)``, ``fold_in``, ``bits`` and ``uniform``
bit for bit, ``normal`` to 4 f32 ulps of max(|x|, 2^-10) (its ``log1p`` is
torch's, not XLA's), ``categorical`` equal off near-ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng  # noqa: E402

SEEDS = np.concatenate([
    np.arange(64),
    [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0xDEADBEEF, 123456789],
    np.random.default_rng(0).integers(0, 2 ** 32, size=59),
]).astype(np.int64)


def _jkeys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_prng_key_matches_jax():
    np.testing.assert_array_equal(
        prng.PRNGKey(torch.from_numpy(SEEDS)).numpy(), _np(_jkeys(SEEDS)))


def test_split_chain_matches_jax():
    jk = _jkeys(SEEDS)
    pk = prng.PRNGKey(torch.from_numpy(SEEDS))
    for _ in range(6):
        pair = jax.vmap(jax.random.split)(jk)
        jk, js = pair[:, 0], pair[:, 1]
        pk, ps = prng.split(pk)
        np.testing.assert_array_equal(pk.numpy(), _np(jk))
        np.testing.assert_array_equal(ps.numpy(), _np(js))


@pytest.mark.parametrize("spans", [
    "one", "small", "powers-of-two", "near-2^31", "random"])
def test_randint_matches_jax(spans):
    rng = np.random.default_rng(1)
    B = SEEDS.shape[0]
    n = {"one": np.ones(B),
         "small": rng.integers(1, 20, size=B),
         "powers-of-two": 2 ** rng.integers(0, 31, size=B),
         "near-2^31": 2 ** 31 - 1 - rng.integers(0, 1000, size=B),
         "random": rng.integers(1, 2 ** 31 - 1, size=B)}[spans]
    n = n.astype(np.int32)
    keys = jax.vmap(jax.random.split)(_jkeys(SEEDS))[:, 1]
    want = jax.vmap(lambda k, m: jax.random.randint(k, (), 0, m))(
        keys, jnp.asarray(n))
    got = prng.randint(torch.from_numpy(_np(keys)),
                       torch.from_numpy(n.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert bool((got >= 0).all()) and bool((got < torch.from_numpy(
        n.astype(np.int64))).all())


def test_threefry_matches_jax_hash():
    from jax._src import prng as jprng

    rng = np.random.default_rng(2)
    k0, k1, c0, c1 = (rng.integers(0, 2 ** 32, size=32).astype(np.uint32)
                      for _ in range(4))
    want = jprng.threefry2x32_p.bind(*(jnp.asarray(x)
                                       for x in (k0, k1, c0, c1)))
    got = prng.threefry2x32(*(torch.from_numpy(x.astype(np.int64))
                              for x in (k0, k1, c0, c1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


# -- single keys (the LM path) -------------------------------------------------

ONE_SEEDS = [0, 1, 3, 42, 2 ** 31 - 1, 2 ** 32 - 1, 0xDEADBEEF]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 17), (4097,), (64, 130)]


def _one(seed):
    return (jax.random.wrap_key_data(jnp.asarray([0, seed], jnp.uint32)),
            prng.PRNGKey(seed))


def _kd(k):
    return _np(jax.random.key_data(k))


@pytest.mark.parametrize("seed", ONE_SEEDS)
def test_single_key_split_and_fold_in_match_jax(seed):
    jk, pk = _one(seed)
    assert pk.shape == (2,) and pk.tolist() == _kd(jk).tolist()
    for num in (1, 2, 3, 4, 9):
        np.testing.assert_array_equal(prng.split(pk, num).numpy(),
                                      _kd(jax.random.split(jk, num)))
    for data in (0, 1, 2, 7, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(pk, data).numpy(),
                                      _kd(jax.random.fold_in(jk, data)))
    # the launcher's chain: key, sub = split(key), every step
    for _ in range(5):
        jk, js = jax.random.split(jk)
        pk, ps = prng.split(pk)
        np.testing.assert_array_equal(ps.numpy(), _kd(js))
    np.testing.assert_array_equal(pk.numpy(), _kd(jk))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_match_jax(shape):
    for seed in ONE_SEEDS:
        jk, pk = _one(seed)
        np.testing.assert_array_equal(
            prng.random_bits(pk, shape).numpy(),
            _np(jax.random.bits(jk, shape, jnp.uint32)))
        for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (float(np.finfo(
                np.float32).tiny), 1.0), (-0.99999994, 1.0)):
            got = prng.uniform(pk, shape, lo, hi)
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax.random.uniform(
                    jk, shape, jnp.float32, lo, hi)))


def test_draws_past_one_chunk_match_jax(monkeypatch):
    """A shape drawn in several chunks keeps the flat counter."""
    monkeypatch.setattr(prng, "_CHUNK", 1000)
    jk, pk = _one(11)
    np.testing.assert_array_equal(prng.random_bits(pk, (7, 523)).numpy(),
                                  _np(jax.random.bits(jk, (7, 523),
                                                      jnp.uint32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_matches_jax(shape):
    for seed in ONE_SEEDS:
        jk, pk = _one(seed)
        got = prng.normal(pk, shape).numpy()
        want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        assert got.dtype == np.float32 and got.shape == shape
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(2 ** -10)))
        assert float(np.max(np.abs(got - want) / ulp)) <= 4.0


@pytest.mark.parametrize("shape", [(5,), (3, 50), (8, 1000), (2, 3, 77)])
def test_categorical_matches_jax_off_near_ties(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    for seed in ONE_SEEDS:
        jk, pk = _one(seed)
        logits = (rng.standard_normal(shape) * 3).astype(np.float32)
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
        got = prng.categorical(pk, torch.from_numpy(logits)).numpy()
        assert got.shape == want.shape
        # the reference's perturbed logits, to find rows whose top two
        # lie within 1e-5 (the port's Gumbel noise is a few ulps off)
        g = np.asarray(jax.random.gumbel(jk, shape, jnp.float32)) + logits
        top2 = np.sort(g, -1)[..., -2:]
        near_tie = (top2[..., 1] - top2[..., 0]) < 1e-5
        np.testing.assert_array_equal(got[~near_tie], want[~near_tie])


def test_categorical_on_an_axis_and_never_a_masked_logit():
    jk, pk = _one(5)
    logits = np.random.default_rng(0).standard_normal((6, 4, 9)).astype(
        np.float32)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), 1))
    got = prng.categorical(pk, torch.from_numpy(logits), axis=1).numpy()
    np.testing.assert_array_equal(got, want)
    masked = torch.full((64, 10), float("-inf"))
    masked[:, 3], masked[:, 7] = 0.0, 1.0
    for seed in range(4):
        drawn = prng.categorical(prng.PRNGKey(seed), masked)
        assert set(drawn.tolist()) <= {3, 7}
