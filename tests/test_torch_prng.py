"""The port's threefry2x32 keys against ``jax.random`` (the installed jax,
``jax_threefry_partitionable`` as configured): ``PRNGKey``, chains of
``split`` and ``randint(key, (), 0, n)``, bit for bit on many seeds and
spans, ``n = 1`` and spans near 2^31 included."""

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
