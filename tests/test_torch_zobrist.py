"""The port's ``zobrist_hash`` against the reference's: bit for bit with
``offset`` and with ``positions``, additive over column slices (mod 2^32)
under both spellings, and unchanged by the row blocking both hashes use to
bound their memory."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hashing import zobrist_hash as jzobrist  # noqa: E402
from repro_torch.core import hashing  # noqa: E402

M32 = 0xFFFFFFFF


def _configs(shape, seed, lo=-7, hi=9):
    return np.random.default_rng(seed).integers(lo, hi, size=shape) \
        .astype(np.int32)


def _assert_lanes(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("shape", [(12,), (5, 12), (2, 3, 7), (4, 0)])
@pytest.mark.parametrize("offset", [0, 1, 40, 2 ** 32 - 3])
def test_offset_matches_reference(shape, offset):
    c = _configs(shape, seed=sum(shape) + offset % 97)
    _assert_lanes(hashing.zobrist_hash(torch.from_numpy(c), offset=offset),
                  jzobrist(jnp.asarray(c), offset=offset))


@pytest.mark.parametrize("seed", range(4))
def test_positions_match_reference(seed):
    rng = np.random.default_rng(seed)
    c = _configs((6, 9), seed, lo=-2 ** 31, hi=2 ** 31 - 1)
    pos = rng.permutation(64)[:9].astype(np.int32)
    _assert_lanes(hashing.zobrist_hash(torch.from_numpy(c),
                                       positions=torch.from_numpy(pos)),
                  jzobrist(jnp.asarray(c), positions=jnp.asarray(pos)))
    # positions = offset + arange is the offset spelling
    _assert_lanes(hashing.zobrist_hash(torch.from_numpy(c),
                                       positions=torch.arange(5, 14)),
                  hashing.zobrist_hash(torch.from_numpy(c), offset=5))


@pytest.mark.parametrize("cuts", [(4, 8), (1, 2, 3), (6,), (), (11,)])
def test_slices_add_up_to_the_whole_row(cuts):
    c = torch.from_numpy(_configs((5, 12), seed=len(cuts)))
    hi, lo = hashing.zobrist_hash(c)
    bounds = [0, *cuts, 12]
    phi = torch.zeros(5, dtype=torch.int64)
    plo = torch.zeros(5, dtype=torch.int64)
    for a, b in zip(bounds, bounds[1:]):
        h, l = hashing.zobrist_hash(c[:, a:b], offset=a)
        phi, plo = (phi + h) & M32, (plo + l) & M32
    assert torch.equal(phi, hi) and torch.equal(plo, lo)


def test_permuted_slices_add_up_through_positions():
    """A degree partition's shards hold scattered columns: each hashes
    at its ``global_idx`` positions, and the sum is the whole row's."""
    rng = np.random.default_rng(3)
    c = torch.from_numpy(_configs((4, 10), seed=9))
    perm = torch.from_numpy(rng.permutation(10))
    hi, lo = hashing.zobrist_hash(c)
    phi = plo = 0
    for part in perm.reshape(2, 5):
        h, l = hashing.zobrist_hash(c[:, part], positions=part)
        phi, plo = (phi + h) & M32, (plo + l) & M32
    assert torch.equal(phi, hi) and torch.equal(plo, lo)


def test_lanes_are_uint32_values_in_int64():
    c = torch.from_numpy(_configs((64, 33), seed=5, lo=-2 ** 31,
                                  hi=2 ** 31 - 1))
    for lane in hashing.zobrist_hash(c, offset=7):
        assert lane.dtype == torch.int64
        assert bool((lane >= 0).all()) and bool((lane <= M32).all())


@pytest.mark.parametrize("fn", ["config_hash", "zobrist_hash"])
def test_row_blocks_do_not_change_the_hash(fn, monkeypatch):
    c = torch.from_numpy(_configs((3, 5, 7), seed=11))
    whole = getattr(hashing, fn)(c)
    monkeypatch.setattr(hashing, "_BLOCK_ENTRIES", 10)   # one row a block
    blocked = getattr(hashing, fn)(c)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocked))
    assert blocked[0].shape == (3, 5)
