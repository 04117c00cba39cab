"""The port's copies of the pure-Python LM modules: every registered
config equal to the JAX package's field for field (``reduced()`` too, and
the derived properties), and ``make_batch`` giving identical arrays."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs import list_archs as jax_list  # noqa: E402
from repro.configs.smoke import reduced as jax_reduced  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import dedup_batch as jax_dedup  # noqa: E402
from repro.data import make_batch as jax_make_batch  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs import shape_for  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.data import DataConfig, dedup_batch, make_batch  # noqa: E402

ARCHS = jax_list()


def _same_config(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("num_periods", "mixer_kinds", "mlp_kinds"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert a.param_count() == b.param_count()
    assert a.active_param_count() == b.active_param_count()


def test_same_registry():
    assert list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_for_field(arch):
    _same_config(get_config(arch), jax_get(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_field_for_field(arch):
    _same_config(reduced(get_config(arch)), jax_reduced(jax_get(arch)))


def test_shapes_and_unknown_arch():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    with pytest.raises(ValueError):
        shape_for(get_config("smollm-360m"), "long_500k")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_smollm_360m_published_shape():
    cfg = get_config("smollm-360m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (32, 960, 15, 5, 64, 2560, 49152)
    assert cfg.tie_embeddings and cfg.dtype == "bfloat16"
    assert round(cfg.param_count() / 1e6, 1) == 361.8


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-vl-7b",
                                  "musicgen-medium"])
@pytest.mark.parametrize("step,shard", [(0, 0), (3, 1)])
def test_make_batch_identical(arch, step, shard):
    for full in (False, True):
        cfg = get_config(arch)
        jcfg = jax_get(arch)
        if not full:
            cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
        got = make_batch(cfg, DataConfig(seed=5), step=step, shard=shard,
                         batch=3, seq_len=40)
        want = jax_make_batch(jcfg, JaxDataConfig(seed=5), step=step,
                              shard=shard, batch=3, seq_len=40)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def test_dedup_batch_identical():
    toks = np.array([[1, 2], [3, 4], [1, 2], [5, 6], [3, 4]], np.int32)
    np.testing.assert_array_equal(dedup_batch(toks), jax_dedup(toks))
