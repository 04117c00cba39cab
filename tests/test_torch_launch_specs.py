"""``repro_torch.launch.specs`` against the reference's
``repro.launch.specs``: for all ten archs at full size and the four
``SHAPES``, every batch tensor has the reference's aval shape and dtype,
and every parameter, optimizer and cache leaf, mapped to the reference's
stacked layout (a layer's tensor is period ``l // P`` of its position's
leaf, ``models.convert._path``), has the shape and dtype of the
reference's ``jax.eval_shape`` tree; the totals in bytes are equal.
The port's trees are meta tensors: the 314B and 398B trees exist only
as metadata on both sides."""

import collections
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.convert import _path  # noqa: E402
from repro_torch.train import AdamWConfig  # noqa: E402

ARCHS = list_archs()


def _dtype(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _leaves(tree, prefix=()):
    """{path: (shape, dtype)} of a nested dict of avals."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), _dtype(tree))}


def _stacked(named, cfg):
    """The port's (name, tensor) pairs in the reference's layout:
    {path: (shape, dtype)}, a layer's tensors stacked along periods."""
    P = len(cfg.layer_pattern)
    out, rows = {}, collections.defaultdict(list)
    for name, t in named:
        path, period = _path(name, P)
        leaf = (tuple(t.shape), _dtype(t))
        if period < 0:
            out[tuple(path)] = leaf
        else:
            rows[tuple(path)].append((period, leaf))
    for path, got in rows.items():
        assert sorted(p for p, _ in got) == list(range(cfg.num_periods)), \
            path
        assert len({leaf for _, leaf in got}) == 1, path
        shape, dtype = got[0][1]
        out[path] = ((cfg.num_periods,) + shape, dtype)
    return out


def _nbytes(leaves):
    size = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4,
            "bool": 1}
    return sum(int(np.prod(s)) * size[d] for s, d in leaves.values())


def _same(got, want):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    assert _nbytes(got) == _nbytes(want)


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    return JS.abstract_train_state(jax_get(arch), JAdamW())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_optimizer_state_equal_the_reference(arch):
    cfg = get_config(arch)
    want = _reference_state(arch)
    state = specs.abstract_train_state(cfg, AdamWConfig())
    assert all(p.is_meta for p in state.params.parameters())
    names = [n for n, _ in state.params.named_parameters()]
    _same(_stacked(state.params.named_parameters(), cfg),
          _leaves(want.params))
    _same(_stacked(zip(names, state.opt.m), cfg), _leaves(want.opt.m))
    _same(_stacked(zip(names, state.opt.v), cfg), _leaves(want.opt.v))
    for got, ref in ((state.opt.count, want.opt.count),
                     (state.step, want.step)):
        assert (tuple(got.shape), _dtype(got)) == \
            (tuple(ref.shape), _dtype(ref))
    assert state.ef is None and want.ef is None
    _same(_stacked(specs.abstract_params(cfg).named_parameters(), cfg),
          _leaves(JS.abstract_params(jax_get(arch))))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batches_and_caches_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get(arch)
    spec, jspec = SHAPES[shape], JSHAPES[shape]
    for labels in (True, False):
        got = specs.input_specs(cfg, spec, with_labels=labels)
        want = JS.input_specs(jcfg, jspec, with_labels=labels)
        assert all(t.is_meta for t in got.values())
        _same({(k,): (tuple(v.shape), _dtype(v)) for k, v in got.items()},
              {(k,): (tuple(v.shape), _dtype(v)) for k, v in want.items()})
    got = specs.decode_input_specs(cfg, spec)
    want = JS.decode_input_specs(jcfg, jspec)
    _same({(k,): (tuple(v.shape), _dtype(v)) for k, v in got.items()},
          {(k,): (tuple(v.shape), _dtype(v)) for k, v in want.items()})
    cache = specs.abstract_cache(cfg, spec.global_batch, spec.seq_len)
    want = JS.abstract_cache(jcfg, jspec.global_batch, jspec.seq_len)
    assert len(cache) == cfg.num_layers
    named = [(f"blocks.{l}.{k}", t) for l, layer in enumerate(cache)
             for k, t in layer.items()]
    # ("stack", "pos<p>", name) -> the reference cache's ("pos<p>", name)
    _same({path[1:]: leaf for path, leaf in _stacked(named, cfg).items()},
          _leaves(want))
