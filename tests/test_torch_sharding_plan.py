"""The port's LM sharding plan (``repro_torch.sharding``: ``ShardingPlan``,
``make_plan``) and elastic mesh arithmetic (``repro_torch.runtime``)
against the JAX package's, on abstract meshes (2, 2) and (2, 4, 2).

The reference maps its rule table over a tree whose layer leaves carry a
leading period axis; the port holds one tensor a layer and drops that
entry, so a port spec must equal the reference's spec of its leaf
without the period entry, for every parameter, cache and batch leaf of
all ten archs' reduced siblings.  The reference shards the period entry
itself only at RWKV's ``wk``/``wv`` and a MoE's shared expert (a rule
written for a rank-3 weight meeting a stacked rank-2 one): those leaves
are listed.  The placements a spec becomes
and ``trace_mesh`` need a device mesh: those tests build one over the
``"fake"`` process group (one process standing for every rank)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.smoke import reduced as jax_reduced  # noqa: E402
from repro.data import DataConfig, make_batch  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import make_plan as jax_make_plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models.convert import _path  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.runtime import choose_mesh_shape  # noqa: E402
from repro_torch.sharding import (P, AbstractMesh, ShardingPlan,  # noqa
                                  make_plan, neuron_axis)

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x4x2": ((2, 4, 2), ("pod", "data", "model"))}
ARCHS = list_archs()
#: the layer weights whose period axis the reference's rules shard
PERIOD_SHARDED = {"rwkv.wk", "rwkv.wv", "moe.shared.wg", "moe.shared.wu",
                  "moe.shared.wd"}


def _jax_mesh(shape, names):
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def _plans(mesh):
    shape, names = MESHES[mesh]
    return (make_plan(AbstractMesh(shape, names)),
            jax_make_plan(_jax_mesh(shape, names)))


def _same(got, want, where):
    assert isinstance(want, JP), where
    assert tuple(got) == tuple(want), (where, got, want)


# -- twins of tests/test_serve_and_sharding.py -------------------------------

def test_fit_drops_non_divisible_axes():
    plan = make_plan(AbstractMesh((2, 2), ("data", "model")))
    assert plan.fit(P("model", None), (5, 8)) == P(None, None)
    assert plan.fit(P("model", None), (4, 8)) == P("model", None)


def test_fit_sheds_outer_axes_of_tuples_first():
    plan = make_plan(AbstractMesh((2, 4, 2), ("pod", "data", "model")))
    assert plan.fsdp == ("pod", "data")
    assert plan.fit(P(("pod", "data")), (8,)) == P(("pod", "data"))
    assert plan.fit(P(("pod", "data")), (4,)) == P("data")
    assert plan.fit(P(("pod", "data")), (3,)) == P(None)
    assert (plan.dp_axes, plan.dp_size, plan.tp_size) == \
        (("pod", "data"), 8, 2)


def test_param_specs_cover_all_leaves():
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    params = LM(None, cfg, "meta")
    plan = make_plan(AbstractMesh((2, 2), ("data", "model")))
    specs = plan.param_specs(cfg, params)
    named = dict(params.named_parameters())
    assert list(specs) == list(named)
    for name, s in specs.items():
        p = named[name]
        assert len(s) == p.dim(), (name, s)
        for dim, entry in zip(p.shape, s):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert dim % int(np.prod([2 for _ in axes])) == 0, (name, s)


def test_cache_specs_shard_kv_sequence():
    cfg = reduced(get_config("command-r-35b"))
    cache = init_cache(cfg, 4, 64, device="meta")
    plan = make_plan(AbstractMesh((2, 2), ("data", "model")))
    k_spec = plan.cache_specs(cfg, cache)[0]["k"]
    assert k_spec[1] == "model"    # sequence dim sharded over model
    assert k_spec[0] == "data"     # batch over data
    off = ShardingPlan(plan.mesh, plan.fsdp, plan.tp, shard_kv_seq=False)
    assert off.cache_specs(cfg, cache)[0]["k"][1] is None


def test_batch_specs_musicgen_codebooks():
    cfg = reduced(get_config("musicgen-medium"))
    batch = {"tokens": torch.empty((4, 4, 16), dtype=torch.int32),
             "positions": torch.empty((4, 16), dtype=torch.int32)}
    plan = make_plan(AbstractMesh((2, 2), ("data", "model")))
    specs = plan.batch_specs(cfg, batch)
    assert specs["tokens"] == P("data", None, None)
    assert specs["positions"] == P("data", None)


def test_choose_mesh_shape():
    assert choose_mesh_shape(256, 16) == (16, 16)
    assert choose_mesh_shape(512, 16, pod_axis=2) == (2, 16, 16)
    assert choose_mesh_shape(384, 16, pod_axis=2) == (2, 12, 16)
    assert choose_mesh_shape(240, 16) == (15, 16)
    with pytest.raises(ValueError):
        choose_mesh_shape(8, 16)


# -- every leaf of every arch against the reference --------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    port, ref = _plans(mesh)
    pc, jc = reduced(get_config(arch)), jax_reduced(jax_get(arch))
    params = LM(None, pc, "meta")
    want = ref.param_specs(jc, jax.eval_shape(
        lambda k: jax_init_params(k, jc), jax.random.PRNGKey(0)))
    got = port.param_specs(pc, params)
    P_ = len(pc.layer_pattern)
    seen = set()
    for name, spec in got.items():
        path, period = _path(name, P_)
        leaf = want
        for part in path:
            leaf = leaf[part]
        if period >= 0:
            assert leaf[0] is None or name.split(".", 2)[2] in \
                PERIOD_SHARDED, (name, leaf)
            leaf = JP(*tuple(leaf)[1:])
        _same(spec, leaf, name)
        seen.add("/".join(path))
    leaves = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, JP))
    assert len(seen) == len(leaves)
    # the moments take their parameter's spec; count and step P()
    tensors = list(params.parameters())
    assert port.param_specs(pc, tensors) == list(got.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    port, ref = _plans(mesh)
    pc, jc = reduced(get_config(arch)), jax_reduced(jax_get(arch))
    B, S = 8, 32
    want = ref.cache_specs(jc, jax.eval_shape(
        lambda: jax_init_cache(jc, B, S)))
    cache = init_cache(pc, B, S, device="meta")
    got = port.cache_specs(pc, cache)
    P_ = len(pc.layer_pattern)
    for layer, specs in enumerate(got):
        pos = want[f"pos{layer % P_}"]
        assert set(specs) == set(pos), (layer, specs, pos)
        for name, spec in specs.items():
            assert pos[name][0] is None
            _same(spec, JP(*tuple(pos[name])[1:]), f"layer {layer} {name}")
    batch = make_batch(jc, DataConfig(seed=1), step=0, shard=0, batch=B,
                       seq_len=S)
    want_b = ref.batch_specs(jc, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    got_b = port.batch_specs(pc, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(got_b) == set(want_b)
    for name, spec in got_b.items():
        _same(spec, want_b[name], name)


def test_constrain_leaves_plain_tensors_and_unknown_kinds():
    plan = make_plan(AbstractMesh((2, 2), ("data", "model")))
    x = torch.ones(4, 8, 16)
    assert plan.constrain(x, "hidden") is x
    assert plan.constrain(x, "no such kind") is x


def test_abstract_mesh_has_no_devices():
    plan = make_plan(AbstractMesh((2, 2), ("data", "model")))
    assert plan.neuron_axis() == neuron_axis(4)
    with pytest.raises(ValueError, match="no devices"):
        plan.trace_mesh()


# -- on a device mesh over the fake process group ----------------------------

@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_named_places_tuples_major_to_minor(fake_group):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.runtime import build_mesh
    fake_group(16)
    mesh = build_mesh((2, 4, 2), device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    plan = make_plan(mesh)
    assert plan.fsdp == ("pod", "data") and plan.tp_size == 2
    assert plan.named(P(("pod", "data"), "model")) == \
        [Shard(0), Shard(0), Shard(1)]
    assert plan.named(P("model", "data")) == [Replicate(), Shard(1),
                                              Shard(0)]
    assert plan.named(P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        plan.named(P(("data", "pod")))
    assert plan.trace_mesh() == [torch.device("cpu")] * 16
    assert plan.neuron_axis(partition="degree") == \
        neuron_axis(16, partition="degree")


def test_build_mesh_needs_the_ranks(fake_group):
    from repro_torch.runtime import build_mesh
    with pytest.raises(RuntimeError, match="no process group"):
        build_mesh((2, 2), device_type="cpu")
    fake_group(4)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        build_mesh((4, 2), device_type="cpu")
    mesh = build_mesh((2, 2), device_type="cpu")
    assert (mesh.device_type, tuple(mesh.shape)) == ("cpu", (2, 2))
    assert mesh.mesh_dim_names == ("data", "model")
