"""The shard step wrappers (kernels B6 and B7) on the CPU against the
reference's ``snp_step_dense_shard`` and ``snp_step_sparse_shard`` in
interpret mode, called directly (no ``shard_map``) on shards carried over
by ``convert.sharded_from_arrays``, with strides combined across shards
and halos drawn from a numpy seed; and the wrappers' refusals.  On CPU
tensors the wrappers run the kernels' plain versions; any other tensor
goes to the launcher, which takes CUDA tensors only."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import (nd_chain, power_law,  # noqa: E402
                                   random_system)
from repro.core.plan import shard_view as jshard_view  # noqa: E402
from repro.core.semantics import packed_rule_table as jtable  # noqa: E402
from repro.core.semantics import sparse_branch_info as jinfo  # noqa: E402
from repro.kernels.snp_step.ops import (  # noqa: E402
    snp_step_dense_shard as jdense)
from repro.kernels.snp_step.sparse_ops import (  # noqa: E402
    snp_step_sparse_shard as jsparse)
from repro_torch.core.convert import sharded_from_arrays  # noqa: E402
from repro_torch.kernels.snp_step import (_build, ops,  # noqa: E402
                                          sparse_ops)
from repro_torch.kernels.snp_step.ref import (  # noqa: E402
    snp_step_dense_shard_ref)
from repro_torch.kernels.snp_step.sparse_ref import (  # noqa: E402
    snp_step_sparse_ref)

# (system, shards, partition, B, T, spike range)
CASES = {
    "paper-pi-S2": (J.paper_pi(True), 2, "contiguous", 6, 8, (0, 5)),
    "paper-pi-S8-empty": (J.paper_pi(True), 8, "contiguous", 4, 8, (0, 5)),
    "random-17-S3-degree": (random_system(17, 3, 0.3, seed=3), 3, "degree",
                            5, 13, (0, 4)),
    "power-law-26-S8-degree": (power_law(26, 3, seed=6), 8, "degree", 4, 16,
                               (0, 4)),
    "nd-chain-8-S2-overflow": (nd_chain(8), 2, "contiguous", 3, 8, (1, 2)),
    "random-16-S4-spikes-2^20": (random_system(16, 2, 0.2, seed=4), 4,
                                 "contiguous", 3, 8,
                                 (2 ** 20 - 8, 2 ** 20 + 8)),
}


def _carry(ref):
    return sharded_from_arrays(
        {k: np.asarray(v) for k, v in ref.arrays._asdict().items()},
        {k: np.asarray(v) for k, v in ref.dense._asdict().items()},
        num_neurons=ref.num_neurons, num_rules=ref.num_rules,
        shard_size=ref.shard_size, num_shards=ref.num_shards,
        halo_width=ref.halo_width, partition=ref.plan.partition,
        occupancy=ref.occupancy, device="cpu")


def _shard_inputs(name):
    """Per shard: the numpy operands both packages step — the slice, its
    branch info with strides times a downstream product, the packed table
    and a halo of fired-produce-sized values — and the two lowerings."""
    system, S, partition, B, T, (lo, hi) = CASES[name]
    ref = J.lower_shard_dense(J.compile_sharded(
        system, J.SystemPlan(num_shards=S, partition=partition)))
    port = _carry(ref)
    rng = np.random.default_rng(S * 31 + B)
    H = S * ref.halo_width
    shards = []
    for d in range(S):
        view = jshard_view(type(ref.arrays)(*(
            x if k == "rule_slots" else x[d:d + 1]
            for k, x in ref.arrays._asdict().items())))
        configs = rng.integers(lo, hi, size=(B, ref.shard_size)) \
            .astype(np.int32)
        info = jinfo(jnp.asarray(configs), view)
        below = rng.integers(1, 4, size=(B,)).astype(np.float32)
        shards.append(dict(
            configs=configs, rank=np.asarray(info.rank),
            app=np.asarray(info.app),
            stride=np.asarray(info.stride) * below[:, None],
            choices=np.asarray(info.choices),
            psi=np.asarray(info.psi) * below,
            tab=np.asarray(jtable(info, view)),
            halo=rng.integers(0, 1 << 16, size=(B, T, H)).astype(np.int32),
            info=info, view=view))
    return ref, port, shards, T


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_shard_matches_reference_interpret(name):
    ref, port, shards, T = _shard_inputs(name)
    for d, sh in enumerate(shards):
        want = jdense(jnp.asarray(sh["configs"]), sh["info"].rank,
                      sh["info"].app, jnp.asarray(sh["stride"]),
                      sh["info"].choices, jnp.asarray(sh["psi"]),
                      ref.dense.onehot[d], ref.dense.M_local[d],
                      ref.dense.hadj[d], jnp.asarray(sh["halo"]),
                      max_branches=T, interpret=True)
        got = ops.snp_step_dense_shard(
            _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]),
            _t(sh["stride"]), _t(sh["choices"]), _t(sh["psi"]),
            port.arrays.rule_neuron[d], port.dense.M_local[d],
            port.dense.hadj[d], _t(sh["halo"]), max_branches=T)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"shard {d}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_shard_matches_reference_interpret(name):
    ref, port, shards, T = _shard_inputs(name)
    for d, sh in enumerate(shards):
        want = jsparse(jnp.asarray(sh["configs"]), jnp.asarray(sh["stride"]),
                       sh["info"].choices, jnp.asarray(sh["psi"]),
                       jnp.asarray(sh["tab"]), ref.arrays.in_idx[d],
                       jnp.asarray(sh["halo"]), max_branches=T,
                       interpret=True)
        got = sparse_ops.snp_step_sparse_shard(
            _t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
            _t(sh["psi"]), _t(sh["tab"]), port.arrays.in_idx[d],
            _t(sh["halo"]), max_branches=T)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"shard {d}")


@pytest.mark.parametrize("name", ["random-17-S3-degree",
                                  "power-law-26-S8-degree"])
def test_port_branch_info_and_table_on_a_shard_match_reference(name):
    """The sharded explore's bookkeeping on a shard (the sparse branch info
    and the packed table, on the port's shard view) equals the
    reference's."""
    ref, port, shards, T = _shard_inputs(name)
    for d, sh in enumerate(shards):
        view = P.plan.shard_view(port.arrays, d)
        info = P.sparse_branch_info(_t(sh["configs"]), view)
        for k in ("app", "choices", "psi"):
            np.testing.assert_array_equal(
                getattr(info, k).numpy(), np.asarray(getattr(sh["info"], k)))
        np.testing.assert_array_equal(
            torch.where(info.app, info.rank, -1).numpy(),
            np.where(sh["app"], sh["rank"], -1))
        np.testing.assert_array_equal(
            P.packed_rule_table(info, view).numpy(), sh["tab"])


def test_cpu_tensors_run_the_plain_versions_only():
    ref, port, shards, T = _shard_inputs("paper-pi-S2")
    sh = shards[0]
    before = (ops.shard_plain_calls, ops.shard_launches,
              sparse_ops.plain_calls, sparse_ops.kernel_launches,
              sparse_ops.halo_launches)
    ops.snp_step_dense_shard(
        _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]), _t(sh["stride"]),
        _t(sh["choices"]), _t(sh["psi"]), port.arrays.rule_neuron[0],
        port.dense.M_local[0], port.dense.hadj[0], _t(sh["halo"]),
        max_branches=T)
    sparse_ops.snp_step_sparse_shard(
        _t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
        _t(sh["psi"]), _t(sh["tab"]), port.arrays.in_idx[0], _t(sh["halo"]),
        max_branches=T)
    assert (ops.shard_plain_calls, ops.shard_launches, sparse_ops.plain_calls,
            sparse_ops.kernel_launches, sparse_ops.halo_launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3], before[4])


def test_plain_versions_are_the_kernel_contracts():
    """B6's plain version is ``C + halo·hadj + S·M_local`` and B7's is the
    sparse step over ``[local | halo | zero]`` with the zero slot as the
    emission index: they agree with each other on a shard, and B7's
    validity is ``t < psi`` with no emission."""
    ref, port, shards, T = _shard_inputs("power-law-26-S8-degree")
    for d, sh in enumerate(shards):
        from repro_torch.core.semantics import clamp_stride
        dense = snp_step_dense_shard_ref(
            _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]),
            clamp_stride(_t(sh["stride"])), _t(sh["choices"]),
            _t(sh["psi"]), port.arrays.rule_neuron[d],
            port.dense.M_local[d], port.dense.hadj[d], _t(sh["halo"]), T)
        mloc, H = sh["configs"].shape[1], sh["halo"].shape[-1]
        out, valid, emis = snp_step_sparse_ref(
            _t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
            _t(sh["psi"]), _t(sh["tab"]), port.arrays.in_idx[d],
            torch.tensor([mloc + H], dtype=torch.int32),
            halo=_t(sh["halo"]), max_branches=T)
        assert torch.equal(out, dense)
        assert not bool(emis.any())
        t = torch.arange(T).to(torch.float32)
        assert torch.equal(valid, t < _t(sh["psi"])[:, None])


def test_launchers_refuse_cpu_tensors():
    ref, port, shards, T = _shard_inputs("paper-pi-S2")
    sh = shards[0]
    from repro_torch.core.semantics import clamp_stride
    launches = (ops.shard_launches, sparse_ops.kernel_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step_dense_shard_cuda(
            _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]),
            clamp_stride(_t(sh["stride"])), _t(sh["choices"]),
            _t(sh["psi"]), port.arrays.rule_neuron[0],
            port.dense.M_local[0], port.dense.hadj[0], _t(sh["halo"]), T)
    mloc, H = sh["configs"].shape[1], sh["halo"].shape[-1]
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.snp_step_sparse_cuda(
            _t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
            _t(sh["psi"]), _t(sh["tab"]), port.arrays.in_idx[0],
            torch.tensor([mloc + H], dtype=torch.int32), halo=_t(sh["halo"]),
            max_branches=T)
    assert (ops.shard_launches, sparse_ops.kernel_launches) == launches


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    """A tensor off the CPU goes to the launcher, which raises unless it
    is a CUDA tensor: no fallback, and nothing is built on the way (the
    ``Popen`` that would start ``nvcc`` is a stub that fails the test)."""
    ref, port, shards, T = _shard_inputs("paper-pi-S2")
    sh = shards[0]

    def no_build(*a, **k):
        raise AssertionError("a kernel build was started")

    monkeypatch.setattr(_build.subprocess, "Popen", no_build)
    meta = {k: _t(v).to("meta") for k, v in sh.items()
            if isinstance(v, np.ndarray)}
    plain = (ops.shard_plain_calls, sparse_ops.plain_calls)
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step_dense_shard(
            meta["configs"], meta["rank"], meta["app"], meta["stride"],
            meta["choices"], meta["psi"],
            port.arrays.rule_neuron[0].to("meta"),
            port.dense.M_local[0].to("meta"), port.dense.hadj[0].to("meta"),
            meta["halo"], max_branches=T)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.snp_step_sparse_shard(
            meta["configs"], meta["stride"], meta["choices"], meta["psi"],
            meta["tab"], port.arrays.in_idx[0].to("meta"), meta["halo"],
            max_branches=T)
    assert (ops.shard_plain_calls, sparse_ops.plain_calls) == plain


def test_the_halo_excludes_the_coo_and_delay_stages():
    ref, port, shards, T = _shard_inputs("paper-pi-S2")
    sh = shards[0]
    mloc, H = sh["configs"].shape[1], sh["halo"].shape[-1]
    args = (_t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
            _t(sh["psi"]), _t(sh["tab"]), port.arrays.in_idx[0],
            torch.tensor([mloc + H], dtype=torch.int32))
    z = torch.zeros_like(args[0])
    for extra in (dict(coo_src=z[0], coo_bounds=z[0], hub_slot=z[0]),
                  dict(dtab=_t(sh["tab"]), cd=z, pd=z)):
        for launch in (snp_step_sparse_ref, sparse_ops.snp_step_sparse_cuda):
            with pytest.raises(ValueError, match="halo"):
                launch(*args, **extra, halo=_t(sh["halo"]), max_branches=T)


def test_shard_kernels_ship_in_their_sources():
    dense = ops.SOURCE.read_text()
    assert 'extern "C" int snp_step_dense_shard(' in dense
    assert "HAS_HALO" in dense
    sparse = sparse_ops.SOURCE.read_text()
    assert "HAS_HALO" in sparse and "int has_halo" in sparse
