"""The shard step wrappers (kernels B6 and B7) on the CPU against the
reference's ``snp_step_dense_shard`` and ``snp_step_sparse_shard`` in
interpret mode, called directly (no ``shard_map``) on shards carried over
by ``convert.sharded_from_arrays``, with strides combined across shards
and halos drawn from a numpy seed; and the wrappers' refusals.  On CPU
tensors the wrappers run the kernels' plain versions; any other tensor
goes to the launcher, which takes CUDA tensors only."""

import dataclasses

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
from repro_torch.core.convert import (sharded_from_arrays,  # noqa: E402
                                      system_from_spec)
from repro_torch.core.matrix import shard_column_lists  # noqa: E402
from repro_torch.kernels.launch_counts import (  # noqa: E402
    launches as launched)
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
    before = (ops.shard_plain_calls, launched("B6"),
              sparse_ops.plain_calls, launched(),
              launched("B7"))
    ops.snp_step_dense_shard(
        _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]), _t(sh["stride"]),
        _t(sh["choices"]), _t(sh["psi"]), port.arrays.rule_neuron[0],
        port.dense.M_local[0], port.dense.hadj[0], _t(sh["halo"]),
        max_branches=T)
    sparse_ops.snp_step_sparse_shard(
        _t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
        _t(sh["psi"]), _t(sh["tab"]), port.arrays.in_idx[0], _t(sh["halo"]),
        max_branches=T)
    assert (ops.shard_plain_calls, launched("B6"), sparse_ops.plain_calls,
            launched(), launched("B7")) == (
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
    launches = (launched("B6"), launched())
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step_dense_shard_cuda(
            _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]),
            clamp_stride(_t(sh["stride"])), _t(sh["choices"]),
            _t(sh["psi"]), port.arrays.rule_neuron[0],
            port.dense.shard_columns(0), _t(sh["halo"]), T)
    mloc, H = sh["configs"].shape[1], sh["halo"].shape[-1]
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.snp_step_sparse_cuda(
            _t(sh["configs"]), _t(sh["stride"]), _t(sh["choices"]),
            _t(sh["psi"]), _t(sh["tab"]), port.arrays.sell_start[0],
            port.arrays.sell_src[0],
            torch.tensor([mloc + H], dtype=torch.int32), halo=_t(sh["halo"]),
            max_branches=T)
    assert (launched("B6"), launched()) == launches


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
            meta["halo"], max_branches=T,
            cols=tuple(x.to("meta") for x in port.dense.shard_columns(0)))
    sell = (port.arrays.sell_start[0].to("meta"),
            port.arrays.sell_src[0].to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.snp_step_sparse_shard(
            meta["configs"], meta["stride"], meta["choices"], meta["psi"],
            meta["tab"], port.arrays.in_idx[0].to("meta"), meta["halo"],
            sell=sell, max_branches=T)
    # B7 walks the shard's sliced lists: a shard without them (a
    # hand-built lowering) is refused before anything launches
    with pytest.raises(ValueError, match="sliced lists"):
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
    kargs = args[:5] + (port.arrays.sell_start[0],
                        port.arrays.sell_src[0]) + args[6:]
    z = torch.zeros_like(args[0])
    # the kernel reads the sliced lists where the plain version reads
    # in_idx, and its COO body hub_neuron where the plain one reads
    # hub_slot
    for hub in ("hub_slot", "hub_neuron"):
        launch, a = (snp_step_sparse_ref, args) if hub == "hub_slot" \
            else (sparse_ops.snp_step_sparse_cuda, kargs)
        for extra in ({"coo_src": z[0], "coo_bounds": z[0], hub: z[0]},
                      dict(dtab=_t(sh["tab"]), cd=z, pd=z)):
            with pytest.raises(ValueError, match="halo"):
                launch(*a, **extra, halo=_t(sh["halo"]), max_branches=T)


def test_shard_kernels_ship_in_their_sources():
    dense = ops.SOURCE.read_text()
    assert 'extern "C" int snp_step_dense_shard(' in dense
    assert "HAS_HALO" in dense
    sparse = sparse_ops.SOURCE.read_text()
    assert "HAS_HALO" in sparse and "int has_halo" in sparse


# ---- B6's column lists (the kernel walks them in place of M_local, hadj) --

def _shard_lists(port, d):
    """Shard ``d``'s lists as lowered, cut to their lengths."""
    start, rule, val, hstart, hslot = port.dense.shard_columns(d)
    nnz, hnnz = int(start[-1]), int(hstart[-1])
    return start, rule[:nnz], val[:nnz], hstart, hslot[:hnnz]


def _rebuild(start, idx, rows, val=None):
    start, idx = start.numpy(), idx.numpy()
    cols = start.shape[0] - 1
    assert start[0] == 0 and start[-1] == idx.size
    mat = np.zeros((rows, cols), np.int64)
    for j in range(cols):
        r = idx[start[j]:start[j + 1]]
        assert (np.diff(r) > 0).all(), f"column {j}'s entries not ascending"
        mat[r, j] = 1 if val is None else val.numpy()[start[j]:start[j + 1]]
    return mat


@pytest.mark.parametrize("name", sorted(CASES))
def test_shard_column_lists_rebuild_M_local_and_hadj(name):
    ref, port, shards, T = _shard_inputs(name)
    for d in range(port.num_shards):
        start, rule, val, hstart, hslot = _shard_lists(port, d)
        M, hadj = port.dense.M_local[d], port.dense.hadj[d]
        np.testing.assert_array_equal(
            _rebuild(start, rule, M.shape[0], val), M.numpy())
        np.testing.assert_array_equal(
            _rebuild(hstart, hslot, hadj.shape[0]), hadj.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_scatter_over_shard_lists_is_the_plain_version(name):
    """``C + Σ S[..., col_rule]·col_val + Σ halo[..., hcol_slot]`` into each
    column is ``snp_step_dense_shard_ref`` on every entry of every shard."""
    from repro_torch.core.semantics import clamp_stride, decode_spiking
    ref, port, shards, T = _shard_inputs(name)
    for d, sh in enumerate(shards):
        start, rule, val, hstart, hslot = _shard_lists(port, d)
        args = (_t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]),
                clamp_stride(_t(sh["stride"])), _t(sh["choices"]),
                _t(sh["psi"]), port.arrays.rule_neuron[d],
                port.dense.M_local[d], port.dense.hadj[d], _t(sh["halo"]))
        want = snp_step_dense_shard_ref(*args, T)
        S = decode_spiking(args[2], args[1], args[3], args[4], args[6], T)
        mloc = start.shape[0] - 1
        col = torch.repeat_interleave(torch.arange(mloc),
                                      (start[1:] - start[:-1]).long())
        hcol = torch.repeat_interleave(torch.arange(mloc),
                                       (hstart[1:] - hstart[:-1]).long())
        got = args[0][:, None, :].expand(-1, T, -1).clone()
        got.index_add_(-1, col, S.index_select(-1, rule.long()) * val)
        got.index_add_(-1, hcol, args[9].index_select(-1, hslot.long()))
        assert torch.equal(got, want), f"shard {d}"


@pytest.mark.parametrize("partition", ["contiguous", "degree"])
def test_lowered_shard_lists_equal_the_derived_ones(partition):
    """The lists ``lower_shard_dense`` carries, those
    ``sharded_from_arrays`` derives for a reference lowering and those
    ``shard_column_lists`` derives from one shard's ``M_local`` and
    ``hadj`` agree."""
    from repro_torch.sharding import neuron_axis
    system = power_law(26, 3, seed=6)
    ref = J.lower_shard_dense(J.compile_sharded(
        system, J.SystemPlan(num_shards=4, partition=partition)))
    own = P.lower_shard_dense(P.compile_sharded(
        system_from_spec(dataclasses.asdict(system)),
        neuron_axis(4, partition=partition), device="cpu"))
    carried = _carry(ref)
    for k in ("col_start", "col_rule", "col_val", "hcol_start", "hcol_slot"):
        assert torch.equal(getattr(own.dense, k), getattr(carried.dense, k))
        assert getattr(own.dense, k).dtype == torch.int32
    for d in range(4):
        derived = shard_column_lists(own.dense.M_local[d], own.dense.hadj[d])
        for x, y in zip(_shard_lists(own, d), derived):
            assert torch.equal(x, y), f"shard {d}"


def test_shard_launcher_refuses_lists_that_do_not_match():
    from repro_torch.core.semantics import clamp_stride
    ref, port, shards, T = _shard_inputs("random-17-S3-degree")
    sh = shards[0]
    args = (_t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]),
            clamp_stride(_t(sh["stride"])), _t(sh["choices"]),
            _t(sh["psi"]), port.arrays.rule_neuron[0],
            port.dense.M_local[0], port.dense.hadj[0], _t(sh["halo"]))
    good = port.dense.shard_columns(0)
    launches = launched("B6")
    for bad, match in (((good[0][:-1],) + good[1:], "col_start"),
                       (good[:2] + (good[2][:-1],) + good[3:], "col_val"),
                       (good[:3] + (good[3][1:],) + good[4:], "hcol_start"),
                       (good[:4] + (good[4].to(torch.int64),), "hcol_slot"),
                       (good[:3], "lists"), (None, "lists")):
        with pytest.raises(ValueError, match=match):
            ops.snp_step_dense_shard_cuda(*args[:7], bad, args[9], T)
    with pytest.raises(ValueError, match="CUDA"):   # well-formed: CPU refused
        ops.snp_step_dense_shard_cuda(*args[:7], good, args[9], T)
    assert launched("B6") == launches


def test_shard_step_off_the_cpu_needs_the_lists():
    """Off the CPU (here the meta device) the shard step goes to B6, which
    walks the lists: without them it refuses before any launch."""
    ref, port, shards, T = _shard_inputs("paper-pi-S2")
    meta = {k: _t(v).to("meta") for k, v in shards[0].items()
            if isinstance(v, np.ndarray)}
    counts = (ops.shard_plain_calls, launched("B6"))
    with pytest.raises(ValueError, match="column lists"):
        ops.snp_step_dense_shard(
            meta["configs"], meta["rank"], meta["app"], meta["stride"],
            meta["choices"], meta["psi"],
            port.arrays.rule_neuron[0].to("meta"),
            port.dense.M_local[0].to("meta"), port.dense.hadj[0].to("meta"),
            meta["halo"], max_branches=T)
    assert (ops.shard_plain_calls, launched("B6")) == counts


def test_cpu_tensors_with_lists_run_the_plain_version_only():
    ref, port, shards, T = _shard_inputs("power-law-26-S8-degree")
    sh = shards[1]
    before = (ops.shard_plain_calls, launched("B6"))
    got = ops.snp_step_dense_shard(
        _t(sh["configs"]), _t(sh["rank"]), _t(sh["app"]), _t(sh["stride"]),
        _t(sh["choices"]), _t(sh["psi"]), port.arrays.rule_neuron[1],
        port.dense.M_local[1], port.dense.hadj[1], _t(sh["halo"]),
        max_branches=T, cols=port.dense.shard_columns(1))
    assert (ops.shard_plain_calls, launched("B6")) == (
        before[0] + 1, before[1])
    assert got.shape == (sh["configs"].shape[0], T, port.shard_size)
