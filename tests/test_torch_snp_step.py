"""The port's step wrapper (``kernels/snp_step/ops.snp_step``) on the CPU
against the reference's Pallas ``snp_step`` in interpret mode: dense
``EQUIV_SYSTEMS``, non-divisible B, T and n, branch overflow and large
spike counts.  On CPU tensors the wrapper runs the kernel's plain version
and never the kernel."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
from repro.core import compile_system as jcompile  # noqa: E402
from repro.core.backend import get_backend as jget_backend  # noqa: E402
from repro.core.generators import nd_chain, random_system  # noqa: E402
from repro.core.system import paper_pi  # noqa: E402
from repro.kernels.snp_step import snp_step as jstep  # noqa: E402
from repro_torch.core import compile_system as pcompile  # noqa: E402
from repro_torch.core import get_backend, next_configs  # noqa: E402
from repro_torch.core.backend import REFERENCE_NAME  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.core.matrix import dense_column_lists  # noqa: E402
from repro_torch.core.semantics import branch_info, clamp_stride  # noqa: E402
from repro_torch.kernels.launch_counts import (  # noqa: E402
    launches as launched)
from repro_torch.kernels.snp_step import ops  # noqa: E402
from repro_torch.kernels.snp_step.ref import snp_step_dense_ref  # noqa: E402


class _Out:
    def __init__(self, configs, valid, emissions, overflow):
        self.configs, self.valid = configs, valid
        self.emissions, self.overflow = emissions, overflow


def _both(system, configs, T):
    jc = jcompile(system)
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    ref = _Out(*jstep(jnp.asarray(configs), jc, max_branches=T, block_b=4,
                      block_t=8, block_n=8, interpret=True))
    port = _Out(*ops.snp_step(torch.from_numpy(configs), pc, max_branches=T))
    return ref, port, pc


@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_wrapper_matches_pallas_interpret(name):
    system, T = conftest.EQUIV_SYSTEMS[name]
    configs = conftest.random_states(system, "no_delays", 6, seed=5, high=5)
    ref, port, _ = _both(system, configs, T)
    conftest.assert_same_step(port, ref)


@pytest.mark.parametrize("case", ["non-divisible", "branch-overflow",
                                  "large-spikes"])
def test_wrapper_edge_shapes_match_pallas_interpret(case):
    if case == "non-divisible":            # B=5, T=17, n=33, m=11
        system, T = random_system(11, 3, 0.4, seed=5), 17
        configs = np.random.default_rng(2).integers(
            0, 4, size=(5, 11)).astype(np.int32)
    elif case == "branch-overflow":        # Ψ = 2^8 > T
        system, T = nd_chain(8), 32
        configs = np.ones((2, 8), np.int32)
    else:
        system, T = paper_pi(True), 8
        configs = np.asarray([[2 ** 22, 1, 2 ** 20]], np.int32)
    ref, port, _ = _both(system, configs, T)
    conftest.assert_same_step(port, ref)
    if case == "branch-overflow":
        assert port.overflow.all()


def test_cpu_tensors_run_the_plain_version_only():
    system, T = conftest.EQUIV_SYSTEMS["random-17"]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 4, seed=1))
    plain, launches = ops.plain_calls, launched("B1")
    out = ops.snp_step(configs, pc, max_branches=T)
    assert ops.plain_calls == plain + 1
    assert launched("B1") == launches
    # equal to the reference semantics on valid entries
    conftest.assert_same_step(_Out(*out), next_configs(configs, pc, T))


def test_plain_version_is_the_kernel_contract():
    """The plain version computes C + S·M, S·env and t < Ψ for every
    branch, valid or not (the kernel is held to all entries on the card)."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 5, seed=8))
    info = branch_info(configs, pc)
    out, valid, emis = snp_step_dense_ref(
        configs, info.rank, info.app, clamp_stride(info.stride),
        info.choices, info.psi, pc.rule_neuron, pc.M, pc.env_produce, T)
    ref = next_configs(configs, pc, T)
    assert torch.equal(out, ref.configs) and torch.equal(emis, ref.emissions)
    assert torch.equal(valid & info.alive[:, None], ref.valid)


def test_kernel_launcher_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel launcher silently: it raises
    instead of falling back."""
    pc = pcompile(system_from_spec(dataclasses.asdict(paper_pi(True))),
                  device="cpu")
    configs = torch.tensor([[2, 1, 1]], dtype=torch.int32)
    info = branch_info(configs, pc)
    launches = launched("B1")
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step_dense(configs, info.rank, info.app,
                           clamp_stride(info.stride), info.choices,
                           info.psi.contiguous(), pc.rule_neuron,
                           (pc.col_start, pc.col_rule, pc.col_val), 8)
    assert launched("B1") == launches


def test_cuda_backend_flattens_batch_dims_like_pallas():
    """Each port backend equals the reference backend that REFERENCE_NAME
    pairs it with, on nd-batched configs and each backend's own encoding:
    ``"cuda"`` <-> ``"pallas"`` and ``"sparse_cuda"`` <-> ``"sparse_pallas"``
    (interpret mode) flatten the batch dims and leave ``spiking`` empty."""
    system, T = conftest.EQUIV_SYSTEMS["random-16"]
    port_system = system_from_spec(dataclasses.asdict(system))
    configs = conftest.random_states(system, "no_delays", 6, seed=2
                                     ).reshape(2, 3, -1)
    assert set(REFERENCE_NAME) == {"ref", "cuda", "sparse", "sparse_cuda"}
    for name, ref_name in REFERENCE_NAME.items():
        be, jbe = get_backend(name), jget_backend(ref_name)
        pc = be.compile(port_system, device="cpu")
        got = be.expand(torch.from_numpy(configs), pc, T)
        want = jbe.expand(jnp.asarray(configs), jbe.compile(system), T)
        assert (got.spiking is None) == (want.spiking is None), name
        assert tuple(got.configs.shape) == (2, 3, T, system.num_neurons)
        conftest.assert_same_step(got, want)


def test_kernel_library_is_named_by_source_hash(tmp_path):
    """An edited source gets a new library name, so it is rebuilt; an
    unchanged one maps to the same name and is reused."""
    from repro_torch.kernels.snp_step import _build

    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert _build.library_path(src) != first
    assert ops.SOURCE.is_file()


def test_kernel_library_hash_covers_the_headers_beside_it(tmp_path):
    """A header beside a source (``csrc/*.cuh``, which the source may
    include) is part of the library's name: editing it rebuilds, and the
    step sources that share ``sliced_lists.cuh`` include it."""
    from repro_torch.kernels.snp_step import _build, sparse_ops

    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\nextern "C" int f() { return g(); }\n')
    header = tmp_path / "h.cuh"
    header.write_text("inline int g() { return 0; }\n")
    first = _build.library_path(src)
    header.write_text("inline int g() { return 1; }\n")
    assert _build.library_path(src) != first
    shared = ops.DELAY_SOURCE.with_name("sliced_lists.cuh")
    assert shared.is_file()
    for source in (ops.DELAY_SOURCE, sparse_ops.SOURCE):
        assert '#include "sliced_lists.cuh"' in source.read_text()


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    from repro_torch.kernels.snp_step import _build

    src = tmp_path / "k.cu"
    src.write_text("// never compiled\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(src)


# ---- B1's column lists (the kernel walks them in place of [M | env]) ----

def _scatter(configs, S, lists):
    """``C + Σ S[..., col_rule]·col_val`` into each column, the columns
    past ``C``'s (B1: env's) starting at 0: the kernel's walk, written as
    a plain scatter over the lists."""
    start, rule, val = lists
    cols = start.shape[0] - 1
    col = torch.repeat_interleave(
        torch.arange(cols), (start[1:] - start[:-1]).to(torch.int64))
    B, T = S.shape[:2]
    out = torch.zeros((B, T, cols), dtype=torch.int32)
    out.index_add_(-1, col, S.index_select(-1, rule.to(torch.int64)) * val)
    out[..., :configs.shape[1]] += configs[:, None, :]
    return out


def _rebuild(lists, rows, cols):
    start, rule, val = (x.numpy() for x in lists)
    assert start.shape == (cols + 1,) and start[0] == 0
    assert start[-1] == rule.size == val.size
    mat = np.zeros((rows, cols), np.int64)
    for j in range(cols):
        r = rule[start[j]:start[j + 1]]
        assert (np.diff(r) > 0).all(), f"column {j}'s rules not ascending"
        assert (val[start[j]:start[j + 1]] != 0).all()
        mat[r, j] = val[start[j]:start[j + 1]]
    return mat


def _kernel_inputs(pc, configs):
    info = branch_info(configs, pc)
    return (configs, info.rank, info.app, clamp_stride(info.stride),
            info.choices, info.psi.contiguous(), pc.rule_neuron, pc.M,
            pc.env_produce)


def _assert_walk_is_the_plain_version(args, lists, T):
    from repro_torch.core.semantics import decode_spiking
    configs, rank, app, stride, choices, psi, rule_neuron, M, env = args
    out, valid, emis = snp_step_dense_ref(*args, T)
    S = decode_spiking(app, rank, stride, choices, rule_neuron, T)
    walk = _scatter(configs, S, lists)
    assert torch.equal(walk[..., :-1], out)
    assert torch.equal(walk[..., -1], emis)


@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_column_lists_rebuild_M_and_env(name):
    system, _ = conftest.EQUIV_SYSTEMS[name]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    lists = (pc.col_start, pc.col_rule, pc.col_val)
    full = np.concatenate([pc.M.numpy(), pc.env_produce.numpy()[:, None]], 1)
    np.testing.assert_array_equal(
        _rebuild(lists, pc.num_rules, pc.num_neurons + 1), full)


@pytest.mark.parametrize("name", sorted(conftest.EQUIV_SYSTEMS))
def test_scatter_over_column_lists_is_the_plain_version(name):
    """Walking the lists (C + S·col_val into each column, env's column
    giving the emissions) is ``snp_step_dense_ref`` on every entry."""
    system, T = conftest.EQUIV_SYSTEMS[name]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 6, seed=9, high=5))
    _assert_walk_is_the_plain_version(
        _kernel_inputs(pc, configs), (pc.col_start, pc.col_rule, pc.col_val),
        T)


def _hand_made(case):
    """Decode inputs of a random system with a hand-made ``M`` and ``env``:
    |values| up to 1000 (past int8), negatives, column 1 empty and column
    0 a hub holding every rule (360 or 8,320 entries); "n-past-one-chunk"
    has more rules than one block stages (ops.RULE_CHUNK)."""
    rng = np.random.default_rng(11)
    system = random_system(64, 130, 0.2, seed=7) if case == \
        "n-past-one-chunk" else random_system(40, 9, 0.2, seed=6)
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    n, m = pc.num_rules, pc.num_neurons
    M = rng.integers(-1000, 1001, size=(n, m)) * (rng.random((n, m)) < 0.05)
    M[:, 0] = rng.integers(128, 1001, size=n) * rng.choice([-1, 1], size=n)
    M[:, 1] = 0
    env = rng.integers(-1000, 1001, size=n) * (rng.random(n) < 0.3)
    configs = torch.from_numpy(
        rng.integers(0, 4, size=(3, m)).astype(np.int32))
    args = _kernel_inputs(pc, configs)[:7] + (
        torch.from_numpy(M.astype(np.int32)),
        torch.from_numpy(env.astype(np.int32)))
    return args, n, m


@pytest.mark.parametrize("case", ["wide-values", "n-past-one-chunk"])
def test_scatter_over_hand_made_lists_is_the_plain_version(case):
    args, n, m = _hand_made(case)
    M, env = args[7], args[8]
    lists = dense_column_lists(M, env)
    full = np.concatenate([M.numpy(), env.numpy()[:, None]], 1)
    np.testing.assert_array_equal(_rebuild(lists, n, m + 1), full)
    start = lists[0].numpy()
    assert start[2] == start[1]                         # the empty column
    assert start[1] - start[0] == n > 300               # the hub column
    assert int(np.abs(lists[2].numpy()).max()) > 127
    if case == "n-past-one-chunk":
        assert n > ops.RULE_CHUNK
        assert int(lists[1].max()) >= ops.RULE_CHUNK
    _assert_walk_is_the_plain_version(args, lists, 16)


@pytest.mark.parametrize("name", ["paper-pi", "power-law-40", "random-17"])
def test_carried_lists_equal_the_derived_ones(name):
    """The lists ``compile_system`` carries, those ``compiled_from_arrays``
    derives for a reference encoding and those ``dense_column_lists``
    derives from ``M`` and ``env`` are one and the same."""
    from repro_torch.core.convert import compiled_from_arrays
    system, _ = conftest.EQUIV_SYSTEMS[name]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    ref = jcompile(system)
    carried = compiled_from_arrays(
        {k: (v if k == "rule_order" or v is None else np.asarray(v))
         for k, v in ref._asdict().items()}, device="cpu")
    derived = dense_column_lists(pc.M, pc.env_produce)
    for enc in (pc, carried):
        for x, y in zip((enc.col_start, enc.col_rule, enc.col_val),
                        derived):
            assert x.dtype == torch.int32 and torch.equal(x, y)


def test_launcher_refuses_lists_that_do_not_match_M():
    system, T = conftest.EQUIV_SYSTEMS["random-17"]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 4, seed=1))
    args = _kernel_inputs(pc, configs)
    good = (pc.col_start, pc.col_rule, pc.col_val)
    launches = launched("B1")
    # lists of a system one neuron wider: col_start one entry too long
    wider = dense_column_lists(
        torch.cat([pc.M, pc.M[:, :1]], 1), pc.env_produce)
    for bad, match in (((good[0][:-1],) + good[1:], "col_start"),
                       (wider, "col_start"),
                       (good[:2] + (good[2][:-1],), "col_val"),
                       (good[:2] + (good[2].to(torch.int64),), "col_val"),
                       (good[:2], "lists"), (None, "lists")):
        with pytest.raises(ValueError, match=match):
            ops.snp_step_dense(*args[:7], bad, T)
    with pytest.raises(ValueError, match="CUDA"):   # well-formed: CPU refused
        ops.snp_step_dense(*args[:7], good, T)
    assert launched("B1") == launches


def test_cpu_tensors_with_lists_run_the_plain_version_only():
    """An encoding that carries its lists still takes the plain version on
    the CPU: the launch counter does not move."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc = pcompile(system_from_spec(dataclasses.asdict(system)), device="cpu")
    assert pc.col_start is not None
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 4, seed=3))
    plain, launches = ops.plain_calls, launched("B1")
    out = ops.snp_step(configs, pc, max_branches=T)
    assert (ops.plain_calls, launched("B1")) == (plain + 1, launches)
    conftest.assert_same_step(_Out(*out), next_configs(configs, pc, T))


def test_an_encoding_without_lists_never_reaches_the_kernel(monkeypatch):
    """Off the CPU (here the meta device) the dense step takes B1's route:
    an encoding without column lists (a delayed one carries none) is
    refused before any launch, one with them reaches the launcher, which
    refuses a tensor that is not on the card; nothing is built on the way
    and no counter moves."""
    from repro_torch.kernels.snp_step import _build

    def no_build(*a, **k):
        raise AssertionError("a kernel build was started")

    monkeypatch.setattr(_build.subprocess, "Popen", no_build)
    pc = pcompile(system_from_spec(dataclasses.asdict(paper_pi(True))),
                  device="cpu")
    meta = pc._replace(**{k: v.to("meta") for k, v in pc._asdict().items()
                          if isinstance(v, torch.Tensor)})
    bare = meta._replace(col_start=None, col_rule=None, col_val=None)
    configs = torch.tensor([[2, 1, 1]], dtype=torch.int32, device="meta")
    counts = (ops.plain_calls, launched("B1"))
    with pytest.raises(ValueError, match="lacks the column lists"):
        ops.snp_step(configs, bare, max_branches=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step(configs, meta, max_branches=8)
    assert (ops.plain_calls, launched("B1")) == counts


def test_rule_chunk_is_the_sources():
    assert f"constexpr int RULE_CHUNK = {ops.RULE_CHUNK};" in \
        ops.SOURCE.read_text()
