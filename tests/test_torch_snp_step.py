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
from repro_torch.core.semantics import branch_info, clamp_stride  # noqa: E402
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
    plain, launches = ops.plain_calls, ops.kernel_launches
    out = ops.snp_step(configs, pc, max_branches=T)
    assert ops.plain_calls == plain + 1
    assert ops.kernel_launches == launches
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
    launches = ops.kernel_launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step_dense(configs, info.rank, info.app,
                           clamp_stride(info.stride), info.choices,
                           info.psi.contiguous(), pc.rule_neuron, pc.M,
                           pc.env_produce, 8)
    assert ops.kernel_launches == launches


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


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    from repro_torch.kernels.snp_step import _build

    src = tmp_path / "k.cu"
    src.write_text("// never compiled\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(src)
