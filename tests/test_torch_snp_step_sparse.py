"""The port's sparse step wrapper (``kernels/snp_step/sparse_ops``) on the
CPU against the reference's Pallas ``snp_step_sparse`` in interpret mode,
pure ELL and hybrid; the plain version ``sparse_ref`` against the kernel's
contract; and the wrapper's refusals.  On CPU tensors the wrapper runs the
kernel's plain version and never the kernel."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.generators import nd_chain, random_system  # noqa: E402
from repro.kernels.snp_step import snp_step_sparse as jstep  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.kernels.launch_counts import (  # noqa: E402
    launches as launched)
from repro_torch.kernels.snp_step import sparse_ops  # noqa: E402
from repro_torch.kernels.snp_step.sparse_ref import (  # noqa: E402
    kernel_inputs, snp_step_sparse_ref)


def _comps(system, h):
    pc = P.compile_system_sparse(system_from_spec(dataclasses.asdict(system)),
                                 hub_threshold=h, device="cpu")
    return pc, J.compile_system_sparse(system, hub_threshold=h)


def _assert_all_equal(port, ref):
    for a, b, f in zip(port, ref, ("configs", "valid", "emissions",
                                   "overflow")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("h", [None, 1], ids=["ell", "hybrid-h1"])
@pytest.mark.parametrize("name", ["paper-pi", "random-17", "power-law-40",
                                  "ring-lattice-12"])
def test_wrapper_matches_sparse_pallas_interpret(name, h):
    system, T = conftest.EQUIV_SYSTEMS[name]
    pc, jc = _comps(system, h)
    configs = conftest.random_states(system, "no_delays", 6, seed=7, high=5)
    port = sparse_ops.snp_step_sparse(torch.from_numpy(configs), pc,
                                      max_branches=T)
    ref = jstep(jnp.asarray(configs), jc, max_branches=T, block_b=4,
                block_t=8, interpret=True)
    _assert_all_equal(port, ref)


@pytest.mark.parametrize("case", ["non-divisible", "branch-overflow",
                                  "large-spikes"])
def test_wrapper_edge_shapes_match_sparse_pallas_interpret(case):
    if case == "non-divisible":            # B=5, T=13, m=11
        system, T, h = random_system(11, 3, 0.4, seed=5), 13, 2
        configs = np.random.default_rng(2).integers(
            0, 4, size=(5, 11)).astype(np.int32)
    elif case == "branch-overflow":        # Ψ = 2^8 > T
        system, T, h = nd_chain(8), 32, None
        configs = np.ones((2, 8), np.int32)
    else:
        system, T, h = J.paper_pi(True), 8, None
        configs = np.asarray([[2 ** 22, 1, 2 ** 20]], np.int32)
    pc, jc = _comps(system, h)
    port = sparse_ops.snp_step_sparse(torch.from_numpy(configs), pc,
                                      max_branches=T)
    ref = jstep(jnp.asarray(configs), jc, max_branches=T, block_b=2,
                block_t=8, interpret=True)
    _assert_all_equal(port, ref)
    if case == "branch-overflow":
        assert bool(port[3].all())


@pytest.mark.parametrize("h", [None, 1, 3])
def test_plain_version_is_the_kernel_contract(h):
    """``sparse_ref`` computes, from the kernel's own inputs, every entry
    of the step (valid or not): ``valid`` is ``t < Ψ`` before the
    ``alive`` mask, the rest equals the sparse semantics."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc, _ = _comps(system, h)
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 5, seed=8))
    args, coo, info = kernel_inputs(configs, pc)
    assert bool(coo) == pc.is_hybrid == (h is not None)
    # the launcher takes contiguous tensors only
    assert all(x.is_contiguous() for x in (*args, *coo.values()))
    out, valid, emis = snp_step_sparse_ref(*args, **coo, max_branches=T)
    ref = P.sparse_next_configs(configs, pc, T)
    assert torch.equal(out, ref.configs) and torch.equal(emis, ref.emissions)
    assert torch.equal(valid & info.alive[:, None], ref.valid)
    t = torch.arange(T).to(torch.float32)
    assert torch.equal(valid, t < info.psi[:, None])


def test_cpu_tensors_run_the_plain_version_only():
    system, T = conftest.EQUIV_SYSTEMS["random-17"]
    pc, _ = _comps(system, 1)
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 4, seed=1))
    before = (sparse_ops.plain_calls, launched(),
              launched("B3"))
    sparse_ops.snp_step_sparse(configs, pc, max_branches=T)
    assert (sparse_ops.plain_calls, launched(),
            launched("B3")) == (before[0] + 1,) + before[1:]


def test_kernel_launcher_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel launcher silently: it raises
    instead of falling back."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc, _ = _comps(system, 1)
    ell, _ = _comps(system, None)
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 2, seed=1))
    args, lists, _ = kernel_inputs(configs, ell, lists=True)  # the ELL body's
    kargs, coo, _ = kernel_inputs(configs, pc, lists=True)   # the COO body's
    launches = launched()
    for a, extra in ((args, lists), (kargs, coo)):
        with pytest.raises(ValueError, match="CUDA"):
            sparse_ops.snp_step_sparse_cuda(*a, **extra, max_branches=T)
    assert launched() == launches


def _launcher_case(case):
    """Arguments of the COO body's launcher at power-law-40, h=1 (the ELL
    body's, h=None, for the ``ell-`` cases), with one thing wrong (or
    ``ok``).  The launcher takes the lists in ``in_idx``'s place: args[5]
    is ``sell_start``, args[6] ``sell_src``."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc, _ = _comps(system, None if case.startswith("ell-") else 1)
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 2, seed=1))
    args, coo, _ = kernel_inputs(configs, pc, lists=True)
    args = list(args)
    if case in ("short-sell-start", "ell-short-sell-start"):
        args[5] = args[5][:-1]
    elif case in ("in-idx-for-coo", "ell-in-idx-for-lists"):
        args[5] = pc.in_idx
    elif case == "ell-in-idx-beside-lists":
        args.insert(5, pc.in_idx)
    elif case == "2d-sell-src":
        args[6] = args[6].reshape(-1, 32)
    elif case == "tail-without-lists":
        args[5] = args[6] = None
    elif case == "lists-without-tail":
        coo = {"coo_src": coo["coo_src"]}
    elif case == "hub-neuron-length":
        coo = dict(coo, hub_neuron=coo["hub_neuron"][:-1])
    elif case == "hub-slot-for-hub-neuron":
        coo = dict(coo, hub_slot=pc.hub_slot)
        del coo["hub_neuron"]
    return args, coo, T


@pytest.mark.parametrize("case, match", [
    ("short-sell-start", "sell_start"), ("2d-sell-src", "sell_src"),
    ("in-idx-for-coo", "sliced lists"), ("tail-without-lists", "sliced lists"),
    ("lists-without-tail", "COO tail"),
    ("hub-neuron-length", "hub_neuron"),
    ("hub-slot-for-hub-neuron", "hub_slot"), ("ok", "CUDA"),
    ("ell-in-idx-for-lists", "sliced lists"),
    ("ell-in-idx-beside-lists", "sliced lists"),
    ("ell-short-sell-start", "sell_start"), ("ell-ok", "CUDA")])
def test_coo_launcher_checks_the_sliced_lists(case, match):
    """The COO body's launcher checks the lists' shapes on the host (the
    kernel skips entries out of range): wrong lengths, ``in_idx`` where
    the lists belong, the tail without the lists, part of the tail
    without the rest, ``hub_slot`` for ``hub_neuron`` are refused before
    anything launches; well-formed lists on CPU tensors then meet the
    device check.  The ELL body (B2) walks the same lists: ``in_idx`` in
    their place or before them, or a short ``sell_start``, is refused the
    same way."""
    args, coo, T = _launcher_case(case)
    launches = launched()
    with pytest.raises((ValueError, TypeError), match=match):
        sparse_ops.snp_step_sparse_cuda(*args, **coo, max_branches=T)
    assert launched() == launches


@pytest.mark.parametrize("h", [1, 3, "auto"])
def test_kernel_inputs_with_lists_differ_only_in_the_adjacency(h):
    """``kernel_inputs(lists=True)`` hands the kernel the same bookkeeping
    as the plain version, with the sliced lists ``sell_start, sell_src``
    in place of ``in_idx`` (two arguments for one) and ``hub_neuron`` in
    place of ``hub_slot``; a pure-ELL encoding (B2) gets the sliced lists
    too, and nothing else."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    if h == "auto":
        h = J.SystemPlan(encoding="hybrid").resolved_hub_threshold(system)
    for hh in (h, None):
        pc, _ = _comps(system, hh)
        configs = torch.from_numpy(
            conftest.random_states(system, "no_delays", 3, seed=2))
        args, extra, _ = kernel_inputs(configs, pc)
        kargs, kextra, _ = kernel_inputs(configs, pc, lists=True)
        assert len(args) == 7 and len(kargs) == 8
        assert args[5] is pc.in_idx
        assert kargs[5] is pc.sell_start and kargs[6] is pc.sell_src
        for i, (a, b) in enumerate(zip(args[:5] + args[6:],
                                       kargs[:5] + kargs[7:])):
            assert torch.equal(a, b), i
        assert extra.keys() - {"hub_slot"} == kextra.keys() - {"hub_neuron"}
        if pc.is_hybrid:
            assert kextra["hub_neuron"] is pc.hub_neuron
        else:
            assert extra == kextra == {}


def test_hybrid_without_sliced_lists_is_refused_on_the_card_path():
    """A hybrid encoding without the sliced lists (hand-built) is refused
    where the kernel would run (``kernel_inputs(lists=True)``, what the
    wrapper asks on a CUDA tensor); the plain version, which reads
    ``in_idx``, steps it.  So is a pure-ELL encoding without them: B2
    walks the same lists."""
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc, _ = _comps(system, 1)
    ell, _ = _comps(system, None)
    configs = torch.from_numpy(
        conftest.random_states(system, "no_delays", 3, seed=4))
    for comp, f in ((pc, "sell_start"), (pc, "sell_src"),
                    (pc, "hub_neuron"), (ell, "sell_start"),
                    (ell, "sell_src")):
        bare = comp._replace(**{f: None})
        with pytest.raises(ValueError, match="sell_start/sell_src"):
            kernel_inputs(configs, bare, lists=True)
        _assert_all_equal(sparse_ops.snp_step_sparse(configs, bare,
                                                     max_branches=T),
                          sparse_ops.snp_step_sparse(configs, comp,
                                                     max_branches=T))


def test_hybrid_without_coo_metadata_is_refused():
    system, T = conftest.EQUIV_SYSTEMS["power-law-40"]
    pc, _ = _comps(system, 1)
    bare = pc._replace(coo_bounds=None, hub_slot=None)
    for name in ("sparse", "sparse_cuda"):
        with pytest.raises(ValueError, match="coo_bounds/hub_slot"):
            P.get_backend(name).lower(bare, P.SystemPlan())
        with pytest.raises(ValueError, match="coo_bounds/hub_slot"):
            P.get_backend(name).expand(bare.init_config[None], bare, T)
        with pytest.raises(ValueError, match="coo_bounds/hub_slot"):
            P.explore(bare, backend=name, max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="coo_bounds/hub_slot"):
        sparse_ops.snp_step_sparse(bare.init_config[None], bare,
                                   max_branches=T)
    # a pure-ELL encoding has no tail, so nothing is missing
    ell, _ = _comps(system, None)
    assert P.SparseCudaBackend().lower(
        ell._replace(coo_bounds=None, hub_slot=None), P.SystemPlan()) \
        is not None


@pytest.mark.parametrize("T", [0, 1 << 23])
def test_branch_counts_outside_the_exact_decode_are_refused(T):
    pc, _ = _comps(J.paper_pi(True), None)
    with pytest.raises(ValueError, match="2\\^23"):
        sparse_ops.snp_step_sparse(pc.init_config[None], pc, max_branches=T)


def test_kernel_source_ships_beside_the_wrapper():
    from repro_torch.kernels.snp_step import _build

    assert sparse_ops.SOURCE.is_file()
    assert _build.library_path(sparse_ops.SOURCE).name.startswith(
        "snp_step_sparse-")
    # the exact float32 decode needs IEEE division: no fast-math flags
    assert not any("fast_math" in f or "prec-div" in f
                   for f in _build.NVCC_FLAGS)
    assert 'extern "C" int snp_step_sparse(' in sparse_ops.SOURCE.read_text()


def test_build_all_starts_every_compile_before_waiting(tmp_path,
                                                       monkeypatch):
    """One nvcc per source, all started together; a failure names its
    source."""
    from repro_torch.kernels.snp_step import _build

    started, waited = [], []

    class FakeProc:
        def __init__(self, cmd, **kw):
            started.append(cmd[-1])
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0 if "good" in cmd[-1] else 1

        def communicate(self):
            waited.append(len(started))
            if self.returncode == 0:
                open(self.out, "w").close()
            return "log of " + self.out, None

    srcs = []
    for name in ("good_a.cu", "good_b.cu"):
        src = tmp_path / name
        src.write_text(f"// {name}\n")
        srcs.append(src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    out = _build.build_all(srcs)
    assert waited == [2, 2] and [p.exists() for p, _ in out] == [True, True]
    assert _build.build_all(srcs) == [(p, "") for p, _ in out]  # cached
    bad = tmp_path / "bad.cu"
    bad.write_text("// bad\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build.build_all([bad])
