"""The port's delayed step against the reference, on the CPU:

* ``delayed_next_configs`` and ``sparse_delayed_next_configs`` (ELL and
  hybrid) equal the JAX functions on every entry, valid or not, and the
  delayed branch info equals the reference's field for field;
* the dense wrapper (B4's plain version on CPU tensors) equals the
  reference's Pallas ``snp_step`` in interpret mode, and the sparse
  wrapper (B5's plain version) the reference's ``snp_step_sparse``;
* each plain version, from its kernel's own inputs, is the step;
* the uint16 emit-now stage of B5 holds at the produce bound 2^16 − 1;
* on CPU tensors only the plain versions run, and the launchers refuse.

All comparisons are exact (tolerance 0)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import conftest  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import semantics as jsem  # noqa: E402
from repro.kernels.snp_step import snp_step as jdense  # noqa: E402
from repro.kernels.snp_step import snp_step_sparse as jsparse  # noqa: E402
from repro_torch.core.convert import system_from_spec  # noqa: E402
from repro_torch.kernels.launch_counts import (  # noqa: E402
    launches as launched)
from repro_torch.kernels.snp_step import ops, sparse_ops  # noqa: E402
from repro_torch.kernels.snp_step.ref import (  # noqa: E402
    snp_step_dense_delay_ref)
from repro_torch.kernels.snp_step.sparse_ref import (  # noqa: E402
    kernel_inputs, snp_step_sparse_ref)

NAMES = sorted(conftest.EQUIV_SYSTEMS)
FIELDS = ("configs", "valid", "emissions", "overflow")

# The reference steps, jitted: eager JAX compiles every primitive anew per
# shape, which costs seconds a call here.
j_delayed = jax.jit(J.delayed_next_configs, static_argnums=2)
j_sparse_delayed = jax.jit(J.sparse_delayed_next_configs, static_argnums=2)


def _delayed(name):
    system, T = conftest.EQUIV_SYSTEMS[name]
    return conftest.delayed_variant(system), T


def _dense(system):
    return (P.compile_system(system_from_spec(dataclasses.asdict(system)),
                             semantics="delays", device="cpu"),
            J.compile_system(system, semantics="delays"))


def _sparse(system, h):
    return (P.compile_system_sparse(
        system_from_spec(dataclasses.asdict(system)), hub_threshold=h,
        semantics="delays", device="cpu"),
        J.compile_system_sparse(system, hub_threshold=h, semantics="delays"))


def _assert_equal(port, ref, fields=FIELDS):
    for f, a, b in zip(fields, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def _states(system, batch, seed):
    return conftest.random_states(system, "delays", batch, seed=seed)


@pytest.mark.parametrize("name", NAMES)
def test_delayed_next_configs_match_reference(name):
    system, T = _delayed(name)
    pc, jc = _dense(system)
    states = _states(system, 7, seed=21)
    port = P.delayed_next_configs(torch.from_numpy(states), pc, T)
    ref = j_delayed(jnp.asarray(states), jc, T)
    _assert_equal([port.configs, port.valid, port.emissions, port.overflow,
                   port.spiking],
                  [ref.configs, ref.valid, ref.emissions, ref.overflow,
                   ref.spiking], FIELDS + ("spiking",))
    # one unbatched state row, as the reference's tests step it
    one = P.delayed_next_configs(torch.from_numpy(states[2]), pc, T)
    jone = j_delayed(jnp.asarray(states[2]), jc, T)
    _assert_equal([one.configs, one.valid, one.emissions, one.overflow],
                  [jone.configs, jone.valid, jone.emissions, jone.overflow])


@pytest.mark.parametrize("h", [None, 1, "auto"],
                         ids=["ell", "hybrid-h1", "hybrid-auto"])
@pytest.mark.parametrize("name", NAMES)
def test_sparse_delayed_next_configs_match_reference(name, h):
    system, T = _delayed(name)
    if h == "auto":
        h = J.SystemPlan(encoding="hybrid").resolved_hub_threshold(system)
    pc, jc = _sparse(system, h)
    states = _states(system, 6, seed=5)
    port = P.sparse_delayed_next_configs(torch.from_numpy(states), pc, T)
    ref = j_sparse_delayed(jnp.asarray(states), jc, T)
    _assert_equal([port.configs, port.valid, port.emissions, port.overflow],
                  [ref.configs, ref.valid, ref.emissions, ref.overflow])


@pytest.mark.parametrize("name", ["paper-pi", "random-17", "power-law-40"])
def test_delayed_branch_info_matches_reference(name):
    system, _ = _delayed(name)
    states = _states(system, 5, seed=2)
    (pd_, jd), (ps, js) = _dense(system), _sparse(system, 1)
    for port, ref in ((P.delayed_branch_info(torch.from_numpy(states), pd_),
                       jax.jit(jsem.delayed_branch_info)(
                           jnp.asarray(states), jd)),
                      (P.sparse_delayed_branch_info(torch.from_numpy(states),
                                                    ps),
                       jax.jit(jsem.sparse_delayed_branch_info)(
                           jnp.asarray(states), js))):
        for f in ref._fields:
            a, b = getattr(port, f), np.asarray(getattr(ref, f))
            if f == "rank":           # defined where the rule applies
                a, b = np.where(b >= 0, a.numpy(), -1), np.where(b >= 0, b,
                                                                 -1)
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    spikes, cd, pd = P.split_state(torch.from_numpy(states))
    m = system.num_neurons
    assert torch.equal(torch.cat([spikes, cd, pd], -1),
                       torch.from_numpy(states)) and spikes.shape[-1] == m


@pytest.mark.parametrize("name", ["paper-pi", "nd-chain-4", "random-17",
                                  "ring-lattice-12"])
def test_dense_wrapper_matches_pallas_interpret(name):
    """B4's plain version through the wrapper, against the reference's
    dense Pallas kernel with its delay stage, on every entry."""
    system, T = _delayed(name)
    pc, jc = _dense(system)
    states = _states(system, 5, seed=13)
    before = (ops.delay_plain_calls, launched("B4"), ops.plain_calls)
    port = ops.snp_step(torch.from_numpy(states), pc, max_branches=T)
    assert (ops.delay_plain_calls, launched("B4"), ops.plain_calls) == \
        (before[0] + 1, before[1], before[2])
    ref = jdense(jnp.asarray(states), jc, max_branches=T, block_b=2,
                 block_t=8, block_n=128, interpret=True)
    _assert_equal(port, ref)


@pytest.mark.parametrize("h", [None, 1], ids=["ell", "hybrid-h1"])
@pytest.mark.parametrize("name", ["paper-pi", "random-17", "power-law-40",
                                  "ring-lattice-12"])
def test_sparse_wrapper_matches_sparse_pallas_interpret(name, h):
    """B5's plain version through the wrapper, against the reference's
    sparse Pallas kernel with its delay stage, on every entry."""
    system, T = _delayed(name)
    pc, jc = _sparse(system, h)
    states = _states(system, 5, seed=17)
    before = (sparse_ops.plain_calls, launched())
    port = sparse_ops.snp_step_sparse(torch.from_numpy(states), pc,
                                      max_branches=T)
    assert (sparse_ops.plain_calls, launched()) == \
        (before[0] + 1, before[1])
    ref = jsparse(jnp.asarray(states), jc, max_branches=T, block_b=2,
                  block_t=8, interpret=True)
    _assert_equal(port, ref)


@pytest.mark.parametrize("name", ["random-17", "power-law-40"])
def test_plain_versions_are_the_kernel_contracts(name):
    """From its kernel's own inputs each plain version computes every
    entry of the delayed step: ``valid`` is ``t < Ψ`` before the ``alive``
    mask, the rest equals the step."""
    system, T = _delayed(name)
    states = torch.from_numpy(_states(system, 6, seed=4))
    pc, _ = _dense(system)
    args, info = ops.delay_inputs(states, pc)
    assert all(x.is_contiguous() for x in args)
    out, valid, emis = snp_step_dense_delay_ref(*args, T)
    ref = P.delayed_next_configs(states, pc, T)
    assert torch.equal(out, ref.configs) and torch.equal(emis,
                                                         ref.emissions)
    assert torch.equal(valid & info.alive[:, None], ref.valid)
    t = torch.arange(T).to(torch.float32)
    assert torch.equal(valid, t < info.psi[:, None])
    for h in (None, 2):
        sc, _ = _sparse(system, h)
        args, extra, info = kernel_inputs(states, sc)
        assert set(extra) >= {"dtab", "cd", "pd"}
        assert all(x.is_contiguous() for x in (*args, *extra.values()))
        out, valid, emis = snp_step_sparse_ref(*args, **extra,
                                               max_branches=T)
        ref = P.sparse_delayed_next_configs(states, sc, T)
        assert torch.equal(out, ref.configs) and torch.equal(
            emis, ref.emissions)
        assert torch.equal(valid & info.alive[:, None], ref.valid)


def _reopen_system(output_neuron):
    top = (1 << 16) - 1
    return J.SNPSystem(
        num_neurons=4, initial_spikes=(1, 1, 0, 0),
        rules=(J.Rule(neuron=0, consume=1, produce=top, regex_base=1,
                      delay=2),
               J.Rule(neuron=1, consume=1, produce=top, regex_base=1),
               J.Rule(neuron=2, consume=1, produce=1, regex_base=1,
                      regex_period=1, delay=1)),
        synapses=((0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
        output_neuron=output_neuron, name="reopen-top")


@pytest.mark.parametrize("out_neuron", [0, -1], ids=["out-0", "no-output"])
@pytest.mark.parametrize("h", [None, 1], ids=["ell", "hybrid-h1"])
def test_emit_now_fits_uint16_at_the_produce_bound(h, out_neuron):
    """B5 stages the emit-now value as uint16.  A reopening neuron (cd = 1)
    is closed, so it fires nothing: with produce = pending = 2^16 − 1 the
    staged value is still below 2^16 on every entry, and the step (the
    neighbours receive 2 · (2^16 − 1)) equals the reference."""
    top = (1 << 16) - 1
    system = _reopen_system(out_neuron)
    pc, jc = _sparse(system, h)
    states = np.array([
        [0, 1, 0, 0, 1, 0, 0, 0, top, 0, 0, 0],   # n0 reopens, n1 fires
        [1, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],     # everything open
        [0, 0, 3, 5, 1, 0, 1, 0, top, 0, 7, 0],   # n0 and n2 reopen
        [0, 1, 1, 0, 2, 0, 0, 0, top, 0, 0, 0],   # n0 stays closed
    ], np.int32)
    x = torch.from_numpy(states)
    args, extra, info = kernel_inputs(x, pc)
    from repro_torch.kernels.snp_step.sparse_ref import (decode_digits,
                                                         fired_packed)
    _, stride, choices, _, tab = args[:5]
    fired = fired_packed(decode_digits(8, stride, choices), tab) & 0xFFFF
    emit_now = fired + torch.where(extra["cd"] == 1, extra["pd"], 0)[:, None]
    assert int(emit_now.max()) == top and int(emit_now.min()) >= 0
    assert not bool(((extra["cd"] == 1)[:, None] & (fired != 0)).any())
    port = sparse_ops.snp_step_sparse(x, pc, max_branches=8)
    ref = jsparse(jnp.asarray(states), jc, max_branches=8, block_b=2,
                  block_t=8, interpret=True)
    _assert_equal(port, ref)
    # row 0, branch 0: n0's pending and n1's fired produce both land on n3
    assert int(port[0][0, 0, 3]) == 2 * top
    # the dense step agrees on valid entries (it has no uint16 stage)
    dc, djc = _dense(system)
    dense = ops.snp_step(x, dc, max_branches=8)
    v = dense[1].numpy()
    np.testing.assert_array_equal(v, port[1].numpy())
    np.testing.assert_array_equal(
        np.where(v[..., None], dense[0].numpy(), 0),
        np.where(v[..., None], port[0].numpy(), 0))
    np.testing.assert_array_equal(np.where(v, dense[2].numpy(), 0),
                                  np.where(v, port[2].numpy(), 0))


def test_kernel_launchers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel launcher silently: B4's and
    B5's launchers raise instead of falling back."""
    system, T = _delayed("power-law-40")
    states = torch.from_numpy(_states(system, 2, seed=1))
    pc, _ = _dense(system)
    args, _ = ops.delay_inputs(states, pc, lists=True)
    launches = launched("B4")
    with pytest.raises(ValueError, match="CUDA"):
        ops.snp_step_dense_delay(*args, T)
    assert launched("B4") == launches
    sc, _ = _sparse(system, 1)
    args, extra, _ = kernel_inputs(states, sc, lists=True)
    launches = launched()
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.snp_step_sparse_cuda(*args, **extra, max_branches=T)
    with pytest.raises(ValueError, match="come together"):
        sparse_ops.snp_step_sparse_cuda(*args, dtab=extra["dtab"],
                                        max_branches=T)
    assert launched() == launches


@pytest.mark.parametrize("h", [None, 1], ids=["ell", "h1"])
def test_delayed_bodies_walk_the_sliced_lists(h):
    """Both of B5's bodies run the sliced-list kernel: on the card path
    (``kernel_inputs(lists=True)``) the encoding's sliced lists take
    ``in_idx``'s place, two arguments for one (with ``hub_neuron`` for a
    hybrid one), the rest equal to the plain version's inputs; the
    launcher refuses ``in_idx`` beside the delay stage and, given the
    lists on CPU tensors, meets the device check; an encoding without the
    lists is refused there, while the plain wrapper still steps it."""
    system, T = _delayed("power-law-40")
    sc, _ = _sparse(system, h)
    states = torch.from_numpy(_states(system, 3, seed=5))
    args, extra, _ = kernel_inputs(states, sc)
    kargs, kextra, _ = kernel_inputs(states, sc, lists=True)
    assert args[5] is sc.in_idx
    assert kargs[5] is sc.sell_start and kargs[6] is sc.sell_src
    assert all(torch.equal(a, b)
               for a, b in zip(args[:5] + args[6:], kargs[:5] + kargs[7:]))
    assert kextra.keys() - {"hub_neuron"} == extra.keys() - {"hub_slot"}
    assert ("hub_neuron" in kextra) == bool(h)
    assert kextra.get("hub_neuron") is sc.hub_neuron
    launches = launched()
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.snp_step_sparse_cuda(*kargs, **kextra, max_branches=T)
    in_idx_args = kargs[:5] + (sc.in_idx,) + kargs[6:]
    with pytest.raises(ValueError, match="sliced lists"):
        sparse_ops.snp_step_sparse_cuda(*in_idx_args, **kextra,
                                        max_branches=T)
    assert launched() == launches
    bare = sc._replace(sell_start=None)
    with pytest.raises(ValueError, match="sell_start/sell_src"):
        kernel_inputs(states, bare, lists=True)
    _assert_equal(sparse_ops.snp_step_sparse(states, bare, max_branches=T),
                  sparse_ops.snp_step_sparse(states, sc, max_branches=T))


def test_dense_delayed_step_needs_the_in_neighbour_lists():
    system, T = _delayed("paper-pi")
    pc, _ = _dense(system)
    bare = pc._replace(adj_in=None)
    with pytest.raises(ValueError, match="adj_in"):
        ops.snp_step(bare.init_config[None], bare, max_branches=T)


@pytest.mark.parametrize("f", ["sell_start", "sell_src"])
def test_dense_delayed_without_sliced_lists_is_refused_on_the_card_path(f):
    """A delayed dense encoding without the sliced lists of ``adj_in``
    (hand-built) is refused where B4 would run (``delay_inputs(...,
    lists=True)``, what the wrapper asks on a CUDA tensor); the plain
    version, which reads ``adj_in``, steps it."""
    system, T = _delayed("power-law-40")
    pc, _ = _dense(system)
    bare = pc._replace(**{f: None})
    states = torch.from_numpy(_states(system, 3, seed=6))
    with pytest.raises(ValueError, match="sell_start/sell_src"):
        ops.delay_inputs(states, bare, lists=True)
    _assert_equal(ops.snp_step(states, bare, max_branches=T),
                  ops.snp_step(states, pc, max_branches=T))


@pytest.mark.parametrize("name", ["paper-pi", "power-law-40",
                                  "ring-lattice-12"])
def test_delay_inputs_with_lists_differ_only_in_the_adjacency(name):
    """``delay_inputs(lists=True)`` hands B4 the plain version's inputs
    with the encoding's sliced lists ``sell_start, sell_src`` in place of
    ``adj_in`` (two arguments for one), and nothing else changed."""
    system, T = _delayed(name)
    pc, _ = _dense(system)
    states = torch.from_numpy(_states(system, 4, seed=2))
    args, _ = ops.delay_inputs(states, pc)
    kargs, _ = ops.delay_inputs(states, pc, lists=True)
    assert len(args) == 14 and len(kargs) == 15
    assert args[12] is pc.adj_in
    assert kargs[12] is pc.sell_start and kargs[13] is pc.sell_src
    for i, (a, b) in enumerate(zip(args[:12] + args[13:],
                                   kargs[:12] + kargs[14:])):
        assert torch.equal(a, b), i


def _dense_launcher_case(case):
    """B4's launcher arguments at power-law-40 with one thing wrong (or
    ``ok``), and T.  The launcher takes the lists in ``adj_in``'s place:
    args[12] is ``sell_start``, args[13] ``sell_src``."""
    system, T = _delayed("power-law-40")
    pc, _ = _dense(system)
    states = torch.from_numpy(_states(system, 2, seed=3))
    args, _ = ops.delay_inputs(states, pc, lists=True)
    args = list(args)
    start, src = args[12:14]
    if case == "adj-in-for-lists":
        args[12] = pc.adj_in
    elif case == "no-lists":
        args[12] = args[13] = None
    elif case == "one-list":
        args[13] = None
    elif case == "short-sell-start":
        args[12] = start[:-1]
    elif case == "2d-sell-src":
        args[13] = src.reshape(-1, 32)
    elif case == "int64-sell-src":
        args[13] = src.to(torch.int64)
    return args, T


@pytest.mark.parametrize("case, match", [
    ("adj-in-for-lists", "sliced lists"), ("no-lists", "sliced lists"),
    ("one-list", "sliced lists"), ("short-sell-start", "sell_start"),
    ("2d-sell-src", "sell_src"), ("int64-sell-src", "sell_src"),
    ("ok", "CUDA")])
def test_dense_delay_launcher_checks_the_sliced_lists(case, match):
    """B4's launcher takes the sliced lists of ``adj_in`` in its place
    and checks their shapes on the host (the kernel reads entries out of
    range as the zero slot): ``adj_in`` itself, no lists, one list, a
    short ``sell_start``, a 2-D or int64 ``sell_src`` are refused before
    anything launches; well-formed lists on CPU tensors then meet the
    device check."""
    args, T = _dense_launcher_case(case)
    launches = launched("B4")
    with pytest.raises(ValueError, match=match):
        ops.snp_step_dense_delay(*args, T)
    assert launched("B4") == launches


def test_kernel_sources_ship_beside_the_wrappers():
    from repro_torch.kernels.snp_step import _build

    assert ops.DELAY_SOURCE.is_file()
    assert _build.library_path(ops.DELAY_SOURCE).name.startswith(
        "snp_step_dense_delay-")
    assert 'extern "C" int snp_step_dense_delay(' in \
        ops.DELAY_SOURCE.read_text()
    text = sparse_ops.SOURCE.read_text()
    assert "HAS_DELAY" in text and "int has_delay" in text
    bodies = {sparse_ops.body(c, d, h) for c in (False, True)
              for d in (False, True) for h in (False, True) if not (
                  h and (c or d))}
    assert bodies == {"B2", "B3", "B5-ELL", "B5-COO", "B7"}
