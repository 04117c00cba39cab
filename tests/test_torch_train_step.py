"""The port's train step, checkpoints of its state, the supervisor and the
launcher (``repro_torch.train``, ``runtime``, ``launch.train``) against
the JAX package's, on the same state (the reference's ``TrainState``
carried across by ``train_state_from_jax``) and the same batches
(``make_batch``, numpy from a seed).

Tolerances (f32): per step the loss, ``grad_norm`` and ``lr`` within
1e-4 relative; after the steps ``m`` and ``v`` within 1e-4 of each
tensor's largest magnitude, the parameters within ``2·lr`` a step
absolutely (AdamW's first steps move an entry by about ``±lr``, so an
entry whose gradient is near 0 can take the other sign in the other
package) and all but 0.1% of entries within 1e-4 of the largest
magnitude.  With int8 compression an entry whose value sits on a
rounding boundary of its block can round to the next int8 step in one
package and not the other (the quantizer itself is bit for bit the
reference's, ``test_torch_train_optimizer.py``), so there up to 2% of
the entries of ``m``, ``v`` and the parameters may lie outside the
1e-4 bound, the parameters still within ``2·lr`` a step.  Remat changes nothing (1e-6);
microbatching stays within the reference's own test's 5e-3.  The
reference runs its train step directly (its launcher's mesh set-up
fails under this jax).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.train import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.models import (params_from_jax, tensors_from_jax,  # noqa
                                train_state_from_jax)
from repro_torch.runtime import (FailureInjector, StragglerConfig,  # noqa
                                 StragglerDetector, Supervisor,
                                 SupervisorConfig, rebalance_shares)
from repro_torch.train import (AdamWConfig, init_train_state,  # noqa: E402
                               make_train_step, restore_train_state,
                               train_state_tree)
from torch_train_support import numpy_tree, one_thread, setup  # noqa

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _batches(jc, n, B=4, S=16, seed=7):
    return [make_batch(jc, DataConfig(seed=seed), step=s, shard=0, batch=B,
                       seq_len=S) for s in range(n)]


def _jax_state(tree, compression=False):
    params = jax.tree.map(jnp.asarray, tree)
    return jax_init_state(params, JaxAdamW(**OPT), compression=compression)


def _port_state(jstate, cfg):
    return train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                device="cpu")


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _rel(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=tol)


def _far(got, want, tol=1e-4):
    """Entries of ``got`` further than ``tol`` of ``want``'s largest
    magnitude from it."""
    scale = max(float(want.abs().max()), 1e-30)
    return int(((got.detach().float() - want).abs() > tol * scale).sum())


def _check_state(pstate, jstate, cfg, steps, flips=0.0):
    """Parameters within ``2·lr`` a step of the reference's, and all but
    0.1% (more with compression: ``flips``) of their entries, and of
    ``m``'s and ``v``'s, within 1e-4 of each tensor's largest magnitude.
    Returns the entries outside by name."""
    lr = OPT["lr"]
    far = {}
    for name in ("params", "m", "v"):
        tree = jstate.params if name == "params" \
            else getattr(jstate.opt, name)
        want = tensors_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                device="cpu")
        got = list(pstate.params.parameters()) if name == "params" \
            else getattr(pstate.opt, name)
        if name == "params":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().float().numpy(),
                                           w.numpy(), atol=2 * lr * steps,
                                           rtol=0)
        far[name] = sum(_far(g, w) for g, w in zip(got, want))
        total = sum(w.numel() for w in want)
        allowed = total * max(flips, 0.001 if name == "params" else 0.0)
        assert far[name] <= allowed, (name, far[name], total)
    assert int(pstate.opt.count) == int(jstate.opt.count) == steps
    assert int(pstate.step) == int(jstate.step) == steps
    return far


@functools.lru_cache(maxsize=None)
def _jax_step(arch, mb, remat, comp):
    jc = setup(arch)[0]
    return jax.jit(jax_make_step(jc, JaxAdamW(**OPT), microbatches=mb,
                                 remat=remat, compression=comp))


# arch, microbatches, remat, compression, steps
STEPS = [
    ("smollm-360m", 1, "none", False, 3),
    ("smollm-360m", 2, "full", True, 2),
]


@pytest.mark.parametrize("arch,mb,remat,comp,steps", STEPS,
                         ids=[f"{a}-mb{m}-{r}-{'int8' if c else 'f32'}"
                              for a, m, r, c, _ in STEPS])
def test_train_steps_equal_the_reference(arch, mb, remat, comp, steps):
    jc, pc, tree, _, _ = setup(arch)
    jstate = _jax_state(tree, comp)
    pstate = _port_state(jstate, pc)
    assert (pstate.ef is None) == (not comp)
    jstep = _jax_step(arch, mb, remat, comp)
    pstep = make_train_step(pc, AdamWConfig(**OPT), microbatches=mb,
                            remat=remat, attn_impl="cuda", compression=comp)
    for b in _batches(jc, steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = pstep(pstate, _tb(b))
        for k in ("loss", "grad_norm", "lr", "ce", "load_balance_loss"):
            _rel(float(pm[k]), float(jm[k]))
    # int8 compression: an entry on a rounding boundary of its block's
    # quantum can round the other way in the other package (the f32
    # gradients differ in their last bits), which moves its applied
    # gradient by one quantum (max |block| / 127)
    _check_state(pstate, jstate, pc, steps, flips=0.02 if comp else 0.0)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "smollm-360m"])
def test_microbatch_split_equals_the_reference(arch):
    """``_split_microbatches`` against the reference's on a batch with
    M-RoPE positions (3, B, S) and frontend embeddings, and a plain one."""
    from repro.train.train_step import _split_microbatches as jax_split
    from repro_torch.train.train_step import _split_microbatches
    jc = setup(arch)[0]
    b = _batches(jc, 1)[0]
    want = jax_split({k: jnp.asarray(v) for k, v in b.items()}, 2)
    got = _split_microbatches(_tb(b), 2)
    assert len(got) == 2 and set(got[0]) == set(want)
    for i in range(2):
        for k, v in want.items():
            np.testing.assert_array_equal(got[i][k].numpy(),
                                          np.asarray(v[i]))


def _fresh(arch="smollm-360m", compression=False):
    jc, pc, tree, _, _ = setup(arch)
    return jc, pc, _port_state(_jax_state(tree, compression), pc)


def test_remat_and_microbatching_leave_the_step():
    jc, pc, _ = _fresh()
    b = _tb(_batches(jc, 1)[0])
    out = {}
    for mb in (1, 2):
        for remat in ("none", "full", "dots"):
            _, _, state = _fresh()
            step = make_train_step(pc, AdamWConfig(**OPT), microbatches=mb,
                                   remat=remat, attn_impl="cuda")
            state, m = step(state, b)
            out[mb, remat] = (state, m)
    base_state, base_m = out[1, "none"]
    for (mb, remat), (state, m) in out.items():
        tol = 1e-6 if mb == 1 else 5e-3
        _rel(float(m["loss"]), float(base_m["loss"]), tol)
        _rel(float(m["grad_norm"]), float(base_m["grad_norm"]), tol)
        for p, q in zip(state.params.parameters(),
                        base_state.params.parameters()):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), atol=tol,
                                       rtol=tol)


def test_train_loss_decreases():
    jc, pc, state = _fresh()
    step = make_train_step(pc, AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=50, grad_clip=1.0),
                           remat="none")
    b = _tb(_batches(jc, 1)[0])
    losses = []
    for _ in range(12):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert np.isfinite(losses).all()


def test_compressed_training_still_converges():
    jc, pc, state = _fresh(compression=True)
    step = make_train_step(pc, AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=50),
                           remat="none", compression=True)
    b = _tb(_batches(jc, 1)[0])
    losses = []
    for _ in range(10):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.95


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A reference-written ``TrainState`` checkpoint restores into the
    port, whose next step equals the reference's; a port-written one
    restores into the reference's template unchanged."""
    jc, pc, tree, _, _ = setup("smollm-360m")
    jstep = _jax_step("smollm-360m", 1, "none", False)
    pstep = make_train_step(pc, AdamWConfig(**OPT), remat="none")
    b0, b1 = _batches(jc, 2)
    jstate, _ = jstep(_jax_state(tree), {k: jnp.asarray(v)
                                         for k, v in b0.items()})
    d = str(tmp_path / "jax")
    jax_save(d, 1, jstate)
    like = _fresh()[2]
    pstate, s = restore_train_state(d, like, pc, device="cpu")
    assert s == 1 and int(pstate.step) == 1 and int(pstate.opt.count) == 1
    _check_state(pstate, jstate, pc, 1)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b1.items()})
    pstate, pm = pstep(pstate, _tb(b1))
    _rel(float(pm["loss"]), float(jm["loss"]))
    _check_state(pstate, jstate, pc, 2)

    d2 = str(tmp_path / "port")
    save_checkpoint(d2, 2, train_state_tree(pstate, pc))
    template = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jstate)
    back, s2, _ = jax_restore(d2, template)
    assert s2 == 2
    for got, want in zip(jax.tree.leaves(back),
                         jax.tree.leaves(numpy_tree(train_state_tree(
                             pstate, pc)))):
        np.testing.assert_array_equal(np.asarray(got), want)


def _supervised(tmp_path, name, fail_at, ckpt_every=5, max_restarts=3):
    jc, pc, _, _, _ = setup("smollm-360m")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    step_fn = make_train_step(pc, opt, remat="none")
    ckpt_dir = str(tmp_path / name)
    restored = []

    def make_step(restore_step):
        state = _fresh()[2]
        if restore_step is not None:
            state, s = restore_train_state(ckpt_dir, state, pc,
                                           step=restore_step, device="cpu")
            restored.append(s)
            return state, step_fn, s
        return state, step_fn, 0

    def data_for(s):
        return _tb(make_batch(jc, DataConfig(seed=7), step=s, shard=0,
                              batch=4, seq_len=16))

    sup = Supervisor(
        SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                         max_restarts=max_restarts),
        make_step, data_for, injector=FailureInjector(fail_at),
        snapshot=lambda s: train_state_tree(s, pc))
    return sup, restored


def test_supervisor_recovers_from_injected_failures(tmp_path):
    sup, restored = _supervised(tmp_path, "sup", (7, 13))
    state, report = sup.run(20)
    assert report["final_step"] == 20
    assert report["restarts"] == 2
    assert restored == [5, 10]
    assert int(state.step) == 20
    assert np.isfinite(report["loss"])


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup, _ = _supervised(tmp_path, "s2", (), ckpt_every=100,
                         max_restarts=2)

    class Always:
        def check(self, step):
            if step == 1:
                raise RuntimeError("hard failure")

    sup.injector = Always()
    with pytest.raises(RuntimeError, match="max_restarts"):
        sup.run(5)


def test_straggler_detector_and_rebalance():
    det = StragglerDetector(StragglerConfig(patience=2, evict_after=3),
                            num_hosts=4)
    decision = {}
    for _ in range(6):
        decision = det.observe([1.0, 1.0, 3.0, 1.0])
    assert decision["stragglers"] == [2]
    assert decision["evict"] == [2]
    shares = rebalance_shares(4, 4, [2], slowdown=2.0)
    assert sum(shares) == 16 and shares[2] == 2
    assert rebalance_shares(4, 4, []) == [4, 4, 4, 4]


def test_launcher_failure_drill_resumes_as_uninterrupted(tmp_path, capsys):
    """``--smoke --device cpu`` with a failure at step 3: one restart, and
    every step's loss equals an uninterrupted run's (the restored state
    is the checkpointed one exactly)."""
    from repro_torch.launch.train import main
    argv = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--steps", "8", "--seq", "32", "--batch", "4", "--log-every",
            "4", "--ckpt-every", "2"]
    _, drill = main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                            "--fail-at", "3"])
    _, plain = main(argv)
    out = capsys.readouterr().out
    assert drill["restarts"] == 1 and drill["final_step"] == 8
    assert "[train] restored step 2" in out
    assert sorted(drill["loss"]) == list(range(1, 9))
    for s in range(1, 9):
        assert abs(drill["loss"][s] - plain["loss"][s]) <= 1e-6, s
    assert plain["loss"][8] < plain["loss"][1]
    assert len(drill["step_ms"]) == 9          # step 3 ran twice


def test_launcher_picks_wsd_and_needs_a_device(monkeypatch, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--steps",
          "2", "--seq", "16", "--batch", "2", "--log-every", "1"])
    assert "schedule=wsd" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
    _, pc, tree, _, _ = setup("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_jax(_jax_state(tree), pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, pc)
