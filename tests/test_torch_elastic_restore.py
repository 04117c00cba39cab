"""Elastic scaling end to end, the twin of ``tests/test_elastic_restore.py``
on the port's DTensor mesh: train the reduced ``smollm-360m`` on 8 gloo
ranks (mesh (4, 2)), checkpoint at step 4, lose half the fleet, restore
the same checkpoint on 4 ranks (mesh (2, 2)) and keep training on the
same data.

Every step's loss and ``grad_norm``, on 8 ranks and after the restore on
4, must be within 1e-5 (relative) of the port's unmeshed steps from the
same weights and batches (a mesh changes only the order of the sums);
the step-8 loss within the 1e-4 that ``tests/test_torch_train_step.py``
holds the port to of the reference's ``make_train_step`` on one device.
Each run is a subprocess a rank (``tests/torch_mesh_support.py``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.train import (AdamWConfig, init_train_state,  # noqa: E402
                               make_train_step)
from torch_mesh_support import start_ranks, wait_ranks  # noqa: E402
from torch_train_support import one_thread, setup  # noqa: E402, F401

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
B, S, SEED = 4, 32, 9

SCRIPT = """
from repro_torch.configs import get_config
from repro_torch.configs.smoke import reduced
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import prng
from repro_torch.data import DataConfig, make_batch
from repro_torch.launch.train import place_batch
from repro_torch.models import init_params
from repro_torch.models.convert import place
from repro_torch.models.model import LM
from repro_torch.runtime import build_mesh, choose_mesh_shape
from repro_torch.sharding import make_plan
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_train_step, restore_train_state,
                               train_state_tree)

phase, ckpt, out = sys.argv[1:4]
mesh = build_mesh(choose_mesh_shape(WORLD, model_axis=2), device_type="cpu")
plan = make_plan(mesh)
cfg = reduced(get_config("smollm-360m"))
opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
step = make_train_step(cfg, opt, remat="none", attn_impl="cuda",
                       constrain=plan.constrain)

def batch_for(s):
    b = make_batch(cfg, DataConfig(seed=9), step=s, shard=0, batch=4,
                   seq_len=32)
    return place_batch({k: torch.from_numpy(v) for k, v in b.items()},
                       cfg, plan)

got = {"loss": {}, "grad_norm": {}, "mesh": list(mesh.shape)}

def run(state, steps):
    for s in steps:
        state, m = step(state, batch_for(s))
        got["loss"][s + 1] = float(m["loss"])
        got["grad_norm"][s + 1] = float(m["grad_norm"])
    return state

if phase == "first":
    params = place(init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg,
                   plan)
    state = run(init_train_state(params, opt), range(4))
    tree = train_state_tree(state, cfg)     # a collective: every rank
    if RANK == 0:
        save_checkpoint(ckpt, 4, tree)
    dist.barrier()
else:
    like = init_train_state(LM(None, cfg, "meta"), opt)
    state, s0 = restore_train_state(ckpt, like, cfg, device="cpu",
                                    plan=plan)
    assert s0 == 4 and int(state.step) == 4, s0
names = [n for n, _ in state.params.named_parameters()]
m_wq = state.opt.m[names.index("blocks.0.attn.wq")]
got["wq"] = [repr(p) for p in state.params.blocks[0].attn.wq.placements]
got["m_wq"] = [repr(p) for p in m_wq.placements]
state = run(state, range(4, 8))
if RANK == 0:
    json.dump(got, open(out, "w"))
dist.destroy_process_group()
"""


def _unmeshed(pc):
    """The port's 8 steps on one device: ({step: loss}, {step: norm})."""
    from repro_torch.core import prng
    from repro_torch.models import init_params
    opt = AdamWConfig(**OPT)
    state = init_train_state(init_params(prng.PRNGKey(0), pc,
                                         device="cpu"), opt)
    step = make_train_step(pc, opt, remat="none", attn_impl="cuda")
    loss, norm = {}, {}
    for s in range(8):
        b = make_batch(pc, DataConfig(seed=SEED), step=s, shard=0, batch=B,
                       seq_len=S)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        loss[s + 1], norm[s + 1] = float(m["loss"]), float(m["grad_norm"])
    return loss, norm


def _reference(jc, tree):
    """The reference's ``make_train_step`` on one device, 8 steps from the
    same weights: the losses."""
    state = jax_init_state(jax.tree.map(jnp.asarray, tree),
                           JaxAdamW(**OPT))
    step = jax.jit(jax_make_step(jc, JaxAdamW(**OPT), remat="none"))
    out = {}
    for s in range(8):
        b = make_batch(jc, DataConfig(seed=SEED), step=s, shard=0, batch=B,
                       seq_len=S)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out[s + 1] = float(m["loss"])
    return out


def _close(got, want, tol, what):
    assert abs(got - want) <= tol * abs(want), (what, got, want)


def test_restore_on_smaller_mesh(tmp_path):
    ckpt = tmp_path / "elastic"
    first = start_ranks(8, SCRIPT, tmp_path, "first",
                        ["first", ckpt, tmp_path / "first.json"])
    # while the 8 ranks train: the unmeshed port and the reference
    jc, pc, tree, _, _ = setup("smollm-360m")
    loss, norm = _unmeshed(pc)
    ref = _reference(jc, tree)
    wait_ranks(first, timeout=240)
    run8 = json.loads((tmp_path / "first.json").read_text())
    wait_ranks(start_ranks(4, SCRIPT, tmp_path, "resume",
                           ["resume", ckpt, tmp_path / "resume.json"]),
               timeout=240)
    run4 = json.loads((tmp_path / "resume.json").read_text())
    assert run8["mesh"] == [4, 2] and run4["mesh"] == [2, 2]
    # wq (d, H, hd) is P("data", "model", None): sharded on both meshes,
    # and its moments with it
    for run in (run8, run4):
        assert run["wq"] == ["Shard(dim=0)", "Shard(dim=1)"], run["wq"]
        assert run["m_wq"] == run["wq"]
    assert sorted(map(int, run8["loss"])) == list(range(1, 9))
    assert sorted(map(int, run4["loss"])) == list(range(5, 9))
    for run, steps in ((run8, range(1, 9)), (run4, range(5, 9))):
        for s in steps:
            _close(run["loss"][str(s)], loss[s], 1e-5, f"loss {s}")
            _close(run["grad_norm"][str(s)], norm[s], 1e-5, f"norm {s}")
    # the restored run continues the uninterrupted one
    np.testing.assert_allclose(
        [run4["loss"][str(s)] for s in range(5, 9)],
        [run8["loss"][str(s)] for s in range(5, 9)], rtol=1e-5)
    _close(run4["loss"]["8"], ref[8], 1e-4, "step 8 against the reference")
