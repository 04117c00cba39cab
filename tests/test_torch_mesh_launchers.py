"""The meshed launchers of the port (``launch/serve.py``'s ``serve_lm`` and
``launch/train.py``) on 4 gloo ranks against their runs on one device, the
serve steps on a (2, 2) plan, GQA attention and the split decode
attention on a (1, 4) mesh, the launchers' need of a card, and the meshes
``build_mesh_for_available`` and ``make_production_mesh`` build.

On 4 ranks the launchers build the reference's mesh for 4 devices, (1,
4); the serve steps then run on a (2, 2) mesh of the same ranks, where
SmolLM's reduced 6 q / 2 kv heads shard over ``model`` and the KV cache's
24 slots over ``model`` too (``cache_specs``), so B8's plain version
runs on each rank's heads and the prefill and decode write a
sequence-sharded cache.  Greedy tokens must equal the unmeshed ones,
logits and the cache within 1e-5 of the largest magnitude, the train
launcher's losses (a failure drill on the mesh) within 1e-5 relative.

On (1, 4) the reduced command-r (16 q / 2 kv heads) shards q's heads
over ``model`` while its kv heads cannot be: each rank reads the kv
heads of its 4 q heads (within one group of 8) from its global head
offset, their gradients summed over ``model``.  Its attention's output
and q/k/v gradients, and two train steps through the plan, must be
within 1e-5 of the unmeshed port; so must the decode attention over a
cache whose sequence is sharded unevenly over the 4 ranks (13 slots: 4,
4, 4, 1; 3 slots: one rank holds none).

The ranks are subprocesses (``tests/torch_mesh_support.py``); the meshes
of 256 and 512 ranks are built over the ``"fake"`` process group."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import make_decode_step, make_prefill_step  # noqa
from torch_mesh_support import start_ranks, wait_ranks  # noqa: E402

SERVE = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch",
         "4", "--prompt-len", "17", "--gen", "6"]
TRAIN = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--steps",
         "6", "--seq", "32", "--batch", "4", "--log-every", "2",
         "--ckpt-every", "2"]
B, S, G = 4, 17, 6

SCRIPT = """
import numpy as np
from repro_torch.configs import get_config
from repro_torch.configs.smoke import reduced
from repro_torch.core import prng
from repro_torch.data import DataConfig, make_batch
from repro_torch.kernels.flash_attn import ops
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import init_params
from repro_torch.models.convert import place
from repro_torch.runtime import build_mesh
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.sharding import make_plan

out, ckpt, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
res = {"gen": serve_main(argv["serve"])}

# the serve steps on a (2, 2) mesh of the same ranks
plan = make_plan(build_mesh((2, 2), device_type="cpu"))
cfg = reduced(get_config("smollm-360m"))
params = place(init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg, plan,
               replicate=True)
prefill = make_prefill_step(cfg, max_len=24, attn_impl="cuda",
                            constrain=plan.constrain, plan=plan)
decode = make_decode_step(cfg, constrain=plan.constrain)
b = make_batch(cfg, DataConfig(seed=0), step=0, shard=0, batch=4,
               seq_len=17)
batch = {k: torch.from_numpy(v) for k, v in b.items() if k != "labels"}
calls = ops.plain_calls
logits, cache = prefill(params, batch)
b8 = ops.plain_calls - calls
res["k_placements"] = np.array([repr(p) for p in cache[0]["k"].placements])
res["prefill_logits"] = logits.full_tensor().numpy()
res["prefill_k"] = cache[0]["k"].full_tensor().numpy()
tok = logits[:, -1].argmax(-1).to(torch.int32)[..., None]
toks = []
for g in range(6):
    pos = torch.full((4, 1), 17 + g, dtype=torch.int32)
    tok, lg, cache = decode(params, cache, tok, pos)
    toks.append(tok.full_tensor()[:, 0])
res["tokens"] = torch.stack(toks, -1).numpy()
res["decode_logits"] = lg.full_tensor().numpy()
res["k"] = cache[0]["k"].full_tensor().numpy()
res["len"] = cache[0]["len"].full_tensor().numpy()

_, report = train_main(argv["train"] + ["--ckpt-dir", ckpt, "--fail-at",
                                        "3"])
res["train_loss"] = np.array([report["loss"][s] for s in range(1, 7)])
res["restarts"] = report["restarts"]
res["mesh"] = np.array(list(report["mesh"].values()))
res["b8_plain_calls"] = b8

# reduced command-r on (1, 4): q's 16 heads sharded, the 2 kv heads whole
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.train import place_batch
from repro_torch.models.layers import _attend, _decode_attend
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
plan = make_plan(build_mesh((1, 4), device_type="cpu"))
mesh = plan.mesh
rng = np.random.default_rng(5)
q0, k0, v0 = (torch.from_numpy(rng.standard_normal((2, 9, h, 16)).astype(
    np.float32)) for h in (16, 2, 2))
w = torch.from_numpy(rng.standard_normal((2, 9, 16, 16)).astype(np.float32))
plain = [t.clone().requires_grad_() for t in (q0, k0, v0)]
att = _attend(*plain, "cuda")
(att * w).sum().backward()
res["gqa_want"] = np.stack([att.detach().numpy().ravel(),
                           plain[0].grad.numpy().ravel()])
res["gqa_kv_grad_want"] = np.stack([t.grad.numpy() for t in plain[1:]])
meshed = [distribute_tensor(t, mesh, pl).requires_grad_() for t, pl in (
    (q0, [Replicate(), Shard(2)]), (k0, [Replicate()] * 2),
    (v0, [Replicate()] * 2))]
att = _attend(*meshed, "cuda")
res["gqa_out_placements"] = np.array([repr(p) for p in att.placements])
(att.full_tensor() * w).sum().backward()
res["gqa_got"] = np.stack([att.full_tensor().detach().numpy().ravel(),
                           meshed[0].grad.full_tensor().numpy().ravel()])
res["gqa_kv_grad_got"] = np.stack([t.grad.full_tensor().numpy()
                                   for t in meshed[1:]])

# the decode attention over a cache sharded unevenly along its sequence
for smax, lens in ((13, [5, 13]), (3, [2, 3])):
    qd = torch.from_numpy(rng.standard_normal((2, 1, 16, 16)).astype(
        np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((2, smax, 2, 16)).astype(
        np.float32)) for _ in range(2))
    n = torch.tensor(lens, dtype=torch.int32)
    res[f"decode{smax}_want"] = _decode_attend(qd, ck, cv, n).numpy()
    got = _decode_attend(*(distribute_tensor(t, mesh, pl) for t, pl in (
        (qd, [Replicate()] * 2), (ck, [Replicate(), Shard(1)]),
        (cv, [Replicate(), Shard(1)]), (n, [Replicate()] * 2))))
    res[f"decode{smax}_got"] = got.full_tensor().numpy()

# two train steps of reduced command-r through the plan, and without it
cfg = reduced(get_config("command-r-35b"))
opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
steps = {}
for label, p in (("want", None), ("got", plan)):
    params = init_params(prng.PRNGKey(2), cfg, device="cpu")
    state = init_train_state(place(params, cfg, p) if p else params, opt)
    step = make_train_step(cfg, opt, attn_impl="cuda",
                           **({"constrain": p.constrain} if p else {}))
    vals = []
    for s in range(2):
        b = make_batch(cfg, DataConfig(seed=4), step=s, shard=0, batch=4,
                       seq_len=16)
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        state, m = step(state, place_batch(b, cfg, p) if p else b)
        vals += [float(m["loss"]), float(m["grad_norm"])]
    res[f"cr_train_{label}"] = np.array(vals)
wq = state.params.blocks[0].attn.wq
wk = state.params.blocks[0].attn.wk
res["cr_wq_wk"] = np.array([repr(wq.placements), repr(wk.placements)])
if RANK == 0:
    np.savez(out, **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """The 4-rank run, and (started while it runs) the unmeshed one."""
    tmp = tmp_path_factory.mktemp("mesh_launchers")
    run = start_ranks(4, SCRIPT, tmp, "launchers", [
        tmp / "out.npz", tmp / "ckpt",
        json.dumps({"serve": SERVE, "train": TRAIN})])
    want = {"gen": serve_main(SERVE)}
    _, report = train_main(TRAIN)
    want["train_loss"] = np.array([report["loss"][s] for s in range(1, 7)])
    cfg = reduced(get_config("smollm-360m"))
    params = init_params(prng.PRNGKey(0), cfg, device="cpu")
    logits, cache = make_prefill_step(cfg, max_len=24, attn_impl="cuda")(
        params, {k: torch.from_numpy(v) for k, v in make_batch(
            cfg, DataConfig(seed=0), step=0, shard=0, batch=B,
            seq_len=S).items() if k != "labels"})
    want["prefill_logits"] = logits.numpy()
    want["prefill_k"] = cache[0]["k"].clone().numpy()
    decode = make_decode_step(cfg)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[..., None]
    toks = []
    for g in range(G):
        pos = torch.full((B, 1), S + g, dtype=torch.int32)
        tok, lg, cache = decode(params, cache, tok, pos)
        toks.append(tok[:, 0])
    want.update(tokens=torch.stack(toks, -1).numpy(),
                decode_logits=lg.numpy(), k=cache[0]["k"].numpy(),
                len=cache[0]["len"].numpy())
    wait_ranks(run, timeout=240)
    return dict(np.load(tmp / "out.npz")), want


def _close(got, want, tol=1e-5):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def test_meshed_serve_launcher_gives_the_unmeshed_tokens(meshed):
    got, want = meshed
    assert got["gen"].shape == (B, G)
    np.testing.assert_array_equal(got["gen"], want["gen"])


def test_serve_steps_on_a_2x2_mesh(meshed):
    got, want = meshed
    # the cache laid out by cache_specs: batch over data, slots over model
    assert list(got["k_placements"]) == ["Shard(dim=0)", "Shard(dim=1)"]
    assert int(got["b8_plain_calls"]) == 2    # one a layer, on the shard
    for name in ("prefill_logits", "prefill_k", "decode_logits", "k"):
        _close(got[name], want[name])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["len"], want["len"])


def test_meshed_train_launcher_drill_equals_the_unmeshed_run(meshed):
    got, want = meshed
    assert list(got["mesh"]) == [1, 4]
    assert int(got["restarts"]) == 1
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-5)


def test_gqa_attention_with_kv_heads_whole_on_1x4(meshed):
    got, _ = meshed
    # q's heads stay sharded; each rank's 4 q heads read one kv head
    assert list(got["gqa_out_placements"]) == ["Replicate()",
                                               "Shard(dim=2)"]
    for part in range(2):          # the output, then q's gradient
        _close(got["gqa_got"][part], got["gqa_want"][part])
    for i in range(2):             # k's and v's gradients, summed
        _close(got["gqa_kv_grad_got"][i], got["gqa_kv_grad_want"][i])


@pytest.mark.parametrize("smax", [13, 3])
def test_decode_attention_split_over_sequence_shards(meshed, smax):
    got, _ = meshed
    _close(got[f"decode{smax}_got"], got[f"decode{smax}_want"])


def test_command_r_train_steps_on_1x4(meshed):
    got, _ = meshed
    # wq's heads over model; wk's 2 kv heads do not divide 4: whole
    wq, wk = got["cr_wq_wk"]
    assert "Shard(dim=1)" in wq and "Shard(dim=1)" not in wk, (wq, wk)
    np.testing.assert_allclose(got["cr_train_got"], got["cr_train_want"],
                               rtol=1e-5)


def test_launchers_need_a_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", "smollm-360m", "--smoke", "--gen", "1"])


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


@pytest.mark.parametrize("world,shape", [
    (1, (1, 1)), (4, (1, 4)), (6, (3, 2)), (12, (3, 4)), (16, (2, 8)),
    (256, (16, 16)), (512, (2, 16, 16))])
def test_build_mesh_for_available(fake_group, world, shape):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import build_mesh_for_available
    fake_group(world)
    mesh = build_mesh_for_available("cpu")
    assert tuple(mesh.shape) == shape
    names = ("pod", "data", "model") if len(shape) == 3 \
        else ("data", "model")
    assert mesh.mesh_dim_names == names
    if world >= 256:
        prod = make_production_mesh(multi_pod=world >= 512,
                                    device_type="cpu")
        assert tuple(prod.shape) == shape
