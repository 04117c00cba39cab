"""Every LM family under the sharding plan: the reduced siblings of the
eight archs beyond the dense GQA family (M-RoPE and frontend embeds,
MoE with a shared expert and expert parallelism where the expert count
divides ``model``, MLA's latent cache, Mamba + MoE + attention, RWKV6,
parallel codebooks) run on 4 gloo ranks under ``make_plan(build_mesh((2,
2)))``: one train step (``make_train_step``, f32, remat ``"full"``), one
prefill and 4 greedy decode steps, parameters placed by
``plan.param_specs`` and caches by ``plan.cache_specs``, each held
against the same steps unmeshed on the same rank.  Loss, ``grad_norm``,
logits and caches within 1e-5 of the largest magnitude; greedy tokens,
the MoE's kept sets (every routing call's expert ids and kept mask) and
``drop_frac`` exactly equal.

The ranks are subprocesses over a ``FileStore`` under ``tmp_path``
(``tests/torch_mesh_support.py``); one 4-rank run serves every test."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_mesh_support import run_ranks  # noqa: E402

ARCHS = ["minicpm-2b", "qwen2-vl-7b", "qwen2-moe-a2.7b", "grok-1-314b",
         "minicpm3-4b", "jamba-1.5-large-398b", "rwkv6-7b",
         "musicgen-medium"]
MOE = ["qwen2-moe-a2.7b", "grok-1-314b", "jamba-1.5-large-398b"]

SCRIPT = """
import pickle
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.configs.smoke import reduced
from repro_torch.core import prng
from repro_torch.data import DataConfig, make_batch
from repro_torch.launch.train import place_batch
from repro_torch.models import init_params, moe
from repro_torch.models.convert import place
from repro_torch.runtime import build_mesh
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.sharding import make_plan
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

out, archs = sys.argv[1], json.loads(sys.argv[2])
plan = make_plan(build_mesh((2, 2), device_type="cpu"))


def whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


class Routing:
    # every MoE routing call's expert ids and kept mask, in order
    def __enter__(self):
        self.picks, self.route = [], moe.route

        def route(p, cfg, xt, C):
            got = self.route(p, cfg, xt, C)
            self.picks += [whole(got[1]).numpy(), whole(got[3]).numpy()]
            return got

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.route


def run(arch, p):
    res = {}
    cfg = reduced(get_config(arch))
    c = {} if p is None else {"constrain": p.constrain}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = init_params(prng.PRNGKey(1), cfg, device="cpu")
    state = init_train_state(params if p is None
                             else place(params, cfg, p), opt)
    step = make_train_step(cfg, opt, attn_impl="cuda", **c)
    b = make_batch(cfg, DataConfig(seed=3), step=0, shard=0, batch=4,
                   seq_len=16)
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    with Routing() as r:
        _, m = step(state, b if p is None else place_batch(b, cfg, p))
    res["train"] = np.array([float(m[k]) for k in ("loss", "grad_norm")])
    res["drop_frac"] = float(m["drop_frac"])
    res["train_picks"] = r.picks

    params = init_params(prng.PRNGKey(2), cfg, device="cpu")
    if p is not None:
        params = place(params, cfg, p)
    prefill = make_prefill_step(cfg, max_len=16, attn_impl="cuda", plan=p,
                                **c)
    decode = make_decode_step(cfg, **c)
    b = make_batch(cfg, DataConfig(seed=0), step=0, shard=0, batch=4,
                   seq_len=12)
    b = {k: torch.from_numpy(v) for k, v in b.items() if k != "labels"}
    with Routing() as r:
        logits, cache = prefill(params, b if p is None
                                else place_batch(b, cfg, p))
        res["prefill"] = whole(logits).numpy()
        tok = whole(logits)[..., -1, :].argmax(-1).to(torch.int32)[..., None]
        toks = []
        for g in range(4):
            pos = torch.full((3, 4, 1) if cfg.mrope_sections else (4, 1),
                             12 + g, dtype=torch.int32)
            tok, lg, cache = decode(params, cache, tok, pos)
            tok = whole(tok)
            toks.append(tok.numpy())
    res["tokens"] = np.stack(toks)
    res["decode"] = whole(lg).numpy()
    res["cache"] = {f"{l}.{k}": whole(t).numpy()
                    for l, layer in enumerate(cache)
                    for k, t in layer.items()}
    res["serve_picks"] = r.picks
    return res


res = {arch: {"want": run(arch, None), "got": run(arch, plan)}
       for arch in archs}
if RANK == 0:
    with open(out, "wb") as f:
        pickle.dump(res, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    import pickle
    tmp = tmp_path_factory.mktemp("mesh_families")
    run_ranks(4, SCRIPT, tmp, "families",
              [tmp / "out.pkl", json.dumps(ARCHS)], timeout=600)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def _close(got, want, tol=1e-5):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_2x2_equals_unmeshed(meshed, arch):
    got, want = meshed[arch]["got"], meshed[arch]["want"]
    np.testing.assert_allclose(got["train"], want["train"], rtol=1e-5)
    assert got["drop_frac"] == want["drop_frac"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_2x2_equal_unmeshed(meshed, arch):
    got, want = meshed[arch]["got"], meshed[arch]["want"]
    _close(got["prefill"], want["prefill"])
    _close(got["decode"], want["decode"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["cache"].keys() == want["cache"].keys()
    for name in want["cache"]:
        if name.endswith(".len"):
            np.testing.assert_array_equal(got["cache"][name],
                                          want["cache"][name])
        else:
            _close(got["cache"][name], want["cache"][name])


@pytest.mark.parametrize("arch", MOE)
def test_moe_kept_sets_on_2x2_equal_unmeshed(meshed, arch):
    got, want = meshed[arch]["got"], meshed[arch]["want"]
    for key in ("train_picks", "serve_picks"):
        assert len(got[key]) == len(want[key]) > 0
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)
