#!/usr/bin/env python3
"""How many operations on DTensors one meshed prefill, decode step and
train step of SmolLM-360M's depth make: each goes through DTensor's
dispatch (sharding propagation, redistribution, the local op), the host
cost phase 24 of ``chip_smoke.py`` measures against the unmeshed steps.

    PYTHONPATH=src python probes/dtensor_ops.py [--device cpu]

The count depends on the depth and the op graph, not on the widths, so
the config is SmolLM-360M's depth (32 layers), head dim and dtype at the
reduced sibling's widths, on a mesh of one rank, (1, 1) (``cpu`` by
default: a gloo group of one; ``cuda`` on the card: NCCL).  An operation
counts when any of its arguments is a DTensor (a dispatch mode above
DTensor's).  Prints one JSON object: the counts and torch's version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import reduced
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.train import place_batch
    from repro_torch.models import init_params
    from repro_torch.models.convert import place
    from repro_torch.runtime import build_mesh, join_group
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.sharding import make_plan
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    dev = ap.parse_args(argv).device
    full = get_config("smollm-360m")
    cfg = dataclasses.replace(reduced(full), num_layers=full.num_layers,
                              head_dim=full.head_dim, dtype=full.dtype)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, DTensor)
                   for a in tree_flatten((args, kwargs))[0]):
                Count.n += 1
            return func(*args, **kwargs)

    def count(fn):
        fn()                            # propagation caches warm
        Count.n = 0
        with Count():
            out = fn()
        return Count.n, out

    B, S = 8, 64
    b = make_batch(cfg, DataConfig(seed=0), step=0, shard=0, batch=B,
                   seq_len=S)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    out = {"torch": torch.__version__, "layers": cfg.num_layers}
    with join_group(torch.device(dev).type):
        plan = make_plan(build_mesh((1, 1), device_type=torch.device(
            dev).type))
        params = place(init_params(prng.PRNGKey(0), cfg, device=dev), cfg,
                       plan, replicate=True)
        prefill = make_prefill_step(cfg, max_len=S + 2, attn_impl="cuda",
                                    constrain=plan.constrain, plan=plan)
        decode = make_decode_step(cfg, constrain=plan.constrain)
        prompt = {k: batch[k] for k in ("tokens", "positions")}
        out["prefill"], (logits, _) = count(lambda: prefill(params, prompt))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((B, 1), S, dtype=torch.int32, device=dev)
        out["decode_step"], _ = count(
            lambda: decode(params, prefill(params, prompt)[1], tok, pos))
        out["decode_step"] -= out["prefill"]
        opt = AdamWConfig(lr=1e-4, warmup_steps=5, total_steps=20)
        state = [init_train_state(place(init_params(
            prng.PRNGKey(0), cfg, device=dev), cfg, plan), opt)]
        step = make_train_step(cfg, opt, remat="full", attn_impl="cuda",
                               constrain=plan.constrain)
        placed = place_batch(batch, cfg, plan)

        def train():
            state[0], m = step(state[0], placed)
            return m

        out["train_step"], _ = count(train)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
