"""Training launcher (the port of the JAX package's ``repro.launch.train``):
real steps of any arch on a mesh of devices, with AdamW under a WSD
schedule (for an arch whose config names it) or cosine, microbatched
gradient accumulation, remat, int8 gradient compression, and, under
``--ckpt-dir``, the :class:`~repro_torch.runtime.Supervisor`:
checkpoints every ``--ckpt-every`` steps, resume from the latest, and the
failure drill of ``--fail-at``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --batch 8 --seq 2048 --steps 20 --remat full     # on the card

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-360m --smoke --device cpu --steps 8  # (2, 2), gloo

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --device cpu --steps 8 --ckpt-dir /tmp/run1 --fail-at 3

Under ``torchrun`` with more than one rank the launcher runs on the
reference's mesh (:func:`build_mesh_for_available`, one rank of the
process group a device: NCCL on the card, gloo on the CPU); the state is
placed on it by :func:`~repro_torch.sharding.make_plan`'s specs
(DTensors), and the plan's ``constrain`` runs in the step.  Every rank
runs the same steps and the same failure drill; rank 0 prints and writes
the checkpoints.  A world of one trains on its one device without a
process group or DTensors: a (1, 1) mesh gives the same values and only
adds DTensor's host time.  ``train(args, plan=)`` runs on a given plan's
mesh whatever the world (its group started by the caller).

The weights are random, drawn from ``PRNGKey(--seed)`` at the config's
shapes (the reference's values), and the batches are ``make_batch(step=
...)``'s.  The attention runs through kernel B8 (``attn_impl="cuda"``;
on the CPU its plain version; on a mesh on each rank's shard), whose
backward is the plain attention's, recomputed; the reference's launcher
trains with its plain ``"xla"`` attention, the same deliberate
difference the port's serve launcher makes.  ``--layers`` (the port's)
cuts the depth.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..checkpoint import latest_step
from ..configs import get_config
from ..configs.smoke import reduced
from ..core import prng
from ..core.device import resolve_device
from ..data import DataConfig, make_batch
from ..models import init_params, param_count
from ..models.convert import place
from ..models.layers import _identity
from ..runtime import (FailureInjector, Supervisor, SupervisorConfig,
                       build_mesh, join_group, world_size)
from ..sharding import make_plan
from ..train import (AdamWConfig, init_train_state, make_train_step,
                     restore_train_state, train_state_tree)
from .mesh import make_production_mesh

__all__ = ["train", "main", "build_mesh_for_available", "launch_plan",
           "place_batch"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_mesh_for_available(device_type: str = "cuda"):
    """The reference's mesh for the ranks of the process group: the
    production mesh at 512 or 256 ranks, else ``(n // model, model)`` with
    ``model`` the largest of 8, 4, 2, 1 that divides ``n``."""
    n = dist.get_world_size()
    if n >= 512:
        return make_production_mesh(multi_pod=True, device_type=device_type)
    if n >= 256:
        return make_production_mesh(device_type=device_type)
    # degenerate CPU/debug meshes
    model = next(c for c in (8, 4, 2, 1) if n % c == 0)
    return build_mesh((n // model, model), device_type=device_type)


@contextlib.contextmanager
def launch_plan(dev: torch.device, plan=None):
    """Run a launcher's block with (plan, rank): ``plan`` as given (on a
    group the caller started); else, among more than one rank (a started
    group or ``torchrun``'s), :func:`make_plan` on
    :func:`build_mesh_for_available` in the joined group; else (None, 0),
    the one device without a group."""
    if plan is not None:
        yield plan, dist.get_rank()
    elif world_size() == 1:
        yield None, 0
    else:
        with join_group(dev.type) as (rank, _):
            yield make_plan(build_mesh_for_available(dev.type)), rank


def place_batch(batch: Dict[str, torch.Tensor], cfg, plan):
    """A batch every rank holds whole, as DTensors on ``plan``'s mesh by
    ``plan.batch_specs`` (the batch split over the data axes); without a
    plan, the batch as it is."""
    if plan is None:
        return batch
    from torch.distributed.tensor import distribute_tensor
    specs = plan.batch_specs(cfg, batch)
    return {k: distribute_tensor(v, plan.mesh, plan.named(specs[k]))
            for k, v in batch.items()}


def train(args, plan=None):
    """Train as ``args`` say (see :func:`main`'s flags), on ``plan``'s
    mesh if given, else as :func:`launch_plan` decides.  Returns (state,
    report): ``report`` holds the loss, ``grad_norm`` and ``lr`` of every
    step by its number (1-based; a step replayed after a restart keeps
    its last value), the host-clock ms of each step run, the restarts,
    the final step and the mesh's shape (``None`` without a mesh)."""
    dev = resolve_device(args.device)
    with launch_plan(dev, plan) as (plan, rank):
        return _train(args, dev, plan, rank)


def _train(args, dev, plan, rank):
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    sched = "wsd" if cfg.schedule == "wsd" else "cosine"
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps, schedule=sched)
    data_cfg = DataConfig(seed=args.seed)
    mesh = None if plan is None else dict(zip(plan.mesh.mesh_dim_names,
                                              plan.mesh.shape))
    say(f"[train] arch={cfg.name} layers={cfg.num_layers} device={dev} "
        f"mesh={mesh} batch={args.batch}x{args.seq} remat={args.remat} "
        f"microbatches={args.microbatches} schedule={sched}")

    step_fn = make_train_step(
        cfg, opt_cfg, microbatches=args.microbatches, remat=args.remat,
        attn_impl="cuda", compression=args.compression,
        constrain=_identity if plan is None else plan.constrain)

    def fresh():
        params = init_params(prng.PRNGKey(args.seed), cfg, device=dev)
        if plan is not None:
            place(params, cfg, plan)
        return init_train_state(params, opt_cfg,
                                compression=args.compression)

    def data_for(step: int):
        b = make_batch(cfg, data_cfg, step=step, shard=0, batch=args.batch,
                       seq_len=args.seq)
        return place_batch({k: torch.from_numpy(v).to(dev)
                            for k, v in b.items()}, cfg, plan)

    report: Dict = {"loss": {}, "grad_norm": {}, "lr": {}, "step_ms": [],
                    "mesh": mesh}
    t_start = time.perf_counter()

    def run_step(state, batch):
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        n = int(state.step)                 # waits for the step
        report["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("loss", "grad_norm", "lr"):
            report[k][n] = float(metrics[k])
        if n % args.log_every == 0:
            say(f"[train] step {n:5d} loss {report['loss'][n]:.4f} "
                f"grad_norm {report['grad_norm'][n]:.3f} "
                f"lr {report['lr'][n]:.2e} "
                f"({report['step_ms'][-1]:.1f} ms)", flush=True)
        return state, metrics

    state = fresh()
    say(f"[train] params: {param_count(state.params):,}")
    if args.ckpt_dir:
        first = [state]          # the state drawn above, used once

        def make_step(restore_step: Optional[int]):
            state = first.pop() if first else fresh()
            if restore_step is not None:
                state, s = restore_train_state(args.ckpt_dir, state, cfg,
                                               step=restore_step,
                                               device=dev, plan=plan)
                say(f"[train] restored step {s}")
                return state, run_step, s
            start = latest_step(args.ckpt_dir)
            if start is not None:
                return make_step(start)
            return state, run_step, 0

        del state
        sup = Supervisor(
            SupervisorConfig(ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every),
            make_step, data_for,
            injector=FailureInjector(args.fail_at) if args.fail_at
            else None,
            snapshot=lambda s: train_state_tree(s, cfg),
            write=rank == 0,
            barrier=dist.barrier if plan is not None else lambda: None)
        state, done = sup.run(args.steps)
        report.update(restarts=done["restarts"],
                      final_step=done["final_step"])
        say(f"[train] done: {done}")
    else:
        for step in range(args.steps):
            state, _ = run_step(state, data_for(step))
        report.update(restarts=0, final_step=args.steps)
        last = report["loss"].get(args.steps, float("nan"))
        say(f"[train] done in {time.perf_counter() - t_start:.1f}s, "
            f"final loss {last:.4f}")
    return state, report


def main(argv=None, *, plan=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return train(ap.parse_args(argv), plan)


if __name__ == "__main__":
    main()
