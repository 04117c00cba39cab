"""Multi-pod dry run: one step of every (arch × shape × mesh) cell on
fake tensors, counted (the port of the JAX package's
``repro.launch.dryrun``).

For each cell: the ``"fake"`` process group of 256 or 512 ranks
(``torch.distributed``'s test backend: collectives return at once), the
production mesh of cards over it (``make_production_mesh``: (16, 16) or
(2, 16, 16); no card is touched), the plan (``make_plan``), the state,
batch and cache as meta tensors placed by the plan (:mod:`.specs`), and
the real ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` run once under
:class:`~repro_torch.roofline.StepCounter`, which counts the per-device
program: FLOPs by dtype, HBM bytes, collectives, live memory.
The record (:func:`~repro_torch.roofline.analyze_step`) holds the three
roofline terms at H100 rates, the memory against the card's 80 GB
(``argument_bytes`` exact from the local shapes, ``temp_bytes`` the
peak of what the step allocates and holds) and ``replication``: the
per-device FLOPs × devices over the same step's FLOPs counted unmeshed
on meta tensors (1 when the mesh splits the work without repeating
any).  Nothing is allocated and no kernel runs; B8 (``--attn-impl
cuda``) is counted through its custom operator's FLOP formula.  Results
stream to one JSON a cell, so partial runs are never lost.

The SNP cell (``--snp``) runs one dense-row level of
``explore_distributed`` (``core/distributed.py::_dense_level``) of
``random_system(2048, 2, 8/2048, seed=0)`` at F = 32, T = 64 a rank over
256 (512) ranks on meta tensors, through the plain backend ``"ref"``
(the compiled system copied to the meta device once, its constants and
``config_hash``'s cached on it), and records the per-rank program (the
level's count over the ranks);
the in-process exchange of its rows is counted as what it stands for,
one all-to-all of the group with the send buffer's bytes a rank.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both --out experiments/dryrun_torch
    ... --arch smollm-360m --shape train_4k --mesh single   # one cell
    ... --snp                                                # SNP cell
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ArchConfig, ShapeSpec
from ..roofline import StepCounter, analyze_step
from .mesh import make_production_mesh
from .specs import (abstract_cache, abstract_params, abstract_train_state,
                    decode_input_specs, input_specs)

__all__ = ["TRAIN_KNOBS", "run_cell", "run_snp_cell", "fake_group",
           "main"]

# Per-arch training knobs chosen so activations fit 16 GB/chip under full
# remat (the reference's; its memory analysis validated them on TPU v5e).
TRAIN_KNOBS: Dict[str, Dict[str, Any]] = {
    "qwen2-vl-7b":          dict(microbatches=4),
    "qwen2-moe-a2.7b":      dict(microbatches=4),
    "grok-1-314b":          dict(microbatches=16),
    "command-r-35b":        dict(microbatches=8),
    "minicpm3-4b":          dict(microbatches=4),
    "smollm-360m":          dict(microbatches=1),
    "minicpm-2b":           dict(microbatches=2),
    "jamba-1.5-large-398b": dict(microbatches=8),
    "rwkv6-7b":             dict(microbatches=4),
    "musicgen-medium":      dict(microbatches=2),
}

#: the port's attention implementations (the reference's xla, chunked,
#: pallas)
ATTN_IMPLS = ("ref", "chunked", "cuda")


def _model_flops(cfg: ArchConfig, spec: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode counts one
    token per sequence, no backward (2·N·D)."""
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n_active * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n_active * tokens
    tokens = spec.global_batch  # decode: one new token each
    return 2.0 * n_active * tokens


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` process group of ``world`` ranks, this process rank 0,
    destroyed after the block."""
    import torch.distributed as dist
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(*trees) -> int:
    """Bytes one device holds of the tensors in ``trees`` (a DTensor's
    local shard; an LM's parameters)."""
    from torch.utils._pytree import tree_flatten
    total = 0
    for x in tree_flatten(list(trees))[0]:
        if isinstance(x, torch.nn.Module):
            total += _local_bytes(list(x.parameters()))
        elif isinstance(x, torch.Tensor):
            t = getattr(x, "_local_tensor", x)
            total += t.numel() * t.element_size()
    return total


def _step_args(cfg, spec, plan, knobs, remat, attn_impl):
    """(step, args) of the cell's kind, its inputs meta tensors (no
    memory) placed by ``plan`` (None: unmeshed)."""
    from ..serve import make_decode_step, make_prefill_step
    from ..train import AdamWConfig, make_train_step
    c = {} if plan is None else {"constrain": plan.constrain}
    if spec.kind == "train":
        opt_cfg = AdamWConfig()
        step = make_train_step(cfg, opt_cfg, remat=remat,
                               attn_impl=attn_impl, **c, **knobs)
        return step, (abstract_train_state(cfg, opt_cfg, plan=plan),
                      input_specs(cfg, spec, plan=plan))
    params = abstract_params(cfg, plan=plan)
    if spec.kind == "prefill":
        step = make_prefill_step(cfg, max_len=spec.seq_len,
                                 attn_impl=attn_impl, plan=plan, **c)
        return step, (params, input_specs(cfg, spec, with_labels=False,
                                          plan=plan))
    step = make_decode_step(cfg, **c)
    cache = abstract_cache(cfg, spec.global_batch, spec.seq_len, plan=plan)
    b = decode_input_specs(cfg, spec, plan=plan)
    return step, (params, cache, b["tokens"], b["positions"])


def _count(cfg, spec, plan, knobs, remat, attn_impl):
    """Run the cell's step once on meta tensors under a counter; returns
    (counter, argument bytes a device)."""
    step, args = _step_args(cfg, spec, plan, knobs, remat, attn_impl)
    arg_bytes = _local_bytes(*args)
    with StepCounter() as counter:
        step(*args)
    return counter, arg_bytes


# unmeshed FLOPs by cell (the same for both meshes)
_UNMESHED: Dict[tuple, float] = {}


def run_cell(cfg: ArchConfig, shape_name: str, multi_pod: bool,
             seq_shard: bool = False,
             microbatches: Optional[int] = None,
             remat: str = "full",
             attn_impl: str = "ref",
             expert_pad: int = 0) -> Dict:
    """The record of one (arch, shape, mesh) cell (module docstring)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention {attn_impl!r}; the port "
                         f"takes {ATTN_IMPLS}")
    if expert_pad:
        cfg = dataclasses.replace(cfg, expert_pad_multiple=expert_pad)
    spec = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    knobs = {}
    if spec.kind == "train":
        knobs = dict(TRAIN_KNOBS.get(cfg.name, {}))
        if microbatches is not None:
            knobs["microbatches"] = microbatches
    from ..sharding import make_plan
    t0 = time.time()
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        plan = make_plan(mesh, seq_shard_activations=seq_shard)
        counter, arg_bytes = _count(cfg, spec, plan, knobs, remat,
                                    attn_impl)
    key = (cfg, shape_name, tuple(sorted(knobs.items())), remat, attn_impl)
    if key not in _UNMESHED:
        _UNMESHED[key] = _count(cfg, spec, None, knobs, remat,
                                attn_impl)[0].flops
    record = analyze_step(counter, chips=chips,
                          model_flops=_model_flops(cfg, spec),
                          argument_bytes=arg_bytes)
    record.update(
        arch=cfg.name, shape=shape_name,
        mesh="2x16x16" if multi_pod else "16x16", chips=chips,
        seq_shard=seq_shard, remat=remat, attn_impl=attn_impl,
        expert_pad=expert_pad,
        microbatches=knobs.get("microbatches"),
        unmeshed_flops=_UNMESHED[key],
        replication=counter.flops * chips / max(_UNMESHED[key], 1.0),
        run_seconds=round(time.time() - t0, 1),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
    )
    return record


@contextlib.contextmanager
def _exchange_as_all_to_all(counter: StepCounter, ranks: int):
    """Count the dense-row level's in-process exchange
    (``distributed._all_to_all``, the ranks' rows copied in lockstep) as
    the collective it stands for: one all-to-all of the ``ranks`` group
    moving one rank's send buffers, its copies not counted."""
    from ..core import distributed as D
    inner = D._all_to_all

    def exchange(sends, devices, block, dim=-1):
        s = sends[0]
        counter.collective("all-to-all", s.numel() * s.element_size(),
                           range(ranks))
        with counter.paused():
            return inner(sends, devices, block, dim)

    D._all_to_all = exchange
    try:
        yield
    finally:
        D._all_to_all = inner


def run_snp_cell(multi_pod: bool, *, neurons: int = 2048, rules: int = 4096,
                 frontier_per_dev: int = 32, max_branches: int = 64) -> Dict:
    """One dense-row level of the distributed SNP explore over the
    production mesh's ranks, on meta tensors (module docstring)."""
    from ..core import distributed as D
    from ..core.backend import get_backend
    from ..core.generators import random_system
    from ..core.matrix import compile_system

    t0 = time.time()
    ndev = 512 if multi_pod else 256
    system = random_system(neurons, max(1, rules // neurons), 8 / neurons,
                           seed=0)
    comp = compile_system(system, device="cpu")
    m, n = comp.num_neurons, comp.num_rules
    F, T = frontier_per_dev, max_branches
    C = max(16, (F * T) // ndev)
    V = 4096
    devices = [torch.device("meta")] * ndev
    counter = StepCounter()
    ranks = D._ranks(comp, devices)            # one meta copy, shared
    with StepCounter():            # its reads answered, its work not kept
        st = D._init_dense(ranks[0].comp, ranks, F, V, None)
    arg_bytes = _local_bytes(st) // ndev
    with _exchange_as_all_to_all(counter, ndev), counter:
        D._dense_level(st, ranks, get_backend("ref"), T, C, V)
    counter.scaled(1.0 / ndev)        # the level ran every rank's share
    record = analyze_step(counter, chips=ndev, argument_bytes=arg_bytes)
    record.update(arch=f"snp-{neurons}n-{n}r", shape="explore_step",
                  mesh="2x16x16" if multi_pod else "16x16", chips=ndev,
                  neurons=m, replication=1.0,
                  run_seconds=round(time.time() - t0, 1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--snp", action="store_true",
                    help="also dry-run the SNP exploration step")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn-impl", default="ref", choices=list(ATTN_IMPLS))
    ap.add_argument("--expert-pad", type=int, default=0)
    args = ap.parse_args(argv)
    # DTensor's notes on the fake group's collectives
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results, failures = [], []

    def emit(rec):
        results.append(rec)
        path = os.path.join(
            args.out, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
        print(f"[dryrun] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:8s} compute={rec.get('compute_s', 0):.4f}s "
              f"memory={rec.get('memory_s', 0):.4f}s "
              f"collective={rec.get('collective_s', 0):.4f}s "
              f"bound={rec.get('bound')} "
              f"replication={rec.get('replication', 0):.3f} "
              f"({rec['run_seconds']}s run)", flush=True)

    for name in archs:
        cfg = get_config(name)
        for shape in shapes:
            if shape == "long_500k" and not cfg.supports_long_context:
                print(f"[dryrun] {name:24s} long_500k    SKIP "
                      "(pure full attention, DESIGN.md §5)", flush=True)
                continue
            for multi in meshes:
                try:
                    emit(run_cell(cfg, shape, multi,
                                  seq_shard=args.seq_shard,
                                  microbatches=args.microbatches,
                                  remat=args.remat,
                                  attn_impl=args.attn_impl,
                                  expert_pad=args.expert_pad))
                except Exception as e:
                    failures.append((name, shape, multi, repr(e)))
                    print(f"[dryrun] FAIL {name} {shape} "
                          f"{'multi' if multi else 'single'}: {e}",
                          flush=True)
                    traceback.print_exc()

    if args.snp:
        for multi in meshes:
            try:
                emit(run_snp_cell(multi))
            except Exception as e:
                failures.append(("snp", "explore", multi, repr(e)))
                traceback.print_exc()

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"results": results, "failures": failures}, f, indent=1,
                  default=float)
    print(f"\n[dryrun] {len(results)} cells OK, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
