"""Batched serving launcher (the port of the JAX package's
``repro.launch.serve``): the LM path (prefill, then streamed greedy or
sampled decode) and the SNP trace path (``--snp``: a burst of random
traces through the async :class:`~repro_torch.serve.SNPTraceService` over
a trace mesh, every visible card or ``[cpu]``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 4 --prompt-len 64 --gen 32          # on the card

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu                        # reduced, on the CPU

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch musicgen-medium --smoke --device cpu   # any of the ten

    PYTHONPATH=src python -m repro_torch.launch.serve --snp \
        --batch 64 --requests 256 --gen 32 --max-delay-ms 5 \
        --inject 'fail=2 poison=17' --max-retries 1  # on the card

Under ``torchrun`` with more than one rank the LM path runs on the
reference's mesh
(:func:`~repro_torch.launch.train.build_mesh_for_available`, one rank of
the process group a device) under :func:`~repro_torch.sharding.make_plan`:
the weights replicated on it, as the reference leaves them, the KV
caches laid out by the plan's ``cache_specs``, the plan's ``constrain``
in both steps, prefill attention through B8 on each rank's shard, and
decode attention split over the cache's sequence shards.  A world of one
serves on its one device without a process group or DTensors (a (1, 1)
mesh gives the same tokens, at DTensor's host cost); ``serve_lm(args,
plan=)`` serves on a given plan's mesh whatever the world.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch smollm-360m --smoke --device cpu       # (2, 2), gloo

Every arch of the reference serves: MoE, MLA, Mamba hybrids, RWKV6 and
musicgen's parallel codebooks (its generations are (B, C, gen); the
printout shows codebook 0, as the reference's does).  The weights are
random, drawn from ``PRNGKey(--seed)`` at the published shapes, and
sampled tokens from the same key split once a step, as the reference's
launcher draws them (the same values, through
:mod:`repro_torch.core.prng`).  Prefill runs its attention through
kernel B8 (``attn_impl="cuda"``; on the CPU its plain version); the
reference's launcher leaves its prefill at the plain ``"xla"``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.smoke import reduced
from ..core import prng
from ..core.device import resolve_device
from ..data import DataConfig, make_batch
from ..models import init_params
from ..serve import (SNPTraceService, TraceRequest, make_decode_step,
                     make_prefill_step, make_trace_runner)

__all__ = ["serve_lm", "serve_snp", "parse_inject", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_inject(spec: str):
    """``"fail=2,4 poison=17 slow=3:0.05"`` -> a
    :class:`~repro_torch.runtime.FaultInjector` with that schedule."""
    from ..runtime import FaultInjector
    kw = {}
    for part in spec.split():
        k, _, v = part.partition("=")
        if k == "fail":
            kw["fail_calls"] = [int(x) for x in v.split(",") if x]
        elif k == "poison":
            kw["poison_seeds"] = [int(x) for x in v.split(",") if x]
        elif k == "slow":
            kw["slow_calls"] = {int(o): float(t) for o, t in
                                (pair.split(":") for pair in v.split(","))}
        else:
            raise SystemExit(f"unknown --inject term {part!r}")
    return FaultInjector(**kw)


def serve_snp(args) -> dict:
    """Stand up the async SNP trace service over a trace mesh and serve a
    burst of ``--requests`` random traces of the paper's Π (covering
    mode), ``--gen`` steps each, seeds 0 .. requests−1.

    The runner is :func:`~repro_torch.serve.make_trace_runner`'s mesh
    runner, :func:`~repro_torch.core.distributed.run_traces_distributed`
    over :func:`~repro_torch.sharding.trace_mesh`: every visible card on
    the card (a named ``--device cuda:<i>`` first), ``[cpu]`` under
    ``--device cpu``.  Each flush splits its batch over the mesh and
    gathers it on the service's device, the mesh's first; the traces
    equal single-device serving bit for bit, so the launcher doubles as a
    check on whatever devices are present.  Any fault flag turns on a
    :class:`~repro_torch.runtime.FaultPolicy`.  Prints the reference's
    set-up line (``[serve-snp] mesh N-device, batch …``), the served
    count with traces/s, the completion latency p50/p99, then the fault
    stats (under a policy) and one sample spike train; returns those
    figures and the mesh."""
    from ..core import paper_pi
    from ..core.device import same_device
    from ..runtime import FaultPolicy
    from ..sharding import trace_mesh

    dev = resolve_device(args.device)
    # the named card first: the service's device is the mesh's first
    mesh = sorted(trace_mesh(), key=lambda d: not same_device(d, dev)) \
        if dev.type == "cuda" else trace_mesh([dev])
    system = paper_pi(covering=True)
    policy = None
    if (args.max_retries is not None or args.deadline_ms is not None
            or args.max_pending is not None or args.inject):
        policy = FaultPolicy(
            max_retries=2 if args.max_retries is None else args.max_retries,
            backoff_ms=args.backoff_ms, deadline_ms=args.deadline_ms,
            max_pending=args.max_pending)
    injector = parse_inject(args.inject) if args.inject else None

    n, G = args.requests, args.gen
    with SNPTraceService(batch_size=args.batch, step_bucket=8,
                         backend=args.backend,
                         runner=make_trace_runner(mesh=mesh),
                         async_mode=True, max_delay_ms=args.max_delay_ms,
                         policy=policy, fault_injector=injector,
                         device=mesh[0]) as svc:
        print(f"[serve-snp] mesh {len(mesh)}-device, batch {args.batch}, "
              f"max_delay {args.max_delay_ms} ms, backend {svc.backend.name}"
              + (f", policy {policy}" if policy else ""))
        done = {}
        t0 = time.perf_counter()
        futs = []
        for s in range(n):
            fut = svc.submit(TraceRequest(system, steps=G, policy="random",
                                          seed=s))
            # completion times by callback: waiting on the futures in
            # order would charge earlier futures' wait to later ones
            fut.add_done_callback(
                lambda f, s=s: done.setdefault(s, time.perf_counter()))
            futs.append(fut)
        failed = []
        for f in futs:
            try:
                f.result()
            except Exception as e:
                failed.append(type(e).__name__)
                print(f"[serve-snp] request failed: {type(e).__name__}: {e}")
        dt = time.perf_counter() - t0
        calls = svc.num_device_calls
        stats = svc.stats()
    # after close(): the drain thread is joined, so every done-callback
    # has run
    lat_ms = np.asarray([done[s] - t0 for s in range(n)]) * 1e3
    p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
    print(f"[serve-snp] {n - len(failed)}/{n} traces x {G} steps in "
          f"{dt*1e3:.1f} ms ({n / dt:.0f} traces/s, {calls} device calls)")
    print(f"[serve-snp] completion latency p50={p50:.1f} ms "
          f"p99={p99:.1f} ms")
    if policy is not None or injector is not None:
        print("[serve-snp] fault stats: " + ", ".join(
            f"{k}={v}" for k, v in stats.items() if v))
    ok = next((f for f in futs if not f.exception()), None)
    if ok is not None:
        print(f"[serve-snp] sample spike train: "
              f"{ok.result().emissions.tolist()}")
    return {"served": n - len(failed), "requests": n, "failed": failed,
            "traces_per_s": n / dt, "p50_ms": p50, "p99_ms": p99,
            "stats": stats, "mesh": [str(d) for d in mesh]}


def serve_lm(args, plan=None) -> np.ndarray:
    """Serve one batch of any of the ten archs: prefill ``--prompt-len``
    tokens (the batch of :func:`~repro_torch.data.make_batch`, codebook
    streams and frontend stubs included), decode ``--gen``, on ``plan``'s
    mesh if given, else as
    :func:`~repro_torch.launch.train.launch_plan` decides (module
    docstring).  Returns the generated token ids (B, gen), or (B, C, gen)
    with codebooks, on every rank."""
    from .train import launch_plan
    dev = resolve_device(args.device)
    with launch_plan(dev, plan) as (plan, rank):
        return _serve_lm(args, dev, plan, rank)


def _serve_lm(args, dev, plan, rank) -> np.ndarray:
    from ..models.convert import place
    from ..models.layers import _identity
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    B, S, G = args.batch, args.prompt_len, args.gen
    max_len = S + G + 1

    params = init_params(prng.PRNGKey(args.seed), cfg, device=dev)
    constrain = _identity
    if plan is not None:
        # the weights replicated on the mesh, as the reference leaves them
        place(params, cfg, plan, replicate=True)
        constrain = plan.constrain
        say(f"[serve] mesh "
            f"{dict(zip(plan.mesh.mesh_dim_names, plan.mesh.shape))}")
    prefill = make_prefill_step(cfg, max_len=max_len, attn_impl="cuda",
                                constrain=constrain, plan=plan)
    decode = make_decode_step(cfg, temperature=args.temperature,
                              constrain=constrain)

    batch = make_batch(cfg, DataConfig(seed=args.seed), step=0, shard=0,
                       batch=B, seq_len=S)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
             if k != "labels"}

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    say(f"[serve] prefill {B}x{S}: {t_prefill*1e3:.1f} ms "
        f"({B*S/t_prefill:.0f} tok/s)")

    last = logits[:, :, -1, :] if cfg.codebooks else logits[:, -1, :]
    tok = last.argmax(dim=-1).to(torch.int32)[..., None]
    key = prng.PRNGKey(args.seed).to(dev)
    outs = []
    t0 = time.perf_counter()
    for g in range(G):
        pos = torch.full((B, 1), S + g, dtype=torch.int32, device=dev)
        if cfg.mrope_sections:
            pos = pos[None].expand(3, B, 1)
        key, sub = prng.split(key)
        tok, logits, cache = decode(params, cache, tok, pos, sub)
        outs.append(tok[..., 0])
    _sync(dev)
    dt = time.perf_counter() - t0
    say(f"[serve] decode {G} steps: {dt/max(G, 1)*1e3:.2f} ms/step "
        f"({B*G/dt if dt > 0 else 0.0:.0f} tok/s)")
    gen = torch.stack([_whole(t) for t in outs], -1).cpu().numpy() \
        if outs else np.zeros(tuple(tok.shape[:-1]) + (0,), np.int32)
    say("[serve] sample generations (first 16 token ids/request):")
    for b in range(min(B, 4)):
        row = gen[b] if not cfg.codebooks else gen[b, 0]
        say(f"  req{b}: {row[:16].tolist()}")
    return gen


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A result read out: a DTensor gathered whole (every rank calls it)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def main(argv=None, *, plan=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snp", action="store_true",
                    help="serve SNP traces (the async trace service) "
                         "instead of the LM path")
    ap.add_argument("--arch", default=None,
                    help="LM config name (required without --snp)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced sibling of --arch")
    ap.add_argument("--batch", type=int, default=None,
                    help="request batch (default: 4 for the LM path, 256 — "
                         "the service batch_size — for --snp)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    # SNP service knobs
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--backend", default=None,
                    help="step backend of --snp (default: the service "
                         "chooses 'cuda')")
    # failure-domain knobs: any of these turns on the FaultPolicy path
    ap.add_argument("--max-retries", type=int, default=None,
                    help="retries per flush before degrade/bisect "
                         "(default 2 once any fault flag is set)")
    ap.add_argument("--backoff-ms", type=float, default=10.0,
                    help="base retry backoff (exponential, jittered)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expired requests fail "
                         "fast with DeadlineExceeded")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission control: reject submits past this "
                         "queue depth")
    ap.add_argument("--inject", default=None,
                    help="deterministic fault schedule, e.g. "
                         "'fail=2,4 poison=17 slow=3:0.05'")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 256 if args.snp else 4
    if args.snp:
        return serve_snp(args)
    if args.arch is None:
        ap.error("--arch is required without --snp")
    return serve_lm(args, plan)


if __name__ == "__main__":
    main()
