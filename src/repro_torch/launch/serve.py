"""Batched LM serving launcher: prefill, then streamed greedy or sampled
decode (the port of the LM path of the JAX package's
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 4 --prompt-len 64 --gen 32          # on the card

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu                        # reduced, on the CPU

The weights are random, drawn from ``PRNGKey(--seed)`` at the published
shapes, and sampled tokens from the same key split once a step, as the
reference's launcher draws them (the same values, through
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
from ..serve import make_decode_step, make_prefill_step

__all__ = ["serve_lm", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(args) -> np.ndarray:
    """Serve one batch: prefill ``--prompt-len`` tokens, decode ``--gen``.
    Returns the generated token ids (B, gen)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    B, S, G = args.batch, args.prompt_len, args.gen
    max_len = S + G + 1

    params = init_params(prng.PRNGKey(args.seed), cfg, device=dev)
    prefill = make_prefill_step(cfg, max_len=max_len, attn_impl="cuda")
    decode = make_decode_step(cfg, temperature=args.temperature)

    batch = make_batch(cfg, DataConfig(seed=args.seed), step=0, shard=0,
                       batch=B, seq_len=S)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
             if k != "labels"}

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"[serve] prefill {B}x{S}: {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:.0f} tok/s)")

    tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[..., None]
    key = prng.PRNGKey(args.seed).to(dev)
    outs = []
    t0 = time.perf_counter()
    for g in range(G):
        pos = torch.full((B, 1), S + g, dtype=torch.int32, device=dev)
        if cfg.mrope_sections:
            pos = pos[None].expand(3, B, 1)
        key, sub = prng.split(key)
        tok, logits, cache = decode(params, cache, tok, pos, sub)
        outs.append(tok[:, 0])
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] decode {G} steps: {dt/max(G, 1)*1e3:.2f} ms/step "
          f"({B*G/dt if dt > 0 else 0.0:.0f} tok/s)")
    gen = torch.stack(outs, -1).cpu().numpy() if outs else \
        np.zeros((B, 0), np.int32)
    print("[serve] sample generations (first 16 token ids/request):")
    for b in range(min(B, 4)):
        print(f"  req{b}: {gen[b][:16].tolist()}")
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snp", action="store_true",
                    help="serve SNP traces (not ported yet)")
    ap.add_argument("--arch", default=None, help="LM config name")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced sibling of --arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.snp:
        raise NotImplementedError(
            "the SNP trace service (--snp) is not ported yet (ROADMAP "
            "item 6)")
    if args.arch is None:
        ap.error("--arch is required")
    return serve_lm(args)


if __name__ == "__main__":
    main()
