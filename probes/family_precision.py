#!/usr/bin/env python3
"""How far apart the serving paths of the LM families land, in bf16 and in
f32, on one NVIDIA GPU.

    python3 probes/family_precision.py [--batch 4] [--prompt 1024]

For each family of smoke phase 22 at its published width (``minicpm3-4b``
and ``musicgen-medium`` at full depth; ``qwen2-moe-a2.7b`` at full depth
in bf16 and at 8 layers in f32, whose full depth in f32 is 57 GB of
weights; ``rwkv6-7b`` at 8 layers), with weights drawn on the card from
``PRNGKey(0)`` and ``make_batch``'s tokens, in bf16 and again in f32:
the last logits of the prefill through ``attn_impl="cuda"`` against the
same prefill on ``"ref"`` (``chip_smoke.compare_to_ref``), and decode of
token S+1 against a prefill of S+1 tokens (``chip_smoke.
teacher_forcing``), each as it runs and with the MoE picks of one run
replayed in the other, as max |difference| over max |logit|.  The last
line is one JSON object of the figures with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name: (arch, bf16 depth, f32 depth); None = the published depth
RUNS = {"minicpm3-4b": ("minicpm3-4b", None, None),
        "musicgen-medium": ("musicgen-medium", None, None),
        "rwkv6-7b": ("rwkv6-7b", 8, 8),
        "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", None, 8)}


def main(argv=None) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.serve import make_prefill_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("family_precision: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    B, S = args.batch, args.prompt
    out = {"card": card, "batch": B, "prompt": S}
    for name, (arch, d16, d32) in RUNS.items():
        for dtype, depth in (("bfloat16", d16), ("float32", d32)):
            cfg = dataclasses.replace(cs.family_config(arch, depth),
                                      dtype=dtype)
            params = init_params(prng.PRNGKey(0), cfg, device=dev)
            batch = cs._serve_batch(cfg, B, S, dev)
            ref = cs.compare_to_ref(params, cfg, batch, S + 2)
            first = cs._last_tokens(make_prefill_step(cfg, max_len=S + 2)(
                params, batch)[0], cfg)
            tf = cs.teacher_forcing(params, cfg, batch, first, S + 2)
            fig = dict(layers=cfg.num_layers, **ref, **{
                f"tf_{k}": v for k, v in tf.items()})
            out[f"{name} {dtype}"] = fig
            print(f"{name} {dtype} ({cfg.num_layers} layers): 'cuda' vs "
                  f"'ref' {ref['vs_ref']:.4g} (as it runs "
                  f"{ref['vs_ref_free']:.4g}, {ref['picks_changed']} of "
                  f"{ref['picks']} picks differ); teacher forcing "
                  f"{tf['teacher_forcing']:.4g} (as it runs "
                  f"{tf['teacher_forcing_free']:.4g}, "
                  f"{tf['picks_changed']} of {tf['picks']} picks differ)",
                  flush=True)
            del params, batch
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
