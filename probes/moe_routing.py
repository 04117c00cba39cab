#!/usr/bin/env python3
"""How far B8's rounding moves qwen2-moe-a2.7b's routing, on one NVIDIA
GPU, at full width and depth.

    python3 probes/moe_routing.py [--batch 4] [--prompt 1024]

The weights are drawn on the card from ``PRNGKey(0)`` (bf16, 24 layers of
60 experts top-4 and a shared expert), the batch is ``make_batch``'s
(seed 0).  For the published capacity factor (1.25) and the drop-free one
(E/K = 15), the prefill runs through ``attn_impl="cuda"`` (B8-TC) and
``"ref"`` (the plain attention), each recording every MoE layer's routing
(``models.moe.route``: the experts each (token, k) pair picks, and
whether it is kept).  Printed per factor: each run's ``drop_frac``; the
last logits' difference between the two runs over max |logit|, per
request and in all; per layer, how many (token, k) pairs pick another
expert and how many change kept/dropped; and the same two counts for a
second ``"ref"`` run against the first (the plain path's own
repeatability).  The last line is one JSON object of these figures with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import forward, init_cache, init_params
    from repro_torch.models import moe

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_routing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("qwen2-moe-a2.7b")
    B, S = args.batch, args.prompt
    params = init_params(prng.PRNGKey(0), cfg, device=dev)
    b = make_batch(cfg, DataConfig(seed=0), step=0, shard=0, batch=B,
                   seq_len=S)
    batch = {k: torch.from_numpy(b[k]).to(dev)
             for k in ("tokens", "positions")}

    record = []
    route = moe.route

    def recording(p, c, xt, C):
        out = route(p, c, xt, C)
        record.append((out[1].clone(), out[3].clone()))
        return out

    moe.route = recording

    def run(c, impl):
        record.clear()
        with torch.no_grad():
            logits, _, aux = forward(params, c, batch, cache=init_cache(
                c, B, S + 1, device=dev), attn_impl=impl,
                logits_slice="last")
        return logits.float(), float(aux["drop_frac"]), list(record)

    def diffs(a, b):
        return ([int((x[0] != y[0]).sum()) for x, y in zip(a, b)],
                [int((x[1] != y[1]).sum()) for x, y in zip(a, b)])

    out = {"card": card, "batch": B, "prompt": S}
    for cf in (cfg.capacity_factor,
               cfg.num_experts / cfg.num_experts_per_tok):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        lc, dc, rc = run(c, "cuda")
        lr, dr, rr = run(c, "ref")
        lr2, _, rr2 = run(c, "ref")
        scale = float(lr.abs().max())
        rows = [float((lc[i] - lr[i]).abs().max()) / scale
                for i in range(B)]
        pick, keep = diffs(rc, rr)
        pick2, keep2 = diffs(rr, rr2)
        first = next((i for i, (p, k) in enumerate(zip(pick, keep))
                      if p or k), None)
        fig = {"drop_frac_cuda": dc, "drop_frac_ref": dr,
               "rel_err_rows": rows, "rel_err": max(rows),
               "ref_repeat_rel_err": float((lr2 - lr).abs().max()) / scale,
               "picks_differing_by_layer": pick,
               "kept_differing_by_layer": keep,
               "first_layer_differing": first,
               "ref_repeat_picks_differing": sum(pick2),
               "ref_repeat_kept_differing": sum(keep2),
               "pairs_per_layer": int(rc[0][0].numel())}
        out[f"capacity_factor_{cf:g}"] = fig
        print(f"capacity factor {cf:g}: drop_frac cuda {dc:.6f} ref "
              f"{dr:.6f}; 'cuda' vs 'ref' last logits {max(rows):.5g} of "
              f"max |logit| (rows {', '.join(f'{r:.5g}' for r in rows)}); "
              f"pairs picking another expert by layer {pick}; kept/dropped "
              f"changed by layer {keep} (of {fig['pairs_per_layer']} a "
              f"layer); 'ref' twice: {sum(pick2)} picks, {sum(keep2)} kept "
              f"differ, logits {fig['ref_repeat_rel_err']:.3g}", flush=True)
    moe.route = route
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
