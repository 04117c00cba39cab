#!/usr/bin/env python3
"""Time kernel B8 on the card at its two main-path launches, from any
checkout of this repository, so that two trees (or two builds of one
source) can be compared in one call on one card.

    python3 probes/attn_device_times.py [--tree DIR] [--label NAME]

on one NVIDIA GPU.  ``--tree`` names the checkout whose ``src/`` is
imported and whose attention source is built (into its own git-ignored
build directory); by default this one.  The launches (inputs drawn on
the card from a fixed seed):

* f32, q (2, 15, 1960, 64), k/v (2, 5, 1960, 64), causal: the f32
  prefill's launch (phase 17's f32 twin of the SmolLM-360M prefill), run
  by the split-TF32 body (the FFMA body before it);
* bf16, q (8, 15, 1960, 64), k/v (8, 5, 1960, 64), causal: the serving
  prefill's launch, run by the wgmma body;

and, end to end, the f32 prefill itself: SmolLM-360M at full width and
depth in f32 (weights drawn on the card from ``PRNGKey(0)``), 2 x 1960
tokens through ``attn_impl="cuda"`` (32 launches of the f32 body): wall
time (host clock, best of 3) and, by ``torch.profiler``, device busy time
and B8's share of it.

Each launch goes through the tree's ``flash_attention_cuda``, is held
against its plain version (``attention_ref``; f32 max |err| <= 2e-5,
bf16 within atol 1e-3 and rtol 8e-3), and is timed by CUDA events and by
``torch.profiler`` (the kernel's own device time), a mean over 20
launches after a warm-up, beside ``scaled_dot_product_attention`` on k/v
repeated to every head (the same function; timed here only).  The last
line is one JSON object of the times, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LAUNCHES = (("f32 prefill", "float32", 2), ("bf16 prefill", "bfloat16", 8))
HQ, HKV, S, D = 15, 5, 1960, 64


def _f32_prefill(cs, dev):
    """Wall and device time of the f32 SmolLM-360M prefill, 2 x 1960."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.serve import make_prefill_step
    cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32")
    params = init_params(prng.PRNGKey(0), cfg, device=dev)
    batch = cs._serve_batch(cfg, 2, S, dev)
    prefill = make_prefill_step(cfg, max_len=S + 65, attn_impl="cuda")
    prefill(params, batch)
    times = cs.time_prefill(prefill, params, batch, f"f32 prefill 2x{S}",
                            tag="probe")
    del params
    torch.cuda.empty_cache()
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/ is imported (default: this "
                         "one)")
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    import chip_smoke as cs       # its helpers; it puts ROOT/src on the path
    tree = Path(a.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attn_device_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attn import attention_ref, ops
    if not Path(ops.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {ops.__file__}, not from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    label = a.label or tree.name
    ops.load_kernel()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = {}
    for name, dname, B in LAUNCHES:
        dt = getattr(torch, dname)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, HQ, S, D), (B, HKV, S, D),
                                 (B, HKV, S, D)))
        kv_len = torch.full((B,), S, dtype=torch.int32, device=dev)

        def launch():
            return ops.flash_attention_cuda(q, k, v, kv_len, causal=True)
        got = launch()
        want = attention_ref(q, k, v, kv_len, causal=True)
        err = float((got.float() - want.float()).abs().max())
        if dname == "float32":
            cs.check(err <= 2e-5, f"{label}: {name} max |err| {err:.3g} > "
                     f"2e-5")
        else:
            cs.check(torch.allclose(got.float(), want.float(), atol=1e-3,
                                    rtol=8e-3),
                     f"{label}: {name} beyond atol 1e-3, rtol 8e-3 (max "
                     f"|err| {err:.3g})")
        del got, want
        ke, ve = (t.repeat_interleave(HQ // HKV, dim=1) for t in (k, v))
        ev = cs.time_ms(launch, 20)
        dv = cs.device_ms(launch, 20, "flash_attn_fwd")
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), 20)
        bound = cs._attn_bound(q, k, kv_len, True)
        rows[name] = dict(events_ms=ev, device_ms=dv, sdpa_mha_device_ms=sdpa,
                          max_abs_err=err, bound_ms=bound["bound_ms"],
                          ops_route=bound["ops_route"])
        cs.log(f"[probe {label}] B8 at the {name} launch q {tuple(q.shape)}: "
               f"max |err| {err:.3g}; CUDA events {ev:.4f} ms, on the card "
               f"{dv:.4f} ms; SDPA on repeated k/v {sdpa:.4f} ms on the "
               f"card; bound {bound['bound_ms']:.6f} ms "
               f"({bound['ops_route']})")
        del q, k, v, ke, ve
        torch.cuda.empty_cache()
    rows["f32 prefill, end to end"] = _f32_prefill(cs, dev)
    print(json.dumps({"tree": label, "card": card,
                      "times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
