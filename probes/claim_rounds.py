#!/usr/bin/env python3
"""H2's device time against its claim rounds, on one NVIDIA GPU.

    python3 probes/claim_rounds.py

At the full-width ``scaled_pi(682)`` wave (its real candidate block: the
last 512 archived states of the phase-5 explore expanded through B1, 64
branches each, hashed by H1), for ``max_probes`` D in 1 ... 64: the
rounds the plain version's loop runs (at most 2·D + 1; it stops when no
candidate is pending), and the device time of H2 (20 calls captured in a
CUDA graph, its replay timed by CUDA events) on its two main-path routes:
the cluster route at the wave's first occurrence (32,768 keys, a fresh
table of 65,536 slots) and the cta route at the level's insert (the
first 512 new keys into a visited table of 524,288 slots holding 100,000
keys).  The slope of time over rounds is a round's cost.  The last line
is one JSON object of the figures, with the card's name and power limit.
Then the cluster route against its candidates: the wave's first K keys
(1,025 to 32,768) into ``table_slots(K)`` slots, at D = 1 and 64; and
against its size: clusters of 4, 8 and 16 blocks at D = 64 on the same
keys, in turns, their flags equal.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rounds(s_hi, s_lo, hi, lo, pending, D):
    """The claim rounds the plain version's loop runs."""
    import chip_smoke as cs
    return cs._probe_reads(s_hi, s_lo, hi, lo, pending, D, True)[1]


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import compile_system, explore, get_backend
    from repro_torch.core import make_table, table_slots
    from repro_torch.core.generators import scaled_pi
    from repro_torch.core.hashtable import _canonical, _empty
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.snp_step import _build, ops

    _build.build_all([ops.SOURCE, ht_ops.SOURCE])
    dev = torch.device("cuda")
    comp = compile_system(scaled_pi(682), device="cuda")
    res = explore(comp, backend="cuda", **cs.FULL_WIDTH)
    frontier = torch.from_numpy(res.configs[-512:]).to(dev)
    out = get_backend("cuda").expand(frontier, comp, 64)
    cand = out.configs.reshape(512 * 64, -1)
    valid = out.valid.reshape(-1)
    hi, lo = _canonical(*ht_ops.config_hash(cand), valid)
    K = hi.shape[0]
    S = table_slots(K)
    empty = _empty(S, 0, dev)
    table = make_table(cs.FULL_WIDTH["visited_cap"], dev)
    rng = np.random.default_rng(21)
    keys = torch.from_numpy(rng.integers(0, 2**32, size=(2, 100_000),
                                         dtype=np.uint64).astype(np.int64))
    base = (table.slots_hi, table.slots_lo, table.slot_payload)
    ht_ops.claim_(*base, keys[0].to(dev), keys[1].to(dev),
                  torch.ones(100_000, dtype=torch.bool, device=dev),
                  torch.arange(100_000, dtype=torch.int32, device=dev), 64)
    first, _, _ = ht_ops.first_claim(hi, lo, valid, S, 64)
    found, _ = ht_ops.lookup(*base, hi, lo, valid, 64)
    new = valid & first & ~found
    sel = torch.sort((~new).to(torch.uint8), stable=True).indices[:512]
    f_hi, f_lo, f_ins = hi[sel], lo[sel], new[sel]
    f_pay = torch.arange(512, dtype=torch.int32, device=dev)
    copy = tuple(x.clone() for x in base)

    def restore():
        for a, b in zip(copy, base):
            a.copy_(b)

    restore_ms = cs._replay_ms(restore)
    rows = []
    for D in (1, 2, 4, 8, 16, 32, 64):
        r_first = rounds(*empty[:2], hi, lo, valid, D)
        r_ins = rounds(*base[:2], f_hi, f_lo, f_ins, D)
        t_first = cs._replay_ms(
            lambda: ht_ops.first_claim(hi, lo, valid, S, D))
        t_ins = cs._replay_ms(lambda: (restore(), ht_ops.claim_(
            *copy, f_hi, f_lo, f_ins, f_pay, D))) - restore_ms
        rows.append(dict(D=D, cluster_rounds=r_first, cluster_ms=t_first,
                         cta_rounds=r_ins, cta_ms=t_ins))
        print(f"D={D}: cluster (first occurrence, K={K}, S={S}) "
              f"{r_first} rounds {t_first:.4f} ms; cta (insert, K=512) "
              f"{r_ins} rounds {t_ins:.4f} ms", flush=True)
    # the cluster route's cost against its candidates: the wave's first
    # K keys, S = table_slots(K), at D = 1 and 64
    sizes = []
    for k in (1025, 2048, 4096, 8192, 16384, 32768):
        s_k = table_slots(k)
        h_k, l_k, v_k = hi[:k].contiguous(), lo[:k].contiguous(), \
            valid[:k].contiguous()
        e_k = _empty(s_k, 0, dev)
        row = dict(K=k, S=s_k,
                   route=list(ht_ops.claim_route(k, s_k, 64, True)))
        for D in (1, 64):
            row[f"rounds_D{D}"] = rounds(*e_k[:2], h_k, l_k, v_k, D)
            row[f"ms_D{D}"] = cs._replay_ms(
                lambda: ht_ops.first_claim(h_k, l_k, v_k, s_k, D))
        sizes.append(row)
        print(f"K={k}: {row}", flush=True)
    # the cluster's size: 4, 8 and 16 blocks on the same keys, in turns
    clusters = []
    for k in (1025, 2048, 4096, 8192, 32768):
        s_k = table_slots(k)
        h_k, l_k, v_k = hi[:k].contiguous(), lo[:k].contiguous(), \
            valid[:k].contiguous()
        row, flags = dict(K=k, S=s_k), {}
        for ctas in (4, 8, 16, 16, 8, 4):
            if -(-k // ctas) > ht_ops.CLUSTER_ITEMS * ht_ops.CTA_MAX:
                continue
            route = ht_ops.ClaimRoute("cluster", ctas)

            def claim():
                return ht_ops._claim(route, True, None, h_k, l_k, v_k, None,
                                     s_k, 64, dev)
            flags[ctas] = [x.cpu() for x in claim()]
            row.setdefault(f"ms_{ctas}", []).append(cs._replay_ms(claim))
        first_flags = next(iter(flags.values()))
        row["flags_equal"] = all(torch.equal(a, b) for f in flags.values()
                                 for a, b in zip(f, first_flags))
        clusters.append(row)
        print(f"clusters K={k}: {row}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "valid": int(valid.sum()),
                      "new": int(new.sum()), "rows": rows,
                      "sizes": sizes, "clusters": clusters}))
    return 0 if all(r["flags_equal"] for r in clusters) else 1


if __name__ == "__main__":
    sys.exit(main())
