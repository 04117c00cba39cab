#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result line):

1. card and build — the card's name and power limit, the CUDA kernels
   built from the sources in this checkout (one ``nvcc`` per source, all
   started together, sm_90a: the dense step B1/B6, the dense delayed step
   B4, the sparse step B2/B3/B5/B7 and the forward attention B8, with
   ``-Xptxas -v``'s registers, spills and performance notes for every
   instantiation);
2. the dense kernel (B1) against its plain version on the card —
   bit-identical outputs on the paper's Π, ``nd_chain(10)`` (Ψ > T), a
   2048-neuron random system, a ragged shape, spike counts near 2^20, an
   output slab no row of which starts 16-byte aligned (m = 1023, T = 33),
   hand-made ``M``s (|values| up to 1000, a hub column holding every
   rule, an empty column), one of them and ``scaled_pi(1700)`` with more
   rules than one block stages, and the full-width explore wave; the
   encodings' column lists against ``dense_column_lists`` of their
   ``M``; forged lists (entries naming rules outside the system, starts
   below 0 and past the end) against the plain version without the
   forged entries, which B1 skips; times of the kernel, its plain
   version and one ``torch.matmul`` of a materialised ``S`` with ``M``
   (the yardstick, timed here only: the port never calls it), the bound
   with ``M`` counted by its nonzeros (and, for comparison, dense), and at
   the wave B1's device time from ``torch.profiler``;
3. the sparse step's sliced-list kernel, its ELL body (B2) and its
   hybrid body (B3: the COO tail), both walking the sliced in-lists,
   against their plain version (which reads ``in_idx``) — bit-identical
   on every entry at Π, ``nd_chain(10)``, a ragged shape (m = 45, not a
   multiple of 32, ELL), a random system with every in-synapse past the
   first in the COO tail, a hybrid system of 45 neurons, one whose
   neurons 32..63 have no in-synapse (a slice of width 0; ELL and
   hybrid), spike counts near 2^20, ``ring_lattice(32768, 8)``,
   ``power_law(32768, max_in=64)`` (ELL, and hybrid at hub threshold 16:
   2 rows a block) and the three full-width waves (B2 at
   ``scaled_pi(682)`` and at ``ring_lattice(32768, 8)``, B3 at
   ``power_law(8192)``), and B2 and B3 on forged lists (list and tail
   entries above m or below 0, slice starts out of range) against the
   plain version without the forged entries; times of the kernel, its
   plain version and one ``torch.sparse.mm`` of ``S`` as CSR with a dense
   ``M`` (where ``M`` fits 4 GiB), each case's block shape, and at the
   waves the kernel's device time from ``torch.profiler``;
4. the paper's §5 run through B1 — the allGenCk list and the ℕ∖{1}
   emission-gap result;
5. full width, dense — ``explore(scaled_pi(682))`` (m=2046, n=3410,
   512 x 64 candidates per wave, a 262,144-row archive) through ``"cuda"``
   and ``"ref"``, archives and flags identical; one wave's stage split
   beside the eager ``config_hash``'s figures and the profiler's split of
   one level, and at the wave's candidate block H1's three bodies and
   H2's route for its first occurrence bit for bit against their plain
   versions, with device times and byte bounds (so for phases 7, 10 and
   11's waves);
6. full width, ELL (B2) — the same explore through ``"sparse_cuda"``,
   archive and flags identical to both runs of phase 5;
7. full width, hybrid (B3), the slice's main path —
   ``explore(power_law(8192, 4, seed=2), plan=SystemPlan.for_system(...))``
   through ``"sparse_cuda"`` and ``"sparse"`` at the same caps, identical;
8. traces — ``run_traces(scaled_pi(682), steps=64, seeds=range(256))``
   with ``policy="first"`` and ``"random"`` identical through ``"cuda"``
   and ``"ref"``, and ``run_traces(power_law(8192), policy="random")``
   identical through ``"sparse_cuda"`` and ``"sparse"``;
9. the delayed kernels against their plain versions — B4 (dense, walking
   the sliced lists of ``adj_in``) and B5 (the sliced-list kernel's ELL
   and hybrid bodies with the delay stage, both walking the sliced
   lists), bit-identical on every entry at small edge shapes (delays 0–3,
   Ψ > T, a ragged shape, a neuron reopening with 2^16 − 1 pending
   spikes, no output neuron, spike counts near 2^20; for B4 and both B5
   bodies m not a multiple of 32, a slice of width 0 and forged lists, as
   in phase 3; for B5 COO also ``power_law(32768, max_in=64)`` at hub
   threshold 16) and at the delayed ``scaled_pi(682)`` (B4, B5 ELL) and
   ``power_law(8192)`` (B5 COO; B4 there at m = 8,192, fewer than 8 rows
   a block) waves (their device times there from ``torch.profiler``, and
   each kernel's block shape as the library chooses it); times of each
   kernel,
   its plain version, its bound and one library call (partial yardsticks:
   ``torch.matmul`` of ``S`` with the ``(n, 4m)`` ``W``, the accumulate
   stage only, for B4; ``torch.sparse.mm`` of ``S`` with ``M``, the
   delay-free product, for B5);
10. full width, delayed, dense and ELL — ``explore(with_delays(
   scaled_pi(682), k % 3), plan=SystemPlan(semantics="delays"))`` (state
   rows 3m = 6138 wide, a 262,144-row archive) through ``"cuda"`` (B4),
   ``"ref"`` and ``"sparse_cuda"`` (B5, ELL), archives and flags
   identical;
11. full width, delayed, hybrid — ``explore(with_delays(power_law(8192),
   k % 3), plan=SystemPlan.for_system(..., semantics="delays"))`` through
   ``"sparse_cuda"`` (B5, COO) and ``"sparse"``, identical, at a
   65,536-row archive (3m-wide rows: 6.4 GB);
12. the four delayed variants of the paper's Π, explored through all four
   backends, identical; traces of both delayed workloads, first and
   random policies, identical through the kernel and plain backends;
13. the shard kernels against their plain versions — B6 (the dense
   kernel's halo body) and B7 (the sliced-list kernel's, walking each
   shard's sliced lists of its extended-space ``in_idx``), bit-identical
   on every entry of every shard, on shard operands made by the sharded
   explore's own exchange: S=1, ``paper_pi`` over 8 shards (m < S: empty
   slices), Ψ > T, a ragged shape, spikes near 2^20, the degree partition
   of ``power_law(26)`` (asymmetric halos), random halos up to 2^16 − 1,
   and the full-width waves (B=512, T=64): ``scaled_pi(682)`` over
   ``neuron_axis(4)``, contiguous and degree, through both, and
   ``ring_lattice(32768, 8)`` through B7; then B6 alone on a halo slab
   that is not 16-byte aligned, on 30,001 halo slots (past its stage)
   over a hand-made ``hadj``, and on forged lists (rules and halo slots
   out of range, which it skips); B7 alone on forged shard lists (entries
   above m + H or below 0, slice starts out of range) on both shards of a
   ``power_law(200)`` of mloc 100 (not a multiple of 32); at the waves the
   times of shard 0's launch, its plain version, its bound (B6:
   ``M_local`` and ``hadj`` counted by their nonzeros; B7: the sliced
   lists in place of ``in_idx``; both kernels' device times from
   ``torch.profiler``, B7's block shape) and a library
   call (``matmul(S, M_local) +
   matmul(halo, hadj)`` for B6; for B7 the partial ``sparse.mm(S,
   M_local)``, without the halo term);
14. full width, sharded, the slice's main path —
   ``explore_distributed(scaled_pi(682), plan=neuron_axis(4))``, contiguous
   and degree (F=512, T=64, 65,536 archive rows a shard), through
   ``"cuda"`` (B6), ``"sparse_cuda"`` (B7), ``"ref"`` and ``"sparse"``,
   archives and flags identical, and held against phase 5's archive;
15. large m, sharded — ``explore_distributed(ring_lattice(32768, 8),
   plan=neuron_axis(4))`` (16,384 archive rows a shard) through
   ``"sparse_cuda"`` (B7) and ``"sparse"``, identical, peak allocation
   under 60 GB, and held against the single-device ``"sparse_cuda"``
   explore at 65,536 rows (B2, 8 launches);
16. the attention kernel's two bodies against their plain version
   (``attention_ref``) — B8-TC (bf16 at D 64/128: wgmma + TMA) and B8-TF32
   (f32; bf16 at D 16/32: mma.sync on TF32 with every f32 operand split in
   two terms), each case counted on the body it runs: the reference tests'
   edge shapes (GQA 8/8, 8/2, 8/1, 15/5, ragged axes, ``Sq != Skv``, a
   single query, ``D`` in {16, 32, 64, 128}, ``kv_len`` with zeros, rows of
   exact zeros), the same edges in bf16 at D 64 and 128, the split-TF32
   body's own edges (f32 at D 32 and 128 with ``Sq`` no multiple of 16, f32
   at D 16 with GQA 8/1, bf16 at D 16 and 32 with ``kv_len`` zeros), both
   causal and not, and the main paths' launches, unpadded: the serving
   prefill's (q (8, 15, 1960, 64), k/v (8, 5, 1960, 64), bf16, causal,
   B8-TC) and its f32 twin at batch 2 (B8-TF32); f32 max |err| <= 2e-5,
   bf16 within atol 1e-3 and rtol 8e-3 in f32; at the two launches the
   times of the body (and its TFLOP/s), its plain version and one
   ``scaled_dot_product_attention(q, k, v, is_causal=True,
   enable_gqa=True)`` (the yardstick, never called by the port), and the
   bound (for f32 the lesser of the split products on the TF32 tensor
   cores and the FLOPs on the f32 pipe, both printed);
17. serving, the slice's main path — SmolLM-360M at full width and depth
   (32 layers, d 960, 15/5 heads, vocab 49,152, bf16, random weights drawn
   on the card from ``PRNGKey(0)``, the reference's values): prefill of 8
   x 1960 tokens through ``attn_impl="cuda"`` (32 B8-TC launches), then 64
   greedy decode steps; its last logits against the ``"ref"`` prefill (0
   launches) within 2% of max |logit|, an f32 prefill at batch 2 (32
   B8-TF32 launches) within 1e-4 relative, decode of token S+1 against a
   prefill of S+1 tokens (teacher forcing), the caches' ``len``, finite
   logits; prefill tokens/s, decode ms/step and tokens/s, peak
   allocation, a profiler split of device time; then the port's launcher
   end to end (``repro_torch.launch.serve.main(["--arch", "smollm-360m",
   "--gen", "32"])``, batch 4, prompt 64), greedy once and twice at
   ``--temperature 0.8 --seed 3`` (identical tokens, in range), and once
   with ``--smoke --gen 8`` (the reduced sibling: f32 at D 16, one B8-TF32
   launch a layer, tokens in its vocabulary);
18. SNP trace serving and its failure domain — the async
   ``SNPTraceService`` at full width: 1,024 random traces of 64 steps in
   batches of 256 (``max_delay_ms`` 5, the burst submitted at once) on
   ``scaled_pi(682)`` through ``"cuda"`` (B1) and on the hybrid
   ``power_law(8192)`` through ``"sparse_cuda"`` (B3), 4 device calls
   each, every result identical to ``run_traces`` of its seed, traces/s
   and p50/p99 completion latency; the dense burst again under ``fail=2
   poison=17`` with one retry (only seed 17 fails, with PoisonError; the
   rest equal the clean run; ``stats()`` equal to :data:`FAULT_STATS`, the
   CPU tests' prediction); no plain fallback on the card: the hybrid
   service naming ``"sparse_cuda"`` and the dense one on its own choice
   (``"cuda"``) with a runner that fails the kernel backends fail every
   request with that error and degrade nothing, no kernel backend has a
   plain fallback, and a planned ``"cuda"`` failure raises itself (a
   listener watches every phase: the run records no degradation);
   ``explore(scaled_pi(682))`` through ``"cuda"`` at phase 5's caps and
   ``explore_distributed`` at phase 14's through ``"cuda"`` (B6) and
   ``"sparse_cuda"`` (B7), each checkpointed every 2 levels, killed at its
   second chunk under ``run_supervised`` and resumed (one restart,
   archives and flags identical to phases 5 and 14; snapshot MB and save
   and restore ms); then the launcher ``repro_torch.launch.serve
   --snp`` (256 requests, batch 64, 32 steps): 256/256 served, and 255/256
   with one PoisonError under ``--inject 'fail=2 poison=17'
   --max-retries 1``;
19. the query planner and block autotuner — (a) every kernel at every
   block shape it takes, against its plain version on every entry: B1 at
   8, 16 and 32 rows, B6 at 1, 2, 4 and 8, B4 and the sliced-list
   kernel's B2, B3, B5 ELL, B5 COO and B7 bodies at 1, 2, 4 and 8 rows
   by 256 and 1024 threads, at edge shapes of phases 2, 3, 9 and 13 and
   at the full-width waves; a shape whose stage passes 227 KB (the ring
   lattice's B2 at 4 and 8 rows) must be refused before any launch, and
   the kernels' shape counters (``kernels/launch_counts.py``) must show
   one launch at exactly the requested shape; (b) ``SystemPlan.for_system(mode=
   "measure")`` at B = 1, 64, 256 and 512 (T = 64) on ``scaled_pi(682)``,
   the hybrid ``power_law(8192)`` and the delayed ``scaled_pi(682)``:
   every candidate's µs (the median of 5 ``be.expand`` calls, timed in
   interleaved rounds) with its spread, and the winner, which must be a
   kernel backend; (c) ``explore`` under each full-width measured plan,
   twice, its archive equal to phase 5's, 7's and 10's and every launch
   at the winner's shape; (d) a second ``mode="auto"`` plan, the cached
   winner; (e) the seed rows (``core/autotune_seed.json``'s format) as
   JSON lines; (f) open plans, with a fresh cache: the committed seed
   rows decide the three workloads at (512, 64) and the cost model
   ``scaled_pi(682)`` at (128, 64); each open-plan explore launches the
   chosen kernel at the chosen shape (the library's rule where the
   choice names none) every wave, with the archive of phases 5, 7 and 10,
   or, unseeded, of the rule's ``"cuda"`` explore, timed beside it.  The
   whole smoke runs with ``REPRO_TORCH_AUTOTUNE_CACHE`` in a temporary
   directory, so no cache on the machine steers a phase; phase 4 pins
   ``"cuda"``, whose launches it counts, and (f) drives the open plan;
20. the dense-row scheme and the distributed traces — (a)
   ``explore_distributed(scaled_pi(682))`` without a sharded plan, 4 ranks
   on the card (``mesh=["cuda"] * 4``, F = 128 a rank: the full-width
   wave of 32,768 candidates; V = 4,096 a rank, past what 8 levels can
   fill), through ``"cuda"`` (B1), ``"sparse_cuda"`` under an ELL plan
   (B2) and ``"ref"``, archives, counts and flags identical, and one rank
   (``mesh=None``, phase 5's caps) through B1 and ``"ref"``, identical to
   each other and to phase 5's explore row for row; (b) the hybrid plan of
   ``power_law(8192, 4, seed=2)`` at 4 ranks through ``"sparse_cuda"``
   (B3) and ``"sparse"``, identical; each with waves/s, host reads a
   wave, peak allocation and launches (one a rank a level); (c)
   ``run_traces_distributed`` (256 seeds × 64 steps, first and random
   policies) of ``paper_pi``, ``scaled_pi(682)`` (B1) and the hybrid
   ``power_law(8192)`` (B3), at 4 ranks and at one, each bit-identical to
   ``run_traces`` through the same backend, traces/s beside it; (d) the
   async service over ``make_trace_runner(mesh=trace_mesh())`` (1,024
   random traces × 64 steps, each equal to ``run_traces`` of its seed)
   and over 4 ranks of the card (equal to it), and the launcher's
   ``--snp`` with its ``[serve-snp] mesh N-device`` line; (e) the 4-rank
   B1 explore checkpointed every 2 levels, killed at its second chunk
   under ``run_supervised`` and resumed, identical to (a)'s;
21. the zero-host-sync BFS — every explore level runs on the card with no
   host read and the level loop is one CUDA graph (a conditional WHILE
   node around one captured level): (a) un-checkpointed full-width
   explores inside ``repro_torch.core.device.sync_check()``
   (``torch.cuda.set_sync_debug_mode("error")``; only the counted final
   readout steps outside it) through B1 and ``"ref"`` (``scaled_pi(682)``),
   B2 (ELL), B3 and ``"sparse"`` (the hybrid ``power_law(8192)``), B4, B5
   ELL and B5 COO (the delayed workloads), B6 and B7 over
   ``neuron_axis(4)`` in both partitions, and phase 20's 4-rank dense-row
   B1 run: each archive identical to its earlier phase's, at most 2 host
   reads a run, with waves/s, wall ms and the profiler's device ms a
   level, peak allocation, and the launches of the step kernel and of H1
   and H2 (the hash-table kernels, ``kernels/hashtable/csrc/
   hashtable.cu``) exact, H1's bodies and H2's routes key by key, read
   from the kernels' own counters; (b) a tree that drains before
   ``max_steps``: its steps and every launch count, key by key, equal the
   CPU run's plain calls; (c) H1's three bodies (rows: hash and lookup in
   one launch; hash: ``config_hash``; keys: ``lookup``) and H2's three
   routes (cta, cluster of 16, grid) against their plain
   versions bit for bit, tables and overflow flags included: a synthetic
   full-width wave (32,768 candidates against a table of 262,144 keys,
   100,000 of them present: lookup, first occurrence fresh and into a
   table, insert), an F = 512 insert, ``max_probes`` 2 on every route,
   forged keys that share one base slot (past the 64-probe bound: the
   overflow), equal keys in one batch (the lowest index wins), and forged
   row blocks (widths 1, 31, 2,046 and 6,138, negative entries, invalid
   rows, every alignment, ``max_probes`` 1, 2 and 64), with device times,
   plain times and bounds (the four waves' real candidate blocks are
   checked and timed in phases 5-11, beside each wave's stage split and
   the eager ``config_hash``'s figures); (d) a checkpointed explore, one
   read a chunk;
22. every LM family served — the MoE, MLA, codebook, RWKV6 and hybrid
   families, each with weights drawn on the card from ``PRNGKey(0)``, a
   counted prefill through ``attn_impl="cuda"``, ``drop_frac`` and the
   load-balance loss, greedy decode steps (tokens in range, caches'
   ``len``), prefill tokens/s, decode ms a step, peak allocation under 60
   GB and a profiler split; then the same prefill on ``"ref"`` (no
   launch) and decode of token S+1 against a prefill of S+1 tokens (MoE
   at the drop-free capacity factor E/K, as the reference's
   teacher-forcing test runs it), each within 2% of max |logit| in bf16
   and 1e-4 in f32 with the MoE picks of one run replayed in the other
   (``RoutingTap``: bf16 router logits tie, and any change of rounding
   upstream flips some picks; the figures as the picks fall are printed
   beside), and again for an f32 twin of each family at batch 2 (B8-TF32
   at its GQA layers): ``qwen2-moe-a2.7b`` at full width and depth (24
   layers of 60 experts top-4 and a shared expert, bf16, 4 x 1024: 24
   B8-TC launches, 16 decode steps; its f32 twin at 8 layers),
   ``minicpm3-4b`` at full width and depth (MLA, 62 layers: no B8 launch,
   as the reference routes MLA; its bf16 decode drifts past the bf16
   bound from the prefill and is held in f32 only, ``BF16_DRIFT``),
   ``musicgen-medium`` at full width and depth (4 codebooks, 48 layers:
   48 B8-TC launches, decode tokens (B, 4, 1)), ``rwkv6-7b`` at full
   width cut to 8 of its 32 layers, and the reduced f32 siblings of
   ``jamba-1.5-large-398b`` (Mamba, MoE on odd positions, 2 B8-TF32
   launches) and ``grok-1-314b`` (2 B8-TF32), which do not fit one card
   at their published widths; B8-TC at the qwen2-moe (q (4, 16, 1024,
   128)) and musicgen (q (4, 24, 1024, 64)) launches held against
   ``attention_ref`` and timed as in phase 16 (the device time from the
   prefill's profile, a launch of the body alone showing no device event
   to the profiler after phase 21's graphs); then ``python -m
   repro_torch.launch.serve --arch qwen2-moe-a2.7b --smoke`` and
   ``--arch musicgen-medium --smoke`` as subprocesses, each exiting 0;
23. training — (a) B8 under autograd at SmolLM-360M's training launch, q
   (8, 15, 2048, 64) bf16 (B8-TC), and an f32 twin at batch 2
   (B8-TF32): the output and dq/dk/dv against ``attention_ref``'s
   autograd, with the launch's times as phase 16 takes them and forward
   + backward against SDPA's; (b) ``chunked_attention`` forward and
   gradients against ``attention_ref`` at a GQA shape with a ragged Sq,
   its peak allocation below one full f32 score tensor; (c) the main
   path, ``python -m repro_torch.launch.train --arch smollm-360m --batch
   8 --seq 2048 --steps 20 --remat full`` through its ``main`` (full
   width and depth, bf16, B8 in every attention forward; ``--lr 1e-4
   --warmup 5``): 64 B8-TC launches a step (32 forward, 32 in the
   recompute), no plain call, finite losses, the loss of step 1's batch
   lower after the 20 steps, step ms and tokens/s, peak allocation under
   60 GB, then one more step profiled (device busy share, leading
   kernels); (d) one step through ``"cuda"`` and ``"ref"`` from the same
   weights and batch at full width (bf16 bounds ``TRAIN_BF16_*``), an
   f32 twin at 4 layers (1e-4) and remat ``"none"`` against ``"full"``
   at batch 2; (e) the supervisor drill (``--ckpt-dir --ckpt-every 4
   --fail-at 6 --steps 10``, depth cut to 8 layers for time): one
   restart, steps 7-10's losses against an uninterrupted run, snapshot
   MB and save/restore ms; (f) every family's reduced f32 sibling, one
   step through ``"cuda"`` against ``"ref"`` within 1e-4 (phases 17, 22
   and 23 run the launchers as a user does on one card: a world of one,
   on the one device without a process group or DTensors);
24. the meshed launchers — SmolLM-360M at full width and depth on the
   reference's mesh for the one card, ``(data, model) = (1, 1)``: an NCCL
   group of one, the sharding plan's DTensors (the launchers given the
   plan, ``plan=``: a world of one runs them without a mesh), B8 on each
   rank's shard through ``local_map``; (a) ``serve_lm`` on the mesh, 8 x
   1960 prompts
   and 8 greedy decode steps, its tokens equal to the unmeshed ones, B8-TC
   once a layer, then the prefill and decode steps timed on and off the
   mesh from the same weights (device split of one prefill each); (b)
   ``train()`` on the mesh, the first 5 steps of phase 23's main path
   (same seed, batches and schedule), loss and ``grad_norm`` within 1e-4
   relative of phase 23's, 64 B8-TC launches a step, step ms, peak, one
   more meshed step timed and profiled; (c) the 4-layer f32 twin, 5 steps
   on and off the mesh from the same weights, within 1e-5; (d) a drill: 7
   steps on the mesh at 8 layers with a checkpoint at step 4, which a
   fresh process restores into a fresh mesh and trains on to step 7, its
   steps 5-7's loss and ``grad_norm`` equal to the uninterrupted run's
   (world 1 is deterministic: a lost moment would show);
25. every LM family under the plan — the reduced f32 siblings of the
   eight archs beyond the dense GQA family (minicpm-2b, qwen2-vl-7b,
   qwen2-moe-a2.7b, grok-1-314b, minicpm3-4b, jamba-1.5-large-398b,
   rwkv6-7b, musicgen-medium) on the card's ``(1, 1)`` plan: one train
   step, a prefill and 4 greedy decode steps each, bit for bit equal to
   the same steps unmeshed (loss, ``grad_norm``, ``drop_frac``, the
   updated embedding, logits, caches, tokens, every MoE routing call's
   picks and kept mask), B8-TF32 as often on the mesh as off it;
26. the roofline on the card — SmolLM-360M at full width and depth
   (bf16) under ``repro_torch.roofline.StepCounter``: (a) the 8 x 1960
   prefill, (b) one decode step at batch 8 over a 2,048-slot cache, (c)
   one 8 x 2048 train step, each through B8-TC: FLOPs by dtype, B8's
   FLOPs through its custom operator's formula (``4·B·Hq·Sq²·D/2`` a
   launch), the count equal to the same step's on meta tensors at the
   same shapes, ``compute_s`` and ``memory_s`` at H100 rates beside the
   profiler's device-busy ms and the roofline share, with the card's name
   and power limit; (d) one dry-run cell (``python -m
   repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --mesh
   both``) in a subprocess of this machine's torch, started with phase 25
   (per-card FLOPs on (2, 16, 16) half those on (16, 16));
27. summary — the kernels with their launch counts, then one JSON line of
   per-kernel figures, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every path driven through a kernel backend has every kernel's launch
counter set to 0 just before it and read just after; each count is
checked and reported per path.  B1-B7, H1 and H2 add one to their
counter on the card each time they run (``kernels/launch_counts.py``),
so a level replayed from the loop's graph counts like an eager one; B8's
wrapper counts its launches (it never runs in a graph).  The main paths
are the full-width explores: phase 5 for B1, phase 6 for B2, phase 7 for
B3, phase 10 for B4 (via ``"cuda"``) and B5's ELL body (via
``"sparse_cuda"``), phase 11 for B5's COO body, and phase 14's
contiguous run for B6 (via ``"cuda"``) and B7 (via ``"sparse_cuda"``), S
launches a level, and phase 17's full-width bf16 prefill for B8-TC and
its f32 prefill for B8-TF32 (one launch a layer); their counts are the
kernels line's ``launches``.  Phase 22's family prefills are B8's paths
too: their counts are in ``launches_by_path``, and B8-TC's figures at
the qwen2-moe and musicgen launches in its ``other_launches``; so are
phase 23's training paths (``train``: the launcher's 20 steps), with
both bodies' figures at the training launch, and phase 24's meshed
paths (``meshed_serve_lm``, ``meshed_train``, ``meshed_train_f32_twin``,
``meshed_train_drill``, and the drill's fresh process,
``meshed_train_drill_resumed``, counted there), phase 25's
(``meshed_families_train``, ``meshed_families_serve``: B8-TF32) and
phase 26's (``roofline_prefill``, ``roofline_train``: B8-TC).
Phase 18's service, fault, checkpoint and launcher paths, and phase 20's
dense-row explores, distributed traces, trace-mesh services, launcher and
checkpointed explore (B1, B2, B3), are counted the same way and listed
in each kernel's ``launches_by_path``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the float32 rate outside the tensor cores (the int32/f32 datapath).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# ... and the dense bf16 and TF32 tensor-core rates (B8's inputs are bf16
# when serving; its f32 body runs split TF32 products).
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12

# The paper's printed allGenCk (§5); it lists '1-0-8' twice.
PAPER_ALLGENCK = """
2-1-1 2-1-2 1-1-2 2-1-3 1-1-3 2-0-2 2-0-1 2-1-4 1-1-4 2-0-3 1-1-1
0-1-2 0-1-1 2-1-5 1-1-5 2-0-4 0-1-3 1-0-2 1-0-1 2-1-6 1-1-6 2-0-5 0-1-4
1-0-3 1-0-0 2-1-7 1-1-7 2-0-6 0-1-5 1-0-4 2-1-8 1-1-8 2-0-7 0-1-6 1-0-5
2-1-9 1-1-9 2-0-8 0-1-7 1-0-6 2-1-10 1-1-10 2-0-9 0-1-8 1-0-7 0-1-9
1-0-8 1-0-8 1-0-9
""".split()

KERNELS = {
    "B1": {"name": "snp_step_dense", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/snp_step_dense.cu",
           "replaces": "src/repro/kernels/snp_step/kernel.py:201"},
    "B2": {"name": "snp_step_sparse_sell_ell", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/"
                     "snp_step_sparse.cu",
           "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
           "body": "_make_kernel(has_coo=False), sparse_kernel.py:71",
           "kernel": "snp_step_sparse_sell_kernel<BT, NT, false, false>, "
                     "Hn = 0"},
    "B3": {"name": "snp_step_sparse_coo", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/"
                     "snp_step_sparse.cu",
           "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
           "body": "_make_kernel(has_coo=True), sparse_kernel.py:155-167"},
    "B4": {"name": "snp_step_dense_delay_sell", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/"
                     "snp_step_dense_delay.cu",
           "replaces": "src/repro/kernels/snp_step/kernel.py:201",
           "body": "_make_kernel(has_halo=False, has_delay=True), "
                   "kernel.py:154-192",
           "kernel": "snp_step_dense_delay_sell_kernel<BT, NT>"},
    "B5-ELL": {"name": "snp_step_sparse_delay_ell", "route": "cuda",
               "source": "src/repro_torch/kernels/snp_step/csrc/"
                         "snp_step_sparse.cu",
               "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
               "body": "_make_kernel(has_coo=False, has_delay=True), "
                       "sparse_kernel.py:124-135,176-186"},
    "B5-COO": {"name": "snp_step_sparse_delay_coo", "route": "cuda",
               "source": "src/repro_torch/kernels/snp_step/csrc/"
                         "snp_step_sparse.cu",
               "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
               "body": "_make_kernel(has_coo=True, has_delay=True), "
                       "sparse_kernel.py:124-135,155-167,176-186"},
    "B6": {"name": "snp_step_dense_shard", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/snp_step_dense.cu",
           "replaces": "src/repro/kernels/snp_step/kernel.py:201",
           "body": "_make_kernel(has_halo=True), kernel.py:81-83,113-118; "
                   "wrapper ops.py:284"},
    "B7": {"name": "snp_step_sparse_shard", "route": "cuda",
           "source": "src/repro_torch/kernels/snp_step/csrc/"
                     "snp_step_sparse.cu",
           "replaces": "src/repro/kernels/snp_step/sparse_kernel.py:197",
           "body": "_make_kernel(has_halo=True), sparse_kernel.py:92-93,"
                   "142-147; wrapper sparse_ops.py:242"},
    "B8-TC": {"name": "flash_attn_fwd_tc", "route": "cuda",
              "source": "src/repro_torch/kernels/flash_attn/csrc/"
                        "flash_attn_fwd.cu",
              "replaces": "src/repro/kernels/flash_attn/kernel.py:90",
              "body": "_kernel, kernel.py:29; pallas_call kernel.py:117; "
                      "the tensor-core body (bf16, D 64/128: wgmma + TMA), "
                      "tc::flash_attn_fwd_tc_kernel; wrapper ops.py:75"},
    "B8-TF32": {"name": "flash_attn_fwd_tf32", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attn/csrc/"
                          "flash_attn_fwd.cu",
                "replaces": "src/repro/kernels/flash_attn/kernel.py:90",
                "body": "_kernel, kernel.py:29; pallas_call kernel.py:117; "
                        "the split-TF32 body (f32; bf16 at D 16/32: "
                        "mma.sync m16n8k8 TF32, three products a step for "
                        "f32), tf32::flash_attn_fwd_tf32_kernel; wrapper "
                        "ops.py:75"},
    "H1": {"name": "hashtable_rows", "route": "cuda",
           "source": "src/repro_torch/kernels/hashtable/csrc/hashtable.cu",
           "replaces": "src/repro/core/hashtable.py:153",
           "body": "no Pallas kernel: lookup's probe lax.while_loop and "
                   "config_hash (src/repro/core/hashing.py:46); "
                   "h1_kernel<BODY, L>: the rows body (the level's rows "
                   "hashed and looked up in one launch; the figures), the "
                   "hash body (config_hash) and the keys body (lookup); "
                   "wrapper kernels/hashtable/ops.py"},
    "H2": {"name": "hashtable_claim", "route": "cuda",
           "source": "src/repro_torch/kernels/hashtable/csrc/hashtable.cu",
           "replaces": "src/repro/core/hashtable.py:215",
           "body": "no Pallas kernel: the claim lax.while_loop of "
                   "_claim_loop; three routes by (K, S, D) and a fresh "
                   "table or a given one, ops.claim_route: "
                   "claim_cta_kernel (one block, __syncthreads), "
                   "claim_cluster_kernel (fresh tables: one cluster, the "
                   "claim words in distributed shared memory, cluster "
                   "barriers; the "
                   "figures: the level's first occurrence), "
                   "claim_grid_kernel (cooperative, grid syncs); wrapper "
                   "kernels/hashtable/ops.py"},
}

# What each kernel's library_ms times (one PyTorch call, never used by the
# port).  The delayed kernels have no single library call for their whole
# function, so theirs time a part of it.
LIBRARY_CALL = {
    "B1": "torch.matmul(S, M), f32",
    "B2": "torch.sparse.mm(S as CSR, M), f32",
    "B3": "torch.sparse.mm(S as CSR, M), f32",
    "B4": "partial: torch.matmul(S, W), f32, the accumulate stage only",
    "B5-ELL": "partial: torch.sparse.mm(S as CSR, M), f32, the delay-free "
              "product",
    "B5-COO": "partial: torch.sparse.mm(S as CSR, M), f32, the delay-free "
              "product",
    "B6": "torch.matmul(S, M_local) + torch.matmul(halo, hadj), f32",
    "B7": "partial: torch.sparse.mm(S as CSR, M_local), f32, without the "
          "halo term",
    "B8-TC": "torch.nn.functional.scaled_dot_product_attention(q, k, v, "
             "is_causal=True, enable_gqa=True), bf16",
    "B8-TF32": "torch.nn.functional.scaled_dot_product_attention(q, k, v, "
               "is_causal=True, enable_gqa=True), f32",
    "H1": None,
    "H2": None,
}

# Dense M for the sparse yardstick (torch.sparse.mm) only up to this size.
LIBRARY_M_BYTES = 4 << 30


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def time_ms(fn, iters):
    """Mean milliseconds per call, by CUDA events around ``iters`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, kernel=None):
    """Mean device time (ms) of the kernels whose name holds ``kernel`` in
    ``iters`` calls of ``fn``, from ``torch.profiler``: beside
    :func:`time_ms`, it shows whether the host kept the card waiting.  With
    ``kernel`` None, the device time a call of every event on the card.  A
    failure here, or two traces in a row without such a kernel, fails the
    smoke (the profiler's trace has lost a short kernel's events once in
    a while: B7's in phase 13 of one run, H1's in another)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (kernel is None or kernel in e.name)]
        if us:
            break
        log(f"the profiler's trace shows no kernel named {kernel!r}; "
            f"profiling again")
    check(len(us) > 0, f"the profiler shows no kernel named {kernel!r}")
    return sum(us) / (iters if kernel is None else len(us)) / 1e3


STEP_KERNELS = ("B1", "B2", "B3", "B4", "B5-ELL", "B5-COO", "B6", "B7",
                "H1", "H2")


def reset_counts():
    """Every kernel's launch counter to 0 (just before a path): the
    counters B1-B7, H1 and H2 add on the card as they run, and B8's,
    which its wrapper adds as it launches (B8 is never in a graph)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attn import ops as attn_ops
    launch_counts.reset()
    attn_ops.kernel_launches = attn_ops.kernel_launches_tc = 0


def read_counts():
    """Launches per kernel since :func:`reset_counts` (just after a
    path; the card's counters are copied out, one transfer a card, not a
    read of the port's)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attn import ops as attn_ops
    ran = launch_counts.by_kernel(launch_counts.read())
    return dict({k: ran.get(k, 0) for k in STEP_KERNELS},
                **{"B8-TC": attn_ops.kernel_launches_tc,
                   "B8-TF32": attn_ops.kernel_launches})


def shape_counts():
    """Launches of the step kernels by ``(kernel, rows, threads)`` since
    :func:`reset_counts`, from the card's counters."""
    from repro_torch.kernels import launch_counts
    return {k: n for k, n in launch_counts.read().items() if len(k) == 3}


# The hash-table kernels run on every hash-dedup path beside the step
# kernel; a path's check names them where it counts them (phase 21).
PROBE_KERNELS = ("H1", "H2")


def check_counts(path, counts, **want):
    """Each kernel named in ``want`` launched that many times on ``path``
    (``None``: at least once), every other step or attention kernel not
    at all (H1 and H2 only where named)."""
    for k, n in counts.items():
        if k in PROBE_KERNELS and k not in want:
            continue
        w = want.get(k, 0)
        ok = n > 0 if w is None else n == w
        check(ok, f"{path}: {k} launched {n} times, expected "
              f"{'at least one' if w is None else w}")


def phase_card_and_build():
    import torch
    from repro_torch.core import graph_loop
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.snp_step import _build, ops, sparse_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"[1] card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on: the plain version's f32 product needs it off")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    sources = [ops.SOURCE, ops.DELAY_SOURCE, sparse_ops.SOURCE,
               attn_ops.SOURCE, ht_ops.SOURCE, graph_loop.SOURCE]
    _build.build_all(sources)
    ops.load_kernel()
    ops.load_delay_kernel()
    sparse_ops.load_kernel()
    attn_ops.load_kernel()
    ht_ops.load_kernel()
    graph_loop.load_library()
    secs = time.perf_counter() - t0
    log(f"[1] built (in parallel) and loaded "
        f"{', '.join(s.name for s in sources)} in {secs:.2f} s; the sparse "
        f"kernel takes up to {sparse_ops.max_neurons()} neurons, the dense "
        f"delayed kernel up to {ops.delay_max_neurons()}")
    for source in sources:
        for line in _build.build_logs.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line \
                    or "Compiling entry" in line or "Performance" in line:
                log(f"[1]   {source.name}: {line.strip()}")
    return card


def _step_inputs(comp, configs):
    from repro_torch.core.semantics import branch_info, clamp_stride
    info = branch_info(configs, comp)
    return (configs.contiguous(), info.rank, info.app,
            clamp_stride(info.stride), info.choices, info.psi.contiguous(),
            comp.rule_neuron, comp.M, comp.env_produce), info


def _list_bytes(*lists):
    return sum(x.numel() * x.element_size() for x in lists)


def _bound(args, T, cols):
    """Least time for one call (ms), what binds, the operations counted,
    the rules fired, and the bound with ``M`` and ``env`` counted as dense
    arrays (for comparison), from this call's inputs.  Bytes: each
    input read once and each output written once, over HBM bandwidth,
    with ``[M | env]`` read as its nonzeros (``cols``, the column lists
    the kernel walks).  Operations: what these inputs need, over the
    f32/int32 datapath peak: a digit decode (divide, modulo, compare) per
    neuron and branch, the ``C +`` per output entry, and a multiply-add
    per nonzero of ``M``'s row (and of ``env``) for every rule that fires
    (at most one per neuron; counted from the decoded ``S``), not the
    dense 2·B·T·n·m."""
    import torch
    from repro_torch.core.semantics import decode_spiking
    configs, rank, app, stride, choices, psi, rule_neuron, M, env = args
    B, m = configs.shape
    dense_bytes = _list_bytes(M, env)
    in_bytes = _list_bytes(*args) - dense_bytes + _list_bytes(*cols)
    out_bytes = 4 * B * T * m + 5 * B * T
    S = decode_spiking(app, rank, stride, choices, rule_neuron, T)
    fired = S.sum(dim=(0, 1), dtype=torch.int64)                 # (n,)
    row_nnz = (M != 0).sum(dim=1) + (env != 0)                   # (n,)
    n_ops = 3 * B * T * m + 2 * int((fired * row_nnz).sum())
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    t_dense = (in_bytes - _list_bytes(*cols) + dense_bytes + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return bound + (n_ops, int(fired.sum()), max(t_dense, t_ops))


def _hand_made(comp, rng):
    """A hand-made ``M`` and ``env`` for ``comp``'s shape: |values| up to
    1000 (past int8), negatives, column 1 empty and column 0 a hub holding
    every rule."""
    import numpy as np
    import torch
    n, m = comp.num_rules, comp.num_neurons
    M = rng.integers(-1000, 1001, size=(n, m)) * (rng.random((n, m)) < 0.01)
    M[:, 0] = rng.integers(128, 1001, size=n) * rng.choice([-1, 1], size=n)
    M[:, 1] = 0
    env = rng.integers(-1000, 1001, size=n) * (rng.random(n) < 0.3)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(comp.device)
                 for x in (M, env))


def phase_kernel():
    """Kernel == plain version on the card; returns (max_abs_err, timing
    rows keyed by case name)."""
    import numpy as np
    import torch
    from repro_torch.core import compile_system, next_configs, paper_pi
    from repro_torch.core.generators import nd_chain, random_system, scaled_pi
    from repro_torch.core.matrix import dense_column_lists
    from repro_torch.core.semantics import decode_spiking
    from repro_torch.kernels.snp_step import ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_ref

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def rand(B, m, lo, hi):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(B, m)).astype(np.int32)).to(dev)

    # (name, system, B, T, configs, hand-made M?): the hand-made cases
    # replace M and env (and their column lists, derived here)
    cases = [
        ("paper_pi", paper_pi(True), 128, 16, lambda m: rand(128, m, 0, 5),
         False),
        ("nd_chain(10)", nd_chain(10), 16, 64,
         lambda m: torch.ones((16, m), dtype=torch.int32, device=dev), False),
        ("random_system(2048)", random_system(2048, 2, 8 / 2048, seed=1),
         64, 32, lambda m: rand(64, m, 0, 4), False),
        ("ragged B13 T37", random_system(45, 3, 0.1, seed=5), 13, 37,
         lambda m: rand(13, m, 0, 4), False),
        ("spikes~2^20", random_system(64, 2, 0.1, seed=2), 32, 32,
         lambda m: rand(32, m, 2 ** 20 - 8, 2 ** 20 + 8), False),
        # m = 1023 (odd), T = 33: no row of the output slab starts aligned
        ("unaligned slab m1023 T33", scaled_pi(341), 37, 33,
         lambda m: rand(37, m, 0, 3), False),
        ("hub column |M|>127 (hand-made)", random_system(40, 9, 0.2, seed=6),
         48, 64, lambda m: rand(48, m, 0, 4), True),
        ("n past one rule chunk (hand-made)",
         random_system(64, 130, 0.2, seed=7), 32, 64,
         lambda m: rand(32, m, 0, 4), True),
        ("scaled_pi(1700) n past one rule chunk", scaled_pi(1700), 64, 64,
         lambda m: rand(64, m, 0, 3), False),
        ("scaled_pi(682) wave", scaled_pi(682), 512, 64,
         lambda m: rand(512, m, 0, 3), False),
    ]
    max_err = 0
    rows = {}
    for name, system, B, T, make, hand in cases:
        comp = compile_system(system, device=dev)
        n, m = comp.num_rules, comp.num_neurons
        configs = make(m)
        args, info = _step_inputs(comp, configs)
        cols = (comp.col_start, comp.col_rule, comp.col_val)
        if hand:
            args = args[:7] + _hand_made(comp, rng)
            cols = dense_column_lists(*args[7:])
            check(int(cols[0][1] - cols[0][0]) == n > 300
                  and int(cols[0][2] - cols[0][1]) == 0
                  and int(cols[2].abs().max()) > 127,
                  f"{name}: the hand-made M lacks its hub or empty column")
        if "chunk" in name:
            check(n > ops.RULE_CHUNK, f"{name}: n={n} fits one rule chunk")
        # B1 reads the lists, its plain version the matrices
        k_out, k_valid, k_emis = ops.snp_step_dense(*args[:7], cols, T)
        p_out, p_valid, p_emis = snp_step_dense_ref(*args, T)
        torch.cuda.synchronize()
        err = max(int((k_out - p_out).abs().max()),
                  int((k_emis - p_emis).abs().max()))
        max_err = max(max_err, err)
        check(err == 0 and bool(torch.equal(k_valid, p_valid)),
              f"{name}: kernel disagrees with its plain version "
              f"(max |err| {err})")
        if not hand:
            check(all(torch.equal(a, b) for a, b in zip(
                cols, dense_column_lists(comp.M, comp.env_produce))),
                f"{name}: the encoding's lists differ from the derived ones")
            # the wrapper against the reference semantics, on valid entries
            w_out, w_valid, w_emis, w_ovf = ops.snp_step(configs, comp,
                                                         max_branches=T)
            ref = next_configs(configs, comp, T)
            check(torch.equal(w_valid, ref.valid)
                  and torch.equal(w_ovf, ref.overflow)
                  and torch.equal(torch.where(w_valid[..., None], w_out, 0),
                                  torch.where(ref.valid[..., None],
                                              ref.configs, 0))
                  and torch.equal(torch.where(w_valid, w_emis, 0),
                                  torch.where(ref.valid, ref.emissions, 0)),
                  f"{name}: wrapper disagrees with next_configs")
            del w_out, ref
        if name == "nd_chain(10)":
            check(bool(info.psi.min() > T) and bool(w_ovf.all()),
                  "nd_chain(10) should overflow T")

        iters = 5 if B * T * n * m > 1e10 else 50
        k_ms = time_ms(lambda: ops.snp_step_dense(*args[:7], cols, T), 50)
        p_ms = time_ms(lambda: snp_step_dense_ref(*args, T), iters)
        S = decode_spiking(*(args[i] for i in (2, 1, 3, 4, 6)), T)
        S = S.reshape(B * T, n).to(torch.float32)
        Mf = args[7].to(torch.float32)
        l_ms = time_ms(lambda: torch.matmul(S, Mf), iters)
        b_ms, b_by, b_ops, fired, b_dense = _bound(args, T, cols)
        rows[name] = dict(B=B, T=T, n=n, m=m, ms=k_ms, plain_ms=p_ms,
                          library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                          bound_dense_ms=b_dense)
        if "wave" in name:
            rows[name]["device_ms"] = d_ms = device_ms(
                lambda: ops.snp_step_dense(*args[:7], cols, T), 20,
                "snp_step_dense_kernel<false")
            log(f"[2] {name}: B1's device time by the profiler {d_ms} ms "
                f"(CUDA events {k_ms:.4f})")
        log(f"[2] {name:38s} B={B:4d} T={T:3d} n={n:5d} m={m:5d} "
            f"nnz={int(cols[0][-1]):6d} | kernel == plain (max |err| {err})"
            f" | kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, matmul(S,M) "
            f"{l_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {fired} fired "
            f"rules, {b_ops} ops needed vs {2 * B * T * n * m} dense; "
            f"{b_dense:.6f} ms counting M dense) = {k_ms / b_ms:.1f}x bound")
        del S, Mf, k_out, p_out
    err = _forged_b1(rng, dev)
    max_err = max(max_err, err)
    return max_err, rows


def _forge(start, index, rows, rng):
    """One column list ``(start, index)`` (``index`` cut to ``start``'s
    last entry) with entries out of range: every 7th entry's index moved
    outside ``0..rows-1``, the first start below 0 and the last past the
    list's end.  Returns the forged pair and the (index, column) of each
    forged entry, which the kernel must skip."""
    import torch
    nnz = int(start[-1])
    start, index = start.clone(), index[:nnz].clone()
    col = torch.repeat_interleave(
        torch.arange(start.shape[0] - 1, device=start.device),
        (start[1:] - start[:-1]).long())
    bad = torch.arange(0, nnz, 7, device=index.device)
    dropped = (index[bad].long(), col[bad])
    far = torch.from_numpy(rng.integers(0, 1 << 20, bad.shape[0])).to(
        index.device, torch.int32)
    index[bad] = torch.where(bad % 2 == 0, rows + far, -1 - far)
    start[0] = -5
    start[-1] = nnz + 1000
    return start, index, dropped


def _forged_b1(rng, dev):
    """B1 on forged column lists (entries naming rules outside the system,
    a start below 0 and one past the lists' end) equals its plain version
    on ``[M | env]`` without the forged entries: the kernel skips them and
    reads nothing out of bounds."""
    import numpy as np
    import torch
    from repro_torch.core import compile_system
    from repro_torch.core.generators import random_system
    from repro_torch.core.matrix import dense_column_lists
    from repro_torch.kernels.snp_step import ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_ref

    comp = compile_system(random_system(40, 9, 0.2, seed=6), device=dev)
    n, m, B, T = comp.num_rules, comp.num_neurons, 48, 64
    configs = torch.from_numpy(
        rng.integers(0, 4, size=(B, m)).astype(np.int32)).to(dev)
    args = _step_inputs(comp, configs)[0][:7] + _hand_made(comp, rng)
    start, rule_idx, val = dense_column_lists(*args[7:])
    start, rule_idx, (rule, col) = _forge(start, rule_idx, n, rng)
    cols = (start, rule_idx, val)
    full = torch.cat([args[7], args[8][:, None]], 1)
    full[rule, col] = 0
    k_out, k_valid, k_emis = ops.snp_step_dense(*args[:7], cols, T)
    p_out, p_valid, p_emis = snp_step_dense_ref(
        *args[:7], full[:, :m].contiguous(), full[:, m].contiguous(), T)
    torch.cuda.synchronize()
    err = max(int((k_out - p_out).abs().max()),
              int((k_emis - p_emis).abs().max()))
    check(err == 0 and bool(torch.equal(k_valid, p_valid)),
          f"forged lists: B1 disagrees with its plain version without the "
          f"forged entries (max |err| {err})")
    log(f"[2] forged lists (hand-made)            B={B:4d} T={T:3d} n={n:5d} "
        f"m={m:5d} | {rule.shape[0]} entries out of range, starts below 0 "
        f"and past the end: B1 == plain without them (max |err| {err})")
    return err


def _sparse_bound(args, extra, T, read=None):
    """Least time for one sparse step call (ms), what binds, and the
    operations counted, from this call's inputs (the plain version's
    ``args``/``extra``).  Bytes: each input the kernel reads (``read``;
    by default the plain version's inputs) read once and each output
    written once, over HBM bandwidth.  Operations:
    what these inputs need, over the f32/int32 datapath peak: a digit
    decode (divide, floor, modulo) per neuron and branch, the ``C −
    consume`` per output entry, and one add per out-synapse of every
    neuron whose fired rule produces (counted from the decoded fired
    produce), not the ELL padding the kernel also walks.  Under delays
    (``extra`` holds ``dtab``/``cd``/``pd``) the rows are 3m wide, a
    neuron sends when its emit-now value is nonzero (a reopening neuron's
    pending spikes count), and the combine adds three operations per
    neuron and branch."""
    import torch
    from repro_torch.kernels.snp_step.sparse_ref import (decode_digits,
                                                         fired_packed)
    configs, stride, choices, psi, tab, in_idx, out_neuron = args
    B, m = configs.shape
    delayed = "dtab" in extra
    inputs = list(args) + list(extra.values()) if read is None else read
    in_bytes = sum(x.numel() * x.element_size() for x in inputs)
    out_bytes = 4 * B * T * m * (3 if delayed else 1) + 5 * B * T
    out_deg = torch.bincount(in_idx[in_idx < m].to(torch.int64),
                             minlength=m)
    if "coo_src" in extra:
        out_deg += torch.bincount(extra["coo_src"].to(torch.int64),
                                  minlength=m)
    fired = (fired_packed(decode_digits(T, stride, choices), tab)
             & 0xFFFF) != 0                                  # (B, T, m)
    if delayed:
        fired |= ((extra["cd"] == 1) & (extra["pd"] != 0))[:, None, :]
    adds = int((fired.sum(dim=(0, 1), dtype=torch.int64) * out_deg).sum())
    n_ops = 3 * B * T * m + B * T * m + adds \
        + (3 * B * T * m if delayed else 0)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (n_ops,)


def _sparse_library_ms(system, comp, configs, info, T, iters,
                       semantics="no_delays"):
    """One ``torch.sparse.mm`` of the fired one-hot ``S`` (B·T × n, CSR,
    f32) with a dense f32 ``M``: the yardstick, or ``None`` where ``M``
    exceeds :data:`LIBRARY_M_BYTES`."""
    import torch
    from repro_torch.core import compile_system
    from repro_torch.core.semantics import clamp_stride, decode_spiking
    n, m = comp.num_rules, comp.num_neurons
    if 4 * n * m > LIBRARY_M_BYTES:
        return None
    B = configs.shape[0]
    Mf = compile_system(system, semantics=semantics,
                        device=configs.device).M.to(torch.float32)
    S = decode_spiking(info.app, info.rank, clamp_stride(info.stride),
                       info.choices, comp.rule_neuron, T)
    S = S.reshape(B * T, n).to(torch.float32).to_sparse_csr()
    ms = time_ms(lambda: torch.sparse.mm(S, Mf), iters)
    del S, Mf
    return ms


def _kernel_read(kargs, kextra):
    """The tensors the kernel reads, from its launcher's arguments."""
    return list(kargs) + list(kextra.values())


def _empty_slice_system():
    """``random_system(100)`` (m not a multiple of 32) with no synapse
    into neurons 32..63, a slice of the sliced lists with width 0, and one
    from every even neuron into neuron 70, a hub."""
    import dataclasses
    from repro_torch.core.generators import random_system
    base = random_system(100, 2, 0.08, seed=7)
    syn = {(i, j) for i, j in base.synapses if not 32 <= j < 64}
    syn |= {(i, 70) for i in range(0, 100, 2) if i != 70}
    return dataclasses.replace(base, synapses=tuple(sorted(syn)),
                               name="empty-slice-100")


def _forge_sliced(start, src, in_idx, zero, rng):
    """Forged copies of one set of sliced lists ``(start, src)`` over
    ``in_idx`` (numpy): every 5th entry up to the lists' end moved above
    the zero slot ``zero`` or below 0, the first start below 0 and the
    last past the lists' end; and ``in_idx`` with the zero slot in place
    of each forged entry, which the kernel reads as the zero slot.
    Returns ``(start, src, in_idx, entries forged)``."""
    import numpy as np
    start, src, in_idx = start.copy(), src.copy(), in_idx.copy()
    pos = np.arange(int(start[-1]))
    sl = np.searchsorted(start, pos, side="right") - 1
    neuron, k = 32 * sl + (pos - start[sl]) % 32, (pos - start[sl]) // 32
    bad = pos[pos % 5 == 0]
    far = rng.integers(1, 1 << 20, bad.shape[0])
    src[bad] = np.where(bad % 2 == 0, zero + far, -far)
    live = neuron[bad] < in_idx.shape[0]
    in_idx[neuron[bad][live], k[bad][live]] = zero
    start[0], start[-1] = -5, src.shape[0] + 1000
    return start, src, in_idx, int(bad.shape[0])


def _forged_lists(rng, dev, delayed, hybrid=True):
    """The sliced-list kernel's B3 (B5 COO when ``delayed``; B2, or B5
    ELL when ``delayed``, when not ``hybrid``) on forged sliced lists (and
    tail)
    equals its plain version without the forged entries: every 5th list
    entry and every 7th tail entry moved above m or below 0 (the kernel
    reads them as the zero slot; the plain version reads ``m``, the zero
    slot, in their place), the first slice start below 0 and the last
    past the lists' end (clamped).  Returns (kernel, max |err|)."""
    import numpy as np
    import torch
    from repro_torch.core import compile_system_sparse, with_delays
    from repro_torch.core.generators import power_law
    from repro_torch.kernels.snp_step import sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import (kernel_inputs,
                                                         snp_step_sparse_ref)

    system = power_law(1000, 4, seed=9)
    if delayed:
        system = with_delays(system, lambda k, r: k % 3)
    comp = compile_system_sparse(system, hub_threshold=3 if hybrid else None,
                                 device=dev, semantics="delays" if delayed
                                 else "no_delays")
    m, B, T = comp.num_neurons, 24, 40
    cols = 3 * m if delayed else m
    configs = torch.from_numpy(rng.integers(0, 4, size=(B, cols)).astype(
        np.int32)).to(dev)
    start, src, in_idx, n_bad = _forge_sliced(
        comp.sell_start.cpu().numpy(), comp.sell_src.cpu().numpy(),
        comp.in_idx.cpu().numpy(), m, rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    forged = comp._replace(sell_start=t(start), sell_src=t(src))
    plain = comp._replace(in_idx=t(in_idx))
    tail = ""
    if hybrid:
        coo = comp.coo_src.cpu().numpy()
        cbad = np.arange(0, coo.shape[0], 7)
        coo_k = coo.copy()
        coo_k[cbad] = m + 1 + rng.integers(0, 1 << 20, cbad.shape[0])
        coo_p = coo.copy()
        coo_p[cbad] = m
        forged = forged._replace(coo_src=t(coo_k))
        plain = plain._replace(coo_src=t(coo_p))
        tail = f" and {cbad.shape[0]} tail"
    kargs, kextra, _ = kernel_inputs(configs, forged, lists=True)
    pargs, pextra, _ = kernel_inputs(configs, plain)
    k = sparse_ops.snp_step_sparse_cuda(*kargs, **kextra, max_branches=T)
    p = snp_step_sparse_ref(*pargs, **pextra, max_branches=T)
    torch.cuda.synchronize()
    err = max(int((k[0] - p[0]).abs().max()), int((k[2] - p[2]).abs().max()))
    kernel = ("B5-COO" if hybrid else "B5-ELL") if delayed else (
        "B3" if hybrid else "B2")
    check(err == 0 and bool(torch.equal(k[1], p[1])),
          f"forged sliced lists: {kernel} disagrees with its plain version "
          f"without the forged entries (max |err| {err})")
    log(f"[{9 if delayed else 3}] forged lists (power_law(1000)"
        f"{' h=3' if hybrid else ''}) {kernel} B={B} T={T} m={m} | "
        f"{n_bad} list{tail} entries out of range, starts below 0 "
        f"and past the end: {kernel} == plain without them (max |err| "
        f"{err})")
    return kernel, err


def phase_sparse_kernel():
    """B2 (the ELL body) and B3 (the COO tail) of the sliced-list kernel
    == their plain version on the card, on every entry; returns (max |err|
    per kernel, timing rows keyed by case name)."""
    import numpy as np
    import torch
    from repro_torch.core import (SystemPlan, compile_system_sparse,
                                  paper_pi, sparse_next_configs)
    from repro_torch.core.generators import (nd_chain, power_law,
                                             random_system, ring_lattice,
                                             scaled_pi)
    from repro_torch.kernels.snp_step import sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import (kernel_inputs,
                                                         snp_step_sparse_ref)

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    def rand(B, m, lo, hi):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(B, m)).astype(np.int32)).to(dev)

    hybrid_system = power_law(8192, 4, seed=2)
    cases = [
        # (name, system, hub threshold, B, T, configs)
        ("paper_pi", paper_pi(True), None, 128, 16,
         lambda m: rand(128, m, 0, 5)),
        ("nd_chain(10)", nd_chain(10), None, 16, 64,
         lambda m: torch.ones((16, m), dtype=torch.int32, device=dev)),
        ("ragged B13 T37", random_system(45, 3, 0.1, seed=5), None, 13, 37,
         lambda m: rand(13, m, 0, 4)),
        ("random(64) h=1", random_system(64, 2, 0.15, seed=3), 1, 24, 40,
         lambda m: rand(24, m, 0, 4)),
        ("ragged m=45 h=2 B13 T37", random_system(45, 3, 0.1, seed=5), 2,
         13, 37, lambda m: rand(13, m, 0, 4)),
        ("empty slice m=100 h=4", _empty_slice_system(), 4, 24, 40,
         lambda m: rand(24, m, 0, 4)),
        ("empty slice m=100", _empty_slice_system(), None, 24, 40,
         lambda m: rand(24, m, 0, 4)),
        ("spikes~2^20", random_system(64, 2, 0.1, seed=2), None, 32, 32,
         lambda m: rand(32, m, 2 ** 20 - 8, 2 ** 20 + 8)),
        ("ring_lattice(32768,8)", ring_lattice(32768, 8, seed=2), None, 64,
         64, lambda m: rand(64, m, 0, 4)),
        ("power_law(32768,max_in=64)",
         power_law(32768, 4, seed=2, max_in=64), None, 64, 64,
         lambda m: rand(64, m, 0, 4)),
        ("power_law(32768,max_in=64) h=16",
         power_law(32768, 4, seed=2, max_in=64), 16, 64, 64,
         lambda m: rand(64, m, 0, 4)),
        ("scaled_pi(682) wave", scaled_pi(682), None, 512, 64,
         lambda m: rand(512, m, 0, 3)),
        ("ring_lattice(32768,8) wave", ring_lattice(32768, 8, seed=2), None,
         512, 64, lambda m: rand(512, m, 0, 4)),
        ("power_law(8192) hybrid wave", hybrid_system, "auto", 512, 64,
         lambda m: rand(512, m, 0, 4)),
    ]
    max_err = {"B2": 0, "B3": 0}
    rows = {}
    for name, system, h, B, T, make in cases:
        if h == "auto":
            h = SystemPlan.for_system(system).hub_threshold
        comp = compile_system_sparse(system, hub_threshold=h, device=dev)
        kernel = "B3" if comp.is_hybrid else "B2"
        check((h is not None) == comp.is_hybrid,
              f"{name}: expected {'a hybrid' if h else 'an ELL'} encoding")
        n, m = comp.num_rules, comp.num_neurons
        configs = make(m)
        args, coo, info = kernel_inputs(configs, comp)
        kargs, kcoo, _ = kernel_inputs(configs, comp, lists=True)
        if name.startswith("empty slice"):
            st = comp.sell_start
            check(m % 32 != 0 and bool((st[1:] == st[:-1]).any()),
                  f"{name}: expected a slice of width 0")
        k_out, k_valid, k_emis = sparse_ops.snp_step_sparse_cuda(
            *kargs, **kcoo, max_branches=T)
        p_out, p_valid, p_emis = snp_step_sparse_ref(*args, **coo,
                                                     max_branches=T)
        torch.cuda.synchronize()
        err = max(int((k_out - p_out).abs().max()),
                  int((k_emis - p_emis).abs().max()))
        max_err[kernel] = max(max_err[kernel], err)
        check(err == 0 and bool(torch.equal(k_valid, p_valid)),
              f"{name}: {kernel} disagrees with its plain version "
              f"(max |err| {err})")
        del k_out, p_out
        # the wrapper on the card against the plain step, every entry
        w = sparse_ops.snp_step_sparse(configs, comp, max_branches=T)
        ref = sparse_next_configs(configs, comp, T)
        check(all(torch.equal(a, b) for a, b in zip(
            w, (ref.configs, ref.valid, ref.emissions, ref.overflow))),
            f"{name}: sparse wrapper disagrees with sparse_next_configs")
        del w, ref
        if name == "nd_chain(10)":
            check(bool(info.psi.min() > T), "nd_chain(10) should overflow T")

        big = B * T * m > 1e7
        iters = 5 if big else 50
        k_ms = time_ms(lambda: sparse_ops.snp_step_sparse_cuda(
            *kargs, **kcoo, max_branches=T), iters)
        p_ms = time_ms(lambda: snp_step_sparse_ref(
            *args, **coo, max_branches=T), iters)
        l_ms = _sparse_library_ms(system, comp, configs, info, T, iters)
        b_ms, b_by, b_ops = _sparse_bound(args, coo, T,
                                          _kernel_read(kargs, kcoo))
        rows[name] = dict(kernel=kernel, B=B, T=T, n=n, m=m,
                          Kin=comp.max_in_degree,
                          Ec=int(comp.coo_src.shape[0]), ms=k_ms,
                          plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                          bound_by=b_by)
        bt, nt = sparse_ops.sell_block_shape(m, 0, T)
        rows[name]["block"] = [bt, nt]
        if "wave" in name:
            rows[name]["device_ms"] = d_ms = device_ms(
                lambda: sparse_ops.snp_step_sparse_cuda(
                    *kargs, **kcoo, max_branches=T), 20,
                "snp_step_sparse_sell_kernel")
            log(f"[3] {name}: {kernel}'s device time by the profiler "
                f"{d_ms} ms (CUDA events {k_ms:.4f}), bound {b_ms:.6f} ms, "
                f"block {bt} rows x {nt} threads")
        lib = "—" if l_ms is None else f"{l_ms:.4f} ms"
        rows_b = (f" sliced entries={comp.sell_src.shape[0]} block {bt} "
                  f"rows x {nt} threads")
        log(f"[3] {name:27s} {kernel} B={B:4d} T={T:3d} n={n:6d} m={m:6d} "
            f"Kin={comp.max_in_degree:3d} Ec={rows[name]['Ec']:6d}{rows_b} | "
            f"kernel == plain (max |err| {err}) | kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, sparse.mm(S,M) {lib}, bound "
            f"{b_ms:.6f} ms ({b_by}; {b_ops} ops) = {k_ms / b_ms:.1f}x "
            f"bound")
        del kargs, kcoo, args, coo, info
        torch.cuda.empty_cache()
    for hybrid in (False, True):
        kernel, err = _forged_lists(rng, dev, False, hybrid)
        max_err[kernel] = max(max_err[kernel], err)
    return max_err, rows


def phase_paper():
    from repro_torch.core import emission_gaps, explore, paper_pi

    # "cuda" pinned: the phase counts B1's launches, and an open plan
    # would let the planner pick the backend (phase 19)
    launches = {}
    reset_counts()
    res = explore(paper_pi(True), max_steps=16, frontier_cap=128,
                  visited_cap=2048, max_branches=16, backend="cuda")
    launches["s5_explore"] = read_counts()["B1"]
    check_counts("§5 explore", read_counts(), B1=res.steps)
    mine = res.as_strings()
    paper = list(dict.fromkeys(PAPER_ALLGENCK))
    check(mine[:45] == paper[:45], "allGenCk prefix differs from the paper")
    check(set(paper) <= set(mine), "allGenCk misses a paper entry")
    reset_counts()
    gaps = emission_gaps(paper_pi(False), max_time=30, max_gap=14,
                         backend="cuda")
    covering = emission_gaps(paper_pi(True), max_time=16, max_gap=8,
                             backend="cuda")
    counts = read_counts()
    launches["s5_emission_gaps"] = counts["B1"]
    check_counts("§5 emission gaps", counts, B1=None)
    check(1 not in gaps and set(range(2, 13)) <= gaps,
          f"exact-mode gaps {sorted(gaps)} are not ℕ∖{{1}} on [2, 12]")
    check(1 in covering, "covering mode should admit gap 1")
    log(f"[4] §5 run on the card: {res.num_discovered} configs in "
        f"{res.steps} levels, first 45 = paper's allGenCk in order, all 47 "
        f"present; exact-mode gaps ⊇ {{2..12}}, 1 ∉ gaps; B1 launches: "
        f"explore {launches['s5_explore']}, emission_gaps "
        f"{launches['s5_emission_gaps']}")
    return launches


FULL_WIDTH = dict(max_steps=8, frontier_cap=512, max_branches=64,
                  visited_cap=262144)


def _timed_explore(tag, label, system, backend, kernel, plan=None,
                   caps=FULL_WIDTH):
    """One full-width explore with its launch counts (set to 0 just
    before, read just after), wall time, host reads and peak memory."""
    import torch
    from repro_torch.core import device as devmod
    from repro_torch.core import explore

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    devmod.host_reads = 0
    t0 = time.perf_counter()
    res = explore(system, backend=backend, plan=plan, **caps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, reads = read_counts(), devmod.host_reads
    peak = torch.cuda.max_memory_allocated()
    waves = res.steps
    cands = waves * caps["frontier_cap"] * caps["max_branches"]
    check_counts(f"{label} via {backend!r}", counts,
                 **({kernel: waves} if kernel else {}))
    log(f"[{tag}] {label} via {backend!r}: {waves} waves in {secs:.3f} s = "
        f"{waves / secs:.3f} waves/s, {cands / secs:.0f} candidates/s, "
        f"{res.num_discovered} configs archived, flags b/f/v="
        f"{res.branch_overflow}/{res.frontier_overflow}/"
        f"{res.visited_overflow}, launches {json.dumps(counts)}, host reads "
        f"{reads} ({reads / max(waves, 1):.1f}/wave), "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    return res, (counts[kernel] if kernel else 0), peak


# Digests of the main-path archives (phases 5, 7 and 10), which phase 19
# holds the planner's explores to.
ARCHIVES = {}


def _digest(res):
    """sha256 of an explore's archive, with its steps and flags."""
    import hashlib

    import numpy as np
    return (hashlib.sha256(np.ascontiguousarray(res.configs).tobytes())
            .hexdigest(), res.num_discovered, res.steps, res.exhausted,
            res.branch_overflow, res.frontier_overflow, res.visited_overflow)


def _same_explore(a, b):
    import numpy as np
    return np.array_equal(a.configs, b.configs) and \
        (a.steps, a.branch_overflow, a.frontier_overflow,
         a.visited_overflow, a.exhausted) == \
        (b.steps, b.branch_overflow, b.frontier_overflow,
         b.visited_overflow, b.exhausted)


def phase_full_width():
    from repro_torch.core import compile_system, resolve_dedup
    from repro_torch.core.generators import scaled_pi

    system = scaled_pi(682)
    dedup = resolve_dedup("auto", frontier_cap=512, visited_cap=262144,
                          max_branches=64)
    check(dedup == "hash", f"dedup auto resolved to {dedup}")
    a, launches, _ = _timed_explore("5", "explore(scaled_pi(682))", system,
                                    "cuda", "B1")
    b, _, _ = _timed_explore("5", "explore(scaled_pi(682))", system, "ref",
                             None)
    check(_same_explore(a, b),
          "full-width archives or flags differ between 'cuda' and 'ref'")
    ARCHIVES["scaled_pi(682)"] = _digest(a)
    log(f"[5] archives identical through 'cuda' and 'ref' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} neurons)")
    _wave_breakdown("5", compile_system(system, device="cuda"), a.configs,
                    ("cuda", "ref"))
    return launches, a


def phase_full_width_ell(dense_result):
    from repro_torch.core import compile_system_sparse
    from repro_torch.core.generators import scaled_pi

    system = scaled_pi(682)
    res, launches, _ = _timed_explore("6", "explore(scaled_pi(682))",
                                      system, "sparse_cuda", "B2")
    check(_same_explore(res, dense_result),
          "ELL full-width archive or flags differ from 'cuda' and 'ref'")
    log(f"[6] archive identical through 'sparse_cuda', 'cuda' and 'ref' "
        f"({res.num_discovered} rows)")
    _wave_breakdown("6", compile_system_sparse(system, device="cuda"),
                    res.configs, ("sparse_cuda", "sparse"))
    return launches


def phase_full_width_hybrid():
    from repro_torch.core import SystemPlan, compile_system_sparse
    from repro_torch.core.generators import power_law

    system = power_law(8192, 4, seed=2)
    plan = SystemPlan.for_system(system)
    check(plan.encoding == "hybrid", f"power_law(8192) planned {plan}")
    comp = compile_system_sparse(system, hub_threshold=plan.hub_threshold,
                                 device="cuda")
    hubs = int(comp.coo_bounds.shape[0]) - 1
    runs = comp.coo_bounds[1:] - comp.coo_bounds[:-1]
    log(f"[7] power_law(8192, 4, seed=2): m={comp.num_neurons}, "
        f"n={comp.num_rules}, {len(system.synapses)} synapses, plan "
        f"{plan.encoding} (hub threshold {plan.hub_threshold}), Kin="
        f"{comp.max_in_degree}, Ec={comp.coo_src.shape[0]} over {hubs} hubs "
        f"(longest run {int(runs.max())}), sliced entries "
        f"{comp.sell_src.shape[0]} against {comp.in_idx.numel()} ELL slots, "
        f"R={comp.max_rules_per_neuron}, K={comp.max_nnz_per_rule}")
    a, launches, _ = _timed_explore("7", "explore(power_law(8192))",
                                    system, "sparse_cuda", "B3", plan)
    b, _, _ = _timed_explore("7", "explore(power_law(8192))", system,
                             "sparse", None, plan)
    check(_same_explore(a, b), "hybrid full-width archives or flags differ "
          "between 'sparse_cuda' and 'sparse'")
    ARCHIVES["power_law(8192)"] = _digest(a)
    log(f"[7] archives identical through 'sparse_cuda' and 'sparse' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} neurons)")
    _wave_breakdown("7", comp, a.configs, ("sparse_cuda", "sparse"))
    return launches


# The full-width waves by the phase that runs them, and the eager
# config_hash's and the expand's ms a level there (host clock, this
# phase's stage split before H1 hashed the rows; NVIDIA H100 80GB HBM3,
# 700 W).
WAVE_OF_TAG = {"5": "scaled_pi(682)", "6": "scaled_pi(682)",
               "7": "power_law(8192) hybrid",
               "10": "scaled_pi(682) delayed",
               "11": "power_law(8192) delayed hybrid"}
EAGER_HASH_MS = {"scaled_pi(682)": (10.078, 1.059),
                "power_law(8192) hybrid": (40.166, 2.420),
                "scaled_pi(682) delayed": (30.202, 1.206),
                "power_law(8192) delayed hybrid": (120.428, 4.719)}
# H1's and H2's checks and figures at each wave's real candidate block
# (phase 21 (a) sums them up)
WAVE_PROBES = {}


def _wave_breakdown(tag, comp, archive, backends):
    """Host-clock milliseconds (synchronised) of each stage of one hash
    wave at the full-width shape, from a frontier of archived states (for
    a sparse encoding, the expand's bookkeeping ops and kernel launch
    too, marked ·), beside the eager config_hash's figures, and the
    profiler's split of the level's stages by kernel; then, once a wave,
    H1 and H2 at its candidate block (:func:`_probe_wave`)."""
    import torch
    from repro_torch.core import (CompiledSparseSNP, applicability,
                                  get_backend, is_delayed, packed_rule_table,
                                  sparse_branch_info, table_slots)
    from repro_torch.core.hashing import SENTINEL, config_hash
    from repro_torch.core.hashtable import (_hash_lookup, first_occurrence,
                                            insert_unique, insert_unique_,
                                            lookup, make_table)
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.snp_step import ops, sparse_ops
    from repro_torch.kernels.snp_step.sparse_ref import kernel_inputs

    dev = comp.device
    F, T = FULL_WIDTH["frontier_cap"], FULL_WIDTH["max_branches"]
    frontier = torch.from_numpy(archive[-F:]).to(dev)
    table = make_table(FULL_WIDTH["visited_cap"], dev)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, r

    stages = {}
    kern, plain = backends
    stages[f"expand ({kern} kernel + bookkeeping)"], out = timed(
        lambda: get_backend(kern).expand(frontier, comp, T))
    stages[f"expand ({plain} plain)"], _ = timed(
        lambda: get_backend(plain).expand(frontier, comp, T))
    if isinstance(comp, CompiledSparseSNP) and not is_delayed(comp):
        # the sparse expand split: its bookkeeping ops and the launch
        stages["· applicability"], _ = timed(
            lambda: applicability(frontier, comp))
        stages["· sparse_branch_info (with applicability)"], info = timed(
            lambda: sparse_branch_info(frontier, comp))
        stages["· packed_rule_table"], _ = timed(
            lambda: packed_rule_table(info, comp))
    if isinstance(comp, CompiledSparseSNP):
        stages["· kernel_inputs (all bookkeeping)"], (args, extra, _) = \
            timed(lambda: kernel_inputs(frontier, comp, lists=True))
        stages["· kernel launch"], _ = timed(
            lambda: sparse_ops.snp_step_sparse_cuda(*args, **extra,
                                                    max_branches=T))
    elif is_delayed(comp):
        stages["· delay_inputs (all bookkeeping)"], (args, _) = timed(
            lambda: ops.delay_inputs(frontier, comp, lists=True))
        stages["· kernel launch"], _ = timed(
            lambda: ops.snp_step_dense_delay(*args, T))
    cand = out.configs.reshape(F * T, -1)
    valid = out.valid.reshape(-1)
    K = F * T
    stages["config_hash (H1 hash body)"], (hi, lo) = timed(
        lambda: config_hash(cand))
    hi = torch.where(valid, hi, SENTINEL)
    lo = torch.where(valid, lo, SENTINEL)
    stages["table lookup (H1 keys body)"], _ = timed(
        lambda: lookup(table, hi, lo, valid))
    stages["hash + lookup (H1 rows body, the level's)"], _ = timed(
        lambda: _hash_lookup(table, cand, valid))
    route = ht_ops.claim_route(K, table_slots(K), PROBE_D, True).name
    stages[f"first_occurrence (H2 {route})"], (first, _) = timed(
        lambda: first_occurrence(hi, lo, valid))
    stages["compaction sort"], sel = timed(
        lambda: torch.sort((~first).to(torch.uint8),
                           stable=True).indices[:F])
    stages["gather cand[sel]"], _ = timed(lambda: cand[sel])
    ins = torch.arange(F, device=dev) < int(first.sum().clamp(max=F))
    ins_route = ht_ops.claim_route(F, table.num_slots, PROBE_D, False).name
    stages[f"table insert (H2 {ins_route})"], _ = timed(lambda: insert_unique(table, hi[sel], lo[sel], ins))
    log(f"[{tag}] one full-width hash wave by stage (ms, host clock, "
        "synchronised): " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages.items()))
    wave = WAVE_OF_TAG[tag]
    was_hash, was_expand = EAGER_HASH_MS[wave]
    now = [stages[k] for k in ("config_hash (H1 hash body)",
                               "table lookup (H1 keys body)",
                               "hash + lookup (H1 rows body, the level's)")]
    log(f"[{tag}] {wave}: the eager config_hash took {was_hash:.3f} ms and "
        f"the expand {was_expand:.3f} ms a level; now config_hash "
        f"{now[0]:.3f} + table lookup {now[1]:.3f}, the level's hash + "
        f"lookup {now[2]:.3f}")

    def level():
        o = get_backend(kern).expand(frontier, comp, T)
        c = o.configs.reshape(K, -1)
        v = o.valid.reshape(-1)
        h, lw, found = _hash_lookup(table, c, v)
        f, _ = first_occurrence(h, lw, v)
        new = v & f & ~found
        s_ = torch.sort((~new).to(torch.uint8), stable=True).indices[:F]
        c[s_]
        insert_unique_(scratch, h[s_], lw[s_], ins)

    scratch = make_table(FULL_WIDTH["visited_cap"], dev)
    _level_split(tag, wave, level)
    del scratch
    _probe_wave(tag, cand, valid)


def _level_split(tag, wave, fn):
    """One hash level's device time by kernel (``torch.profiler`` over one
    call after a warm one): the total and the leading kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us()
    total = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] {wave}: one hash level's device time (profiler, "
        f"expand to insert) {total / 1e3:.3f} ms over {len(by)} kernel "
        f"names; leading: " + "; ".join(f"{n} {us / 1e3:.3f}"
                                        for n, us in top))
    WAVE_PROBES.setdefault(("split", wave), dict(
        device_ms=total / 1e3, leading={n: us / 1e3 for n, us in top}))


def _same_bits(errs, kernel, label, got, want):
    """Every tensor of ``got`` equal to ``want``'s (dtype aside); the
    largest difference goes into ``errs[kernel]``."""
    import torch
    for g, w in zip(got, want):
        w = w.to(g.device, g.dtype)
        if g.numel():
            errs[kernel] = max(errs[kernel], int(
                (g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        check(torch.equal(g, w), f"{kernel} {label}: the kernel differs from "
              "its plain version")


def _probe_wave(tag, cand, valid):
    """At one wave's candidate block (K = F·T rows): H1's rows, hash and
    keys bodies bit for bit against ``config_hash_ref``, the canonical
    lanes and ``lookup_ref`` (a visited table holding every third valid
    row's key; max_probes 64, 1 and 2), and H2 at the wave's first
    occurrence (its route into a fresh table, and the grid route into a
    given empty one) and at the held keys' insert against ``claim_ref``,
    tables included; with each
    body's device time (20 calls in a graph, replayed), CUDA-event time,
    plain time and byte bound.  Once a wave."""
    import torch
    from repro_torch.core import table_slots
    from repro_torch.core.hashing import config_hash_ref
    from repro_torch.core.hashtable import _canonical, _empty, make_table
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.hashtable.ref import claim_ref, lookup_ref

    wave = WAVE_OF_TAG[tag]
    if wave in WAVE_PROBES:
        return
    t0 = time.perf_counter()
    dev = cand.device
    cand = cand.contiguous()
    K, w = cand.shape
    D = PROBE_D
    errs = {"H1": 0, "H2": 0}
    raw = config_hash_ref(cand)
    hi, lo = _canonical(*raw, valid)
    held_mask = valid & (torch.arange(K, device=dev) % 3 == 0)
    held = make_table(FULL_WIDTH["visited_cap"], dev)
    tab = (held.slots_hi, held.slots_lo, held.slot_payload)
    pay = torch.arange(K, dtype=torch.int32, device=dev)
    want = claim_ref(*tab, hi, lo, held_mask, pay, D)
    ins_route = ht_ops.claim_route(K, tab[0].shape[0], D, False).name
    got = ht_ops.claim_(*tab, hi, lo, held_mask, pay, D)
    _same_bits(errs, "H2", f"{wave}: its held keys into the visited table "
               f"({ins_route})", (*tab, *got), want)
    _same_bits(errs, "H1", f"{wave}: the hash body", ht_ops.config_hash(cand),
               raw)
    for d in (D, 1, 2):
        found_ref, _ = lookup_ref(*tab, hi, lo, valid, d)
        _same_bits(errs, "H1", f"{wave}: the rows body, max_probes {d}",
                   ht_ops.hash_lookup(*tab, cand, valid, d),
                   (hi, lo, found_ref))
    found, _ = ht_ops.lookup(*tab, hi, lo, valid, D)
    _same_bits(errs, "H1", f"{wave}: the keys body",
               (found,), lookup_ref(*tab, hi, lo, valid, D)[:1])
    check(bool(found[held_mask].all()), f"H1 {wave}: a held key not found")
    S = table_slots(K)
    route = ht_ops.claim_route(K, S, D, True)
    given = ht_ops.claim_route(K, S, D, False).name
    zero = torch.zeros(K, dtype=torch.int32, device=dev)
    want = claim_ref(*_empty(S, 0, dev), hi, lo, valid, zero, D)
    _same_bits(errs, "H2", f"{wave}: first occurrence ({route.name}, fresh)",
               ht_ops.first_claim(hi, lo, valid, S, D), want[3:])
    k_tab = _empty(S, 0, dev)
    _same_bits(errs, "H2", f"{wave}: first occurrence ({given}, into a "
               "given empty table)",
               (*k_tab, *ht_ops.claim_(*k_tab, hi, lo, valid, zero, D)), want)

    # figures: device ms (graph replay), event ms, plain ms, byte bound
    n_valid = int(valid.sum())
    reads = _probe_reads(tab[0], tab[1], hi, lo, valid, D, False)[0]
    first_reads = _probe_reads(*_empty(S, 0, dev)[:2], hi, lo, valid, D,
                               True)[0]

    def plain_rows():
        h, lw = _canonical(*config_hash_ref(cand), valid)
        return h, lw, lookup_ref(*tab, h, lw, valid, D)[0]

    def fig(fn, plain, nbytes, **extra):
        return dict(ms=time_ms(fn, 20), device_ms=_replay_ms(fn),
                    plain_ms=time_ms(plain, 2),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, bytes=nbytes, **extra)

    rec = dict(K=K, w=w, valid_rows=n_valid, errs=errs)
    rec["rows"] = fig(
        lambda: ht_ops.hash_lookup(*tab, cand, valid, D), plain_rows,
        n_valid * w * 4 + K * (1 + 16 + 1) + reads * 16,
        slot_reads=reads, threads_a_row=ht_ops.row_threads(K))
    rec["hash"] = fig(lambda: ht_ops.config_hash(cand),
                      lambda: config_hash_ref(cand), K * w * 4 + K * 16,
                      threads_a_row=ht_ops.row_threads(K))
    rec["keys"] = fig(lambda: ht_ops.lookup(*tab, hi, lo, valid, D),
                      lambda: lookup_ref(*tab, hi, lo, valid, D),
                      K * (16 + 1) + reads * 16 + K * 5, slot_reads=reads)
    # the first occurrence needs the keys and mask in, won and dup out:
    # its table is the kernel's own (the cluster's shared memory)
    rec["first"] = fig(
        lambda: ht_ops.first_claim(hi, lo, valid, S, D),
        lambda: claim_ref(*_empty(S, 0, dev), hi, lo, valid, zero, D),
        K * (16 + 1) + K * 2, claim_route=route.name, ctas=route.ctas,
        slots=S,
        slot_reads=first_reads,
        bound_ms_table_in_memory=(K * (16 + 1) + K * 2 + first_reads * 16)
        / HBM_BYTES_PER_S * 1e3)
    WAVE_PROBES[wave] = rec
    for body in ("rows", "hash", "keys", "first"):
        r = rec[body]
        log(f"[{tag}] {wave} (K={K}, w={w}, {n_valid} valid): "
            f"{'H2 ' + route.name if body == 'first' else 'H1 ' + body} "
            f"{r['device_ms']:.4f} ms on the card (20 calls in a graph, "
            f"replayed), {r['ms']:.4f} ms by events, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bytes']} bytes; {r['device_ms'] / r['bound_ms']:.1f}x)")
    log(f"[{tag}] {wave}: H1's three bodies and H2's {ins_route} and "
        f"{route.name} routes bit-identical to their plain versions "
        f"(max_abs_err {json.dumps(errs)}), checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")


def _traces(tag, label, system, policy, backends, kernel, plan=None,
            last_row=True):
    """``run_traces`` through a kernel backend and its plain twin, with
    the kernel path's launch counts; the two must be identical.  Random
    traces must differ across seeds: in their last rows, or anywhere
    (``last_row=False``, for systems that may halt in one state)."""
    import torch
    from repro_torch.core import run_traces

    steps, outs, launches = 64, {}, 0
    for backend in backends:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs[backend] = run_traces(system, steps=steps, seeds=range(256),
                                   policy=policy, backend=backend, plan=plan)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        log(f"[{tag}] run_traces({label}, {steps} steps, 256 seeds, "
            f"policy={policy!r}) via {backend!r}: {secs:.3f} s = "
            f"{steps / secs:.2f} steps/s, launches {json.dumps(counts)}")
        if backend == backends[0]:
            check_counts(f"traces {label} {policy}", counts,
                         **{kernel: steps})
            launches = counts[kernel]
        else:
            check_counts(f"traces {label} {policy} plain", counts)
    a, b = (outs[x] for x in backends)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{policy} traces of {label} differ between {backends}")
    if policy == "random":
        rows = [r[-1] if last_row else r for r in a.configs[:16]]
        check(len({tuple(r.reshape(-1).tolist()) for r in rows}) > 1,
              f"random traces of {label} do not differ across seeds")
    log(f"[{tag}] {policy} traces of {label} identical through "
        f"{backends[0]!r} and {backends[1]!r}")
    return launches


def phase_traces():
    from repro_torch.core import SystemPlan
    from repro_torch.core.generators import power_law, scaled_pi

    pi = scaled_pi(682)
    first = _traces("8", "scaled_pi(682)", pi, "first", ("cuda", "ref"),
                    "B1")
    rand_dense = _traces("8", "scaled_pi(682)", pi, "random",
                         ("cuda", "ref"), "B1")
    hubby = power_law(8192, 4, seed=2)
    rand_hybrid = _traces("8", "power_law(8192)", hubby, "random",
                          ("sparse_cuda", "sparse"), "B3",
                          SystemPlan.for_system(hubby))
    return first, rand_dense, rand_hybrid


# ---------------------------------------------------------------------------
# The delayed tier: B4 and B5 (phases 9–12)
# ---------------------------------------------------------------------------

TOP = (1 << 16) - 1        # the largest produce the sparse encoding takes


def _reopen_system():
    """Three rules at the produce bound 2^16 − 1 (n0 delayed), no output
    neuron: a reopening n0 sends 2^16 − 1 pending spikes next to n1's
    fired 2^16 − 1."""
    from repro_torch.core import Rule, SNPSystem
    return SNPSystem(
        num_neurons=4, initial_spikes=(1, 1, 0, 0),
        rules=(Rule(neuron=0, consume=1, produce=TOP, regex_base=1,
                    delay=2),
               Rule(neuron=1, consume=1, produce=TOP, regex_base=1),
               Rule(neuron=2, consume=1, produce=1, regex_base=1,
                    regex_period=1, delay=3)),
        synapses=((0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
        output_neuron=-1, name="reopen-top")


def _dense_delay_bound(args, T, read=None):
    """Least time for one B4 call (ms), what binds, and the operations
    counted, from this call's inputs (the plain version's ``args``).
    Bytes: each input the kernel reads (``read``; by default the plain
    version's inputs) read once and each output (3m-wide rows) written
    once, over HBM bandwidth.
    Operations: what these inputs need, over the f32/int32 datapath peak:
    a digit decode per neuron and branch, a compare per applicable rule
    and branch, the combine (three outputs) per neuron and branch, and
    one add per out-synapse of every neuron whose emit-now value is
    nonzero (counted from the decoded fired rules and the reopening
    neurons' pending spikes)."""
    import torch
    from repro_torch.core.semantics import decode_spiking
    (spikes, cd, pd, rank, app, stride, choices, psi, rule_bounds, consume,
     produce, delay, adj_in, out_neuron) = args
    B, m = spikes.shape
    n = rank.shape[-1]
    in_bytes = sum(x.numel() * x.element_size()
                   for x in (args if read is None else read))
    out_bytes = 4 * B * T * 3 * m + 5 * B * T
    rule_neuron = torch.repeat_interleave(
        torch.arange(m, device=spikes.device, dtype=torch.int32),
        (rule_bounds[1:] - rule_bounds[:-1]).to(torch.int64), output_size=n)
    S = decode_spiking(app, rank, stride, choices, rule_neuron, T)
    sends = ((delay == 0) & (produce != 0)).to(torch.int32)
    emits = torch.zeros((B, T, m), dtype=torch.int32, device=spikes.device)
    emits.index_add_(-1, rule_neuron, S * sends)
    del S
    emits = (emits != 0) | ((cd == 1) & (pd != 0))[:, None, :]
    out_deg = torch.bincount(adj_in[adj_in < m].to(torch.int64),
                             minlength=m)
    adds = int((emits.sum(dim=(0, 1), dtype=torch.int64) * out_deg).sum())
    n_ops = 3 * B * T * m + T * int(app.sum()) + 3 * B * T * m + adds
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (n_ops,)


def _delay_cases(rng, dev):
    """(name, system, hub threshold, B, T, state rows, time it?) — the
    phase-9 shapes, smallest first."""
    import numpy as np
    import torch
    from repro_torch.core import paper_pi, with_delays
    from repro_torch.core.generators import (nd_chain, power_law,
                                             random_system, scaled_pi)

    def states(m, B, lo=0, hi=4):
        return torch.from_numpy(np.concatenate(
            [rng.integers(lo, hi, (B, m)), rng.integers(0, 4, (B, m)),
             rng.integers(0, 3, (B, m))], 1).astype(np.int32)).to(dev)

    k3, k4 = (lambda k, r: k % 3), (lambda k, r: k % 4)
    reopen = torch.tensor([
        [0, 1, 0, 0, 1, 0, 0, 0, TOP, 0, 0, 0],   # n0 reopens, n1 fires
        [1, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],     # every neuron open
        [0, 0, 3, 5, 1, 0, 1, 0, TOP, 0, 7, 0],   # n0 and n2 reopen
        [0, 1, 1, 0, 2, 0, 3, 0, TOP, 0, 1, 0],   # n0, n2 stay closed
    ], dtype=torch.int32, device=dev)
    return [
        ("paper_pi d=k%4", with_delays(paper_pi(True), k4), None, 128, 16,
         lambda m: states(m, 128, 0, 5)),
        ("nd_chain(10) d=1", with_delays(nd_chain(10), 1), None, 16, 64,
         lambda m: torch.cat([torch.ones((16, m), dtype=torch.int32),
                              torch.zeros((16, 2 * m), dtype=torch.int32)],
                             1).to(dev)),
        ("ragged B13 T37 d=k%4",
         with_delays(random_system(45, 3, 0.1, seed=5), k4), None, 13, 37,
         lambda m: states(m, 13)),
        ("random(64) h=1 d=k%3",
         with_delays(random_system(64, 2, 0.15, seed=3), k3), 1, 24, 40,
         lambda m: states(m, 24)),
        ("ragged m=45 h=2 B13 T37 d=k%4",
         with_delays(random_system(45, 3, 0.1, seed=5), k4), 2, 13, 37,
         lambda m: states(m, 13)),
        ("empty slice m=100 h=4 d=k%3",
         with_delays(_empty_slice_system(), k3), 4, 24, 40,
         lambda m: states(m, 24)),
        ("empty slice m=100 d=k%3",
         with_delays(_empty_slice_system(), k3), None, 24, 40,
         lambda m: states(m, 24)),
        ("reopen 2^16-1, no output", _reopen_system(), None, 4, 8,
         lambda m: reopen),
        ("reopen 2^16-1 h=1", _reopen_system(), 1, 4, 8, lambda m: reopen),
        ("spikes~2^20 d=k%3",
         with_delays(random_system(64, 2, 0.1, seed=2), k3), None, 32, 32,
         lambda m: states(m, 32, 2 ** 20 - 8, 2 ** 20 + 8)),
        ("power_law(32768,max_in=64) h=16 d=k%3",
         with_delays(power_law(32768, 4, seed=2, max_in=64), k3), 16, 64,
         64, lambda m: states(m, 64)),
        ("scaled_pi(682) delayed wave", with_delays(scaled_pi(682), k3),
         None, 512, 64, lambda m: states(m, 512, 0, 3)),
        ("power_law(8192) delayed hybrid wave",
         with_delays(power_law(8192, 4, seed=2), k3), "auto", 512, 64,
         lambda m: states(m, 512)),
    ]


def _max_err(k, p):
    return max(int((k[0] - p[0]).abs().max()), int((k[2] - p[2]).abs().max()))


def _forged_b4(rng, dev):
    """B4 on forged sliced lists of ``adj_in`` equals its plain version
    without the forged entries: every 5th list entry moved above m or
    below 0 (the kernel reads them as the zero slot; the plain version's
    ``adj_in`` holds ``m``, the zero slot, in their place), the first
    slice start below 0 and the last past the lists' end (clamped), on a
    delayed ``power_law(1000)`` (m not a multiple of 32).  Returns max
    |err|."""
    import numpy as np
    import torch
    from repro_torch.core import compile_system, with_delays
    from repro_torch.core.generators import power_law
    from repro_torch.kernels.snp_step import ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_delay_ref

    system = with_delays(power_law(1000, 4, seed=9), lambda k, r: k % 3)
    comp = compile_system(system, semantics="delays", device=dev)
    m, B, T = comp.num_neurons, 24, 40
    configs = torch.from_numpy(np.concatenate(
        [rng.integers(0, 4, (B, m)), rng.integers(0, 4, (B, m)),
         rng.integers(0, 3, (B, m))], 1).astype(np.int32)).to(dev)
    start, src, adj_in, n_bad = _forge_sliced(
        comp.sell_start.cpu().numpy(), comp.sell_src.cpu().numpy(),
        comp.adj_in.cpu().numpy(), m, rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    kargs, _ = ops.delay_inputs(
        configs, comp._replace(sell_start=t(start), sell_src=t(src)),
        lists=True)
    pargs, _ = ops.delay_inputs(configs, comp._replace(adj_in=t(adj_in)))
    k = ops.snp_step_dense_delay(*kargs, T)
    p = snp_step_dense_delay_ref(*pargs, T)
    torch.cuda.synchronize()
    err = _max_err(k, p)
    check(err == 0 and bool(torch.equal(k[1], p[1])),
          f"forged sliced lists: B4 disagrees with its plain version "
          f"without the forged entries (max |err| {err})")
    log(f"[9] forged lists (power_law(1000) d=k%3) B4 B={B} T={T} m={m} | "
        f"{n_bad} list entries out of range, starts below 0 and past the "
        f"end: B4 == plain without them (max |err| {err})")
    return err


def phase_delay_kernels():
    """B4 and B5 (ELL and COO bodies) == their plain versions on the card,
    on every entry, at the phase-9 shapes; the wrappers against the
    delayed semantics.  Returns (max |err| per kernel, timing rows keyed
    by kernel and case)."""
    import numpy as np
    import torch
    from repro_torch.core import (SystemPlan, compile_system,
                                  compile_system_sparse,
                                  delayed_next_configs,
                                  delayed_weight_matrix,
                                  sparse_delayed_next_configs)
    from repro_torch.kernels.snp_step import ops, sparse_ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_delay_ref
    from repro_torch.kernels.snp_step.sparse_ref import (kernel_inputs,
                                                         snp_step_sparse_ref)

    dev = torch.device("cuda")
    max_err = {"B4": 0, "B5-ELL": 0, "B5-COO": 0}
    rows = {}
    for name, system, h, B, T, make in _delay_cases(
            np.random.default_rng(3), dev):
        wave = "wave" in name
        iters = 5 if wave or B * T * system.num_neurons > 1e7 else 50
        m = system.num_neurons
        configs = make(m)
        hybrid_wave = wave and h == "auto"
        if h == "auto":
            h = SystemPlan.for_system(system,
                                      semantics="delays").hub_threshold
        # B4 (dense) on the same state rows
        if h is None or hybrid_wave:
            comp = compile_system(system, semantics="delays", device=dev)
            n = comp.num_rules
            args, info = ops.delay_inputs(configs, comp)
            kargs, _ = ops.delay_inputs(configs, comp, lists=True)
            if name.startswith("empty slice"):
                st = comp.sell_start
                check(m % 32 != 0 and bool((st[1:] == st[:-1]).any()),
                      f"{name}: expected a slice of width 0 in B4's lists")
            k = ops.snp_step_dense_delay(*kargs, T)
            p = snp_step_dense_delay_ref(*args, T)
            torch.cuda.synchronize()
            err = _max_err(k, p)
            max_err["B4"] = max(max_err["B4"], err)
            check(err == 0 and bool(torch.equal(k[1], p[1])),
                  f"{name}: B4 disagrees with its plain version "
                  f"(max |err| {err})")
            del k, p
            bt4, nt4 = ops.delay_block_shape(m, T)
            shape4 = f"block {bt4} rows x {nt4} threads"
            if not hybrid_wave:   # the (n, 4m) W product would be huge
                w = ops.snp_step(configs, comp, max_branches=T)
                ref = delayed_next_configs(configs, comp, T)
                check(torch.equal(w[1], ref.valid)
                      and torch.equal(w[3], ref.overflow)
                      and torch.equal(torch.where(w[1][..., None], w[0], 0),
                                      torch.where(ref.valid[..., None],
                                                  ref.configs, 0))
                      and torch.equal(torch.where(w[1], w[2], 0),
                                      torch.where(ref.valid,
                                                  ref.emissions, 0)),
                      f"{name}: B4 wrapper disagrees with "
                      "delayed_next_configs")
                if name.startswith("nd_chain"):
                    check(bool(w[3].all()), f"{name} should overflow T")
                k_ms = time_ms(lambda: ops.snp_step_dense_delay(*kargs, T),
                               iters)
                p_ms = time_ms(lambda: snp_step_dense_delay_ref(*args, T),
                               iters)
                S = ref.spiking.reshape(B * T, n).to(torch.float32)
                W = delayed_weight_matrix(comp)
                l_ms = time_ms(lambda: torch.matmul(S, W), iters)
                del S, W, ref, w
                b_ms, b_by, b_ops = _dense_delay_bound(args, T, kargs)
                rows[("B4", name)] = dict(
                    B=B, T=T, n=n, m=m, ms=k_ms, plain_ms=p_ms,
                    library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                    block=[bt4, nt4])
                if wave:
                    rows[("B4", name)]["device_ms"] = d_ms = device_ms(
                        lambda: ops.snp_step_dense_delay(*kargs, T), 20,
                        "snp_step_dense_delay_sell_kernel")
                    log(f"[9] {name}: B4's device time by the profiler "
                        f"{d_ms} ms (CUDA events {k_ms:.4f}), {shape4}")
                log(f"[9] {name:36s} B4     B={B:4d} T={T:3d} n={n:5d} "
                    f"m={m:5d} {shape4} | kernel == plain (max |err| "
                    f"{err}) | kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"matmul(S,W) {l_ms:.4f} ms, bound {b_ms:.6f} ms "
                    f"({b_by}; {b_ops} ops) = {k_ms / b_ms:.1f}x bound")
            else:
                # past m = 7,263 a block stages fewer than 8 rows
                check(m <= 7263 or bt4 < 8,
                      f"{name}: B4 staged 8 rows of m={m} a block")
                log(f"[9] {name:36s} B4     B={B:4d} T={T:3d} n={n:5d} "
                    f"m={m:5d} {shape4} | kernel == plain (max |err| "
                    f"{err})")
            del comp, args, kargs, info
            torch.cuda.empty_cache()
        # B5 (sparse, ELL or COO body)
        comp = compile_system_sparse(system, hub_threshold=h,
                                     semantics="delays", device=dev)
        kernel = "B5-COO" if comp.is_hybrid else "B5-ELL"
        check((h is not None) == comp.is_hybrid,
              f"{name}: expected {'a hybrid' if h else 'an ELL'} encoding")
        n = comp.num_rules
        args, extra, info = kernel_inputs(configs, comp)
        kargs, kextra, _ = kernel_inputs(configs, comp, lists=True)
        if name.startswith("empty slice"):
            st = comp.sell_start
            check(m % 32 != 0 and bool((st[1:] == st[:-1]).any()),
                  f"{name}: expected a slice of width 0")
        k = sparse_ops.snp_step_sparse_cuda(*kargs, **kextra, max_branches=T)
        p = snp_step_sparse_ref(*args, **extra, max_branches=T)
        torch.cuda.synchronize()
        err = _max_err(k, p)
        max_err[kernel] = max(max_err[kernel], err)
        check(err == 0 and bool(torch.equal(k[1], p[1])),
              f"{name}: {kernel} disagrees with its plain version "
              f"(max |err| {err})")
        if name.startswith("reopen"):
            # n0's pending 2^16 − 1 and n1's fired 2^16 − 1 meet at n3
            check(int(k[0][0, 0, 3]) == 2 * TOP,
                  f"{name}: the uint16 stage lost the reopening spikes")
        del k, p
        w = sparse_ops.snp_step_sparse(configs, comp, max_branches=T)
        ref = sparse_delayed_next_configs(configs, comp, T)
        check(all(torch.equal(a, b) for a, b in zip(
            w, (ref.configs, ref.valid, ref.emissions, ref.overflow))),
            f"{name}: {kernel} wrapper disagrees with "
            "sparse_delayed_next_configs")
        del w, ref
        k_ms = time_ms(lambda: sparse_ops.snp_step_sparse_cuda(
            *kargs, **kextra, max_branches=T), iters)
        p_ms = time_ms(lambda: snp_step_sparse_ref(
            *args, **extra, max_branches=T), iters)
        l_ms = _sparse_library_ms(system, comp, configs, info, T, iters,
                                  semantics="delays")
        b_ms, b_by, b_ops = _sparse_bound(args, extra, T,
                                          _kernel_read(kargs, kextra))
        rows[(kernel, name)] = dict(
            B=B, T=T, n=n, m=m, Kin=comp.max_in_degree,
            Ec=int(comp.coo_src.shape[0]), ms=k_ms, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
        if wave:
            rows[(kernel, name)]["device_ms"] = d_ms = device_ms(
                lambda: sparse_ops.snp_step_sparse_cuda(
                    *kargs, **kextra, max_branches=T), 20,
                "snp_step_sparse_sell_kernel")
            log(f"[9] {name}: {kernel}'s device time by the profiler "
                f"{d_ms} ms (CUDA events {k_ms:.4f})")
        lib = "—" if l_ms is None else f"{l_ms:.4f} ms"
        bt, nt = sparse_ops.sell_block_shape(m, 0, T)
        rows_b = (f" sliced entries={comp.sell_src.shape[0]} block "
                  f"{bt} rows x {nt} threads")
        log(f"[9] {name:36s} {kernel} B={B:4d} T={T:3d} n={n:5d} m={m:5d} "
            f"Kin={comp.max_in_degree:3d} Ec={rows[(kernel, name)]['Ec']:6d}"
            f"{rows_b} | kernel == plain (max |err| {err}) | kernel "
            f"{k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, sparse.mm(S,M) {lib}, bound "
            f"{b_ms:.6f} ms ({b_by}; {b_ops} ops) = {k_ms / b_ms:.1f}x "
            f"bound")
        del comp, args, extra, kargs, kextra, info
        torch.cuda.empty_cache()
    for hybrid in (False, True):
        kernel, err = _forged_lists(np.random.default_rng(4), dev, True,
                                    hybrid)
        max_err[kernel] = max(max_err[kernel], err)
    max_err["B4"] = max(max_err["B4"],
                        _forged_b4(np.random.default_rng(5), dev))
    return max_err, rows


# The delayed hybrid explore keeps a 65,536-row archive: 8 waves fill at
# most 1 + 8·512 rows, and 262,144 rows of 3m = 24,576 columns would
# allocate 25.8 GB.
DELAY_HYBRID = dict(FULL_WIDTH, visited_cap=65536)


def phase_delay_full_width():
    """Phase 10 (delayed scaled_pi(682) through B4, ref and B5-ELL) and
    phase 11 (delayed power_law(8192), hybrid, through B5-COO and the
    plain sparse backend).  Returns the launches of each main path."""
    import torch
    from repro_torch.core import (SystemPlan, compile_system,
                                  compile_system_sparse, with_delays)
    from repro_torch.core.generators import power_law, scaled_pi

    k3 = (lambda k, r: k % 3)
    system = with_delays(scaled_pi(682), k3)
    plan = SystemPlan(semantics="delays")
    label = "explore(scaled_pi(682) d=k%3)"
    a, b4, _ = _timed_explore("10", label, system, "cuda", "B4", plan)
    b, _, _ = _timed_explore("10", label, system, "ref", None, plan)
    check(_same_explore(a, b), "delayed full-width archives or flags differ "
          "between 'cuda' and 'ref'")
    c, b5_ell, _ = _timed_explore("10", label, system, "sparse_cuda",
                                  "B5-ELL", plan)
    check(_same_explore(a, c), "delayed full-width archive or flags differ "
          "between 'sparse_cuda' and 'cuda'/'ref'")
    m = system.num_neurons
    check(a.configs.shape[1] == 3 * m and bool((a.configs[:, m:] != 0).any()),
          "delayed archive rows should be 3m wide with live countdowns")
    ARCHIVES["scaled_pi(682) d=k%3"] = _digest(a)
    log(f"[10] archives identical through 'cuda', 'ref' and 'sparse_cuda' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} columns)")
    _wave_breakdown("10", compile_system(system, semantics="delays",
                                         device="cuda"),
                    a.configs, ("cuda", "ref"))
    _wave_breakdown("10", compile_system_sparse(system, semantics="delays",
                                                device="cuda"),
                    a.configs, ("sparse_cuda", "sparse"))
    del a, b, c
    torch.cuda.empty_cache()

    system = with_delays(power_law(8192, 4, seed=2), k3)
    plan = SystemPlan.for_system(system, semantics="delays")
    check(plan.encoding == "hybrid" and plan.semantics == "delays",
          f"delayed power_law(8192) planned {plan}")
    label = "explore(power_law(8192) d=k%3)"
    a, b5_coo, peak = _timed_explore("11", label, system, "sparse_cuda",
                                     "B5-COO", plan, DELAY_HYBRID)
    b, _, peak_plain = _timed_explore("11", label, system, "sparse", None,
                                      plan, DELAY_HYBRID)
    check(_same_explore(a, b), "delayed hybrid archives or flags differ "
          "between 'sparse_cuda' and 'sparse'")
    check(not a.visited_overflow, "the delayed hybrid archive overflowed")
    ARCHIVES["power_law(8192) d=k%3"] = _digest(a)
    log(f"[11] archives identical through 'sparse_cuda' and 'sparse' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} columns); peak "
        f"allocation {peak / 2**30:.3f} / {peak_plain / 2**30:.3f} GiB")
    comp = compile_system_sparse(system, hub_threshold=plan.hub_threshold,
                                 semantics="delays", device="cuda")
    _wave_breakdown("11", comp, a.configs, ("sparse_cuda", "sparse"))
    return b4, b5_ell, b5_coo


def phase_delay_paper_and_traces():
    """Phase 12: the four delayed variants of Π through all four backends
    (identical archives, launches per kernel path), then traces of both
    delayed workloads.  Returns {kernel: {path: launches}}."""
    import numpy as np
    from repro_torch.core import SystemPlan, explore, paper_pi, with_delays
    from repro_torch.core.generators import power_law, scaled_pi

    launches = {"B4": {}, "B5-ELL": {}, "B5-COO": {}}
    variants = {"d=0": 0, "d=1": 1, "d=k%3": (lambda k, r: k % 3),
                "d=(2,0,1,0,3)": (2, 0, 1, 0, 3)}
    plan = SystemPlan(semantics="delays")
    for tag, d in variants.items():
        system = with_delays(paper_pi(), d)
        res = {}
        for backend, kernel in (("ref", None), ("cuda", "B4"),
                                ("sparse", None),
                                ("sparse_cuda", "B5-ELL")):
            reset_counts()
            res[backend] = explore(system, max_steps=8, plan=plan,
                                   backend=backend)
            counts = read_counts()
            check_counts(f"Π {tag} via {backend!r}", counts,
                         **({kernel: res[backend].steps} if kernel else {}))
            if kernel:
                launches[kernel][f"paper_pi_{tag}"] = counts[kernel]
        check(all(np.array_equal(r.configs, res["ref"].configs)
                  and r.exhausted == res["ref"].exhausted
                  for r in res.values()),
              f"delayed Π {tag}: archives differ across the backends")
        log(f"[12] Π {tag}: {res['ref'].num_discovered} states in "
            f"{res['ref'].steps} levels, identical through 'ref', 'cuda', "
            f"'sparse', 'sparse_cuda'")
    k3 = (lambda k, r: k % 3)
    pi = with_delays(scaled_pi(682), k3)
    for policy in ("first", "random"):
        launches["B4"][f"traces_{policy}"] = _traces(
            "12", "scaled_pi(682) d=k%3", pi, policy, ("cuda", "ref"), "B4",
            plan, last_row=False)
    hubby = with_delays(power_law(8192, 4, seed=2), k3)
    hplan = SystemPlan.for_system(hubby, semantics="delays")
    for policy in ("first", "random"):
        launches["B5-COO"][f"traces_{policy}"] = _traces(
            "12", "power_law(8192) d=k%3", hubby, policy,
            ("sparse_cuda", "sparse"), "B5-COO", hplan, last_row=False)
    return launches


# ---------------------------------------------------------------------------
# The neuron-sharded frontier: B6 and B7 (phases 13–15)
# ---------------------------------------------------------------------------

SHARDED = dict(max_steps=8, frontier_cap=512, max_branches=64,
               visited_cap=65536)          # per shard: S·V = phase 5's rows
# Phase 15: ring_lattice(32768, 8) over 4 shards, 16,384 archive rows a
# shard (the 65,536 rows of its single-device comparison).
RING = dict(SHARDED, visited_cap=16384)


def _shard_level(system, plan, B, T, configs_fn, dev, dense=True):
    """The per-shard operands of one level at frontier rows made by
    ``configs_fn(m)`` (B, m): ``(comp, shards, frontier slices, level)``,
    through the sharded explore's own bookkeeping and halo exchange."""
    import torch
    from repro_torch.core import compile_sharded, lower_shard_dense
    from repro_torch.core import distributed as dist

    comp = compile_sharded(system, plan, device=dev)
    if dense:
        comp = lower_shard_dense(comp)
    S, mloc, m = comp.num_shards, comp.shard_size, comp.num_neurons
    full = torch.zeros((B, S * mloc), dtype=torch.int32, device=dev)
    full[:, :m] = configs_fn(m)
    cols = full[:, comp.arrays.global_idx.reshape(-1).to(torch.int64)]
    frontier = list(cols.reshape(B, S, mloc).unbind(1))
    frontier = [f.contiguous() for f in frontier]
    shards = dist._shards(comp, [torch.device(dev)] * S, dense)
    return comp, shards, frontier, dist._exchange(shards, frontier, T, True)


def _b6_args(sh, f, info, stride, psi, halo):
    from repro_torch.core.semantics import clamp_stride
    return (f, info.rank, info.app, clamp_stride(stride).contiguous(),
            info.choices, psi.contiguous(), sh.view.rule_neuron, sh.M_local,
            sh.hadj, halo)


def _b6_hand_cases(rng, dev, T=33):
    """Hand-made B6 operands on one shard of ``power_law(26)`` over 4
    degree shards (B=24, T=33): ``(name, args, cols)`` with the halo slab
    not 16-byte aligned (the tensor starts 4 bytes past an aligned
    address, so every block stages it by plain loads), and with 30,001
    random halo slots (a slab past the stage: read in place) over a
    hand-made ``hadj`` of 2,000 nonzeros, and the first case's operands on
    forged lists (entries naming rules and halo slots out of range, starts
    below 0 and past the lists' end) against the plain version on the
    matrices without the forged entries."""
    import numpy as np
    import torch
    from repro_torch.core.generators import power_law
    from repro_torch.core.matrix import shard_column_lists
    from repro_torch.sharding import neuron_axis

    B = 24
    make = lambda m: torch.from_numpy(                       # noqa: E731
        rng.integers(0, 4, size=(B, m)).astype(np.int32)).to(dev)
    comp, shards, frontier, lv = _shard_level(
        power_law(26, 3, seed=6), neuron_axis(4, partition="degree"), B, T,
        make, dev)
    sh, info, f = shards[1], lv.infos[1], frontier[1]
    halo = lv.halos[1]
    buf = torch.empty(halo.numel() + 1, dtype=torch.int32, device=dev)
    shifted = buf[1:].view(halo.shape)
    shifted.copy_(halo)
    check(shifted.data_ptr() % 16 != 0, "the shifted halo is aligned")
    out = [("halo slab unaligned (hand-made)",
            _b6_args(sh, f, info, lv.strides[1], lv.psi, shifted), sh.cols)]
    H, mloc = 30001, f.shape[1]
    hadj = np.zeros((H, mloc), np.int8)
    hadj[rng.integers(0, H, 2000), rng.integers(0, mloc, 2000)] = 1
    big = torch.from_numpy(rng.integers(
        0, 1 << 16, size=(B, T, H)).astype(np.int32)).to(dev)
    args = _b6_args(sh, f, info, lv.strides[1], lv.psi, big)
    args = args[:8] + (torch.from_numpy(hadj).to(dev), big)
    out.append(("halo past the stage (hand-made)", args,
                shard_column_lists(*args[7:9])))
    a6 = out[0][1]
    start, rule, (r, c) = _forge(sh.cols[0], sh.cols[1], a6[7].shape[0], rng)
    hstart, hslot, (hs, hc) = _forge(sh.cols[3], sh.cols[4],
                                     a6[9].shape[-1], rng)
    M_local, hadj = a6[7].clone(), a6[8].clone()
    M_local[r, c] = 0
    hadj[hs, hc] = 0
    out.append(("forged lists (hand-made)",
                a6[:7] + (M_local, hadj, a6[9]),
                (start, rule, sh.cols[2][:rule.shape[0]], hstart, hslot)))
    return out


def _b7_args(sh, f, info, stride, psi, tab, halo):
    """B7's plain-version arguments (``in_idx``, and the zero slot as the
    emission index) and its halo."""
    import torch
    mloc, H = f.shape[-1], halo.shape[-1]
    zero = torch.full((1,), mloc + H, dtype=torch.int32, device=f.device)
    return (f, stride.contiguous(), info.choices, psi.contiguous(), tab,
            sh.in_idx, zero), halo


def _b7(args, halo, sell, T):
    """One B7 launch on the plain version's ``args``, with the shard's
    sliced lists ``sell = (sell_start, sell_src)`` in place of
    ``in_idx``."""
    from repro_torch.kernels.snp_step import sparse_ops
    return sparse_ops.snp_step_sparse_cuda(
        *args[:5], *sell, args[6], halo=halo, max_branches=T)


def _forged_b7(rng, dev):
    """B7 on forged shard lists equals its plain version without the
    forged entries, on both shards of ``power_law(200)`` over 2 degree
    shards (mloc = 100, not a multiple of 32; B=24, T=40): every 5th list
    entry moved above the zero slot m + H or below 0 (the kernel reads
    them as the zero slot; the plain version's ``in_idx`` holds the zero
    slot in their place), the first slice start below 0 and the last past
    the lists' end (clamped).  Returns max |err|."""
    import numpy as np
    import torch
    from repro_torch.core.generators import power_law
    from repro_torch.kernels.snp_step.sparse_ref import snp_step_sparse_ref
    from repro_torch.sharding import neuron_axis

    B, T = 24, 40
    make = lambda m: torch.from_numpy(                       # noqa: E731
        rng.integers(0, 4, size=(B, m)).astype(np.int32)).to(dev)
    comp, shards, frontier, lv = _shard_level(
        power_law(200, 3, seed=6), neuron_axis(2, partition="degree"), B, T,
        make, dev, dense=False)
    mloc = comp.shard_size
    check(mloc % 32 != 0, "the forged shard case wants mloc % 32 != 0")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    err, n_bad = 0, 0
    for d, sh in enumerate(shards):
        a7, h7 = _b7_args(sh, frontier[d], lv.infos[d], lv.strides[d],
                          lv.psi, lv.tabs[d], lv.halos[d])
        start, src, in_idx, bad = _forge_sliced(
            sh.sell[0].cpu().numpy(), sh.sell[1].cpu().numpy(),
            sh.in_idx.cpu().numpy(), mloc + h7.shape[-1], rng)
        k_out = _b7(a7, h7, (t(start), t(src)), T)
        p_out = snp_step_sparse_ref(*a7[:5], t(in_idx), a7[6], halo=h7,
                                    max_branches=T)
        torch.cuda.synchronize()
        err = max(err, int((k_out[0] - p_out[0]).abs().max()),
                  int((k_out[2] - p_out[2]).abs().max()))
        check(bool(torch.equal(k_out[1], p_out[1])),
              "forged shard lists: B7's validity differs")
        n_bad += bad
    check(err == 0, f"forged shard lists: B7 disagrees with its plain "
          f"version without the forged entries (max |err| {err})")
    log(f"[13] forged lists (power_law(200) degree S=2) mloc={mloc} B={B} "
        f"T={T} | {n_bad} list entries out of range, starts below 0 and "
        f"past the end: B7 == plain without them on both shards (max |err| "
        f"{err})")
    return err


def _halo_adds(halo, in_idx, mloc):
    """Adds the data needs for the halo term: each nonzero halo entry
    times the local neurons it feeds."""
    import torch
    H = halo.shape[-1]
    ext = in_idx[(in_idx >= mloc) & (in_idx < mloc + H)] - mloc
    fan = torch.bincount(ext.to(torch.int64), minlength=H)
    nz = (halo != 0).sum(dim=(0, 1), dtype=torch.int64)
    return int((nz * fan).sum())


def _shard_dense_bound(args, in_idx, T, cols):
    """Least time of one B6 call (ms), what binds, and the bound with
    ``M_local`` and ``hadj`` counted as dense arrays (for comparison),
    from its inputs: bytes (each input once, ``M_local`` and ``hadj``
    as their nonzeros, i.e. the column lists ``cols`` the kernel walks;
    the output once) over HBM bandwidth; operations as for B1 (a decode
    per neuron and branch, the ``C +``, a multiply-add per nonzero of each
    fired rule's row of ``M_local``) plus two per halo entry and local
    neuron it feeds."""
    import torch
    from repro_torch.core.semantics import decode_spiking
    (configs, rank, app, stride, choices, psi, rule_neuron, M, hadj,
     halo) = args
    B, m = configs.shape
    start, rule, val, hstart, hslot = cols
    lists = _list_bytes(start, hstart) + 4 * (2 * int(start[-1])
                                              + int(hstart[-1]))
    in_bytes = _list_bytes(*args) - _list_bytes(M, hadj) + lists
    out_bytes = 4 * B * T * m
    S = decode_spiking(app, rank, stride, choices, rule_neuron, T)
    fired = S.sum(dim=(0, 1), dtype=torch.int64)
    row_nnz = (M != 0).sum(dim=1)
    n_ops = 3 * B * T * m + 2 * int((fired * row_nnz).sum()) \
        + 2 * _halo_adds(halo, in_idx, m)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    t_dense = (in_bytes - lists + _list_bytes(M, hadj) + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (max(t_dense, t_ops),)


def _shard_sparse_bound(args, halo, T, sell):
    """Least time of one B7 call (ms) and what binds: ``_sparse_bound``'s
    operations for the local slice plus one add per halo entry and local
    neuron it feeds; bytes with the halo read once and the shard's sliced
    lists ``sell`` (up to their end) in place of ``in_idx``."""
    B, m = args[0].shape
    n_ops = _sparse_bound(args, {}, T)[2] + _halo_adds(halo, args[5], m)
    start = sell[0]
    in_bytes = sum(x.numel() * x.element_size() for x in args) \
        - _list_bytes(args[5]) + _list_bytes(start) + 4 * int(start[-1]) \
        + halo.numel() * 4
    t_bytes = (in_bytes + 4 * B * T * m + 5 * B * T) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _shard_cases(rng, dev):
    """(name, system, plan, B, T, configs, kernels, random halo?) — the
    phase-13 shapes, smallest first."""
    import numpy as np
    import torch
    from repro_torch.core import paper_pi
    from repro_torch.core.generators import (nd_chain, power_law,
                                             random_system, ring_lattice,
                                             scaled_pi)
    from repro_torch.sharding import neuron_axis

    def rand(B, lo, hi):
        return lambda m: torch.from_numpy(
            rng.integers(lo, hi, size=(B, m)).astype(np.int32)).to(dev)

    both = ("B6", "B7")
    return [
        ("paper_pi S=1", paper_pi(True), neuron_axis(1), 128, 16,
         rand(128, 0, 5), both, False),
        ("paper_pi S=8 (m<S)", paper_pi(True), neuron_axis(8), 128, 16,
         rand(128, 0, 5), both, False),
        ("nd_chain(10) S=2 Ψ>T", nd_chain(10), neuron_axis(2), 16, 64,
         lambda m: torch.ones((16, m), dtype=torch.int32, device=dev),
         both, False),
        ("ragged B13 T37 S=3", random_system(45, 3, 0.1, seed=5),
         neuron_axis(3), 13, 37, rand(13, 0, 4), both, False),
        ("spikes~2^20 S=4", random_system(64, 2, 0.1, seed=2),
         neuron_axis(4), 32, 32, rand(32, 2 ** 20 - 8, 2 ** 20 + 8), both,
         False),
        ("power_law(26) degree S=8", power_law(26, 3, seed=6),
         neuron_axis(8, partition="degree"), 64, 32, rand(64, 0, 4), both,
         False),
        ("random halo <2^16 S=4", random_system(64, 2, 0.15, seed=3),
         neuron_axis(4), 24, 40, rand(24, 0, 4), both, True),
        ("scaled_pi(682) wave S=4", scaled_pi(682), neuron_axis(4), 512, 64,
         rand(512, 0, 3), both, False),
        ("scaled_pi(682) degree wave S=4", scaled_pi(682),
         neuron_axis(4, partition="degree"), 512, 64, rand(512, 0, 3), both,
         False),
        ("ring_lattice(32768,8) wave S=4", ring_lattice(32768, 8, seed=2),
         neuron_axis(4), 512, 64, rand(512, 0, 4), ("B7",), False),
    ]


def phase_shard_kernels():
    """Phase 13: B6 and B7 == their plain versions on the card, on every
    entry of every shard, at the phase-13 shapes; each wave's shard 0
    timed.  Returns (max |err| per kernel, timing rows keyed by kernel
    and case)."""
    import numpy as np
    import torch
    from repro_torch.core.semantics import decode_spiking
    from repro_torch.kernels.snp_step import ops, sparse_ops
    from repro_torch.kernels.snp_step.ref import snp_step_dense_shard_ref
    from repro_torch.kernels.snp_step.sparse_ref import snp_step_sparse_ref

    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    max_err = {"B6": 0, "B7": 0}
    rows = {}
    for name, system, plan, B, T, make, kernels, rand_halo in _shard_cases(
            rng, dev):
        wave = "wave" in name
        comp, shards, frontier, lv = _shard_level(
            system, plan, B, T, make, dev, dense="B6" in kernels)
        S, mloc, H = comp.num_shards, comp.shard_size, lv.halos[0].shape[-1]
        if rand_halo:
            halos = [torch.from_numpy(rng.integers(
                0, 1 << 16, size=(B, T, H)).astype(np.int32)).to(dev)
                for _ in range(S)]
        else:
            halos = lv.halos
        if name.startswith("nd_chain"):
            check(bool(lv.psi.min() > T), f"{name} should overflow T")
        errs = {}
        for d, sh in enumerate(shards):
            info, f = lv.infos[d], frontier[d]
            psi = lv.psi
            if "B6" in kernels:
                a6 = _b6_args(sh, f, info, lv.strides[d], psi, halos[d])
                k = ops.snp_step_dense_shard_cuda(*a6[:7], sh.cols, a6[9],
                                                  T)
                p = snp_step_dense_shard_ref(*a6, T)
                torch.cuda.synchronize()
                errs["B6"] = max(errs.get("B6", 0),
                                 int((k - p).abs().max()))
                del k, p
            a7, h7 = _b7_args(sh, f, info, lv.strides[d], psi, lv.tabs[d],
                              halos[d])
            k = _b7(a7, h7, sh.sell, T)
            p = snp_step_sparse_ref(*a7, halo=h7, max_branches=T)
            torch.cuda.synchronize()
            errs["B7"] = max(errs.get("B7", 0), int((k[0] - p[0]).abs().max()),
                             int((k[2] - p[2]).abs().max()))
            check(bool(torch.equal(k[1], p[1])) and not bool(k[2].any()),
                  f"{name}: B7's validity differs or its emission index is "
                  "not the zero slot")
            del k, p
        for kern, err in errs.items():
            max_err[kern] = max(max_err[kern], err)
            check(err == 0, f"{name}: {kern} disagrees with its plain "
                  f"version on some shard (max |err| {err})")
        line = (f"[13] {name:32s} S={S} mloc={mloc:5d} H={H:5d} "
                f"nloc={comp.arrays.rule_neuron.shape[1]:5d} "
                f"Kin={comp.arrays.in_idx.shape[-1]:3d} B={B:4d} T={T:3d} | "
                + ", ".join(f"{k} == plain on all {S} shards (max |err| "
                            f"{e})" for k, e in errs.items()))
        if not wave:
            log(line)
            continue
        iters = 5
        sh, info, f = shards[0], lv.infos[0], frontier[0]
        psi = lv.psi
        parts = []
        if "B6" in kernels:
            a6 = _b6_args(sh, f, info, lv.strides[0], psi, halos[0])
            k_ms = time_ms(lambda: ops.snp_step_dense_shard_cuda(
                *a6[:7], sh.cols, a6[9], T), 50)
            p_ms = time_ms(lambda: snp_step_dense_shard_ref(*a6, T), iters)
            Sm = decode_spiking(info.app, info.rank, a6[3], info.choices,
                                sh.view.rule_neuron, T)
            Sm = Sm.reshape(B * T, -1).to(torch.float32)
            Mf = sh.M_local.to(torch.float32)
            hf = halos[0].reshape(B * T, H).to(torch.float32)
            hadjf = sh.hadj.to(torch.float32)
            l_ms = time_ms(lambda: torch.matmul(Sm, Mf)
                           + torch.matmul(hf, hadjf), iters)
            del Sm, Mf, hf, hadjf
            b_ms, b_by, b_dense = _shard_dense_bound(a6, sh.in_idx, T,
                                                     sh.cols)
            d_ms = device_ms(lambda: ops.snp_step_dense_shard_cuda(
                *a6[:7], sh.cols, a6[9], T), 20,
                "snp_step_dense_kernel<true")
            rows[("B6", name)] = dict(S=S, B=B, T=T, mloc=mloc, H=H,
                                      ms=k_ms, plain_ms=p_ms,
                                      library_ms=l_ms, bound_ms=b_ms,
                                      bound_by=b_by, bound_dense_ms=b_dense,
                                      device_ms=d_ms)
            parts.append(f"B6 {k_ms:.4f} ms (profiler: {d_ms} ms on the "
                         f"card), plain {p_ms:.4f} ms, "
                         f"matmul(S,M_local)+matmul(halo,hadj) {l_ms:.4f} "
                         f"ms, bound {b_ms:.6f} ms ({b_by}; {b_dense:.6f} "
                         f"ms counting M_local and hadj dense) = "
                         f"{k_ms / b_ms:.1f}x bound")
        a7, h7 = _b7_args(sh, f, info, lv.strides[0], psi, lv.tabs[0],
                          halos[0])
        k_ms = time_ms(lambda: _b7(a7, h7, sh.sell, T), iters)
        d7_ms = device_ms(lambda: _b7(a7, h7, sh.sell, T), 20,
                          "snp_step_sparse_sell_kernel")
        p_ms = time_ms(lambda: snp_step_sparse_ref(
            *a7, halo=h7, max_branches=T), iters)
        l_ms = None
        if "B6" in kernels:    # M_local is there: the partial yardstick
            Sm = decode_spiking(info.app, info.rank,
                                a6[3], info.choices, sh.view.rule_neuron,
                                T).reshape(B * T, -1).to(torch.float32)
            Sm = Sm.to_sparse_csr()
            Mf = sh.M_local.to(torch.float32)
            l_ms = time_ms(lambda: torch.sparse.mm(Sm, Mf), iters)
            del Sm, Mf
        b_ms, b_by = _shard_sparse_bound(a7, h7, T, sh.sell)
        rows[("B7", name)] = dict(S=S, B=B, T=T, mloc=mloc, H=H, ms=k_ms,
                                  plain_ms=p_ms, library_ms=l_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  device_ms=d7_ms)
        lib = "—" if l_ms is None else f"{l_ms:.4f} ms"
        bt, nt = sparse_ops.sell_block_shape(mloc, H, T)
        parts.append(f"B7 {k_ms:.4f} ms (profiler: {d7_ms} ms on the "
                     f"card; block {bt} rows x {nt} threads, "
                     f"{int(sh.sell[0][-1])} sliced entries), plain "
                     f"{p_ms:.4f} ms, sparse.mm(S,M_local) {lib}, bound "
                     f"{b_ms:.6f} ms ({b_by}) = {k_ms / b_ms:.1f}x bound")
        log(line + " | shard 0: " + "; ".join(parts))
        del comp, shards, frontier, lv, halos
        torch.cuda.empty_cache()
    for name, a6, cols in _b6_hand_cases(rng, dev):
        T = a6[-1].shape[1]
        k = ops.snp_step_dense_shard_cuda(*a6[:7], cols, a6[9], T)
        p = snp_step_dense_shard_ref(*a6, T)
        torch.cuda.synchronize()
        err = int((k - p).abs().max())
        max_err["B6"] = max(max_err["B6"], err)
        check(err == 0, f"{name}: B6 disagrees with its plain version "
              f"(max |err| {err})")
        log(f"[13] {name:32s} H={a6[-1].shape[-1]:5d} halo at byte "
            f"{a6[-1].data_ptr() % 16} mod 16, B={a6[0].shape[0]} T={T} | "
            f"B6 == plain (max |err| {err})")
    max_err["B7"] = max(max_err["B7"], _forged_b7(rng, dev))
    return max_err, rows


def _timed_sharded(tag, label, system, plan, backend, kernel, caps):
    """One sharded explore with its launch counts (set to 0 just before,
    read just after), wall time, host reads and peak memory."""
    import torch
    from repro_torch.core import device as devmod
    from repro_torch.core.distributed import explore_distributed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    devmod.host_reads = 0
    t0 = time.perf_counter()
    res = explore_distributed(system, plan=plan, backend=backend, **caps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, reads = read_counts(), devmod.host_reads
    peak = torch.cuda.max_memory_allocated()
    waves = res.steps
    S = plan.num_shards
    check_counts(f"{label} via {backend!r}", counts,
                 **({kernel: S * waves} if kernel else {}))
    log(f"[{tag}] {label} via {backend!r}: {waves} waves in {secs:.3f} s = "
        f"{waves / secs:.3f} waves/s, {res.num_discovered} configs "
        f"archived, flags b/f/v={res.branch_overflow}/"
        f"{res.frontier_overflow}/{res.visited_overflow}, launches "
        f"{json.dumps(counts)}, host reads {reads} "
        f"({reads / max(waves, 1):.1f}/wave), max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    return res, (counts[kernel] if kernel else 0), peak


def _against_single(tag, sharded, single, what):
    """The comparison with a single-device archive: as a set with an equal
    count where neither run flags an overflow (checked); whether it holds
    in order, and as a set, is printed either way."""
    import numpy as np
    flags = lambda r: (r.branch_overflow, r.frontier_overflow,  # noqa: E731
                       r.visited_overflow)
    as_set = {tuple(r) for r in sharded.configs} == \
        {tuple(r) for r in single.configs}
    in_order = np.array_equal(sharded.configs, single.configs)
    if not any(flags(sharded)) and not any(flags(single)):
        check(as_set and sharded.num_discovered == single.num_discovered,
              f"{what}: the sharded archive differs from the single-device "
              "one as a set")
        verdict = "equal as a set (checked: neither run overflowed)"
    else:
        verdict = (f"overflow flags b/f/v {flags(sharded)} sharded, "
                   f"{flags(single)} single-device: the set comparison does "
                   f"not apply; as a set {as_set}")
    log(f"[{tag}] {what} against the single-device archive: {verdict}; "
        f"identical in order: {in_order} ({sharded.num_discovered} vs "
        f"{single.num_discovered} rows)")


def phase_sharded(single_dense):
    """Phase 14: ``explore_distributed(scaled_pi(682), neuron_axis(4))``,
    contiguous and degree, through ``"cuda"`` (B6), ``"sparse_cuda"``
    (B7), ``"ref"`` and ``"sparse"``: identical archives and flags, and
    against phase 5's single-device archive.  Returns {kernel: {path:
    launches}}."""
    import torch
    from repro_torch.core import compile_sharded, partition_stats
    from repro_torch.core.generators import scaled_pi
    from repro_torch.sharding import neuron_axis

    system = scaled_pi(682)
    launches = {"B6": {}, "B7": {}}
    for part in ("contiguous", "degree"):
        plan = neuron_axis(4, partition=part)
        comp = compile_sharded(system, plan, device="cuda")
        stats = partition_stats(comp.occupancy)
        log(f"[14] scaled_pi(682) over 4 shards, {part}: mloc="
            f"{comp.shard_size}, nloc={comp.arrays.rule_neuron.shape[1]}, "
            f"Kin={comp.arrays.in_idx.shape[-1]}, Hmax={comp.halo_width} "
            f"(halo {4 * comp.halo_width} slots a shard), occupancy "
            f"imbalance {stats['imbalance']:.4f}")
        del comp
        label = f"explore_distributed(scaled_pi(682), neuron_axis(4, {part}))"
        res = {}
        for backend, kernel in (("cuda", "B6"), ("sparse_cuda", "B7"),
                                ("ref", None), ("sparse", None)):
            res[backend], n, _ = _timed_sharded("14", label, system, plan,
                                                backend, kernel, SHARDED)
            if kernel:
                launches[kernel][f"sharded_{part}_explore"] = n
            torch.cuda.empty_cache()
        a = res["cuda"]
        check(all(_same_explore(a, r) for r in res.values()),
              f"{label}: archives or flags differ across the backends")
        log(f"[14] {part}: archives and flags identical through 'cuda', "
            f"'sparse_cuda', 'ref' and 'sparse' ({a.num_discovered} rows x "
            f"{a.configs.shape[1]} neurons)")
        _against_single("14", a, single_dense, f"{part} partition")
        ARCHIVES[f"scaled_pi(682) neuron_axis(4, {part})"] = _digest(a)
        if part == "contiguous":
            contiguous = a
        del res, a
    return launches, contiguous


def phase_sharded_large():
    """Phase 15: ``explore_distributed(ring_lattice(32768, 8, seed=2),
    neuron_axis(4))`` through ``"sparse_cuda"`` (B7) and ``"sparse"``,
    identical; against the single-device ``"sparse_cuda"`` explore (B2)
    at a 65,536-row archive.  Returns B7's and B2's launches."""
    import torch
    from repro_torch.core.generators import ring_lattice
    from repro_torch.sharding import neuron_axis

    system = ring_lattice(32768, 8, seed=2)
    plan = neuron_axis(4)
    label = "explore_distributed(ring_lattice(32768, 8), neuron_axis(4))"
    a, b7, peak = _timed_sharded("15", label, system, plan, "sparse_cuda",
                                 "B7", RING)
    torch.cuda.empty_cache()
    b, _, peak_plain = _timed_sharded("15", label, system, plan, "sparse",
                                      None, RING)
    check(_same_explore(a, b), f"{label}: archives or flags differ between "
          "'sparse_cuda' and 'sparse'")
    check(max(peak, peak_plain) < 60e9, "phase 15 allocated past 60 GB")
    log(f"[15] archives identical through 'sparse_cuda' and 'sparse' "
        f"({a.num_discovered} rows x {a.configs.shape[1]} neurons); peak "
        f"allocation {peak / 2**30:.3f} / {peak_plain / 2**30:.3f} GiB")
    del b
    torch.cuda.empty_cache()
    single, b2, _ = _timed_explore(
        "15", "explore(ring_lattice(32768, 8))", system, "sparse_cuda", "B2",
        caps=dict(RING, visited_cap=65536))
    _against_single("15", a, single, "ring_lattice(32768, 8)")
    return b7, b2


# Phases 16-17: the LM serving slice, SmolLM-360M through kernel B8.
# ``CARD`` is the device the two phases put their tensors on.
CARD = "cuda"
SERVE = dict(arch="smollm-360m", batch=8, prompt=1960, gen=64, seed=0)


def _attn_pairs(Sq, kv_len, causal):
    """Valid (query, key) pairs of one head, summed over the batch rows:
    keys below ``kv_len`` (and, causal, at or before the query)."""
    total = 0
    for n in kv_len:
        if causal:
            m = min(int(n), Sq)
            total += m * (m + 1) // 2 + (Sq - m) * int(n)
        else:
            total += Sq * int(n)
    return total


def _attn_bound(q, k, kv_len, causal):
    """Least time of one attention call at these (unpadded) inputs: a dict
    of the bound (ms), what binds (``bound_by``: operations or bytes), the
    way of computing that binds (``ops_route``), the f32-pipe and
    split-TF32 figures (ms) and the FLOPs.  4·D FLOPs a valid pair and
    head (``q·k`` and ``p·v``); bf16 over the bf16 tensor-core peak; f32
    over the lesser of the f32 pipe (67 TFLOP/s) and three TF32 products
    a product on the tensor cores (3x the FLOPs at 495 TFLOP/s), the least
    that keeps f32 accuracy there; bytes: q, k, v and ``kv_len`` read once,
    o written once."""
    import torch
    B, Hq, Sq, D = q.shape
    flops = 4 * Hq * D * _attn_pairs(Sq, kv_len.tolist(), causal)
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * B
    f32_ms = flops / FP32_OPS_PER_S * 1e3
    tf32x3_ms = 3 * flops / TF32_OPS_PER_S * 1e3
    # 3 / 495e12 < 1 / 67e12: for f32 the split products are always the
    # lesser of the two
    if q.dtype == torch.bfloat16:
        t_ops, route = flops / BF16_OPS_PER_S * 1e3, "bf16_tensor_cores"
    else:
        t_ops, route = tf32x3_ms, "tf32x3_tensor_cores"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return dict(bound_ms=bound[0], bound_by=bound[1], ops_route=route,
                f32_pipe_ms=f32_ms, tf32x3_ms=tf32x3_ms, flops=flops)


def _attn_cases():
    """(name, B, Hq, Hkv, Sq, Skv, D, causal, kv_len or None, dtypes) — the
    reference tests' shapes, a D=16 head (the reduced models), their edge
    shapes again at D = 64 and 128 in bf16 (the tensor-core body), the
    serving prefill's launch (unpadded, as the main path launches it) and
    its f32 twin at batch 2 (the split-TF32 body's main-path launch), and
    that body's own edges: f32 at D 32 and 128 with Sq no multiple of 16
    (its rows a warp) or 64 (its rows a block), f32 at D 16 with GQA 8/1,
    bf16 at D 16 and 32 with kv_len zeros."""
    f32, bf, both = ("float32",), ("bfloat16",), ("float32", "bfloat16")
    S = SERVE["prompt"]
    return [
        ("basic causal", 2, 4, 2, 64, 64, 32, True, None, both),
        ("basic", 2, 4, 2, 64, 64, 32, False, None, both),
        ("GQA 8/8", 1, 8, 8, 64, 64, 32, True, None, f32),
        ("GQA 8/2", 1, 8, 2, 64, 64, 32, True, None, f32),
        ("GQA 8/1", 1, 8, 1, 64, 64, 32, True, None, f32),
        ("GQA 15/5", 1, 15, 5, 64, 64, 32, True, None, both),
        ("multi-tile 96", 2, 4, 2, 96, 96, 64, True, None, f32),
        ("ragged 40x72", 2, 4, 2, 40, 72, 64, False, None, f32),
        ("Sq != Skv 128x256", 2, 4, 2, 128, 256, 64, False, None, both),
        ("single query", 2, 4, 2, 1, 128, 64, False, None, both),
        ("ragged causal 50, D=16", 2, 6, 2, 50, 50, 16, True, None, both),
        ("D=128", 1, 4, 2, 64, 64, 128, True, None, both),
        ("D=128 long", 2, 4, 1, 700, 700, 128, True, None, both),
        ("kv_len 0/57/128", 3, 4, 2, 32, 128, 32, False, [0, 57, 128], both),
        ("kv_len 0 causal", 2, 2, 2, 200, 200, 64, True, [0, 131], both),
        ("512 causal", 1, 2, 1, 512, 512, 64, True, None, f32),
        # the split-TF32 body's edges (f32; bf16 at D in {16, 32})
        ("TF32 15/5 333 D=32", 1, 15, 5, 333, 333, 32, True, None, f32),
        ("TF32 15/5 333 D=128", 1, 15, 5, 333, 333, 128, True, None, f32),
        ("TF32 8/1 D=128 not causal", 1, 8, 1, 77, 333, 128, False,
         [333], f32),
        ("TF32 GQA 8/1 D=16", 1, 8, 1, 200, 200, 16, True, None, f32),
        ("TF32 kv_len 0 D=16", 2, 4, 2, 150, 150, 16, True, [0, 97], bf),
        ("TF32 kv_len 0 D=32", 3, 6, 2, 45, 130, 32, False, [0, 130, 7],
         bf),
        # the tensor-core body's edges (bf16, D in {64, 128})
        ("TC basic D=64", 2, 4, 2, 64, 64, 64, False, None, bf),
        ("TC GQA 15/5 D=64", 1, 15, 5, 300, 300, 64, True, None, bf),
        ("TC GQA 8/2 D=64", 1, 8, 2, 200, 200, 64, True, None, bf),
        ("TC GQA 8/1 D=128", 1, 8, 1, 200, 200, 128, True, None, bf),
        ("TC basic D=128", 2, 4, 2, 96, 96, 128, False, None, bf),
        ("TC ragged 40x72 D=128", 2, 4, 2, 40, 72, 128, False, None, bf),
        ("TC Sq != Skv 200x130", 2, 4, 2, 200, 130, 128, True, None, bf),
        ("TC Sq != Skv 130x300", 2, 4, 2, 130, 300, 64, False, None, bf),
        ("TC single query D=128", 2, 4, 2, 1, 131, 128, False, None, bf),
        ("TC kv_len 0/57/128 D=128", 3, 4, 2, 32, 128, 128, False,
         [0, 57, 128], bf),
        ("TC kv_len 0 causal D=128", 2, 2, 2, 200, 200, 128, True,
         [0, 131], bf),
        ("serving prefill", 8, 15, 5, S, S, 64, True, None, bf),
        ("serving prefill f32", 2, 15, 5, S, S, 64, True, None, f32),
    ]


def _body(dtype, D):
    """The B8 body the kernel's entry point runs for these inputs."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    return "B8-TC" if attn_ops.uses_tensor_cores(dtype, D) else "B8-TF32"


def phase_attention_kernel():
    """Phase 16: both of B8's bodies == the plain version on the card.
    Returns (max error by body and dtype, timing row by body)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn import attention_ref, flash_attention

    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(16)
    errs = {"B8-TC": {"bfloat16": 0.0},
            "B8-TF32": {"float32": 0.0, "bfloat16": 0.0}}
    rows = {}
    for (name, B, Hq, Hkv, Sq, Skv, D, causal, kl,
         dtypes) in _attn_cases():
        for dname in dtypes:
            dt = getattr(torch, dname)
            body = _body(dt, D)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                                     (B, Hkv, Skv, D)))
            kv_len = torch.tensor(kl if kl is not None else [Skv] * B,
                                  dtype=torch.int32, device=dev)
            reset_counts()
            got = flash_attention(q, k, v, kv_len, causal=causal)
            torch.cuda.synchronize()
            counts = read_counts()
            check_counts(f"[16] {name} {dname}", counts, **{body: 1})
            want = attention_ref(q, k, v, kv_len, causal=causal)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            errs[body][dname] = max(errs[body][dname], err)
            if dname == "float32":
                check(err <= 2e-5, f"[16] {name} f32: {body} disagrees with "
                      f"its plain version (max |err| {err:.3g} > 2e-5)")
                detail = f"max |err| {err:.3g}"
            else:
                check(torch.allclose(got.float(), want.float(), atol=1e-3,
                                     rtol=8e-3),
                      f"[16] {name} bf16: {body} disagrees with its plain "
                      f"version beyond atol 1e-3, rtol 8e-3 (max |err| "
                      f"{err:.3g})")
                share = float((got != want).float().mean())
                detail = (f"max |err| {err:.3g}, {share:.4%} of elements "
                          f"differ")
            check(bool(torch.isfinite(got).all()),
                  f"[16] {name} {dname}: {body} output not finite")
            if kl is not None and 0 in kl:
                zero = [i for i, n in enumerate(kl) if n == 0]
                check(bool((got[zero] == 0).all()),
                      f"[16] {name}: rows with kv_len 0 are not exactly 0")
                detail += ", kv_len-0 rows exactly 0"
            log(f"[16] {name:26s} {dname:8s} q {tuple(q.shape)} k "
                f"{tuple(k.shape)} causal={causal}: {body} == plain "
                f"({detail})")
            if name.startswith("serving prefill"):
                rows[body] = _time_attention(q, k, v, kv_len, body,
                                             attn_ops, attention_ref, F)
                rows[body]["max_abs_err"] = err
            del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    return errs, rows


def _time_attention(q, k, v, kv_len, body, attn_ops, attention_ref, F,
                    tag="16", device=None):
    """Times at a main-path launch (unpadded, as the wrapper launches):
    B8's body, its plain version on the same inputs, the library call on
    the same inputs, and the library call on k/v repeated to every head.
    ``device`` given (ms, where from) stands for the profiler's time of
    the body's own launches."""
    import torch
    B, Hq, Sq, D = q.shape
    k_ms = time_ms(lambda: attn_ops.flash_attention_cuda(
        q, k, v, kv_len, causal=True), 20)
    p_ms = time_ms(lambda: attention_ref(q, k, v, kv_len, causal=True), 3)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    group = Hq // k.shape[1]
    ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))
    mha_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True), 20)
    again = time_ms(lambda: attn_ops.flash_attention_cuda(
        q, k, v, kv_len, causal=True), 20)
    bd = _attn_bound(q, k, kv_len, True)
    flops, b_ms = bd["flops"], bd["bound_ms"]
    if device is None:
        dev_ms, dev_from = device_ms(lambda: attn_ops.flash_attention_cuda(
            q, k, v, kv_len, causal=True), 20, KERNELS[body]["name"]), ""
    else:
        dev_ms, dev_from = device
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"[{tag}] {body} at its main-path launch q {tuple(q.shape)} k "
        f"{tuple(k.shape)} {str(q.dtype)[6:]} causal, kv_len {Sq}: "
        f"{k_ms:.4f} / {again:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s of "
        f"{flops / 1e9:.2f} GFLOP), {dev_txt} on the card by the "
        f"profiler{dev_from}, plain {p_ms:.4f} ms, SDPA (GQA) {l_ms:.4f} "
        f"ms, SDPA on "
        f"repeated k/v {mha_ms:.4f} ms; bound {b_ms:.6f} ms ({bd['bound_by']}"
        f", {bd['ops_route']}) = {k_ms / b_ms:.1f}x bound, "
        f"{k_ms / l_ms:.2f}x SDPA (GQA), {k_ms / mha_ms:.2f}x SDPA on "
        f"repeated k/v; {bd['f32_pipe_ms']:.6f} ms on the f32 pipe, "
        f"{bd['tf32x3_ms']:.6f} ms as three TF32 products")
    del ke, ve
    return dict(B=B, Hq=Hq, Hkv=k.shape[1], Sq=Sq, D=D,
                dtype=str(q.dtype)[6:], ms=k_ms, ms_again=again,
                device_ms=dev_ms, plain_ms=p_ms, library_ms=l_ms,
                library_mha_ms=mha_ms, bound_ms=b_ms,
                bound_by=bd["bound_by"], ops_route=bd["ops_route"],
                f32_pipe_ms=bd["f32_pipe_ms"], tf32x3_ms=bd["tf32x3_ms"],
                gflop=flops / 1e9, tflops=flops / k_ms / 1e9)


def _rel_err(got, want):
    """max |got - want| over max |want|, in f32."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def _serve_batch(cfg, B, S, dev, seed=0):
    import torch
    from repro_torch.data import DataConfig, make_batch
    b = make_batch(cfg, DataConfig(seed=seed), step=0, shard=0, batch=B,
                   seq_len=S)
    return {k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "positions")}


def _device_time(fn, wall_ms, label, tag="17"):
    """Device busy time of ``fn`` from ``torch.profiler`` (the sum of the
    durations of the events on the card: kernels, copies, sets; one
    stream, so they do not overlap), beside ``wall_ms`` measured without
    the profiler: the idle share is ``1 - busy / wall``.  Returns the busy
    ms and the kernels' ms by name (B8 apart), or None if the profiler
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                   n + 1)
    except Exception as e:          # diagnostics only: report and go on
        log(f"[{tag}] {label}: profiler failed ({type(e).__name__}: {e}); "
            f"device time not measured")
        return None
    kernels = [(k, ms, n) for k, (ms, n) in by_name.items()]
    busy = sum(ms for _, ms, _ in kernels)
    if busy <= 0:
        log(f"[{tag}] {label}: the profiler shows no device time; device "
            f"time not measured")
        return None
    kernels.sort(key=lambda r: -r[1])
    b8 = sum(ms for k, ms, _ in kernels if "flash_attn_fwd" in k)
    log(f"[{tag}] {label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"wall (idle share {max(0.0, 1 - busy / wall_ms):.3f}); B8 "
        f"{b8:.3f} ms ({b8 / busy:.3f} of busy); top kernels: " + "; ".join(
            f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in kernels[:6]))
    return dict(busy_ms=busy, wall_ms=wall_ms, b8_ms=b8,
                idle_share=max(0.0, 1 - busy / wall_ms))


def time_prefill(prefill, params, batch, label, tag="17"):
    """Wall times (ms, host clock) of 3 calls of a warmed-up ``prefill``,
    then the device split of one more (:func:`_device_time`, against the
    least wall time): the split's dict (empty if the profiler showed no
    device time) with ``wall_runs_ms``."""
    import torch
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[{tag}] {label}: {', '.join(f'{t:.3f}' for t in walls)} ms wall")
    split = _device_time(lambda: prefill(params, batch), min(walls), label,
                         tag=tag)
    return dict(split or {}, wall_runs_ms=walls)


def phase_serving():
    """Phase 17: SmolLM-360M served at full width and depth through B8.
    Returns the launches of each B8 body per path."""
    import contextlib
    import dataclasses
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import reduced
    from repro_torch.core import prng
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import init_params, param_count
    from repro_torch.serve import make_decode_step, make_prefill_step

    dev = torch.device(CARD)
    cfg = get_config(SERVE["arch"])
    L = cfg.num_layers
    B, S, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    max_len = S + G + 1
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(prng.PRNGKey(SERVE["seed"]), cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = param_count(params)
    check(all(bool(torch.isfinite(t).all()) for t in params.parameters()),
          "[17] the seeded weights are not finite")
    batch = _serve_batch(cfg, B, S, dev)
    prefill = make_prefill_step(cfg, max_len=max_len, attn_impl="cuda")
    decode = make_decode_step(cfg)
    log(f"[17] {cfg.name}: {L} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; {n_params} "
        f"parameters ({n_params * 2 / 1e9:.3f} GB), drawn on the card from "
        f"PRNGKey({SERVE['seed']}) as the reference draws them in "
        f"{t_init:.3f} s; batch {B} x prompt {S}, {G} decode steps, max_len "
        f"{max_len}")

    prefill(params, batch)            # first use: cuBLAS handles, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {"B8-TC": {}, "B8-TF32": {}}
    # the main path: counts set to 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = read_counts()
    check_counts("[17] full-width prefill via attn_impl='cuda'", counts,
                 **{"B8-TC": L})
    launches["B8-TC"]["full_width_prefill"] = counts["B8-TC"]
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"[17] prefill logits {tuple(logits.shape)} not finite or "
          f"misshapen")
    check(all(bool((c["len"] == S).all()) for c in cache),
          "[17] the caches' len after prefill is not S")
    more = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t0)
    log(f"[17] prefill {B}x{S} via 'cuda': {t_prefill * 1e3:.3f} ms "
        f"({B * S / t_prefill:.0f} tokens/s); again "
        f"{', '.join(f'{t * 1e3:.3f}' for t in more)} ms; launches "
        f"{json.dumps(counts)}")

    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    first = tok
    reset_counts()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(G):
        pos = torch.full((B, 1), S + g, dtype=torch.int32, device=dev)
        tok, dlogits, cache = decode(params, cache, tok, pos)
        finite &= torch.isfinite(dlogits).all()
        if g == 0:
            dec_first = dlogits
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = read_counts()
    check_counts("[17] decode", counts)
    check(bool(finite), "[17] decode logits not finite")
    check(all(bool((c["len"] == S + G).all()) for c in cache),
          "[17] the caches' len after decode is not S + gen")
    peak = torch.cuda.max_memory_allocated()
    log(f"[17] decode {G} steps x batch {B}: {t_dec / G * 1e3:.3f} ms/step "
        f"({B * G / t_dec:.0f} tokens/s); caches' len {S} -> {S + G}; "
        f"peak allocation (prefill + decode) {peak / 2**30:.3f} GiB")

    # where the time goes: one prefill, and 8 decode steps past the cache
    # (len is clamped at the last slot, as the reference clamps)
    _device_time(lambda: prefill(params, batch), min([t_prefill] + more)
                 * 1e3, f"prefill {B}x{S} profile")

    def steps8():
        t = tok
        for g in range(8):
            t, _, _ = decode(params, cache, t, pos)
    _device_time(steps8, t_dec / G * 8e3, f"decode, 8 steps x batch {B}, "
                 f"profile")
    del cache

    # teacher forcing: decode of token S+1 == a prefill of S+1 tokens
    tf_batch = {"tokens": torch.cat([batch["tokens"], first], 1),
                "positions": torch.arange(S + 1, dtype=torch.int32,
                                          device=dev).expand(B, S + 1)}
    tf_logits, _ = prefill(params, tf_batch)
    tf = _rel_err(dec_first, tf_logits)
    check(tf <= 0.02, f"[17] decode of token S+1 vs a prefill of S+1 "
          f"tokens: {tf:.4g} of max |logit| > 2%")

    reset_counts()
    ref_logits, _ = make_prefill_step(cfg, max_len=max_len,
                                      attn_impl="ref")(params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("[17] full-width prefill via attn_impl='ref'", counts)
    launches["B8-TC"]["full_width_prefill_ref"] = counts["B8-TC"]
    rel = _rel_err(logits, ref_logits)
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean()
    check(rel <= 0.02, f"[17] prefill via 'cuda' vs 'ref': {rel:.4g} of "
          f"max |logit| > 2%")
    log(f"[17] bf16: 'cuda' vs 'ref' prefill last logits {rel:.4g} of max "
        f"|logit| ({float(ref_logits.float().abs().max()):.4f}); decode of "
        f"token S+1 vs prefill of S+1 tokens {tf:.4g}; greedy tokens "
        f"agree on {float(agree):.3f} of rows")
    del params, logits, ref_logits, tf_logits, dec_first
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(prng.PRNGKey(SERVE["seed"]), cfg32, device=dev)
    b2 = {k: t[:2] for k, t in batch.items()}
    pf32 = make_prefill_step(cfg32, max_len=max_len, attn_impl="cuda")
    reset_counts()
    l32, c32 = pf32(p32, b2)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("[17] f32 prefill via 'cuda'", counts, **{"B8-TF32": L})
    launches["B8-TF32"]["f32_prefill"] = counts["B8-TF32"]
    r32, _ = make_prefill_step(cfg32, max_len=max_len,
                               attn_impl="ref")(p32, b2)
    rel32 = _rel_err(l32, r32)
    check(rel32 <= 1e-4, f"[17] f32 prefill, batch 2: 'cuda' vs 'ref' "
          f"{rel32:.3g} relative > 1e-4")
    nxt = l32[:, -1].argmax(-1).to(torch.int32)[:, None]
    _, d32, _ = make_decode_step(cfg32)(
        p32, c32, nxt, torch.full((2, 1), S, dtype=torch.int32, device=dev))
    t32, _ = pf32(p32, {"tokens": torch.cat([b2["tokens"], nxt], 1),
                        "positions": torch.arange(
                            S + 1, dtype=torch.int32,
                            device=dev).expand(2, S + 1)})
    tf32 = _rel_err(d32, t32)
    check(tf32 <= 1e-4, f"[17] f32 teacher forcing {tf32:.3g} > 1e-4")
    log(f"[17] f32, batch 2: 'cuda' vs 'ref' prefill {rel32:.3g} relative "
        f"(<= 1e-4); decode of token S+1 vs prefill of S+1 {tf32:.3g}")
    time_prefill(pf32, p32, b2, f"f32 prefill 2x{S} via 'cuda'")
    del p32, l32, c32, r32, d32, t32
    torch.cuda.empty_cache()

    # the launcher without its mesh (phase 24 serves on it)
    argv = ["--arch", SERVE["arch"], "--gen", "32"]
    if CARD != "cuda":
        argv += ["--device", CARD]
    runs = [("launcher_serve_lm", argv)] + [
        (f"launcher_sampled_{i}", argv + ["--temperature", "0.8", "--seed",
                                          "3"]) for i in (1, 2)]
    gens = {}
    for path, args in runs:
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            gens[path] = serve_main(args)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(f"[17] {path}", counts, **{"B8-TC": L})
        launches["B8-TC"][path] = counts["B8-TC"]
        check(gens[path].shape == (4, 32),
              f"[17] {path} returned {gens[path].shape}")
        check(bool(((gens[path] >= 0)
                    & (gens[path] < cfg.vocab_size)).all()),
              f"[17] {path}: token ids out of [0, {cfg.vocab_size})")
        for line in out.getvalue().splitlines():
            log(f"[17] {path} | {line}")
    a, b = gens["launcher_sampled_1"], gens["launcher_sampled_2"]
    check(bool((a == b).all()), "[17] two launcher runs at --temperature "
          "0.8 --seed 3 sampled different tokens")
    log(f"[17] launcher at --temperature 0.8 --seed 3, twice: identical "
        f"tokens (4 x 32, in [0, {cfg.vocab_size})); {float((a != gens[
            'launcher_serve_lm']).mean()):.3f} of them differ from the "
        f"greedy run's")

    # the launcher's reduced sibling: f32 at D 16, through B8-TF32
    small = reduced(cfg)
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        gen = serve_main(argv[:2] + ["--smoke", "--gen", "8"] + argv[4:])
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("[17] launcher_smoke", counts,
                 **{"B8-TF32": small.num_layers})
    launches["B8-TF32"]["launcher_smoke"] = counts["B8-TF32"]
    check(gen.shape == (4, 8) and bool(((gen >= 0)
                                        & (gen < small.vocab_size)).all()),
          f"[17] launcher_smoke returned {gen.shape} tokens, or ids out of "
          f"[0, {small.vocab_size})")
    for line in out.getvalue().splitlines():
        log(f"[17] launcher_smoke | {line}")
    log(f"[17] launcher --smoke ({small.name}: {small.num_layers} layers, "
        f"{small.dtype}, heads {small.num_heads}/{small.num_kv_heads} x "
        f"{small.head_dim}): {counts['B8-TF32']} B8-TF32 launches, tokens "
        f"(4 x 8) in [0, {small.vocab_size})")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: SNP trace serving and its failure domain
# ---------------------------------------------------------------------------

# The service's full-width bursts: 1,024 random traces of 64 steps.
SERVICE = dict(requests=1024, batch=256, steps=64, max_delay_ms=5.0)
# The fault run: the burst under `fail=2 poison=17` with one retry.  The
# stats are those both packages' services give for this schedule on the
# CPU (tests/test_torch_snp_service.py): seed 17's chunk fails at call 1,
# its bisection's first half takes the transient fault at call 2, and the
# other three chunks serve at once.  (``branch_overflow_traces``, the
# other stat, depends on the system: it is held against the clean run.)
FAULT_RUN = dict(requests=1024, batch=256,
                 policy=dict(max_retries=1, backoff_ms=0.0),
                 inject=dict(fail_calls=(2,), poison_seeds=(17,)))
FAULT_STATS = {"device_calls": 11, "traces_served": 1023, "retries": 0,
               "bisections": 8, "degraded": 0, "deadline_exceeded": 0,
               "rejected": 0, "failed_calls": 9, "failed_requests": 1}


#: Every degradation the run records (a listener installed before phase
#: 1): only phase 18's forced one may appear.
DEGRADES = []


def _burst(svc, requests):
    """Submit ``requests`` to an async service as one burst — while the
    drain thread waits on the service's lock, so it takes the burst in
    full chunks, in ticket order, as the CPU tests predict — then wait for
    every future.  Returns ({seed: TraceResult or exception}, seconds,
    completion latencies in ms)."""
    done = {}
    t0 = time.perf_counter()
    with svc._cv:
        futs = []
        for r in requests:
            fut = svc.submit(r)
            fut.add_done_callback(
                lambda f, s=r.seed: done.setdefault(s, time.perf_counter()))
            futs.append(fut)
    out = {}
    for r, fut in zip(requests, futs):
        try:
            out[r.seed] = fut.result(timeout=600)
        except Exception as e:
            out[r.seed] = e
    secs = time.perf_counter() - t0
    svc.close()            # joins the drain thread: every callback ran
    return out, secs, [(done[r.seed] - t0) * 1e3 for r in requests]


def _serve(tag, label, comp, backend, kernel, requests, *, policy=None,
           injector=None, runner=None, want_launches=None):
    """One full-width async service burst through ``backend`` with its
    launch counts (set to 0 just before, read just after)."""
    import numpy as np
    import torch
    from repro_torch.serve import SNPTraceService, TraceRequest

    reqs = [TraceRequest(comp, steps=SERVICE["steps"], policy="random",
                         seed=s) for s in range(requests)]
    svc = SNPTraceService(batch_size=SERVICE["batch"], backend=backend,
                          async_mode=True,
                          max_delay_ms=SERVICE["max_delay_ms"],
                          policy=policy, fault_injector=injector,
                          runner=runner, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    out, secs, lat = _burst(svc, reqs)
    torch.cuda.synchronize()
    counts, stats = read_counts(), svc.stats()
    if kernel is not None:
        check_counts(f"[{tag}] {label}", counts, **{kernel: want_launches})
    else:
        check_counts(f"[{tag}] {label}", counts)
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    log(f"[{tag}] {label} via {svc.backend.name!r}: {requests} requests x "
        f"{SERVICE['steps']} steps in {secs:.3f} s = {requests / secs:.1f} "
        f"traces/s, completion latency p50 {p50:.3f} ms p99 {p99:.3f} ms, "
        f"{stats['device_calls']} device calls, stats {json.dumps(stats)}, "
        f"launches {json.dumps(counts)}")
    return out, stats, counts, dict(
        traces_per_s=requests / secs, p50_ms=p50, p99_ms=p99,
        flush_ms=secs * 1e3 / max(stats["device_calls"], 1))


def _same_traces(tag, label, got, comp, backend, seeds, flush_ms):
    """Every served result against ``run_traces`` of the same seeds (in
    the service's chunks), bit for bit; with the host-clock milliseconds
    (synchronised) of those calls and of one ``policy="first"`` chunk,
    beside the service's mean flush (``flush_ms``): what the trace loop,
    its random branch draws and the service around it each take."""
    import torch
    from repro_torch.core import run_traces
    B, ms = SERVICE["batch"], []

    def timed(part, policy):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_traces(comp, steps=SERVICE["steps"], seeds=part,
                         policy=policy, backend=backend)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for lo in range(0, len(seeds), B):
        part = seeds[lo:lo + B]
        want, t = timed(part, "random")
        ms.append(t)
        want = [x.cpu().numpy() for x in want]
        for i, s in enumerate(part):
            r = got[s]
            check(not isinstance(r, Exception),
                  f"[{tag}] {label}: seed {s} failed: {r!r}")
            for f, w in zip(("configs", "emissions", "alive",
                             "branch_overflow"), want):
                check((getattr(r, f) == w[i]).all(),
                      f"[{tag}] {label}: seed {s}'s {f} differs from "
                      "run_traces")
    _, first_ms = timed(seeds[:B], "first")
    split = dict(flush_ms=flush_ms, run_traces_ms=sum(ms) / len(ms),
                 first_policy_ms=first_ms)
    log(f"[{tag}] {label}: all {len(seeds)} results identical to "
        f"run_traces of the same seeds via {backend!r}; a chunk of {B} "
        f"(host clock, synchronised): service flush {flush_ms:.3f} ms, "
        f"run_traces random {split['run_traces_ms']:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in ms)}), first policy "
        f"{first_ms:.3f} ms")
    return split


def _same_results(a, b):
    return all((getattr(a, f) == getattr(b, f)).all() for f in (
        "configs", "emissions", "alive", "branch_overflow"))


def _supervised(tag, label, run, kernel, want):
    """``run(checkpoint_dir, injector)`` killed at its second chunk under
    ``run_supervised`` and resumed from its snapshot, with the launch
    counts, the snapshot size and the save/restore milliseconds."""
    import tempfile
    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import engine
    from repro_torch.runtime import FaultInjector, run_supervised

    times = {"save": [], "restore": []}
    saved, restored = engine.save_checkpoint, engine._restore

    def timed(fn, key):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return r
        return wrapped

    d = tempfile.mkdtemp(prefix="snp-ckpt-")
    engine.save_checkpoint = timed(saved, "save")
    engine._restore = timed(restored, "restore")
    try:
        inj = FaultInjector(fail_calls=(2,))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res, restarts = run_supervised(lambda: run(d, inj), max_restarts=3)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        last = Path(d) / f"step_{latest_step(d):08d}"
        mb = sum(f.stat().st_size for f in last.iterdir()) / 1e6
    finally:
        engine.save_checkpoint, engine._restore = saved, restored
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    check(restarts == 1, f"[{tag}] {label}: {restarts} restarts, expected 1")
    check_counts(f"[{tag}] {label}", counts, **{kernel: want})
    log(f"[{tag}] {label}: killed at chunk 2, resumed: {restarts} restart, "
        f"{secs:.3f} s in all, {len(times['save'])} snapshots of "
        f"{mb:.3f} MB (the last), save ms "
        f"{', '.join(f'{t:.3f}' for t in times['save'])}, restore ms "
        f"{', '.join(f'{t:.3f}' for t in times['restore'])}, launches "
        f"{json.dumps(counts)}")
    return res, counts[kernel], dict(snapshot_mb=mb, save_ms=times["save"],
                                     restore_ms=times["restore"])


def phase_snp_service(dense_result, sharded_result):
    """Phase 18: the SNP trace service at full width through B1 and B3,
    its fault schedule and its forced kernel failures (no plain
    fallback); the checkpointed
    explores through B1, B6 and B7 against phases 5 and 14; the
    launcher's ``--snp``.  Returns ({kernel: {path: launches}}, figures)."""
    import contextlib
    import io

    import torch
    from repro_torch.core import (SystemPlan, compile_system,
                                  compile_system_sparse, explore, failover,
                                  get_backend, run_traces)
    from repro_torch.core.distributed import explore_distributed
    from repro_torch.core.generators import power_law, scaled_pi
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.runtime import (FaultInjector, FaultPolicy,
                                     PoisonError)
    from repro_torch.sharding import neuron_axis

    check(DEGRADES == [], f"[18] degradations before phase 18: {DEGRADES}")
    n, steps = SERVICE["requests"], SERVICE["steps"]
    calls = n // SERVICE["batch"]
    launches = {"B1": {}, "B3": {}, "B6": {}, "B7": {}}
    figures = {}

    dense = compile_system(scaled_pi(682), device="cuda")
    clean, stats, counts, figures["service_dense"] = _serve(
        "18", "service scaled_pi(682)", dense, "cuda", "B1", n,
        want_launches=calls * steps)
    check(stats["device_calls"] == calls and stats["traces_served"] == n,
          f"[18] dense service stats {stats}")
    launches["B1"]["service_dense"] = counts["B1"]
    figures["service_dense"].update(_same_traces(
        "18", "service scaled_pi(682)", clean, dense, "cuda", list(range(n)),
        figures["service_dense"]["flush_ms"]))

    hubby = power_law(8192, 4, seed=2)
    plan = SystemPlan.for_system(hubby)
    hybrid = compile_system_sparse(hubby, hub_threshold=plan.hub_threshold,
                                   device="cuda")
    hyb, stats, counts, figures["service_hybrid"] = _serve(
        "18", "service power_law(8192) hybrid", hybrid, "sparse_cuda", "B3",
        n, want_launches=calls * steps)
    check(stats["device_calls"] == calls and stats["traces_served"] == n,
          f"[18] hybrid service stats {stats}")
    launches["B3"]["service_hybrid"] = counts["B3"]
    figures["service_hybrid"].update(_same_traces(
        "18", "service power_law(8192) hybrid", hyb, hybrid, "sparse_cuda",
        list(range(n)), figures["service_hybrid"]["flush_ms"]))

    # the fault schedule on the dense service
    fr = FAULT_RUN
    faulty, stats, counts, figures["service_fault"] = _serve(
        "18", f"service scaled_pi(682) under {fr['inject']}", dense, "cuda",
        "B1", fr["requests"], policy=FaultPolicy(**fr["policy"]),
        injector=FaultInjector(**fr["inject"]),
        want_launches=FAULT_STATS["device_calls"] * steps)
    launches["B1"]["service_fault"] = counts["B1"]
    bad = {s for s, r in faulty.items() if isinstance(r, Exception)}
    check(bad == {17} and isinstance(faulty[17], PoisonError),
          f"[18] failed seeds {sorted(bad)}, expected only 17 with "
          f"PoisonError ({faulty.get(17)!r})")
    check(all(_same_results(faulty[s], clean[s]) for s in faulty if s != 17),
          "[18] a fault-run result differs from the clean run's")
    truncated = sum(r.truncated for s, r in clean.items() if s != 17)
    check({k: stats[k] for k in FAULT_STATS} == FAULT_STATS
          and stats["branch_overflow_traces"] == truncated,
          f"[18] fault-run stats {stats}, the CPU tests predict "
          f"{FAULT_STATS} and {truncated} truncated traces")
    log(f"[18] fault run: only seed 17 failed (PoisonError), the other "
        f"{fr['requests'] - 1} identical to the clean run; stats equal the "
        "CPU tests' prediction")
    del faulty, clean

    # no plain fallback on the card: a kernel backend that fails raises
    # its failure, on the service's own choice too, and degrades nothing
    def broken(comp, *, backend=None, **kw):
        be = get_backend(backend)
        if be.name in failover.KERNEL_BACKENDS:
            raise RuntimeError(f"forced failure of {be.name!r}")
        return run_traces(comp, backend=be, **kw)

    forced_n = SERVICE["batch"]
    for name, comp, backend in (("named_hybrid", hybrid, "sparse_cuda"),
                                ("chosen_dense", dense, None)):
        forced, stats, _, figures[f"service_forced_{name}"] = _serve(
            "18", f"service, its {name.split('_')[0]} kernel backend "
            "forced to fail", comp, backend, None, forced_n,
            policy=FaultPolicy(max_retries=0, backoff_ms=0.0, bisect=False),
            runner=broken)
        check(all(isinstance(r, RuntimeError) and "forced failure" in str(r)
                  for r in forced.values()) and stats["degraded"] == 0
              and stats["failed_requests"] == forced_n,
              f"[18] {name}: a forced kernel failure did not fail every "
              f"request with its own error (stats {stats})")
    for top, plan in (("cuda", SystemPlan()),
                      ("sparse_cuda", SystemPlan(encoding="hybrid")),
                      ("sparse_cuda", SystemPlan(encoding="ell"))):
        cands = failover.degrade_candidates(get_backend(top), plan,
                                            device="cuda")
        check(cands == [], f"[18] {top!r} under {plan.encoding!r} has "
              f"fallbacks on the card: {[c.name for c, _ in cands]}")

    def attempt(be, plan):
        raise RuntimeError(f"forced failure of {be.name!r}")

    raised = None
    try:
        failover.run_with_failover(attempt, get_backend("cuda"),
                                   SystemPlan(backend="cuda"),
                                   degradable=True, device="cuda")
    except RuntimeError as e:
        raised = e
    check("forced failure of 'cuda'" in str(raised),
          f"[18] a planned 'cuda' failure raised {raised!r}")
    check(DEGRADES == [], f"[18] degradations recorded: {DEGRADES}")
    log("[18] no plain fallback on the card: a named 'sparse_cuda' and the "
        "service's own 'cuda' forced to fail each failed all "
        f"{forced_n} requests with their own error, 0 degraded; no "
        "fallback for 'cuda' (dense, auto) or 'sparse_cuda' (ell, hybrid); "
        "a planned 'cuda' failure raised itself; 0 degradation events")
    del forced, hyb

    # checkpointed explores, killed at the second chunk, resumed
    pi = scaled_pi(682)
    res, n_b1, figures["checkpointed_explore"] = _supervised(
        "18", "explore(scaled_pi(682)) via 'cuda', checkpoint_every=2",
        lambda d, inj: explore(pi, backend="cuda", checkpoint_dir=d,
                               checkpoint_every=2, fault_injector=inj,
                               **FULL_WIDTH), "B1", dense_result.steps)
    check(_same_explore(res, dense_result),
          "[18] the resumed explore differs from phase 5's")
    launches["B1"]["checkpointed_explore"] = n_b1
    log(f"[18] resumed explore identical to phase 5's "
        f"({res.num_discovered} rows)")
    for backend, kernel in (("cuda", "B6"), ("sparse_cuda", "B7")):
        res, n_k, figures[f"checkpointed_sharded_{kernel}"] = _supervised(
            "18", f"explore_distributed(scaled_pi(682), neuron_axis(4)) via "
            f"{backend!r}, checkpoint_every=2",
            lambda d, inj, b=backend: explore_distributed(
                pi, plan=neuron_axis(4), backend=b, checkpoint_dir=d,
                checkpoint_every=2, fault_injector=inj, **SHARDED),
            kernel, 4 * sharded_result.steps)
        check(_same_explore(res, sharded_result),
              f"[18] the resumed sharded explore via {backend!r} differs "
              "from phase 14's")
        launches[kernel]["checkpointed_sharded_explore"] = n_k
        log(f"[18] resumed sharded explore via {backend!r} identical to "
            f"phase 14's ({res.num_discovered} rows)")
        torch.cuda.empty_cache()

    # the launcher
    argv = ["--snp", "--requests", "256", "--batch", "64", "--gen", "32"]
    for name, extra, served, failed in (
            ("launcher_snp", [], 256, []),
            ("launcher_snp_inject", ["--inject", "fail=2 poison=17",
                                     "--max-retries", "1"], 255,
             ["PoisonError"])):
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            got = serve_main(argv + extra)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(f"[18] {name}", counts, B1=None)
        launches["B1"][name] = counts["B1"]
        for line in out.getvalue().splitlines():
            log(f"[18] {name} | {line}")
        check(got["served"] == served and got["failed"] == failed
              and f"{served}/256 traces" in out.getvalue(),
              f"[18] {name} served {got['served']}/256, failed "
              f"{got['failed']}")
        figures[name] = {k: got[k] for k in ("traces_per_s", "p50_ms",
                                              "p99_ms")}
    log(f"[18] launcher --snp: 256/256 clean, 255/256 and one PoisonError "
        "under 'fail=2 poison=17'")
    check(DEGRADES == [], f"[18] degradations recorded: {DEGRADES}")
    return launches, figures


# ---------------------------------------------------------------------------
# The planner and block autotuner (phase 19)
# ---------------------------------------------------------------------------

# Shapes each kernel takes: B1 (rows; 256 threads), B6 (rows; 256
# threads), B4 and the sliced-list kernel (rows x threads).
B1_SHAPES = [(8, None), (16, None), (32, None)]
B6_SHAPES = [(1, None), (2, None), (4, None), (8, None)]
SELL_SHAPES = [(r, t) for t in (256, 1024) for r in (1, 2, 4, 8)]

# The workloads phase 19 plans (B, T = 512, 64), with the kernel each
# (backend, encoding, tier) runs and the phase whose archive it must equal.
PLANNED = [("scaled_pi(682)", "5"), ("power_law(8192)", "7"),
           ("scaled_pi(682) d=k%3", "10")]
# A measured ``"sparse_cuda"`` winner keeps the encoding ``"auto"`` when
# the degree heuristic leaves it on ELL (``autotune.choice_to_plan``
# names ``"hybrid"`` otherwise): the backend then compiles its ELL
# encoding.
KERNEL_OF = {("cuda", "dense", "no_delays"): "B1",
             ("sparse_cuda", "ell", "no_delays"): "B2",
             ("sparse_cuda", "auto", "no_delays"): "B2",
             ("sparse_cuda", "hybrid", "no_delays"): "B3",
             ("cuda", "dense", "delays"): "B4",
             ("sparse_cuda", "ell", "delays"): "B5-ELL",
             ("sparse_cuda", "auto", "delays"): "B5-ELL",
             ("sparse_cuda", "hybrid", "delays"): "B5-COO"}


def _every_shape(label, kernel, run, want, shapes, width=None, nbytes=2):
    """``run(rows, threads)``, one launch of ``kernel``, at every shape of
    ``shapes``: bit-identical to ``want``, the plain version's outputs,
    and, by the card's shape counters, one launch at exactly the requested
    shape.  A shape whose stage of
    ``width + 1`` values of ``nbytes`` bytes a row passes 227 KB must be
    refused (``ValueError``) before any launch.  Returns the shapes run
    and refused."""
    import torch
    from repro_torch.kernels.snp_step import sparse_ops

    ran, refused = [], []
    for rows, threads in shapes:
        fits = width is None or \
            rows * (width + 1) * nbytes <= sparse_ops.SMEM_LIMIT
        before = shape_counts()
        try:
            got = run(rows, threads)
        except ValueError as e:
            check(not fits, f"{label}: {kernel} refused {rows} x {threads}, "
                  f"whose stage fits: {e}")
            check(shape_counts() == before,
                  f"{label}: a refused shape launched")
            refused.append([rows, threads])
            continue
        check(fits, f"{label}: {kernel} ran {rows} rows, past its stage")
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        delta = {k: v - before.get(k, 0) for k, v in shape_counts().items()
                 if v != before.get(k, 0)}
        shape = (kernel, rows, 256 if threads is None else threads)
        check(delta == {shape: 1}, f"{label}: asked {kernel} for {rows} x "
              f"{threads}, the counters saw {delta}")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{label}: {kernel} at {rows} rows x {shape[2]} threads "
              f"disagrees with its plain version")
        ran.append([rows, shape[2]])
        del got
    log(f"[19] {label}: {kernel} bit-identical to its plain version at "
        f"{len(ran)} shapes {ran}" + (f"; refused (stage past 227 KB) "
                                      f"{refused}" if refused else ""))
    return ran, refused


def phase_planner_kernels():
    """Phase 19 (a): every kernel at every block shape it takes ==
    its plain version, at edge shapes of phases 2, 3, 9 and 13 and at the
    full-width waves; the shape counters show the requested shape ran.
    Returns {kernel: shapes run}."""
    import numpy as np
    import torch
    from repro_torch.core import (SystemPlan, compile_system,
                                  compile_system_sparse, with_delays)
    from repro_torch.core.generators import (nd_chain, power_law,
                                             random_system, ring_lattice,
                                             scaled_pi)
    from repro_torch.kernels.snp_step import ops, sparse_ops
    from repro_torch.kernels.snp_step.ref import (snp_step_dense_delay_ref,
                                                  snp_step_dense_ref,
                                                  snp_step_dense_shard_ref)
    from repro_torch.kernels.snp_step.sparse_ref import (kernel_inputs,
                                                         snp_step_sparse_ref)
    from repro_torch.sharding import neuron_axis

    rng = np.random.default_rng(19)
    dev = torch.device("cuda")
    lim = sparse_ops.SMEM_LIMIT
    check(sparse_ops.max_neurons() == lim // 2 - 1
          and ops.delay_max_neurons() == lim // 4 - 1,
          f"the library's limits {sparse_ops.max_neurons()} / "
          f"{ops.delay_max_neurons()} differ from SMEM_LIMIT {lim}")

    def rand(B, lo=0, hi=4):
        return lambda m: torch.from_numpy(
            rng.integers(lo, hi, size=(B, m)).astype(np.int32)).to(dev)

    shapes = {}

    def note(kernel, ran):
        for r in ran[0]:
            if r not in shapes.setdefault(kernel, []):
                shapes[kernel].append(r)

    for name, system, B, T, make in (
            ("ragged B13 T37", random_system(45, 3, 0.1, seed=5), 13, 37,
             rand(13)),
            ("nd_chain(10)", nd_chain(10), 16, 64,
             lambda m: torch.ones((16, m), dtype=torch.int32, device=dev)),
            ("unaligned slab m1023 T33", scaled_pi(341), 37, 33,
             rand(37, 0, 3)),
            ("scaled_pi(682) wave", scaled_pi(682), 512, 64, rand(512, 0, 3))):
        comp = compile_system(system, device=dev)
        args, _ = _step_inputs(comp, make(comp.num_neurons))
        cols = (comp.col_start, comp.col_rule, comp.col_val)
        note("B1", _every_shape(
            name, "B1",
            lambda r, t: ops.snp_step_dense(*args[:7], cols, T, rows=r,
                                            threads=t),
            snp_step_dense_ref(*args, T), B1_SHAPES))
        del comp, args, cols

    hybrid = power_law(8192, 4, seed=2)
    for name, system, h, B, T, make in (
            ("ragged B13 T37", random_system(45, 3, 0.1, seed=5), None, 13,
             37, rand(13)),
            ("empty slice m=100", _empty_slice_system(), None, 24, 40,
             rand(24)),
            ("ragged m=45 h=2 B13 T37", random_system(45, 3, 0.1, seed=5), 2,
             13, 37, rand(13)),
            ("scaled_pi(682) wave", scaled_pi(682), None, 512, 64,
             rand(512, 0, 3)),
            ("power_law(8192) hybrid wave", hybrid,
             SystemPlan.for_system(hybrid).hub_threshold, 512, 64, rand(512)),
            ("ring_lattice(32768,8) wave", ring_lattice(32768, 8, seed=2),
             None, 512, 64, rand(512))):
        comp = compile_system_sparse(system, hub_threshold=h, device=dev)
        configs = make(comp.num_neurons)
        args, coo, _ = kernel_inputs(configs, comp)
        kargs, kcoo, _ = kernel_inputs(configs, comp, lists=True)
        kernel = "B3" if comp.is_hybrid else "B2"
        note(kernel, _every_shape(
            name, kernel,
            lambda r, t: sparse_ops.snp_step_sparse_cuda(
                *kargs, **kcoo, max_branches=T, rows=r, threads=t),
            snp_step_sparse_ref(*args, **coo, max_branches=T), SELL_SHAPES,
            comp.num_neurons))
        del comp, configs, args, coo, kargs, kcoo
        torch.cuda.empty_cache()

    for name, system, h, B, T, make in _delay_cases(rng, dev):
        if name not in ("ragged B13 T37 d=k%4",
                        "ragged m=45 h=2 B13 T37 d=k%4",
                        "reopen 2^16-1, no output",
                        "scaled_pi(682) delayed wave",
                        "power_law(8192) delayed hybrid wave"):
            continue
        m = system.num_neurons
        states = make(m)
        if h == "auto":
            h = SystemPlan.for_system(system,
                                      semantics="delays").hub_threshold
        if h is None:
            comp = compile_system(system, semantics="delays", device=dev)
            pargs, _ = ops.delay_inputs(states, comp)
            dargs, _ = ops.delay_inputs(states, comp, lists=True)
            note("B4", _every_shape(
                name, "B4",
                lambda r, t: ops.snp_step_dense_delay(*dargs, T, rows=r,
                                                      threads=t),
                snp_step_dense_delay_ref(*pargs, T), SELL_SHAPES, m, 4))
            del comp, pargs, dargs
        comp = compile_system_sparse(system, hub_threshold=h,
                                     semantics="delays", device=dev)
        args, extra, _ = kernel_inputs(states, comp)
        kargs, kextra, _ = kernel_inputs(states, comp, lists=True)
        kernel = "B5-COO" if comp.is_hybrid else "B5-ELL"
        note(kernel, _every_shape(
            name, kernel,
            lambda r, t: sparse_ops.snp_step_sparse_cuda(
                *kargs, **kextra, max_branches=T, rows=r, threads=t),
            snp_step_sparse_ref(*args, **extra, max_branches=T), SELL_SHAPES,
            m))
        del comp, states, args, extra, kargs, kextra
        torch.cuda.empty_cache()

    for name, system, plan, B, T in (
            ("power_law(26) degree S=4", power_law(26, 3, seed=6),
             neuron_axis(4, partition="degree"), 24, 33),
            ("scaled_pi(682) wave S=4", scaled_pi(682), neuron_axis(4), 512,
             64)):
        comp, shards, frontier, lv = _shard_level(system, plan, B, T,
                                                  rand(B, 0, 3), dev)
        for d in (0, comp.num_shards - 1):
            sh, info, f = shards[d], lv.infos[d], frontier[d]
            a6 = _b6_args(sh, f, info, lv.strides[d], lv.psi, lv.halos[d])
            note("B6", _every_shape(
                f"{name} shard {d}", "B6",
                lambda r, t: ops.snp_step_dense_shard_cuda(
                    *a6[:7], sh.cols, a6[9], T, rows=r, threads=t),
                (snp_step_dense_shard_ref(*a6, T),), B6_SHAPES))
            a7, h7 = _b7_args(sh, f, info, lv.strides[d], lv.psi, lv.tabs[d],
                              lv.halos[d])
            note("B7", _every_shape(
                f"{name} shard {d}", "B7",
                lambda r, t: sparse_ops.snp_step_sparse_cuda(
                    *a7[:5], *sh.sell, a7[6], halo=h7, max_branches=T,
                    rows=r, threads=t)[0],
                (snp_step_sparse_ref(*a7, halo=h7, max_branches=T)[0],),
                SELL_SHAPES, f.shape[1] + h7.shape[-1]))
        del comp, shards, frontier, lv
        torch.cuda.empty_cache()
    log(f"[19] shapes held against the plain versions: {json.dumps(shapes)}")
    return shapes


def _launched_shape(plan, kernel, m, T):
    """The shape-counter key ``plan``'s ``kernel`` launches under at
    ``m`` neurons and ``T`` branches: the plan's block shape, the
    library's rule where it names none."""
    from repro_torch.kernels.snp_step import ops, sparse_ops
    bt = None if plan is None or plan.kernel is None else plan.kernel.block_t
    nt = None if plan is None or plan.kernel is None else plan.kernel.threads
    if kernel == "B1":
        return ("B1", *ops.dense_block_shape(bt, nt))
    if kernel == "B4":
        return ("B4", *ops.delay_block_shape(m, T, bt, nt))
    return (kernel, *sparse_ops.sell_block_shape(m, 0, T, bt, nt))


def _check_shapes(label, plan, kernel, m, T, waves):
    """Every launch of the explore just run was ``kernel`` at the shape
    ``plan`` gives it; returns that shape."""
    key = _launched_shape(plan, kernel, m, T)
    seen = shape_counts()
    check(seen == {key: waves}, f"{label}: the explore launched {seen}, "
          f"not {waves} x {key}")
    return list(key[1:])


# The batches phase 19 (b) sweeps at T = 64: what the entry points serve
# (successor_set 1, emission_gaps 64, the full-width explore 512).
PLAN_BATCHES = (1, 64, 256, 512)


def phase_planner():
    """Phase 19 (b)-(e): ``SystemPlan.for_system(mode="measure")`` on the
    three main-path workloads at each batch of :data:`PLAN_BATCHES` (every
    candidate timed through ``be.expand`` in interleaved rounds, the
    winner a kernel backend), ``explore`` under each full-width measured
    plan, twice (archive equal to phases 5, 7 and 10, the winner's kernel
    launched at the winner's shape), a second ``mode="auto"`` plan from
    the cache, and the seed rows as JSON lines.  Returns ({workload:
    figures}, seed rows)."""
    import torch
    from repro_torch.core import SystemPlan, autotune, failover, with_delays
    from repro_torch.core.generators import power_law, scaled_pi

    systems = {"scaled_pi(682)": scaled_pi(682),
               "power_law(8192)": power_law(8192, 4, seed=2),
               "scaled_pi(682) d=k%3": with_delays(scaled_pi(682),
                                                   lambda k, r: k % 3)}
    B, T = FULL_WIDTH["frontier_cap"], FULL_WIDTH["max_branches"]
    figures, seeds = {}, []
    for label, phase in PLANNED:
        system = systems[label]
        semantics = "delays" if "d=" in label else "no_delays"
        tier = "snp_step_delays" if semantics == "delays" else "snp_step"
        sweeps = {}
        for b in PLAN_BATCHES:
            sig = autotune.signature_of(system, workload=(b, T),
                                        semantics=semantics)
            t0 = time.perf_counter()
            plan = SystemPlan.for_system(system, workload=(b, T),
                                         mode="measure", semantics=semantics)
            secs = time.perf_counter() - t0
            sweep = list(autotune.last_sweep)
            for row in sweep:
                log(f"[19] measure {label} B={b}: {row['backend']} block_t="
                    f"{row['block_t']} threads={row['threads']}: "
                    + (f"{row['us']:.1f} us a step, spread "
                       f"{row['spread_us']:.1f}"
                       if row["refused"] is None else
                       f"refused: {row['refused']}"))
            check(all(r["refused"] is None for r in sweep),
                  f"{label} B={b}: a candidate of the card's grid was "
                  "refused")
            check(plan.backend in failover.KERNEL_BACKENDS
                  and plan.mode == "measure",
                  f"{label} B={b}: the measured winner is {plan}")
            kernel = KERNEL_OF[(plan.backend, "dense"
                                if plan.backend == "cuda" else plan.encoding,
                                semantics)]
            log(f"[19] measure {label} B={b}: winner {plan.backend} "
                f"({kernel}) encoding {plan.encoding}, kernel {plan.kernel}, "
                f"{len(sweep)} candidates in {secs:.1f} s")
            for row in sweep:
                seeds.append({
                    "name": f"{tier}/{row['backend']}/m{sig.m}_n{sig.n}"
                            f"_B{b}_T{T}", "us_per_call": row["us"],
                    "block_t": row["block_t"], "threads": row["threads"],
                    "spread_us": row["spread_us"]})
            sweeps[b] = dict(
                winner=[plan.backend, kernel, plan.encoding,
                        None if plan.kernel is None else plan.kernel.block_t,
                        None if plan.kernel is None else plan.kernel.threads],
                candidates=[[r["backend"], r["block_t"], r["threads"],
                             r["us"], r["spread_us"]] for r in sweep],
                sweep_s=secs)
        # (c) the explore under the full-width measured plan, twice
        runs = []
        for n in (1, 2):
            t0 = time.perf_counter()
            res, launches, _ = _timed_explore(
                "19", f"explore({label}) under the measured plan, run {n}",
                system, None, kernel, plan)
            runs.append(res.steps / (time.perf_counter() - t0))
            check(_digest(res) == ARCHIVES[label],
                  f"{label}: the measured plan's archive differs from phase "
                  f"{phase}'s")
            shape = _check_shapes(label, plan, kernel, system.num_neurons, T,
                                  res.steps)
            del res
        log(f"[19] explore({label}) under the measured plan: archive equal "
            f"to phase {phase}'s, {kernel} at {shape} every wave")
        # (d) the cached winner
        again = SystemPlan.for_system(system, workload=(B, T), mode="auto",
                                      semantics=semantics)
        hit = autotune.lookup(autotune.signature_of(
            system, workload=(B, T), semantics=semantics))
        check((again.backend, again.encoding, again.kernel)
              == (plan.backend, plan.encoding, plan.kernel)
              and hit is not None and hit.source == "cache",
              f"{label}: mode='auto' after the sweep gave {again} ({hit})")
        figures[label] = dict(sweeps=sweeps, launches=launches,
                              block=shape, explore_waves_s=runs)
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(f"[19] seed rows (card: {card}, torch {torch.__version__}):")
    for row in seeds:
        log("[19] seed " + json.dumps(row))
    return figures, seeds


def phase_open_plans():
    """Phase 19 (f): the open plan, the path of every caller that names
    no backend.  With a fresh cache of its own, the committed seed rows
    decide the three seeded workloads at (512, 64) and the cost model
    decides ``scaled_pi(682)`` at (128, 64), which no row seeds (the
    rows of its system, at other batches, fit the curves): what
    ``resolve_entry_info`` chose and who decided, that kernel launched
    at that shape every wave of an open-plan ``explore``, the archive
    equal to phases 5, 7 and 10 (for the unseeded workload, to the
    explore under the rule's ``"cuda"`` at the same caps, the two timed
    in turns, twice each).  Returns {workload: figures}."""
    import os
    import tempfile

    import torch
    from repro_torch.core import (SystemPlan, autotune, failover,
                                  resolve_entry_info, with_delays)
    from repro_torch.core.generators import power_law, scaled_pi

    pi = scaled_pi(682)
    cases = [("scaled_pi(682)", pi, "no_delays", FULL_WIDTH, "seed"),
             ("power_law(8192)", power_law(8192, 4, seed=2), "no_delays",
              FULL_WIDTH, "seed"),
             ("scaled_pi(682) d=k%3", with_delays(pi, lambda k, r: k % 3),
              "delays", FULL_WIDTH, "seed"),
             ("scaled_pi(682) F=128", pi, "no_delays",
              dict(FULL_WIDTH, frontier_cap=128), "model")]
    fresh = tempfile.TemporaryDirectory(prefix="chip_smoke_open_plan_")
    saved = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(fresh.name) / "autotune.json")
    figures = {}
    try:
        for label, system, semantics, caps, _ in cases:
            workload = (caps["frontier_cap"], caps["max_branches"])
            sig = autotune.signature_of(system, workload=workload,
                                        semantics=semantics)
            hit = autotune.lookup(sig)
            decider = hit.source if hit is not None else (
                "model" if autotune.model_choice(sig) is not None
                else "rule")
            open_plan = SystemPlan(semantics=semantics)
            be, plan, planned = resolve_entry_info(system, None, open_plan,
                                                   workload=workload)
            check(planned and be.name in failover.KERNEL_BACKENDS,
                  f"open plan {label}: {be.name}, planned={planned}")
            kernel = KERNEL_OF[(be.name, "dense" if be.name == "cuda"
                                else plan.encoding, semantics)]
            t0 = time.perf_counter()
            res, launches, _ = _timed_explore(
                "19", f"open plan {label}", system, None, kernel, open_plan,
                caps)
            secs = time.perf_counter() - t0
            shape = _check_shapes(f"open plan {label}", plan, kernel,
                                  system.num_neurons, workload[1], res.steps)
            row = dict(decider=decider, backend=be.name, kernel=kernel,
                       encoding=plan.encoding, block=shape,
                       launches=launches, waves_s=res.steps / secs)
            if label in ARCHIVES:
                check(_digest(res) == ARCHIVES[label],
                      f"open plan {label}: the archive differs from the "
                      "main path's")
            else:
                # in turns, open plan and rule, each run twice
                row["waves_s"], row["rule_waves_s"] = [row["waves_s"]], []
                for backend, plan_n, key in (
                        ("cuda", None, "rule_waves_s"),
                        (None, open_plan, "waves_s"),
                        ("cuda", None, "rule_waves_s")):
                    t0 = time.perf_counter()
                    other, _, _ = _timed_explore(
                        "19", f"{label} under "
                        f"{'the rule' if backend else 'the open plan'}",
                        system, backend, kernel if backend is None else
                        "B1", plan_n, caps)
                    row[key].append(other.steps
                                    / (time.perf_counter() - t0))
                    check(_same_explore(res, other),
                          f"open plan {label}: the archive differs from "
                          "the rule's 'cuda' explore")
                    del other
            log(f"[19] open plan {label}: {decider} chose {be.name} "
                f"({kernel}, {plan.encoding}) at {shape}; "
                f"{json.dumps(row)}")
            figures[label] = row
            del res
            torch.cuda.empty_cache()
    finally:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = saved
        fresh.cleanup()
    for label, _, _, _, want in cases:
        check(figures[label]["decider"] == want,
              f"open plan {label}: decided by {figures[label]['decider']}, "
              f"not by the {want}")
    return figures


# ---------------------------------------------------------------------------
# The dense-row scheme and the distributed traces (phase 20)
# ---------------------------------------------------------------------------

# Phase 20 (a), (b), (e): 4 ranks on the one card, each with F = 128
# frontier rows (512 in all: the full-width wave of 32,768 candidates),
# T = 64, 8 levels.  A rank inserts at most F rows a level, so 8 levels
# fill at most 1 + 8·128 = 1,025 of its V = 4,096 table and archive rows:
# no visited overflow can occur (checked).
DENSE_ROWS = dict(max_steps=8, frontier_cap=128, max_branches=64,
                  visited_cap=4096)
DENSE_RANKS = 4
# one rank (mesh=None) at the full width of phase 5, whose archive it is
DENSE_ONE = FULL_WIDTH
TRACE_MESH = dict(seeds=256, steps=64)


def _timed_dense_rows(tag, label, system, backend, kernel, *, mesh=None,
                      plan=None, caps=DENSE_ROWS, **kw):
    """One dense-row explore with its launch counts (set to 0 just
    before, read just after; a kernel launches once a rank a level), wall
    time, host reads and peak memory."""
    import torch
    from repro_torch.core import device as devmod
    from repro_torch.core.distributed import explore_distributed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    devmod.host_reads = 0
    t0 = time.perf_counter()
    res = explore_distributed(system, mesh=mesh, plan=plan, backend=backend,
                              **caps, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, reads = read_counts(), devmod.host_reads
    peak = torch.cuda.max_memory_allocated()
    waves = res.steps
    R = 1 if mesh is None else len(mesh)
    check_counts(f"{label} via {backend!r}", counts,
                 **({kernel: R * waves} if kernel else {}))
    check(not res.visited_overflow, f"{label} via {backend!r}: visited "
          f"overflow at V = {caps['visited_cap']} a rank")
    cands = waves * R * caps["frontier_cap"] * caps["max_branches"]
    log(f"[{tag}] {label} via {backend!r}, {R} rank(s): {waves} waves in "
        f"{secs:.3f} s = {waves / secs:.3f} waves/s, {cands / secs:.0f} "
        f"candidates/s, {res.num_discovered} configs archived, flags "
        f"b/f/v={res.branch_overflow}/{res.frontier_overflow}/"
        f"{res.visited_overflow}, exhausted {res.exhausted}, launches "
        f"{json.dumps(counts)}, host reads {reads} "
        f"({reads / max(waves, 1):.1f}/wave), max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    return res, (counts[kernel] if kernel else 0), dict(
        waves_per_s=waves / secs, host_reads_per_wave=reads / max(waves, 1),
        peak_gib=peak / 2**30)


def _timed_traces(label, fn, backend, kernel, want_launches):
    """One trace call with its launch counts and host-clock seconds."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"[20] {label} via {backend!r}", counts,
                 **{kernel: want_launches})
    return out, secs, counts[kernel]


def phase_dense_rows():
    """Phase 20: the dense-row hash-partitioned explore (4 ranks on the
    card through B1, B2 and ``"ref"``; one rank through B1 and ``"ref"``,
    equal to phase 5's explore; the hybrid plan through B3 and
    ``"sparse"``), ``run_traces_distributed`` at 4 ranks and at one
    through B1 and B3 against ``run_traces``, the service over the trace
    mesh, the launcher's mesh line, and a checkpointed dense-row explore
    killed and resumed.  Returns ({kernel: {path: launches}}, figures)."""
    import contextlib
    import io

    import torch
    from repro_torch.core import (SystemPlan, compile_system,
                                  compile_system_sparse, paper_pi,
                                  run_traces)
    from repro_torch.core.distributed import (explore_distributed,
                                              run_traces_distributed)
    from repro_torch.core.generators import power_law, scaled_pi
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve import make_trace_runner
    from repro_torch.sharding import trace_mesh

    mesh = ["cuda"] * DENSE_RANKS
    launches = {"B1": {}, "B2": {}, "B3": {}}
    figures = {}
    log(f"[20] dense-row caps a rank: {json.dumps(DENSE_ROWS)}, "
        f"{DENSE_RANKS} ranks on {torch.cuda.get_device_name(0)}; one "
        f"rank: {json.dumps(DENSE_ONE)}")

    # (a) scaled_pi(682): 4 ranks through B1, B2 (ELL plan) and "ref"
    pi = scaled_pi(682)
    label = "explore_distributed(scaled_pi(682)), dense rows"
    res = {}
    for backend, kernel, plan, path in (
            ("cuda", "B1", None, "dense_row_explore"),
            ("sparse_cuda", "B2", SystemPlan(encoding="ell"),
             "dense_row_ell_explore"),
            ("ref", None, None, "dense_row_ref_explore")):
        res[backend], n, figures[path] = _timed_dense_rows(
            "20", label, pi, backend, kernel, mesh=mesh, plan=plan)
        if kernel:
            launches[kernel][path] = n
        torch.cuda.empty_cache()
    a = res["cuda"]
    check(all(_same_explore(a, r) and a.num_discovered == r.num_discovered
              for r in res.values()),
          f"[20] {label}: archives or flags differ across 'cuda', "
          "'sparse_cuda' and 'ref'")
    log(f"[20] (a) 4 ranks: archives and flags identical through 'cuda', "
        f"'sparse_cuda' (ELL) and 'ref' ({a.num_discovered} rows x "
        f"{a.configs.shape[1]} neurons, the ranks' archives in rank order)")
    dense_rows = a
    ARCHIVES["scaled_pi(682) dense rows R=4"] = _digest(a)
    del res
    one = {}
    for backend, kernel in (("cuda", "B1"), ("ref", None)):
        one[backend], n, figures[f"dense_row_one_rank_{backend}"] = \
            _timed_dense_rows("20", label, pi, backend, kernel,
                              caps=DENSE_ONE)
        if kernel:
            launches[kernel]["dense_row_one_rank_explore"] = n
        torch.cuda.empty_cache()
    check(_same_explore(one["cuda"], one["ref"]),
          f"[20] {label}, one rank: 'cuda' and 'ref' differ")
    check(_digest(one["cuda"]) == ARCHIVES["scaled_pi(682)"],
          f"[20] {label}, one rank: the archive differs from phase 5's "
          "explore")
    log(f"[20] (a) one rank: identical through 'cuda' and 'ref', and to "
        f"phase 5's explore row for row ({one['cuda'].num_discovered} rows)")
    del one

    # (b) the hybrid plan: 4 ranks through B3 and "sparse"
    hubby = power_law(8192, 4, seed=2)
    plan = SystemPlan.for_system(hubby)
    check(plan.encoding == "hybrid", f"[20] power_law(8192) planned {plan}")
    label = "explore_distributed(power_law(8192)), dense rows, hybrid"
    res = {}
    for backend, kernel in (("sparse_cuda", "B3"), ("sparse", None)):
        res[backend], n, figures[f"dense_row_hybrid_{backend}"] = \
            _timed_dense_rows("20", label, hubby, backend, kernel,
                              mesh=mesh, plan=plan)
        if kernel:
            launches[kernel]["dense_row_hybrid_explore"] = n
        torch.cuda.empty_cache()
    check(_same_explore(res["sparse_cuda"], res["sparse"]),
          f"[20] {label}: archives or flags differ between 'sparse_cuda' "
          "and 'sparse'")
    log(f"[20] (b) archives identical through 'sparse_cuda' and 'sparse' "
        f"({res['sparse'].num_discovered} rows x "
        f"{res['sparse'].configs.shape[1]} neurons)")
    del res

    # (c) run_traces_distributed against run_traces
    hybrid = compile_system_sparse(hubby, hub_threshold=plan.hub_threshold,
                                   device="cuda")
    B, steps = TRACE_MESH["seeds"], TRACE_MESH["steps"]
    seeds = list(range(B))
    for name, system, backend, kernel in (
            ("paper_pi", compile_system(paper_pi(True), device="cuda"),
             "cuda", "B1"),
            ("scaled_pi(682)", compile_system(pi, device="cuda"), "cuda",
             "B1"),
            ("power_law(8192) hybrid", hybrid, "sparse_cuda", "B3")):
        for policy in ("first", "random"):
            kw = dict(steps=steps, seeds=seeds, policy=policy,
                      backend=backend)
            want, t_single, _ = _timed_traces(
                f"run_traces({name})", lambda: run_traces(system, **kw),
                backend, kernel, steps)
            row = {"run_traces_per_s": B / t_single}
            for tag, m, R in (("mesh4", mesh, DENSE_RANKS),
                              ("mesh_none", None, 1)):
                got, secs, n = _timed_traces(
                    f"run_traces_distributed({name}, {tag})",
                    lambda m=m: run_traces_distributed(system, mesh=m, **kw),
                    backend, kernel, R * steps)
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"[20] run_traces_distributed({name}, {policy}, "
                      f"{tag}) differs from run_traces")
                launches[kernel][f"traces_distributed_{tag}_{name}_"
                                 f"{policy}"] = n
                row[f"{tag}_per_s"] = B / secs
            figures[f"traces_{name}_{policy}"] = row
            log(f"[20] (c) {policy} traces of {name}, {B} seeds x {steps} "
                f"steps via {backend!r}: identical to run_traces at 4 ranks "
                f"and at one; traces/s run_traces "
                f"{row['run_traces_per_s']:.1f}, 4 ranks "
                f"{row['mesh4_per_s']:.1f}, one rank "
                f"{row['mesh_none_per_s']:.1f}")

    # (d) the service over the trace mesh, and the launcher's mesh line
    dense = compile_system(pi, device="cuda")
    n = SERVICE["requests"]
    calls = n // SERVICE["batch"]
    cards = trace_mesh()
    served, stats, counts, figures["service_trace_mesh"] = _serve(
        "20", f"service scaled_pi(682) over trace_mesh() ({len(cards)} "
        "card(s))", dense, "cuda", "B1", n,
        runner=make_trace_runner(mesh=cards),
        want_launches=len(cards) * calls * SERVICE["steps"])
    check(stats["device_calls"] == calls and stats["traces_served"] == n,
          f"[20] trace-mesh service stats {stats}")
    launches["B1"]["service_trace_mesh"] = counts["B1"]
    figures["service_trace_mesh"].update(_same_traces(
        "20", "service over the trace mesh", served, dense, "cuda",
        list(range(n)), figures["service_trace_mesh"]["flush_ms"]))
    four = trace_mesh([cards[0]] * DENSE_RANKS)
    served4, stats, counts, figures["service_trace_mesh_4_ranks"] = _serve(
        "20", "service scaled_pi(682) over 4 ranks of the card", dense,
        "cuda", "B1", n, runner=make_trace_runner(mesh=four),
        want_launches=DENSE_RANKS * calls * SERVICE["steps"])
    check(all(_same_results(served4[s], served[s]) for s in served),
          "[20] the 4-rank service differs from the trace-mesh service")
    launches["B1"]["service_trace_mesh_4_ranks"] = counts["B1"]
    log(f"[20] (d) the service over 4 ranks of the card: all {n} results "
        "identical to the trace-mesh service's")
    del served, served4
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        got = serve_main(["--snp", "--requests", "256", "--batch", "64",
                          "--gen", "32"])
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("[20] launcher --snp over the trace mesh", counts, B1=None)
    launches["B1"]["launcher_snp_trace_mesh"] = counts["B1"]
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[20] launcher | {line}")
    check(lines and lines[0].startswith(
        f"[serve-snp] mesh {torch.cuda.device_count()}-device, batch 64")
        and got["served"] == 256 and got["mesh"] == [str(d) for d in cards],
        f"[20] the launcher's set-up line {lines[:1]}, served "
        f"{got['served']}/256")

    # (e) a checkpointed dense-row explore, killed at chunk 2, resumed
    res, n_b1, figures["checkpointed_dense_row_explore"] = _supervised(
        "20", "explore_distributed(scaled_pi(682)), dense rows, 4 ranks, "
        "via 'cuda', checkpoint_every=2",
        lambda d, inj: explore_distributed(
            pi, mesh=mesh, backend="cuda", checkpoint_dir=d,
            checkpoint_every=2, fault_injector=inj, **DENSE_ROWS),
        "B1", DENSE_RANKS * dense_rows.steps)
    check(_same_explore(res, dense_rows),
          "[20] the resumed dense-row explore differs from (a)'s")
    launches["B1"]["checkpointed_dense_row_explore"] = n_b1
    log(f"[20] (e) resumed dense-row explore identical to (a)'s "
        f"({res.num_discovered} rows)")
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# Phase 21: the zero-host-sync BFS and the hash-table kernels H1 and H2
# ---------------------------------------------------------------------------

# (b): random_system(9, 2, 0.3, seed=9) drains at level 4 of 32 (hash
# dedup named: at these caps "auto" would sort)
DRAIN = dict(max_steps=32, frontier_cap=64, visited_cap=512, max_branches=64)
# (d): the full-width B1 explore in chunks of 3 levels: 3 chunks of 8
CKPT_EVERY = 3
# (c): the full-width wave against a table of FULL_WIDTH's capacity, this
# many keys present
PROBE_PRESENT = 100_000
PROBE_D = 64


def _probe_launches(scheme, F, T, V, units=1, send_cap=None):
    """H1's bodies' and H2's routes' launches in a hash-dedup run, by
    launch-count key, as a function of its levels ``w``.  ``scheme``:
    ``"explore"`` (the level's rows hashed and looked up in one H1 launch,
    the initial config's hash), ``"sort"`` (its hashes only),
    ``"sharded"`` over ``units`` shards (Zobrist keys from the shards'
    slices, looked up by keys), ``"dense"`` over ``units`` ranks (each
    rank's rows hashed, then its received keys looked up).  A table a
    unit: a first occurrence a level (H2's route for its candidates, F·T
    or the ranks' ``units·send_cap``), an insert of up to F keys a level
    and one at the start."""
    from collections import Counter

    from repro_torch.core import table_slots
    from repro_torch.core.hashtable import _probes
    from repro_torch.kernels.hashtable.ops import claim_route

    if scheme == "sort":
        return lambda w: Counter({("H1", "hash"): w + 1})
    K = units * send_cap if scheme == "dense" else F * T
    S, S_v = table_slots(K), table_slots(V)
    first = ("H2", claim_route(K, S, _probes(S, None), True).name)
    insert = ("H2", claim_route(F, S_v, _probes(S_v, None), False).name)
    look = {"explore": {("H1", "rows"): 1}, "sharded": {("H1",): units},
            "dense": {("H1", "hash"): units, ("H1",): units}}[scheme]
    once = {("H1", "hash"): 1} if scheme != "sharded" else {}

    def launches(w):
        n = Counter(once)
        n.update({k: v * w for k, v in look.items()})
        n.update({first: units * w})
        n.update({insert: units * (w + 1)})
        return n
    return launches


def _send_cap(caps, R):
    """The dense-row scheme's send slots a rank for ``caps`` over ``R``
    ranks (``core/distributed.py``'s default)."""
    return caps.get("send_cap") or max(
        16, caps["frontier_cap"] * caps["max_branches"] // R)


def probe_counts():
    """Launches of H1's bodies and H2's routes since :func:`reset_counts`,
    by launch-count key (every key, 0 where none ran)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.hashtable.ops import KEYS
    ran = launch_counts.read()
    return {k: ran.get(k, 0) for k in KEYS}


def _keyed(counts):
    """A counter of launch-count keys as ``"H1/rows"``-style names."""
    return {"/".join(k): n for k, n in counts.items() if n}


def _synced_run(label, run, want, archive, probes=None):
    """``run()``, one un-checkpointed explore, inside ``sync_check()``: its
    launches (``want``: kernel -> launches, or a function of the levels;
    ``probes``: H1's bodies and H2's routes by key, a function of the
    levels), at most 2 host reads, its archive that of
    ``ARCHIVES[archive]``; then the profiler's device time of another run.
    Returns its figures."""
    import torch
    from repro_torch.core import device as devmod
    from repro_torch.kernels.launch_counts import by_kernel

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    devmod.host_reads = 0
    t0 = time.perf_counter()
    with devmod.sync_check():
        res = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, reads, keyed = read_counts(), devmod.host_reads, probe_counts()
    peak = torch.cuda.max_memory_allocated()
    waves = res.steps
    expect = {k: (v(waves) if callable(v) else v) for k, v in want.items()}
    if probes is not None:
        wkeys = probes(waves)
        check(all(keyed[k] == wkeys.get(k, 0) for k in keyed),
              f"[21] {label}: H1/H2 launches by body {_keyed(keyed)}, "
              f"expected {_keyed(wkeys)}")
        expect.update({k: by_kernel(wkeys).get(k, 0) for k in PROBE_KERNELS})
    check_counts(f"[21] {label}", counts, **expect)
    check(reads <= 2, f"[21] {label}: {reads} host reads, expected <= 2")
    check(_digest(res) == ARCHIVES[archive],
          f"[21] {label}: the archive differs from the earlier phase's "
          f"({archive})")
    # every level runs once on the card (the first eagerly, the rest in
    # the graph), so the device time divides by the levels alone
    dev_ms = device_ms(run, 1)
    fig = dict(waves=waves, host_reads=reads, waves_per_s=waves / secs,
               wall_ms_per_level=secs * 1e3 / waves,
               device_ms_per_level=dev_ms / waves,
               device_busy_share=dev_ms / (secs * 1e3),
               peak_gib=peak / 2**30,
               launches={k: counts[k] for k in expect},
               launches_by_body=_keyed(keyed))
    log(f"[21] {label}: sync check passed, {reads} host reads in {waves} "
        f"waves (phase 5-20 figure: 16-77.75 a wave), {secs:.3f} s = "
        f"{fig['waves_per_s']:.3f} waves/s, wall "
        f"{fig['wall_ms_per_level']:.3f} ms a level (the eager first level "
        f"and the capture included) against "
        f"{fig['device_ms_per_level']:.3f} device ms a level (profiler, "
        f"{dev_ms:.3f} ms over {waves} levels), "
        f"archive identical to {archive!r} ({res.num_discovered} rows), "
        f"launches {json.dumps(fig['launches'])}, H1/H2 by body "
        f"{json.dumps(fig['launches_by_body'])}, max_memory_allocated "
        f"{fig['peak_gib']:.3f} GiB")
    return fig


def _zero_sync_explores():
    """(a): the un-checkpointed full-width explores of phases 5-20 inside
    the sync check.  Returns ({kernel: {path: launches}}, figures)."""
    import torch
    from repro_torch.core import (SystemPlan, compile_sharded,
                                  compile_system, compile_system_sparse,
                                  explore, get_backend, resolve_dedup,
                                  with_delays)
    from repro_torch.core.distributed import explore_distributed
    from repro_torch.core.generators import power_law, scaled_pi
    from repro_torch.sharding import neuron_axis

    k3 = (lambda k, r: k % 3)
    pi, hubby = scaled_pi(682), power_law(8192, 4, seed=2)
    hplan = SystemPlan.for_system(hubby)
    dhub = with_delays(hubby, k3)
    dplan = SystemPlan.for_system(dhub, semantics="delays")
    # compiled here, outside the check: lowering copies host arrays
    comps = {
        "dense": lambda: compile_system(pi, device="cuda"),
        "ell": lambda: compile_system_sparse(pi, device="cuda"),
        "hybrid": lambda: compile_system_sparse(
            hubby, hub_threshold=hplan.hub_threshold, device="cuda"),
        "delayed": lambda: compile_system(with_delays(pi, k3),
                                          semantics="delays", device="cuda"),
        "delayed_ell": lambda: compile_system_sparse(
            with_delays(pi, k3), semantics="delays", device="cuda"),
        "delayed_hybrid": lambda: compile_system_sparse(
            dhub, hub_threshold=dplan.hub_threshold, semantics="delays",
            device="cuda")}
    # (path, compiled, backend, step kernel, caps, archive key)
    runs = [
        ("zero_sync_full_width_explore", "dense", "cuda", "B1", FULL_WIDTH,
         "scaled_pi(682)"),
        ("zero_sync_ref_explore", "dense", "ref", None, FULL_WIDTH,
         "scaled_pi(682)"),
        ("zero_sync_ell_explore", "ell", "sparse_cuda", "B2", FULL_WIDTH,
         "scaled_pi(682)"),
        ("zero_sync_hybrid_explore", "hybrid", "sparse_cuda", "B3",
         FULL_WIDTH, "power_law(8192)"),
        ("zero_sync_sparse_hybrid_explore", "hybrid", "sparse", None,
         FULL_WIDTH, "power_law(8192)"),
        ("zero_sync_delayed_explore", "delayed", "cuda", "B4", FULL_WIDTH,
         "scaled_pi(682) d=k%3"),
        ("zero_sync_delayed_ell_explore", "delayed_ell", "sparse_cuda",
         "B5-ELL", FULL_WIDTH, "scaled_pi(682) d=k%3"),
        ("zero_sync_delayed_hybrid_explore", "delayed_hybrid",
         "sparse_cuda", "B5-COO", DELAY_HYBRID, "power_law(8192) d=k%3")]
    launches = {}
    figures = {}

    def note(path, fig):
        figures[path] = fig
        for k, n in fig["launches"].items():
            launches.setdefault(k, {})[path] = n

    built = {}
    for path, key, backend, kernel, caps, archive in runs:
        if key not in built:
            built.clear()
            torch.cuda.empty_cache()
            built[key] = comps[key]()
        comp = built[key]
        # the delayed hybrid's 65,536-row archive resolves to sort dedup:
        # no table, so no probe but H1's hash body
        sort = resolve_dedup("auto", frontier_cap=caps["frontier_cap"],
                             visited_cap=caps["visited_cap"],
                             max_branches=caps["max_branches"]) == "sort"
        probes = _probe_launches("sort" if sort else "explore",
                                 caps["frontier_cap"], caps["max_branches"],
                                 caps["visited_cap"])
        note(path, _synced_run(
            f"{path}: explore({archive}) via {backend!r}",
            lambda: explore(comp, backend=backend, **caps),
            {kernel: lambda w: w} if kernel else {}, archive, probes))
    built.clear()
    torch.cuda.empty_cache()

    S = 4
    for part in ("contiguous", "degree"):
        comp = compile_sharded(pi, neuron_axis(S, partition=part),
                               device="cuda")
        lowered = get_backend("cuda").lower(comp, comp.plan)
        for backend, kernel, c in (("cuda", "B6", lowered),
                                   ("sparse_cuda", "B7", comp)):
            path = f"zero_sync_sharded_{part}_explore"
            note(f"{path}_{kernel}", _synced_run(
                f"{path}: explore_distributed(scaled_pi(682), "
                f"neuron_axis(4, {part})) via {backend!r}",
                lambda: explore_distributed(c, backend=backend, **SHARDED),
                {kernel: lambda w: S * w},
                f"scaled_pi(682) neuron_axis(4, {part})",
                _probe_launches("sharded", SHARDED["frontier_cap"],
                                SHARDED["max_branches"],
                                SHARDED["visited_cap"], S)))
        del comp, lowered
        torch.cuda.empty_cache()

    dense = comps["dense"]()
    R = DENSE_RANKS
    note("zero_sync_dense_row_explore", _synced_run(
        "zero_sync_dense_row_explore: explore_distributed(scaled_pi(682)), "
        f"dense rows, {R} ranks via 'cuda'",
        lambda: explore_distributed(dense, mesh=["cuda"] * R,
                                    backend="cuda", **DENSE_ROWS),
        {"B1": lambda w: R * w}, "scaled_pi(682) dense rows R=4",
        _probe_launches("dense", DENSE_ROWS["frontier_cap"],
                        DENSE_ROWS["max_branches"], DENSE_ROWS["visited_cap"],
                        R, _send_cap(DENSE_ROWS, R))))
    del dense
    torch.cuda.empty_cache()
    return launches, figures


def _drained_tree():
    """(b): a tree that drains before ``max_steps``, on the card (inside
    the sync check) and on the CPU: the same archive and steps, and each
    kernel's launches equal to its plain version's calls (H1's bodies
    and H2's routes key by key)."""
    import numpy as np
    from repro_torch.core import compile_system, explore
    from repro_torch.core.device import sync_check
    from repro_torch.core.generators import random_system
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.launch_counts import by_kernel
    from repro_torch.kernels.snp_step import ops

    system = random_system(9, 2, 0.3, seed=9)
    ops.plain_calls = 0
    ht_ops.plain_calls.clear()
    cpu = explore(compile_system(system, device="cpu"), backend="cuda",
                  device="cpu", dedup="hash", **DRAIN)
    plain_keyed = {k: ht_ops.plain_calls[k] for k in ht_ops.KEYS}
    plain = dict(B1=ops.plain_calls, **by_kernel(plain_keyed))
    comp = compile_system(system, device="cuda")
    reset_counts()
    with sync_check():
        card = explore(comp, backend="cuda", dedup="hash", **DRAIN)
    counts, keyed = read_counts(), probe_counts()
    check(card.steps == cpu.steps < DRAIN["max_steps"] and card.exhausted
          and cpu.exhausted, f"[21] (b) the tree did not drain alike: "
          f"{card.steps}/{cpu.steps} steps, exhausted {card.exhausted}/"
          f"{cpu.exhausted}")
    check(np.array_equal(card.configs, cpu.configs),
          "[21] (b) the drained tree's archive differs from the CPU's")
    check_counts("[21] (b) drained tree", counts, **plain)
    check(keyed == plain_keyed, f"[21] (b) H1/H2 launches by body "
          f"{_keyed(keyed)}, the CPU run's plain calls {_keyed(plain_keyed)}")
    log(f"[21] (b) random_system(9, 2, 0.3, seed=9) drains at level "
        f"{card.steps} of {DRAIN['max_steps']} on the card as on the CPU "
        f"({card.num_discovered} configs); launches "
        f"{json.dumps({k: counts[k] for k in plain})} "
        f"(H1/H2 by body {json.dumps(_keyed(keyed))}) equal the CPU run's "
        f"plain calls")
    return {k: counts[k] for k in plain}


def _fmix_np(x):
    import numpy as np
    M = np.uint64(0xFFFFFFFF)
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & M
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(0xC2B2AE35)) & M
    return x ^ (x >> np.uint64(16))


def _forged_keys(rng, S, slot, n):
    """``n`` distinct keys (hi, lo int64) whose chains start at ``slot`` of
    a table of ``S`` slots (H1's and H2's base slot)."""
    import numpy as np
    found = []
    while sum(len(f) for f in found) < n:
        k = rng.integers(0, 2**32, size=(2, 1 << 22), dtype=np.uint64)
        mixed = _fmix_np(k[0] ^ ((k[1] * np.uint64(0x9E3779B1))
                                 & np.uint64(0xFFFFFFFF)))
        found.append(k[:, (mixed & np.uint64(S - 1)) == slot])
    keys = np.concatenate(found, 1)[:, :n].astype(np.int64)
    return keys


def _probe_reads(s_hi, s_lo, hi, lo, pending, D, claim):
    """``(reads, rounds)``: the slots H1 (``claim`` False) or H2 reads for
    these keys, one a pending candidate a probe or a round, and the probes
    or rounds run, counted by the plain versions' loops (for the bound)."""
    import torch
    from repro_torch.kernels.hashtable.ref import base_slot
    S, K = s_hi.shape[0], hi.shape[0]
    SENT = 0xFFFFFFFF
    base = base_slot(hi, lo, S)
    pending, reads, rounds = pending.clone(), 0, 0
    probe = torch.zeros_like(hi)
    idx = torch.arange(K, device=hi.device)
    s_hi, s_lo = s_hi.clone(), s_lo.clone()
    for _ in range(2 * D + 1 if claim else D):
        if not bool(pending.any()):
            break
        reads += int(pending.sum())
        rounds += 1
        slot = (base + probe) & (S - 1)
        ch, cl = s_hi[slot], s_lo[slot]
        match = pending & (ch == hi) & (cl == lo)
        empty = (ch == SENT) & (cl == SENT)
        if not claim:
            pending &= ~match & ~empty
            probe = probe + 1
            continue
        try_claim = pending & ~match & empty
        cw = torch.full((S,), K, dtype=torch.int64, device=hi.device)
        cw.scatter_reduce_(0, slot, torch.where(try_claim, idx, K), "amin")
        win = try_claim & (cw[slot] == idx)
        w = cw.clamp(max=K - 1)
        s_hi = torch.where(cw < K, hi[w], s_hi)
        s_lo = torch.where(cw < K, lo[w], s_lo)
        probe = probe + (pending & ~match & ~empty)
        pending = pending & ~match & ~win & ~(probe >= D)
    return reads, rounds


def _probe_bound_ms(K, reads, won, claim):
    """The least time for H1 or H2's work at 3.35 TB/s: the keys (16 B), a
    mask byte (and H2's payload, 4 B) read once a candidate, 16 B a slot
    read (H1 also the 4-byte payload of a hit), and the outputs written
    once (H1: found and payload, 5 B a candidate; H2: won and dup, 2 B a
    candidate, 20 B a slot won).  H2's claim words are its own scratch,
    not work the function needs, so they are not counted."""
    if claim:
        nbytes = K * (16 + 1 + 4) + reads * 16 + K * 2 + won * 20
    else:
        nbytes = K * (16 + 1) + reads * 16 + won * 4 + K * 5
    return nbytes / 3.35e12 * 1e3, nbytes


def _replay_ms(fn, reps=20, iters=10):
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in a
    CUDA graph, its replay timed by CUDA events (no host work between the
    launches).  The profiler showed no device event for H1's and H2's
    launches outside a graph in this phase, so their device time is
    taken this way."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin()
        for _ in range(reps):
            fn()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    ms = time_ms(g.replay, iters) / reps
    g.reset()
    return ms


# (c): H1's forged rows: (K, w) at odd and wide widths, each row at its own
# alignment (w odd) or a buffer offset of 1-3 entries; K=9000 gives a warp
# a row, the others a block
H1_FORGED = [(24, 1), (24, 31), (9000, 31), (24, 2046), (24, 6138)]


def _probe_kernels():
    """(c): H1's bodies and H2's routes against their plain versions, bit
    for bit, on forged and synthetic inputs (the waves' real blocks are
    checked in phases 5-11, :func:`_probe_wave`).  Returns ({kernel:
    max_abs_err over every case}, {kernel: wave figures})."""
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.core import make_table, table_slots
    from repro_torch.core.hashing import config_hash_ref
    from repro_torch.core.hashtable import _canonical, _empty
    from repro_torch.kernels.hashtable import ops as ht_ops
    from repro_torch.kernels.hashtable.ref import claim_ref, lookup_ref

    t0 = time.perf_counter()
    dev = torch.device(CARD)
    rng = np.random.default_rng(21)
    D = PROBE_D
    cases = 0
    errs = {"H1": 0, "H2": 0}
    routes = Counter()

    def t(x, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    def same(kernel, label, got, want):
        _same_bits(errs, kernel, f"[21] (c) {label}", got, want)

    def route_of(K, S, d, fresh):
        r = ht_ops.claim_route(K, S, d, fresh)
        routes[f"{r.name}{r.ctas if r.name == 'cluster' else ''}"] += 1
        return r.name

    def claim_both(label, table, hi, lo, pend, pay, d=D):
        """H2 on a copy of ``table`` against the plain version, the
        table's three tensors included; returns the kernel's table and
        outputs."""
        nonlocal cases
        name = route_of(hi.shape[0], table[0].shape[0], d, False)
        k_tab = tuple(x.clone() for x in table)
        won, dup, ovf = ht_ops.claim_(*k_tab, hi, lo, pend, pay, d)
        same("H2", f"{label} ({name})", (*k_tab, won, dup, ovf),
             claim_ref(*table, hi, lo, pend, pay, d))
        cases += 1
        return k_tab, won, dup, ovf

    def first_both(label, hi, lo, pend, d=D):
        """H2 into a fresh table of its own against the plain version on
        an empty one."""
        nonlocal cases
        K = hi.shape[0]
        S = table_slots(max(K, 1))
        name = route_of(K, S, d, True)
        got = ht_ops.first_claim(hi, lo, pend, S, d)
        same("H2", f"{label} ({name}, fresh)", got,
             claim_ref(*_empty(S, 0, dev), hi, lo, pend,
                       torch.zeros(K, dtype=torch.int32, device=dev), d)[3:])
        cases += 1
        return got

    def lookup_both(label, table, hi, lo, valid):
        nonlocal cases
        got = ht_ops.lookup(*table, hi, lo, valid, D)
        same("H1", f"{label} (keys)", got,
             lookup_ref(*table, hi, lo, valid, D))
        cases += 1
        return got

    # the synthetic full-width wave against a table of 262,144 keys'
    # capacity (the case the grid design was first timed on)
    V = FULL_WIDTH["visited_cap"]
    S = table_slots(V)
    tab = make_table(V, dev)
    base = (tab.slots_hi, tab.slots_lo, tab.slot_payload)
    keys = rng.integers(0, 2**32, size=(2, PROBE_PRESENT), dtype=np.uint64)
    keys = keys.astype(np.int64)
    present = (t(keys[0]), t(keys[1]))
    n = PROBE_PRESENT
    filled, won, _, _ = claim_both(
        f"{n} keys into {S} slots", base, *present,
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev))
    check(bool(won.all()), "[21] (c) a present key was not inserted")
    K = FULL_WIDTH["frontier_cap"] * FULL_WIDTH["max_branches"]
    F = FULL_WIDTH["frontier_cap"]
    fresh = rng.integers(0, 2**32, size=(2, K // 4), dtype=np.uint64)
    pick = rng.integers(0, n, size=K // 2)
    wave = np.concatenate([keys[:, pick], fresh.astype(np.int64)], 1)
    wave = np.concatenate([wave, wave[:, rng.integers(0, wave.shape[1],
                                                      size=K // 4)]], 1)
    wave = wave[:, rng.permutation(K)]
    hi, lo = t(wave[0]), t(wave[1])
    valid = t(rng.random(K) < 0.9, torch.bool)
    found, _ = lookup_both("the full-width wave", filled, hi, lo, valid)
    S2 = table_slots(K)
    zero = torch.zeros(K, dtype=torch.int32, device=dev)
    _, first, _, _ = claim_both("first occurrence at the wave, into a given "
                                "table", _empty(S2, 0, dev), hi, lo,
                                valid, zero)
    first_both("first occurrence at the wave", hi, lo, valid)
    ins = valid & first & ~found
    pay = torch.arange(n, n + K, dtype=torch.int32, device=dev)
    claim_both("insert of the wave", filled, hi, lo, ins, pay)
    # the level's insert: the first F new keys into the held table
    sel = torch.sort((~ins).to(torch.uint8), stable=True).indices[:F]
    f_hi, f_lo, f_ins = hi[sel], lo[sel], ins[sel]
    f_pay = torch.arange(F, dtype=torch.int32, device=dev)
    claim_both(f"an F = {F} insert into {n} keys' table", filled, f_hi,
               f_lo, f_ins, f_pay)
    # max_probes 2: each route overflows
    _, _, _, o1 = claim_both("the wave's first occurrence, max_probes 2",
                             _empty(S2, 0, dev), hi, lo, valid, zero, 2)
    _, _, o2 = first_both("the wave's first occurrence, max_probes 2", hi,
                          lo, valid, 2)
    _, _, _, o3 = claim_both(f"{n} keys, max_probes 2", base, *present,
                             torch.ones(n, dtype=torch.bool, device=dev),
                             torch.arange(n, dtype=torch.int32, device=dev),
                             2)
    # the cluster at its most: 131,072 keys (a quarter repeated) into
    # 262,144 slots, 8,192 a block; their first 65,536, and those into a
    # given table of 131,072 slots on the grid
    big = rng.integers(0, 2**32, size=(2, 1 << 17), dtype=np.uint64)
    big[:, 3::4] = big[:, rng.integers(0, 1 << 17, size=(1 << 17) // 4)]
    b_hi, b_lo = t(big[0].astype(np.int64)), t(big[1].astype(np.int64))
    b_pend = t(rng.random(1 << 17) < 0.95, torch.bool)
    first_both("131,072 keys' first occurrence", b_hi, b_lo, b_pend)
    h_hi, h_lo, h_pend = (x[:1 << 16].contiguous()
                          for x in (b_hi, b_lo, b_pend))
    first_both("65,536 keys' first occurrence", h_hi, h_lo, h_pend)
    claim_both("65,536 keys into 131,072 slots",
               _empty(1 << 17, 0, dev), h_hi, h_lo, h_pend,
               torch.arange(1 << 16, dtype=torch.int32, device=dev))
    # a probe bound past the cluster's claim words: the grid
    first_both("16,384 keys' first occurrence, max_probes 16,384",
               h_hi[:1 << 14].contiguous(), h_lo[:1 << 14].contiguous(),
               h_pend[:1 << 14].contiguous(), 1 << 14)
    # the grid route's fresh table: 262,144 keys' first occurrence
    g = rng.integers(0, 2**32, size=(2, 1 << 18), dtype=np.uint64)
    g[:, 1::2] = g[:, rng.integers(0, 1 << 18, size=1 << 17)]
    first_both("262,144 keys' first occurrence", t(g[0].astype(np.int64)),
               t(g[1].astype(np.int64)),
               torch.ones(1 << 18, dtype=torch.bool, device=dev))

    # forged keys on one base slot of a 1,024-slot table: 100 chains past
    # the 64-probe bound
    Sf = table_slots(512)
    forged = _forged_keys(rng, Sf, 7, 100)
    fh, fl = t(forged[0]), t(forged[1])
    ones = torch.ones(100, dtype=torch.bool, device=dev)
    ftab, fwon, _, fovf = claim_both(
        "100 forged keys on one base slot", _empty(Sf, 0, dev), fh, fl,
        ones, torch.arange(100, dtype=torch.int32, device=dev))
    check(bool(fovf) and int(fwon.sum()) == D,
          f"[21] (c) forged chain: {int(fwon.sum())} inserted, overflow "
          f"{bool(fovf)}; expected {D} and an overflow")
    lookup_both("the forged keys", ftab, fh, fl, ones)
    claim_both("the forged keys again (duplicates)", ftab, fh, fl, ones,
               torch.zeros(100, dtype=torch.int32, device=dev))
    _, _, o4 = first_both("the forged keys, max_probes 2", fh, fl, ones, 2)
    check(all(bool(o) for o in (o1, o2, o3, o4)),
          "[21] (c) max_probes 2 did not overflow on every route")

    # equal keys in one batch: the lowest index of each group wins
    groups = rng.integers(0, 2**32, size=(2, 300), dtype=np.uint64)
    which = rng.integers(0, 300, size=4096)
    eq = groups[:, which].astype(np.int64)
    eh, el = t(eq[0]), t(eq[1])
    e_all = torch.ones(4096, dtype=torch.bool, device=dev)
    _, ewon, _, _ = claim_both(
        "4,096 keys of 300 distinct", _empty(table_slots(4096), 0, dev),
        eh, el, e_all, torch.zeros(4096, dtype=torch.int32, device=dev))
    lowest = np.unique(which, return_index=True)[1]
    check(np.array_equal(np.flatnonzero(ewon.cpu().numpy()), np.sort(lowest)),
          "[21] (c) equal keys: the winners are not each group's lowest "
          "index")
    first_both("4,096 keys of 300 distinct", eh, el, e_all)
    check(set(routes) >= {"cta", "cluster16", "grid"},
          f"[21] (c) not every H2 route ran: {dict(routes)}")

    # H1's bodies on forged rows: negative entries, invalid rows, rows at
    # every alignment, a table holding every other valid row's key, at
    # max_probes 64, 1 and 2
    rows_cases = 0
    for K_f, w in H1_FORGED:
        for off in (0, 1, 3):
            buf = rng.integers(-2**31, 2**31, size=K_f * w + off,
                               dtype=np.int64).astype(np.int32)
            rows = t(buf, torch.int32)[off:].view(K_f, w)
            fvalid = t(rng.random(K_f) < 0.8, torch.bool)
            raw = config_hash_ref(rows)
            same("H1", f"hash body, {K_f} x {w} at offset {off}",
                 ht_ops.config_hash(rows), raw)
            h, lw = _canonical(*raw, fvalid)
            ftab = make_table(16 if K_f < 100 else 4096, dev)
            held = fvalid & (torch.arange(K_f, device=dev) % 2 == 0)
            ht_ops.claim_(ftab.slots_hi, ftab.slots_lo, ftab.slot_payload,
                          h, lw, held, torch.arange(K_f, dtype=torch.int32,
                                                    device=dev), D)
            ft = (ftab.slots_hi, ftab.slots_lo, ftab.slot_payload)
            for d in (D, 1, 2):
                same("H1", f"rows body, {K_f} x {w} at offset {off}, "
                     f"max_probes {d}", ht_ops.hash_lookup(*ft, rows, fvalid,
                                                           d),
                     (h, lw, lookup_ref(*ft, h, lw, fvalid, d)[0]))
                rows_cases += 1
    cases += rows_cases

    # figures: H1 at the scaled_pi(682) wave's real block (phase 5), H2's
    # cluster route at its first occurrence; H2's cta route at the level's
    # insert and its grid route at the synthetic wave's
    rows = {}
    main = WAVE_PROBES["scaled_pi(682)"]
    others = {wv: {b: WAVE_PROBES[wv][b] for b in ("rows", "hash", "keys",
                                                   "first")}
              for wv in EAGER_HASH_MS if wv in WAVE_PROBES}
    rows["H1"] = dict(main["rows"], K=main["K"], w=main["w"],
                      hash_body=main["hash"], keys_body=main["keys"],
                      waves=others)
    copy = tuple(x.clone() for x in filled)

    def restore():
        for a, b in zip(copy, filled):
            a.copy_(b)

    def cta():
        restore()
        ht_ops.claim_(*copy, f_hi, f_lo, f_ins, f_pay, D)

    def grid():
        restore()
        ht_ops.claim_(*copy, hi, lo, ins, pay, D)

    restore_ms = _replay_ms(restore)
    f_reads = _probe_reads(*filled[:2], f_hi, f_lo, f_ins, D, True)[0]
    g_reads = _probe_reads(*filled[:2], hi, lo, ins, D, True)[0]
    cta_fig = dict(
        device_ms=_replay_ms(cta) - restore_ms,
        bound_ms=_probe_bound_ms(F, f_reads, int(f_ins.sum()), True)[0],
        K=F, slots=S, slot_reads=f_reads)
    grid_fig = dict(
        device_ms=_replay_ms(grid) - restore_ms,
        bound_ms=_probe_bound_ms(K, g_reads, int(ins.sum()), True)[0],
        K=K, slots=S, slot_reads=g_reads,
        grid=list(ht_ops.claim_block_shape(K, S, D, False)))
    synth_fig = dict(
        device_ms=_replay_ms(lambda: ht_ops.first_claim(hi, lo, valid, S2,
                                                        D)),
        ms=time_ms(lambda: ht_ops.first_claim(hi, lo, valid, S2, D), 50),
        K=K, slots=S2)
    rows["H2"] = dict(main["first"], K=main["K"],
                      routes={"cta (the level's insert)": cta_fig,
                              "grid (the synthetic wave's insert)": grid_fig,
                              "cluster (the synthetic wave's first "
                              "occurrence)": synth_fig},
                      waves={wv: r["first"] for wv, r in others.items()})
    for k, r in rows.items():
        log(f"[21] (c) {k} at the scaled_pi(682) wave (K={r['K']}): "
            f"{r['device_ms']:.4f} ms on the card (20 calls in a graph, "
            f"replayed), {r['ms']:.4f} ms by events, plain version "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bytes']} bytes)")
    for name, r in rows["H2"]["routes"].items():
        log(f"[21] (c) H2 {name}: {r['device_ms']:.4f} ms on the card"
            + (f", bound {r['bound_ms']:.5f} ms" if "bound_ms" in r else ""))
    for wv in EAGER_HASH_MS:
        if wv in WAVE_PROBES:
            for k in ("H1", "H2"):
                errs[k] = max(errs[k], WAVE_PROBES[wv]["errs"][k])
    log(f"[21] (c) H1's three bodies and H2's routes bit-identical to their "
        f"plain versions in {cases} cases (and at the four waves' blocks, "
        f"phases 5-11): {n} keys into {S} slots, the synthetic full-width "
        f"wave (lookup, first occurrence fresh and into a table, insert), "
        f"an F = {F} insert, max_probes 2 on every route (each overflows), "
        f"131,072 and 65,536 keys on a cluster of 16, 65,536 into a table "
        f"on the grid, 16,384 at max_probes 16,384 and 262,144 keys' first "
        f"occurrence on the grid, 100 forged keys on one base slot of "
        f"{Sf}, 4,096 keys "
        f"of 300 (each group's lowest index wins), {rows_cases} forged row "
        f"blocks (widths {sorted({w for _, w in H1_FORGED})}, negative "
        f"entries, invalid rows, offsets 0/1/3); routes {dict(routes)}; "
        f"max_abs_err {json.dumps(errs)}; {time.perf_counter() - t0:.1f} s")
    return errs, rows


def _checkpointed():
    """(d): the full-width B1 explore checkpointed every CKPT_EVERY
    levels: one read a chunk, the archive of phase 5."""
    import math
    import shutil
    import tempfile

    import torch
    from repro_torch.core import compile_system, explore
    from repro_torch.core import device as devmod
    from repro_torch.core.generators import scaled_pi
    from repro_torch.kernels.launch_counts import by_kernel

    comp = compile_system(scaled_pi(682), device="cuda")
    d = tempfile.mkdtemp(prefix="snp-zero-sync-")
    try:
        torch.cuda.synchronize()
        reset_counts()
        devmod.host_reads = 0
        t0 = time.perf_counter()
        res = explore(comp, backend="cuda", checkpoint_dir=d,
                      checkpoint_every=CKPT_EVERY, **FULL_WIDTH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, reads = read_counts(), devmod.host_reads
    finally:
        shutil.rmtree(d, ignore_errors=True)
    chunks = math.ceil(res.steps / CKPT_EVERY)
    check(reads == chunks + 2, f"[21] (d) {reads} host reads for {chunks} "
          "chunks; expected one a chunk and two at the end")
    check(_digest(res) == ARCHIVES["scaled_pi(682)"],
          "[21] (d) the checkpointed archive differs from phase 5's")
    keyed = probe_counts()
    wkeys = _probe_launches("explore", FULL_WIDTH["frontier_cap"],
                            FULL_WIDTH["max_branches"],
                            FULL_WIDTH["visited_cap"])(res.steps)
    check(all(keyed[k] == wkeys.get(k, 0) for k in keyed),
          f"[21] (d) H1/H2 launches by body {_keyed(keyed)}, expected "
          f"{_keyed(wkeys)}")
    want = dict(B1=res.steps, **by_kernel(wkeys))
    check_counts("[21] (d) checkpointed explore", counts, **want)
    log(f"[21] (d) explore(scaled_pi(682)) via 'cuda' checkpointed every "
        f"{CKPT_EVERY} levels: {res.steps} levels in {chunks} chunks, "
        f"{reads} host reads ({chunks} chunks + 2 at the end), "
        f"{secs:.3f} s, archive identical to phase 5's, launches "
        f"{json.dumps(want)}")
    return {k: counts[k] for k in want}


def phase_zero_sync():
    """Phase 21 (module docstring).  Returns ({kernel: {path: launches}},
    {kernel: max_abs_err} of H1 and H2, their wave figures, the explores'
    figures)."""
    import torch
    log(f"[21] the level loop: one CUDA graph, a conditional WHILE node "
        f"around one captured level (core/csrc/graph_loop.cu; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}); no other route")
    launches, figures = _zero_sync_explores()
    for k, n in _drained_tree().items():
        launches.setdefault(k, {})["zero_sync_drained_tree"] = n
    err, rows = _probe_kernels()
    for k, n in _checkpointed().items():
        launches.setdefault(k, {})["zero_sync_checkpointed_explore"] = n
    return launches, err, rows, figures


# ---------------------------------------------------------------------------
# Phase 22: every LM family served at its published widths
# ---------------------------------------------------------------------------

# arch: (depth or None = the published depth, batch, prompt, decode
# steps, the f32 twin's depth or None = the published depth).  Depth
# cuts: rwkv6-7b to 8 of 32 layers (time); qwen2-moe's f32 twin to 8 of
# 24 (57 GB of f32 weights at full depth); jamba and grok run their
# reduced siblings (FAMILY_REDUCED): neither fits one card at its
# published width (one jamba period's four MoE layers hold 4 x 16
# experts x 3 x 8192 x 24576 bf16 weights, about 77 GB; one grok layer,
# 8 x 3 x 6144 x 32768, about 9.7 GB, 64 of them).
FAMILIES = {
    "qwen2-moe-a2.7b": (None, 4, 1024, 16, 8),
    "minicpm3-4b": (None, 4, 1024, 8, None),
    "musicgen-medium": (None, 4, 1024, 8, None),
    "rwkv6-7b": (8, 4, 1024, 8, 8),
}
FAMILY_REDUCED = {
    "jamba-1.5-large-398b": (4, 256, 8),
    "grok-1-314b": (4, 256, 8),
}
# The f32 twins' batch (phase 17's f32 twin's).
TWIN_BATCH = 2
# Families whose bf16 decode is not held to the bf16 bound against a
# prefill of S+1 tokens: minicpm3-4b's 62 MLA layers, whose decode
# expands the latent cache anew every step and rounds its softmax
# numerators to bf16 as the reference's does, drift 5.72% of max |logit|
# from the prefill in bf16 and 1.104e-05 in f32 at the same width, depth
# and batch (probes/family_precision.py, NVIDIA H100 80GB HBM3, 700 W).
# Its f32 twin holds the f32 bound, as every family's does.
BF16_DRIFT = ("minicpm3-4b",)
# the launcher's subprocess runs, on each arch's reduced sibling
FAMILY_LAUNCHES = ("qwen2-moe-a2.7b", "musicgen-medium")
PEAK_LIMIT_BYTES = 60e9


def family_config(arch, depth=None, small=False):
    """The config phase 22 serves: the published one, its depth cut to
    ``depth`` layers, or (``small``) its reduced sibling."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import reduced
    cfg = get_config(arch)
    if small:
        return reduced(cfg)
    return cfg if depth is None else dataclasses.replace(
        cfg, num_layers=depth)


def _b8_launches(cfg):
    """B8's launches in one prefill through ``attn_impl="cuda"``, by body:
    one a GQA attention layer (MLA sends no prefill with a cache to B8, as
    the reference routes it)."""
    import torch
    if cfg.attention == "mla" or "attn" not in cfg.mixer_kinds:
        return {}
    n = cfg.num_periods * sum(k == "attn" for k in cfg.mixer_kinds)
    return {_body(getattr(torch, cfg.dtype), cfg.head_dim): n}


def _extend(batch, nxt, S):
    """The prompt and one more token per row: teacher forcing's batch."""
    import torch
    B = batch["positions"].shape[0]
    return {"tokens": torch.cat([batch["tokens"], nxt], -1),
            "positions": torch.arange(S + 1, dtype=torch.int32,
                                      device=nxt.device).expand(B, S + 1)}


def _last_tokens(logits, cfg):
    import torch
    last = logits[:, :, -1] if cfg.codebooks else logits[:, -1]
    return last.argmax(-1).to(torch.int32)[..., None]


class RoutingTap:
    """Records the experts each MoE routing call picks
    (``repro_torch.models.moe.route``, one call a layer for all its token
    chunks, in order), or, given ``replay``, makes each call pick the recorded
    experts instead, its gates taken from its own probabilities at those
    experts and its buffer positions and capacity from those picks (the
    port's own ``moe.positions``).  ``changed`` counts the (token, k)
    pairs whose own pick differed from the replayed one.  A bf16 MoE
    picks from router logits rounded to bf16, whose near-ties flip under
    any change of rounding upstream; replaying one run's picks in another
    compares the two runs' arithmetic apart from those discrete flips."""

    def __init__(self, replay=None):
        self.picks = []
        self.replay = None if replay is None else list(replay)
        self.changed = 0

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route

        def route(p, cfg, xt, C):
            # a call routes every chunk of a layer: idx (chunks, T, K),
            # kept as (chunks·T, K) rows in token order
            gates, idx, pos, keep, probs = self._route(p, cfg, xt, C)
            if self.replay is None:
                self.picks.append(idx.reshape(-1, idx.shape[-1]).clone())
                return gates, idx, pos, keep, probs
            want = self.replay.pop(0).to(idx.device).reshape(idx.shape)
            self.changed += int((want != idx).sum())
            g = probs.gather(-1, want)
            g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
            pos = moe.positions(want, probs.shape[-1])
            return g, want, pos, pos < C, probs

        moe.route = route
        return self

    def __exit__(self, exc_type, *exc):
        self._moe.route = self._route
        if exc_type is None and self.replay:
            raise SmokeFailure(f"{len(self.replay)} recorded routing calls "
                               f"were not replayed")
        return False


def compare_to_ref(params, cfg, batch, max_len):
    """The last logits of the prefill through ``attn_impl="cuda"`` against
    the same prefill on ``"ref"``: as it runs, and with the ``"ref"`` run
    replaying the ``"cuda"`` run's MoE picks (:class:`RoutingTap`; the same
    run for a model without experts).  Returns the figures."""
    import torch
    from repro_torch.serve import make_prefill_step
    with RoutingTap() as tap:
        logits, _ = make_prefill_step(cfg, max_len=max_len,
                                      attn_impl="cuda")(params, batch)
    plain = make_prefill_step(cfg, max_len=max_len, attn_impl="ref")
    free, _ = plain(params, batch)
    pinned, changed = free, 0
    if cfg.num_experts:
        with RoutingTap(replay=tap.picks) as rt:
            pinned, _ = plain(params, batch)
        changed = rt.changed
    torch.cuda.synchronize()
    pairs = sum(int(p.numel()) for p in tap.picks)
    return dict(vs_ref=_rel_err(logits, pinned),
                vs_ref_free=_rel_err(logits, free),
                picks_changed=changed, picks=pairs,
                greedy_agree=float((logits.argmax(-1) == free.argmax(-1))
                                   .float().mean()))


def teacher_forcing(params, cfg, batch, first, max_len):
    """Decode of token S+1 after a prefill of S tokens against a prefill
    of S+1 tokens, both through ``"cuda"`` (MoE at the drop-free capacity
    factor E/K, as the reference's teacher-forcing test sets it): as it
    runs, and with the decode replaying the S+1 prefill's MoE picks for
    each request's last token (:class:`RoutingTap`).  Returns the
    figures."""
    import dataclasses

    import torch
    from repro_torch.serve import make_decode_step, make_prefill_step
    B, S = batch["positions"].shape
    tcfg = cfg if not cfg.num_experts else dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    pre = make_prefill_step(tcfg, max_len=max_len, attn_impl="cuda")
    decode = make_decode_step(tcfg)
    _, cache = pre(params, batch)
    with RoutingTap() as tap:
        full, _ = pre(params, _extend(batch, first, S))
    pos = torch.full((B, 1), S, dtype=torch.int32, device=first.device)
    _, free, _ = decode(params, cache, first, pos)
    pinned, changed = free, 0
    if cfg.num_experts:
        # each MoE layer routed the S+1 prefill in one call, its chunks
        # of TOKEN_CHUNK tokens in order (the last one padded at its end)
        last = torch.arange(B, device=first.device) * (S + 1) + S
        replay = [picks[last] for picks in tap.picks]
        # the decode writes its cache slot S in place: a second decode
        # from the same prefill cache rewrites it
        with RoutingTap(replay=replay) as rt:
            _, pinned, _ = decode(params, cache, first, pos)
        changed = rt.changed
    torch.cuda.synchronize()
    return dict(teacher_forcing=_rel_err(pinned, full),
                teacher_forcing_free=_rel_err(free, full),
                picks_changed=changed, picks=B * cfg.num_experts_per_tok
                * sum(k == "moe" for k in cfg.mlp_kinds) * cfg.num_periods,
                capacity_factor=tcfg.capacity_factor)


def _serve_family(name, cfg, B, S, G, tag="22"):
    """Serve one family on the card: weights drawn from ``PRNGKey(0)``, a
    counted prefill through ``attn_impl="cuda"`` (B8 at every GQA layer),
    its MoE statistics, ``G`` decode steps, peak allocation, a profiler
    split, then :func:`_compare_family`.  Returns (its figures, B8's
    launches by path)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import forward, init_cache, init_params
    from repro_torch.models import param_count
    from repro_torch.serve import make_decode_step, make_prefill_step

    dev = torch.device(CARD)
    bf16 = cfg.dtype == "bfloat16"
    want = _b8_launches(cfg)
    key = name.replace("-", "_").replace(".", "_")
    launches = {}
    max_len = S + G + 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(prng.PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = param_count(params)
    check(all(bool(torch.isfinite(t).all()) for t in params.parameters()),
          f"[{tag}] {name}: the seeded weights are not finite")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, pattern "
        f"{cfg.layer_pattern}, d {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} x {cfg.head_dim}, attention {cfg.attention}, "
        f"experts {cfg.num_experts} (top {cfg.num_experts_per_tok}, d_ff "
        f"{cfg.moe_d_ff}, shared {cfg.shared_expert_d_ff}), codebooks "
        f"{cfg.codebooks}, vocab {cfg.vocab_size}, {cfg.dtype}; {n_params} "
        f"parameters ({n_params * (2 if bf16 else 4) / 1e9:.3f} GB), "
        f"drawn on the card from PRNGKey(0) in {t_init:.3f} s; batch {B} x "
        f"prompt {S}, {G} decode steps")
    batch = _serve_batch(cfg, B, S, dev)
    prefill = make_prefill_step(cfg, max_len=max_len, attn_impl="cuda")
    prefill(params, batch)            # first use: cuBLAS handles, caches
    torch.cuda.synchronize()

    # the path: counts set to 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"[{tag}] {name} prefill via attn_impl='cuda'", counts,
                 **want)
    launches[f"{key}_prefill"] = counts
    shape = (B, cfg.codebooks, 1, cfg.vocab_size) if cfg.codebooks \
        else (B, 1, cfg.vocab_size)
    check(tuple(logits.shape) == shape
          and bool(torch.isfinite(logits).all()),
          f"[{tag}] {name}: prefill logits {tuple(logits.shape)} not "
          f"finite or not {shape}")
    check(all(bool((c["len"] == S).all()) for c in cache if "len" in c),
          f"[{tag}] {name}: the caches' len after prefill is not S")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    t_best = min([t_pre] + walls)
    log(f"[{tag}] {name} prefill {B}x{S} via 'cuda': {t_pre * 1e3:.3f} ms "
        f"({B * S / t_pre:.0f} tokens/s); again "
        f"{', '.join(f'{t * 1e3:.3f}' for t in walls)} ms; launches "
        f"{json.dumps(counts)}")

    # the MoE statistics of the same prefill, through forward
    reset_counts()
    with torch.no_grad():
        _, _, aux = forward(params, cfg, batch, cache=init_cache(
            cfg, B, max_len, device=dev), attn_impl="cuda",
            logits_slice="last")
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(f"[{tag}] {name} forward via 'cuda'", counts, **want)
    launches[f"{key}_forward"] = counts
    drop = float(aux["drop_frac"])
    lb = float(aux["load_balance_loss"])
    check(0.0 <= drop < 1.0 and lb >= 0.0 and (lb > 0) == bool(
        cfg.num_experts), f"[{tag}] {name}: drop_frac {drop}, "
        f"load_balance_loss {lb}")

    # decode
    tok = _last_tokens(logits, cfg)
    first = tok
    reset_counts()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(G):
        pos = torch.full((B, 1), S + g, dtype=torch.int32, device=dev)
        tok, dlogits, cache = decode(params, cache, tok, pos)
        finite &= torch.isfinite(dlogits).all()
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"[{tag}] {name} decode", counts)
    launches[f"{key}_decode"] = counts
    check(bool(finite), f"[{tag}] {name}: decode logits not finite")
    check(all(bool((c["len"] == S + G).all()) for c in cache
              if "len" in c),
          f"[{tag}] {name}: the caches' len after decode is not S + gen")
    want_tok = (B, cfg.codebooks, 1) if cfg.codebooks else (B, 1)
    check(tuple(tok.shape) == want_tok and bool(
        ((tok >= 0) & (tok < cfg.vocab_size)).all()),
        f"[{tag}] {name}: decode tokens {tuple(tok.shape)} not {want_tok} "
        f"or out of [0, {cfg.vocab_size})")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {name} decode {G} steps x batch {B}: "
        f"{t_dec / G * 1e3:.3f} ms/step ({B * G / t_dec:.0f} tokens/s); "
        f"tokens {tuple(tok.shape)} in [0, {cfg.vocab_size}); caches' len "
        f"{S} -> {S + G}; drop_frac {drop:.6f}, load_balance_loss {lb:.6f}; "
        f"peak allocation (weights, prefill, decode) {peak / 2**30:.3f} GiB")
    check(peak < PEAK_LIMIT_BYTES, f"[{tag}] {name}: peak allocation "
          f"{peak / 1e9:.3f} GB past {PEAK_LIMIT_BYTES / 1e9:.0f} GB")
    split = _device_time(lambda: prefill(params, batch), t_best * 1e3,
                         f"{name} prefill {B}x{S} profile", tag=tag) or {}
    del cache, dlogits
    figs = _compare_family(name, cfg, params, batch, first, max_len, want,
                           launches, key, tag=tag,
                           hold_tf=not (bf16 and name in BF16_DRIFT))
    del params, logits
    torch.cuda.empty_cache()
    fig = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
               dtype=cfg.dtype, batch=B, prompt=S, decode_steps=G,
               init_s=t_init, prefill_ms=t_pre * 1e3,
               prefill_again_ms=[t * 1e3 for t in walls],
               prefill_tokens_per_s=B * S / t_best,
               decode_ms_per_step=t_dec / G * 1e3,
               decode_tokens_per_s=B * G / t_dec,
               peak_bytes=peak, drop_frac=drop, load_balance_loss=lb,
               b8=want, **figs, **{f"device_{k}": v for k, v in split.items()
                                   if k in ("busy_ms", "b8_ms",
                                            "idle_share")})
    return fig, launches


def _compare_family(name, cfg, params, batch, first, max_len, want,
                    launches, key, tag="22", hold_tf=True):
    """The prefill through B8 against ``"ref"`` (:func:`compare_to_ref`)
    and decode against teacher forcing (:func:`teacher_forcing`), counted
    and held to the bound of ``cfg``'s type (2% of max |logit| in bf16,
    1e-4 in f32) with the MoE picks replayed across the two runs; the
    figures as they run beside them.  ``hold_tf=False`` reports the
    teacher-forcing figure without holding it (:data:`BF16_DRIFT`)."""
    import torch
    tol = 0.02 if cfg.dtype == "bfloat16" else 1e-4
    pre = f"{key}_f32" if tol < 0.02 and name in FAMILIES else key
    reset_counts()
    r = compare_to_ref(params, cfg, batch, max_len)
    counts = read_counts()
    check_counts(f"[{tag}] {name} {cfg.dtype} prefill via 'cuda' and "
                 f"'ref'", counts, **want)
    launches[f"{pre}_vs_ref"] = counts
    check(r["vs_ref"] <= tol, f"[{tag}] {name} {cfg.dtype}: prefill via "
          f"'cuda' vs 'ref' {r['vs_ref']:.4g} of max |logit| > {tol}")
    reset_counts()
    t = teacher_forcing(params, cfg, batch, first[:batch["tokens"].shape[0]],
                        max_len)
    counts = read_counts()
    check_counts(f"[{tag}] {name} {cfg.dtype} teacher forcing", counts,
                 **{k: 2 * n for k, n in want.items()})
    launches[f"{pre}_teacher_forcing"] = counts
    check(not hold_tf or t["teacher_forcing"] <= tol,
          f"[{tag}] {name} {cfg.dtype}: decode of token S+1 vs a prefill "
          f"of S+1 tokens {t['teacher_forcing']:.4g} of max |logit| > "
          f"{tol}")
    torch.cuda.synchronize()
    moe = (f" ({r['picks_changed']} of {r['picks']} MoE picks differ "
           f"between the runs; {r['vs_ref_free']:.4g} as they fall)"
           if cfg.num_experts else "")
    tmoe = (f" (capacity factor {t['capacity_factor']:g}, no drops; "
            f"{t['picks_changed']} of {t['picks']} last-token picks "
            f"differ; {t['teacher_forcing_free']:.4g} as they fall)"
            if cfg.num_experts else "")
    log(f"[{tag}] {name} {cfg.dtype}, batch {batch['tokens'].shape[0]}: "
        f"'cuda' vs 'ref' prefill last logits {r['vs_ref']:.4g} of max "
        f"|logit| (<= {tol}){moe}, greedy tokens agree on "
        f"{r['greedy_agree']:.3f}; decode of token S+1 vs a prefill of "
        f"S+1 tokens {t['teacher_forcing']:.4g}"
        + ("" if hold_tf else f" (not held in {cfg.dtype}: BF16_DRIFT)")
        + tmoe)
    return {f"{cfg.dtype}_{k}": v for k, v in dict(r, **{
        f"tf_{k}": v for k, v in t.items()}).items()}


def _f32_twin(name, depth, S, tag="22"):
    """The family again in f32 (at ``depth`` layers), batch
    :data:`TWIN_BATCH`, weights from ``PRNGKey(0)``: its prefill through
    B8 (B8-TF32 at every GQA layer) against ``"ref"`` and decode against
    teacher forcing, held to the f32 bound.  Returns (figures, B8's
    launches by path)."""
    import dataclasses

    import torch
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.serve import make_prefill_step
    dev = torch.device(CARD)
    cfg = dataclasses.replace(family_config(name, depth), dtype="float32")
    B = TWIN_BATCH
    torch.cuda.empty_cache()
    params = init_params(prng.PRNGKey(0), cfg, device=dev)
    batch = _serve_batch(cfg, B, S, dev)
    first = _last_tokens(make_prefill_step(cfg, max_len=S + 2)(
        params, batch)[0], cfg)
    launches = {}
    figs = _compare_family(name, cfg, params, batch, first, S + 2,
                           _b8_launches(cfg), launches,
                           name.replace("-", "_").replace(".", "_"),
                           tag=tag)
    del params
    torch.cuda.empty_cache()
    return dict(figs, f32_layers=cfg.num_layers), launches


def _family_attention(name, cfg, B, S, prefill_b8_ms, tag="22"):
    """B8 at the family's prefill launch (unpadded, random bf16 inputs at
    the shapes the prefill gives it): against ``attention_ref`` as phase
    16 holds it, then timed as phase 16 times its main-path launches, its
    device time the profiler's B8 time in one prefill
    (``prefill_b8_ms``, None if not measured) over its launches: after
    phase 21's graphs the profiler has shown no device event for a launch
    of a ctypes-loaded kernel timed alone (phase 21 (c) for H1)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import attention_ref, flash_attention
    from repro_torch.kernels.flash_attn import ops as attn_ops
    dev = torch.device(CARD)
    dt = getattr(torch, cfg.dtype)
    body = _body(dt, cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(22)
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for shape in ((B, H, S, D), (B, Hk, S, D), (B, Hk, S, D)))
    kv_len = torch.full((B,), S, dtype=torch.int32, device=dev)
    reset_counts()
    got = flash_attention(q, k, v, kv_len, causal=True)
    torch.cuda.synchronize()
    check_counts(f"[{tag}] {name} B8 launch", read_counts(), **{body: 1})
    want = attention_ref(q, k, v, kv_len, causal=True)
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=1e-3, rtol=8e-3),
        f"[{tag}] {name}: {body} at q {tuple(q.shape)} disagrees with its "
        f"plain version beyond atol 1e-3, rtol 8e-3 (max |err| {err:.3g})")
    log(f"[{tag}] {name}: {body} at its prefill launch q {tuple(q.shape)} "
        f"k {tuple(k.shape)} {cfg.dtype} causal == plain (max |err| "
        f"{err:.3g})")
    n = _b8_launches(cfg)[body]
    per = None if prefill_b8_ms is None else prefill_b8_ms / n
    row = _time_attention(q, k, v, kv_len, body, attn_ops, attention_ref, F,
                          tag=tag, device=(per, f" (one prefill's {n} "
                                                f"launches, averaged)"))
    row["max_abs_err"] = err
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return body, row


def _launcher_subprocess(arch, tag="22"):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke`` in a
    process of its own: it must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--smoke"]
    if CARD != "cuda":
        cmd += ["--device", CARD]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    dt = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[{tag}] launcher {arch} --smoke | {line}")
    check(proc.returncode == 0, f"[{tag}] {' '.join(cmd[1:])} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    check("[serve] decode" in proc.stdout,
          f"[{tag}] launcher {arch} --smoke printed no decode line")
    log(f"[{tag}] launcher {arch} --smoke: exit 0 in {dt:.1f} s")
    return dt


def phase_lm_families():
    """Phase 22: the MoE, MLA, codebook, RWKV6 and hybrid families served
    (module docstring).  Returns ({body: {path: launches}}, {body: {name:
    timing row}} at the new launches, the families' figures)."""
    import torch
    launches = {"B8-TC": {}, "B8-TF32": {}}
    rows = {"B8-TC": {}, "B8-TF32": {}}
    figures = {}

    def record(paths):
        for path, counts in paths.items():
            for body in launches:
                if counts[body]:
                    launches[body][path] = counts[body]

    runs = [(name, family_config(name, depth), B, S, G)
            for name, (depth, B, S, G, _) in FAMILIES.items()]
    runs += [(name, family_config(name, small=True), B, S, G)
             for name, (B, S, G) in FAMILY_REDUCED.items()]
    for name, cfg, B, S, G in runs:
        fig, paths = _serve_family(name, cfg, B, S, G)
        record(paths)
        if name in FAMILIES:
            twin, paths = _f32_twin(name, FAMILIES[name][4], S)
            fig.update(twin)
            record(paths)
            if cfg.attention != "mla" and "attn" in cfg.mixer_kinds:
                body, row = _family_attention(name, cfg, B, S,
                                              fig.get("device_b8_ms"))
                rows[body][name] = row
        figures[name] = fig
        torch.cuda.empty_cache()
    for arch in FAMILY_LAUNCHES:
        figures[f"launcher_{arch}_smoke_s"] = _launcher_subprocess(arch)
    return launches, rows, figures


# The training phase: SmolLM-360M trained at full width and depth, bf16,
# through the launcher; its attention launch held under autograd.
# The launcher's default rate (3e-3 warmed up over 20 steps, the
# reference's) drove the loss up at this width (step 1's batch 10.83,
# step 20's 12.43), and among 3e-5, 1e-4, 3e-4 and 1e-3 warmed up over 5
# steps, 1e-4 lowered the loss of step 1's batch the most after 20 steps
# (10.83 -> 5.82; probes/train_lr.py, NVIDIA H100 80GB HBM3, 700 W).
# The pipeline draws a new token permutation for every batch, so the
# loss of each step's fresh batch moves with its batch (10.8-11.8 at
# every rate); "the loss falls" is held on step 1's batch, before and
# after the 20 steps.
TRAIN = dict(arch="smollm-360m", batch=8, seq=2048, steps=20,
             remat="full", lr="1e-4", warmup="5")
# the f32 twins' batch, and the f32 twin's depth at full width
TRAIN_TWIN = dict(batch=2, layers=4)
# the chunked attention's case: ragged Sq (no multiple of block_q = 512)
CHUNKED = dict(B=2, Hq=15, Hkv=5, S=3000, D=64)
# the supervisor drill: depth cut to 8 layers for time
DRILL = dict(layers=8, steps=10, ckpt_every=4, fail_at=6)
# every family's reduced f32 sibling: one step through "cuda" and "ref"
FAMILY_TRAIN = dict(batch=2, seq=128)
# bounds (relative): bf16 "cuda" vs "ref" loss and grad_norm; f32 twins;
# remat "none" vs "full" in bf16 (the same forward; the embedding's
# backward sums by atomics); the drill's replayed losses
TRAIN_BF16_LOSS, TRAIN_BF16_GNORM = 5e-3, 2e-2
TRAIN_F32 = 1e-4
TRAIN_REMAT_LOSS, TRAIN_REMAT_GNORM = 1e-6, 1e-3
DRILL_TOL = 1e-3


def _train_args(extra, cfg_layers=None):
    """The launcher's argv for the training runs (``--device`` only off
    the card, as the smoke's CPU rehearsal runs it)."""
    argv = ["--arch", TRAIN["arch"], "--batch", str(TRAIN["batch"]),
            "--seq", str(TRAIN["seq"]), "--lr", TRAIN["lr"], "--warmup",
            TRAIN["warmup"]] + extra
    if cfg_layers is not None:
        argv += ["--layers", str(cfg_layers)]
    if CARD != "cuda":
        argv += ["--device", CARD]
    return argv


def _train_attention(tag="23"):
    """(a) B8 forward and autograd gradients at SmolLM-360M's training
    launch, q (8, 15, 2048, 64) bf16 (B8-TC), and its f32 twin at batch 2
    (B8-TF32), against ``attention_ref``'s autograd on the same inputs;
    the launch's times as phase 16 takes them, and forward + backward
    against SDPA's.  Returns ({body: max error}, {body: timing row})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn import attention_ref, flash_attention

    cfg = get_config(TRAIN["arch"])
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(23)
    errs, rows = {}, {}
    for B, dname in ((TRAIN["batch"], "bfloat16"),
                     (TRAIN_TWIN["batch"], "float32")):
        dt = getattr(torch, dname)
        S, Hq, Hkv, D = TRAIN["seq"], cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        body = _body(dt, D)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, Hq, S, D), (B, Hkv, S, D),
                                 (B, Hkv, S, D)))
        g = torch.randn((B, Hq, S, D), generator=gen, device=dev).to(dt)
        kv_len = torch.full((B,), S, dtype=torch.int32, device=dev)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        reset_counts()
        got = flash_attention(*leaves, causal=True)
        got.backward(g)
        torch.cuda.synchronize()
        check_counts(f"[{tag}] B8 under autograd {dname}", read_counts(),
                     **{body: 1})
        refs = [t.clone().requires_grad_() for t in (q, k, v)]
        want = attention_ref(*refs, causal=True)
        want.backward(g)
        torch.cuda.synchronize()
        figs = {"out": _rel_err(got, want)}
        for name, a, b in zip(("dq", "dk", "dv"), leaves, refs):
            figs[name] = _rel_err(a.grad, b.grad)
            check(bool(torch.isfinite(a.grad).all()),
                  f"[{tag}] {dname} {name} not finite")
        err = float((got.detach().float() - want.detach().float()).abs()
                    .max())
        if dname == "float32":
            ok = err <= 2e-5 and max(figs.values()) <= 1e-4
            bound = "out within 2e-5, grads within 1e-4 of max"
        else:
            ok = torch.allclose(got.detach().float(), want.detach().float(),
                                atol=1e-3, rtol=8e-3) \
                and max(figs.values()) <= 2e-2
            bound = ("out within atol 1e-3, rtol 8e-3 (phase 16's); grads "
                     "within 2% of max")
        check(ok, f"[{tag}] B8 under autograd {dname}: {figs} beyond "
              f"the bound ({bound})")
        log(f"[{tag}] (a) B8 {body} under autograd, q {tuple(q.shape)} "
            f"{dname}: out max |err| {err:.3g}; relative to max, out "
            f"{figs['out']:.3g}, dq {figs['dq']:.3g}, dk {figs['dk']:.3g}, "
            f"dv {figs['dv']:.3g} ({bound}; the backward is the plain "
            f"attention's, recomputed from B8's saved inputs)")
        del leaves, refs, got, want
        torch.cuda.empty_cache()
        row = _time_attention(q, k, v, kv_len, body, attn_ops, attention_ref,
                              F, tag=tag)

        def fwd_bwd(fn, *args):
            ts = [t.detach().requires_grad_() for t in (q, k, v)]
            fn(*ts, *args).backward(g)

        row["fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(
            lambda a, b, c: flash_attention(a, b, c, causal=True)), 3)
        row["sdpa_fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True, enable_gqa=True)), 3)
        row["max_abs_err"] = err
        row["grads_rel_err"] = {n: figs[n] for n in ("dq", "dk", "dv")}
        log(f"[{tag}] (a) {body} forward + backward at the training "
            f"launch: {row['fwd_bwd_ms']:.3f} ms (B8, then the plain "
            f"recompute), SDPA forward + backward "
            f"{row['sdpa_fwd_bwd_ms']:.3f} ms")
        errs[body], rows[body] = err, row
        del q, k, v, g
        torch.cuda.empty_cache()
    return errs, rows


def _chunked_on_card(tag="23"):
    """(b) ``chunked_attention`` forward and gradients against
    ``attention_ref``'s at one GQA shape with a ragged Sq, f32, and the
    peak allocation above its inputs below one (B, H, Sq, Skv) f32
    score tensor."""
    import torch
    from repro_torch.kernels.flash_attn import attention_ref, \
        chunked_attention
    c = CHUNKED
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((c["B"], c["Hq"], c["S"], c["D"]),
                             (c["B"], c["Hkv"], c["S"], c["D"]),
                             (c["B"], c["Hkv"], c["S"], c["D"])))
    g = torch.randn_like(q)
    scores = 4 * c["B"] * c["Hq"] * c["S"] * c["S"]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = chunked_attention(*leaves, causal=True)
    got.backward(g)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    check(peak < scores, f"[{tag}] (b) chunked attention allocated "
          f"{peak} bytes above its inputs, not below one full score "
          f"tensor's {scores}")
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention_ref(*refs, causal=True)
    want.backward(g)
    figs = {"out": _rel_err(got, want)}
    for name, a, b in zip(("dq", "dk", "dv"), leaves, refs):
        figs[name] = _rel_err(a.grad, b.grad)
    check(max(figs.values()) <= 2e-5, f"[{tag}] (b) chunked attention "
          f"against attention_ref beyond 2e-5 of max: {figs}")
    log(f"[{tag}] (b) chunked attention q {tuple(q.shape)} k "
        f"{tuple(k.shape)} f32 causal (Sq {c['S']}, block_q 512: ragged): "
        f"relative to max, out {figs['out']:.3g}, dq {figs['dq']:.3g}, dk "
        f"{figs['dk']:.3g}, dv {figs['dv']:.3g} (bound 2e-5); peak "
        f"{peak / 2**20:.1f} MiB above its inputs against "
        f"{scores / 2**20:.1f} MiB for one full f32 score tensor; forward "
        f"+ backward {ms:.1f} ms wall")
    del q, k, v, g, leaves, refs, got, want
    torch.cuda.empty_cache()
    return dict(figs, peak_mib=peak / 2**20, scores_mib=scores / 2**20,
                fwd_bwd_wall_ms=ms)


def _train_cfg(layers=None, dtype=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN["arch"])
    over = {}
    if layers is not None:
        over["num_layers"] = layers
    if dtype is not None:
        over["dtype"] = dtype
    return dataclasses.replace(cfg, **over) if over else cfg


def _train_batch(cfg, B, S, step=0, seed=0):
    import torch
    from repro_torch.data import DataConfig, make_batch
    b = make_batch(cfg, DataConfig(seed=seed), step=step, shard=0, batch=B,
                   seq_len=S)
    return {k: torch.from_numpy(v).to(CARD) for k, v in b.items()}


def _train_main_path(tag="23"):
    """(c) The launcher at full width and depth: ``--batch 8 --seq 2048
    --steps 20 --remat full``, counted; then one more step profiled.
    Returns (B8's launches by path, the figures)."""
    import statistics

    import torch
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import loss_fn
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = _train_cfg()
    body, per_fwd = next(iter(_b8_launches(cfg).items()))
    steps = TRAIN["steps"]
    want = 2 * per_fwd * steps          # the forward and the recompute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = attn_ops.plain_calls
    reset_counts()
    t0 = time.perf_counter()
    state, report = train_main(_train_args(
        ["--steps", str(steps), "--remat", TRAIN["remat"],
         "--log-every", "5"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_counts(f"[{tag}] (c) train", counts, **{body: want})
    check(attn_ops.plain_calls == plain,
          f"[{tag}] (c) train: {attn_ops.plain_calls - plain} plain "
          f"attention calls through B8's wrapper")
    losses = [report["loss"][s] for s in range(1, steps + 1)]
    check(all(map(math.isfinite, losses)), f"[{tag}] (c) losses not "
          f"finite: {losses}")
    first = _train_batch(cfg, TRAIN["batch"], TRAIN["seq"], step=0)
    with torch.no_grad():
        after, _ = loss_fn(state.params, cfg, first, attn_impl="cuda",
                           remat="none")
    after = float(after)
    check(after < losses[0], f"[{tag}] (c) the loss of step 1's batch did "
          f"not fall: {losses[0]} -> {after}")
    check(peak < PEAK_LIMIT_BYTES, f"[{tag}] (c) peak allocation {peak} "
          f"bytes over {PEAK_LIMIT_BYTES}")
    step_ms = report["step_ms"]
    med = statistics.median(step_ms[1:]) if len(step_ms) > 1 \
        else step_ms[0]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    log(f"[{tag}] (c) {cfg.name} trained {steps} steps at full width and "
        f"depth ({cfg.num_layers} layers, {cfg.dtype}), batch "
        f"{TRAIN['batch']} x {TRAIN['seq']}, remat {TRAIN['remat']}, "
        f"lr {TRAIN['lr']} warmed up over {TRAIN['warmup']}, through "
        f"the launcher in {wall:.1f} s: {body} launched "
        f"{counts[body]} times ({counts[body] / steps:.0f} a step: the "
        f"forward and the remat recompute), 0 plain calls; loss of step "
        f"1's batch {losses[0]:.4f} -> {after:.4f} after {steps} steps; "
        f"each step's loss on its own batch "
        f"{' '.join(f'{x:.3f}' for x in losses)}; grad_norm "
        f"{report['grad_norm'][1]:.3f} -> {report['grad_norm'][steps]:.3f}"
        f"; step ms (host clock) first {step_ms[0]:.1f}, median of the "
        f"rest {med:.1f} ({tokens / med * 1e3:.0f} tokens/s), all "
        f"{[round(t, 1) for t in step_ms]}; peak allocation "
        f"{peak / 2**30:.3f} GiB")
    # one more step, profiled (the same step the launcher runs)
    opt = AdamWConfig(lr=float(TRAIN["lr"]), warmup_steps=int(
        TRAIN["warmup"]), total_steps=steps)
    step = make_train_step(cfg, opt, remat=TRAIN["remat"], attn_impl="cuda")
    batch = _train_batch(cfg, TRAIN["batch"], TRAIN["seq"], step=steps)
    holder = [state]

    def one():
        holder[0], m = step(holder[0], batch)
        float(m["loss"])

    reset_counts()
    one()
    torch.cuda.synchronize()
    check_counts(f"[{tag}] (c) one step", read_counts(),
                 **{body: 2 * per_fwd})
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    split = _device_time(one, min(walls), "(c) one training step", tag=tag)
    del holder, state, step, batch, first
    torch.cuda.empty_cache()
    return ({body: {"train": counts[body]}},
            dict(step_ms=step_ms, median_step_ms=med,
                 tokens_per_s=tokens / med * 1e3, losses=losses,
                 grad_norms=[report["grad_norm"][s]
                             for s in range(1, steps + 1)],
                 first_batch_after=after, peak_gib=peak / 2**30,
                 launches_per_step=counts[body] / steps, wall_s=wall,
                 profiled_walls_ms=walls, **(split or {})))


def _one_step(cfg, impl, remat, B, S, tag, expect=None):
    """One train step from weights drawn from ``PRNGKey(0)`` on the card
    and the batch of step 0: (loss, grad_norm, B8's launches)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    opt = AdamWConfig(lr=float(TRAIN["lr"]), warmup_steps=int(
        TRAIN["warmup"]), total_steps=TRAIN["steps"])
    state = init_train_state(init_params(prng.PRNGKey(0), cfg,
                                         device=CARD), opt)
    batch = _train_batch(cfg, B, S)
    step = make_train_step(cfg, opt, remat=remat, attn_impl=impl)
    reset_counts()
    _, m = step(state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    counts = read_counts()
    if expect is not None:
        check_counts(f"[{tag}] {cfg.name} {impl} {remat}", counts, **expect)
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"[{tag}] {cfg.name} {impl}: loss {loss}, grad_norm {gnorm}")
    del state, step, batch
    torch.cuda.empty_cache()
    return loss, gnorm, counts


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _train_cuda_vs_ref(tag="23"):
    """(d) One step through ``"cuda"`` and through ``"ref"`` from the same
    weights and batch at full width (bf16, batch 8 x 2048, remat full);
    the f32 twin (full width, 4 layers, batch 2); remat ``"none"`` against
    ``"full"`` (bf16, batch 2 x 2048).  Returns (launches by path,
    figures)."""
    cfg = _train_cfg()
    body, per_fwd = next(iter(_b8_launches(cfg).items()))
    B, S, r = TRAIN["batch"], TRAIN["seq"], TRAIN["remat"]
    lc, gc, _ = _one_step(cfg, "cuda", r, B, S, tag, {body: 2 * per_fwd})
    lr_, gr, _ = _one_step(cfg, "ref", r, B, S, tag, {})
    figs = dict(bf16_loss=(lc, lr_), bf16_grad_norm=(gc, gr),
                bf16_loss_rel=_rel(lc, lr_), bf16_grad_norm_rel=_rel(gc, gr))
    check(figs["bf16_loss_rel"] <= TRAIN_BF16_LOSS
          and figs["bf16_grad_norm_rel"] <= TRAIN_BF16_GNORM,
          f"[{tag}] (d) bf16 cuda vs ref beyond {TRAIN_BF16_LOSS} / "
          f"{TRAIN_BF16_GNORM}: {figs}")
    twin = _train_cfg(layers=TRAIN_TWIN["layers"], dtype="float32")
    tbody, tper = next(iter(_b8_launches(twin).items()))
    Bt = TRAIN_TWIN["batch"]
    l32c, g32c, _ = _one_step(twin, "cuda", r, Bt, S, tag,
                              {tbody: 2 * tper})
    l32r, g32r, _ = _one_step(twin, "ref", r, Bt, S, tag, {})
    figs.update(f32_loss_rel=_rel(l32c, l32r),
                f32_grad_norm_rel=_rel(g32c, g32r))
    check(figs["f32_loss_rel"] <= TRAIN_F32
          and figs["f32_grad_norm_rel"] <= TRAIN_F32,
          f"[{tag}] (d) f32 twin cuda vs ref beyond {TRAIN_F32}: {figs}")
    ln, gn, _ = _one_step(cfg, "cuda", "none", Bt, S, tag, {body: per_fwd})
    lf, gf, _ = _one_step(cfg, "cuda", "full", Bt, S, tag,
                          {body: 2 * per_fwd})
    figs.update(remat_loss_rel=_rel(lf, ln), remat_grad_norm_rel=_rel(gf, gn))
    check(figs["remat_loss_rel"] <= TRAIN_REMAT_LOSS
          and figs["remat_grad_norm_rel"] <= TRAIN_REMAT_GNORM,
          f"[{tag}] (d) remat full vs none beyond {TRAIN_REMAT_LOSS} / "
          f"{TRAIN_REMAT_GNORM}: {figs}")
    log(f"[{tag}] (d) one step at full width from PRNGKey(0): bf16 batch "
        f"{B} x {S}, cuda vs ref loss {lc:.6f} / {lr_:.6f} (rel "
        f"{figs['bf16_loss_rel']:.3g}, bound {TRAIN_BF16_LOSS}), grad_norm "
        f"{gc:.6f} / {gr:.6f} (rel {figs['bf16_grad_norm_rel']:.3g}, bound "
        f"{TRAIN_BF16_GNORM}); f32 twin ({TRAIN_TWIN['layers']} layers, "
        f"batch {Bt}, {tbody}) loss rel {figs['f32_loss_rel']:.3g}, "
        f"grad_norm rel {figs['f32_grad_norm_rel']:.3g} (bound {TRAIN_F32})"
        f"; remat full vs none (bf16, batch {Bt}) loss rel "
        f"{figs['remat_loss_rel']:.3g} (bound {TRAIN_REMAT_LOSS}), "
        f"grad_norm rel {figs['remat_grad_norm_rel']:.3g} (bound "
        f"{TRAIN_REMAT_GNORM})")
    paths = {}
    for b, path, n in ((body, "train_cuda_vs_ref", 2 * per_fwd),
                       (body, "train_remat_none", per_fwd),
                       (body, "train_remat_full", 2 * per_fwd),
                       (tbody, "train_f32_twin", 2 * tper)):
        paths.setdefault(b, {})[path] = n
    return paths, figs


def _supervisor_drill(tag="23"):
    """(e) The launcher's failure drill: ``--ckpt-dir --ckpt-every 4
    --fail-at 6 --steps 10`` at full width, depth cut to 8 layers, against
    an uninterrupted run; then one save and one restore of the state,
    timed."""
    import os
    import tempfile

    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.train import main as train_main
    from repro_torch.train import restore_train_state, train_state_tree

    d = DRILL
    cfg = _train_cfg(layers=d["layers"])
    body, per_fwd = next(iter(_b8_launches(cfg).items()))
    common = ["--steps", str(d["steps"]), "--remat", TRAIN["remat"],
              "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        reset_counts()
        _, drill = train_main(_train_args(
            common + ["--ckpt-dir", os.path.join(tmp, "drill"),
                      "--ckpt-every", str(d["ckpt_every"]), "--fail-at",
                      str(d["fail_at"])], d["layers"]))
        counts = read_counts()
        restored = d["fail_at"] // d["ckpt_every"] * d["ckpt_every"]
        runs = d["steps"] + (d["fail_at"] - restored)
        check_counts(f"[{tag}] (e) drill", counts,
                     **{body: 2 * per_fwd * runs})
        check(drill["restarts"] == 1 and drill["final_step"] == d["steps"],
              f"[{tag}] (e) drill: {drill['restarts']} restarts, final "
              f"step {drill['final_step']}")
        state, plain = train_main(_train_args(common, d["layers"]))
        replay = range(d["fail_at"] + 1, d["steps"] + 1)
        diffs = {s: _rel(drill["loss"][s], plain["loss"][s])
                 for s in replay}
        check(max(diffs.values()) <= DRILL_TOL, f"[{tag}] (e) replayed "
              f"losses differ from the uninterrupted run's beyond "
              f"{DRILL_TOL}: {diffs}")
        path = os.path.join(tmp, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, d["steps"], train_state_tree(state, cfg))
        save_ms = (time.perf_counter() - t0) * 1e3
        mb = sum(os.path.getsize(os.path.join(root, f)) for root, _, fs
                 in os.walk(path) for f in fs) / 1e6
        t0 = time.perf_counter()
        back, s = restore_train_state(path, state, cfg, device=CARD)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        same = all(bool(torch.equal(a, b)) for a, b in zip(
            back.params.parameters(), state.params.parameters()))
        check(s == d["steps"] and same, f"[{tag}] (e) restore: step {s}, "
              f"parameters equal {same}")
    log(f"[{tag}] (e) supervisor drill at full width, depth cut to "
        f"{d['layers']} of 32 layers for time: failure injected at step "
        f"{d['fail_at']}, {drill['restarts']} restart, resumed from step "
        f"{restored}; losses of steps {replay.start}-{replay.stop - 1} "
        f"against the uninterrupted run: "
        + ", ".join(f"{drill['loss'][s]:.6f}/{plain['loss'][s]:.6f}"
                    for s in replay)
        + f" (max rel {max(diffs.values()):.3g}, bound {DRILL_TOL}); "
        f"snapshot {mb:.1f} MB, save {save_ms:.1f} ms, restore "
        f"{restore_ms:.1f} ms (host clock, warm page cache)")
    del state, back
    torch.cuda.empty_cache()
    return ({body: {"train_drill": counts[body]}},
            dict(restarts=drill["restarts"], replay_max_rel=max(
                diffs.values()), snapshot_mb=mb, save_ms=save_ms,
                restore_ms=restore_ms))


def _train_families(tag="23"):
    """(f) Every family's reduced f32 sibling: one step on the card
    through ``"cuda"`` and ``"ref"`` from the same weights and batch,
    loss and grad_norm within 1e-4 relative."""
    from repro_torch.configs import list_archs
    paths, figs = {}, {}
    B, S = FAMILY_TRAIN["batch"], FAMILY_TRAIN["seq"]
    for arch in list_archs():
        cfg = family_config(arch, small=True)
        want = _b8_launches(cfg)
        lc, gc, counts = _one_step(cfg, "cuda", "none", B, S, tag, want)
        lr_, gr, _ = _one_step(cfg, "ref", "none", B, S, tag, {})
        figs[arch] = dict(loss_rel=_rel(lc, lr_), grad_norm_rel=_rel(gc, gr))
        check(max(figs[arch].values()) <= TRAIN_F32,
              f"[{tag}] (f) {cfg.name} cuda vs ref beyond {TRAIN_F32}: "
              f"{figs[arch]}")
        for b, n in want.items():
            paths.setdefault(b, {})[f"train_{arch}_smoke"] = n
        log(f"[{tag}] (f) {cfg.name}: one f32 step, cuda vs ref loss "
            f"{lc:.6f} (rel {figs[arch]['loss_rel']:.3g}), grad_norm "
            f"{gc:.6f} (rel {figs[arch]['grad_norm_rel']:.3g}); B8 {want}")
    return paths, figs


def phase_training():
    """Phase 23: training (module docstring).  Returns (B8's launches by
    body and path, {body: timing row} at the training launch, the
    figures)."""
    t0 = time.perf_counter()
    launches = {"B8-TC": {}, "B8-TF32": {}}

    def record(paths):
        for body, by_path in paths.items():
            launches[body].update(by_path)

    errs, rows = _train_attention()
    figures = {"attention_max_abs_err": errs,
               "chunked": _chunked_on_card()}
    paths, figures["main_path"] = _train_main_path()
    record(paths)
    paths, figures["cuda_vs_ref"] = _train_cuda_vs_ref()
    record(paths)
    paths, figures["drill"] = _supervisor_drill()
    record(paths)
    paths, figures["families"] = _train_families()
    record(paths)
    figures["phase_s"] = time.perf_counter() - t0
    log(f"[23] phase 23 in {figures['phase_s']:.1f} s")
    return launches, rows, figures


# The meshed launchers (phase 24): SmolLM-360M at full width and depth on
# the reference's mesh for the one card, (1, 1): one rank, an NCCL group
# of one, parameters and state as DTensors placed by the sharding plan, B8
# on each rank's shard through local_map.
MESHED = dict(serve_gen=8, steps=5, drill_layers=8, drill_steps=7,
              drill_ckpt=4)
# bounds (relative) against the unmeshed runs: the bf16 main path, the f32
# twin (the drill's resumed steps must equal the uninterrupted run's)
MESHED_BF16, MESHED_F32 = 1e-4, 1e-5

DRILL_CHILD = """
import json, sys
import torch
from repro_torch.kernels.flash_attn import ops
from repro_torch.launch.train import build_mesh_for_available, main
from repro_torch.runtime import join_group
from repro_torch.sharding import make_plan
kind = torch.device(sys.argv[2]).type
with join_group(kind):
    _, report = main(sys.argv[3:],
                     plan=make_plan(build_mesh_for_available(kind)))
json.dump({"loss": report["loss"], "grad_norm": report["grad_norm"],
           "restarts": report["restarts"], "mesh": report["mesh"],
           "b8_tc": ops.kernel_launches_tc, "plain": ops.plain_calls},
          open(sys.argv[1], "w"))
"""


def _parse_serve(text):
    """The launcher's prefill ms and decode ms a step, from its lines."""
    import re
    pre = re.search(r"prefill \d+x\d+: ([\d.]+) ms", text)
    dec = re.search(r"decode \d+ steps: ([\d.]+) ms/step", text)
    return (float(pre.group(1)) if pre else None,
            float(dec.group(1)) if dec else None)


def _meshed_serve(plan, tag="24"):
    """(a) ``serve_lm`` on the mesh (``plan=``) and without: 8 x 1960
    prompts, 8 greedy decode steps, the same tokens, B8-TC once a layer
    on the meshed prefill; then the prefill and decode steps timed on the
    mesh and off it from the same weights (host clock, the device split
    of one prefill each)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import init_params
    from repro_torch.models.convert import place
    from repro_torch.serve import make_decode_step, make_prefill_step

    cfg = get_config(SERVE["arch"])
    L = cfg.num_layers
    B, S, G = SERVE["batch"], SERVE["prompt"], MESHED["serve_gen"]
    argv = ["--arch", SERVE["arch"], "--batch", str(B), "--prompt-len",
            str(S), "--gen", str(G)]
    if CARD != "cuda":
        argv += ["--device", CARD]
    gens, figs, launches = {}, {}, {}
    for path, on in (("meshed_serve_lm", plan),
                     ("unmeshed_serve_lm", None)):
        out = io.StringIO()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        plain = attn_ops_plain_calls()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            gens[path] = serve_main(argv, plan=on)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_counts(f"[{tag}] (a) {path}", counts, **{"B8-TC": L})
        check(attn_ops_plain_calls() == plain, f"[{tag}] (a) {path}: plain "
              f"attention calls through B8's wrapper")
        launches[path] = counts["B8-TC"]
        pre, dec = _parse_serve(out.getvalue())
        figs[path] = dict(launcher_s=wall, prefill_ms=pre,
                          decode_ms_per_step=dec,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        for line in out.getvalue().splitlines():
            log(f"[{tag}] (a) {path} | {line}")
    a, b = gens["meshed_serve_lm"], gens["unmeshed_serve_lm"]
    check(a.shape == (B, G) and np.array_equal(a, b), f"[{tag}] (a) the "
          f"meshed launcher's tokens differ from the unmeshed one's: "
          f"{a[:2].tolist()} vs {b[:2].tolist()}")
    # the steps timed off the mesh, then on it, from the same weights
    # (placed on the mesh in place after the unmeshed timings)
    batch = _serve_batch(cfg, B, S, CARD)
    p = init_params(prng.PRNGKey(SERVE["seed"]), cfg, device=CARD)
    timed = {}
    for label, kw in (("unmeshed", {}),
                      ("meshed", dict(constrain=plan.constrain, plan=plan))):
        if kw:
            place(p, cfg, plan, replicate=True)
        prefill = make_prefill_step(cfg, max_len=S + G + 1, attn_impl="cuda",
                                    **kw)
        decode = make_decode_step(cfg, **({"constrain": plan.constrain}
                                          if kw else {}))
        row = time_prefill(prefill, p, batch, f"(a) {label} prefill "
                           f"{B}x{S}", tag=tag)
        logits, cache = prefill(p, batch)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in range(G):
            pos = torch.full((B, 1), S + g, dtype=torch.int32, device=CARD)
            tok, _, cache = decode(p, cache, tok, pos)
        torch.cuda.synchronize()
        row["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / G
        timed[label] = row
        del logits, cache
    log(f"[{tag}] (a) {cfg.name} served on the mesh "
        f"{_mesh_shape(plan)} and off it, {B} x {S} prompts, {G} greedy "
        f"steps: tokens equal; B8-TC {launches['meshed_serve_lm']} launches "
        f"on the meshed prefill (one a layer, on the rank's shard), 0 plain "
        f"calls; prefill wall (warm, min of 3) meshed "
        f"{min(timed['meshed']['wall_runs_ms']):.3f} ms vs unmeshed "
        f"{min(timed['unmeshed']['wall_runs_ms']):.3f} ms; decode "
        f"{timed['meshed']['decode_ms_per_step']:.3f} vs "
        f"{timed['unmeshed']['decode_ms_per_step']:.3f} ms a step; "
        f"launcher peaks {figs['meshed_serve_lm']['peak_gib']:.3f} / "
        f"{figs['unmeshed_serve_lm']['peak_gib']:.3f} GiB")
    del p
    torch.cuda.empty_cache()
    return ({"B8-TC": {"meshed_serve_lm": launches["meshed_serve_lm"]}},
            dict(figs, timed=timed))


def attn_ops_plain_calls():
    from repro_torch.kernels.flash_attn import ops as attn_ops
    return attn_ops.plain_calls


def _mesh_shape(plan):
    return dict(zip(plan.mesh.mesh_dim_names, plan.mesh.shape))


def _meshed_train(plan, main_path, tag="24"):
    """(b) ``train()`` on the mesh: the first 5 of phase 23's main-path
    steps (same seed, batches and schedule: the warm-up covers them),
    loss and ``grad_norm`` each within 1e-4 relative of phase 23's, B8-TC
    twice a layer a step; step ms, peak; one more meshed step profiled."""
    import statistics

    import torch
    from repro_torch.launch.train import main as train_main, place_batch
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = _train_cfg()
    body, per_fwd = next(iter(_b8_launches(cfg).items()))
    steps = MESHED["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    plain = attn_ops_plain_calls()
    t0 = time.perf_counter()
    state, report = train_main(_train_args(
        ["--steps", str(steps), "--remat", TRAIN["remat"], "--log-every",
         "1"]), plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_counts(f"[{tag}] (b) meshed train", counts,
                 **{body: 2 * per_fwd * steps})
    check(attn_ops_plain_calls() == plain, f"[{tag}] (b) plain attention "
          f"calls through B8's wrapper")
    check(report["mesh"] == _mesh_shape(plan), f"[{tag}] (b) the launcher's "
          f"mesh {report['mesh']}")
    rel = {}
    for k, want in (("loss", main_path["losses"]),
                    ("grad_norm", main_path["grad_norms"])):
        rel[k] = max(_rel(report[k][s], want[s - 1])
                     for s in range(1, steps + 1))
        check(rel[k] <= MESHED_BF16, f"[{tag}] (b) meshed {k} against phase "
              f"23's beyond {MESHED_BF16}: "
              f"{[report[k][s] for s in range(1, steps + 1)]} vs "
              f"{want[:steps]}")
    step_ms = report["step_ms"]
    med = statistics.median(step_ms[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    losses = [report["loss"][s] for s in range(1, steps + 1)]
    # one more step on the mesh from the launcher's state (its mesh lives
    # on in this phase's group), timed, then profiled
    opt = AdamWConfig(lr=float(TRAIN["lr"]), warmup_steps=int(
        TRAIN["warmup"]), total_steps=steps)
    step = make_train_step(cfg, opt, remat=TRAIN["remat"], attn_impl="cuda",
                           constrain=plan.constrain)
    holder = [state]
    batch = place_batch(_train_batch(cfg, TRAIN["batch"], TRAIN["seq"],
                                     step=steps), cfg, plan)
    del state

    def one():
        holder[0], m = step(holder[0], batch)
        float(m["loss"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    walls = [(time.perf_counter() - t0) * 1e3]
    split = _device_time(one, min(walls), "(b) one meshed training step",
                         tag=tag)
    log(f"[{tag}] (b) {cfg.name} trained {steps} steps on the mesh "
        f"{_mesh_shape(plan)} through train() (bf16, {cfg.num_layers} "
        f"layers, batch {TRAIN['batch']} x {TRAIN['seq']}, remat "
        f"{TRAIN['remat']}) in {wall:.1f} s: {body} {counts[body]} launches "
        f"({counts[body] // steps} a step), 0 plain calls; loss "
        f"{' '.join(f'{x:.6f}' for x in losses)}"
        f" (max rel {rel['loss']:.3g} against phase 23's, bound "
        f"{MESHED_BF16}), grad_norm max rel {rel['grad_norm']:.3g}; step ms "
        f"(host clock) first {step_ms[0]:.1f}, median of the rest "
        f"{med:.1f} ({tokens / med * 1e3:.0f} tokens/s) against phase 23's "
        f"{main_path['median_step_ms']:.1f}; peak {peak / 2**30:.3f} GiB "
        f"against {main_path['peak_gib']:.3f}")
    del holder, step, batch
    torch.cuda.empty_cache()
    return ({body: {"meshed_train": counts[body]}},
            dict(losses=losses,
                 grad_norms=[report["grad_norm"][s]
                             for s in range(1, steps + 1)],
                 rel=rel, step_ms=step_ms, median_step_ms=med,
                 tokens_per_s=tokens / med * 1e3, peak_gib=peak / 2**30,
                 wall_s=wall, profiled_walls_ms=walls, **(split or {})))


def _meshed_twin(plan, tag="24"):
    """(c) The 4-layer f32 twin (batch 2 x 2048), 5 steps on the mesh and
    off it from the same weights and batches: loss and ``grad_norm``
    within 1e-5 relative, B8-TF32 twice a layer a step on the mesh."""
    import torch
    from repro_torch.core import prng
    from repro_torch.launch.train import place_batch
    from repro_torch.models import init_params
    from repro_torch.models.convert import place
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step

    cfg = _train_cfg(layers=TRAIN_TWIN["layers"], dtype="float32")
    body, per_fwd = next(iter(_b8_launches(cfg).items()))
    steps, B, S = MESHED["steps"], TRAIN_TWIN["batch"], TRAIN["seq"]
    opt = AdamWConfig(lr=float(TRAIN["lr"]), warmup_steps=int(
        TRAIN["warmup"]), total_steps=TRAIN["steps"])
    runs, counts = {}, None
    for label in ("unmeshed", "meshed"):
        on = label == "meshed"
        params = init_params(prng.PRNGKey(0), cfg, device=CARD)
        state = init_train_state(place(params, cfg, plan) if on else params,
                                 opt)
        step = make_train_step(cfg, opt, remat=TRAIN["remat"],
                               attn_impl="cuda",
                               **({"constrain": plan.constrain} if on else {}))
        reset_counts()
        out = []
        for s in range(steps):
            batch = _train_batch(cfg, B, S, step=s)
            state, m = step(state, place_batch(batch, cfg, plan) if on
                            else batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[label] = out
        if on:
            counts = read_counts()
        del state, step, params
        torch.cuda.empty_cache()
    check_counts(f"[{tag}] (c) meshed f32 twin", counts,
                 **{body: 2 * per_fwd * steps})
    rel = max(_rel(a, b) for x, y in zip(runs["meshed"], runs["unmeshed"])
              for a, b in zip(x, y))
    check(rel <= MESHED_F32, f"[{tag}] (c) meshed f32 twin beyond "
          f"{MESHED_F32}: {runs}")
    log(f"[{tag}] (c) f32 twin ({cfg.num_layers} layers, batch {B} x {S}, "
        f"{body} {counts[body]} launches on the mesh): {steps} steps, loss "
        f"and grad_norm on the mesh vs off it max rel {rel:.3g} (bound "
        f"{MESHED_F32}); losses {[round(x[0], 6) for x in runs['meshed']]}")
    return {body: {"meshed_train_f32_twin": counts[body]}}, dict(
        rel=rel, runs=runs)


def _meshed_drill(plan, tag="24"):
    """(d) Train on the mesh with a checkpoint (8 layers, 7 steps, one at
    step 4), then restore step 4 into a fresh mesh in a fresh process
    (the launcher through ``python -c``, given the plan of its own group
    of one) and continue to step 7: steps 5-7's loss and ``grad_norm``
    equal to the uninterrupted run's."""
    import json
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.launch.train import main as train_main

    d = MESHED
    cfg = _train_cfg(layers=d["drill_layers"])
    body, per_fwd = next(iter(_b8_launches(cfg).items()))
    common = ["--steps", str(d["drill_steps"]), "--remat", TRAIN["remat"],
              "--log-every", "1", "--ckpt-every", str(d["drill_ckpt"])]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        first = os.path.join(tmp, "first")
        resumed = os.path.join(tmp, "resumed")
        reset_counts()
        _, whole = train_main(_train_args(
            common + ["--ckpt-dir", first], d["drill_layers"]), plan=plan)
        counts = read_counts()
        check_counts(f"[{tag}] (d) meshed run with checkpoints", counts,
                     **{body: 2 * per_fwd * d["drill_steps"]})
        step_dir = f"step_{d['drill_ckpt']:08d}"
        shutil.copytree(os.path.join(first, step_dir),
                        os.path.join(resumed, step_dir))
        out = os.path.join(tmp, "resumed.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", DRILL_CHILD, out, CARD] + _train_args(
                common + ["--ckpt-dir", resumed], d["drill_layers"]),
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[{tag}] (d) fresh process | {line}")
        check(proc.returncode == 0, f"[{tag}] (d) the fresh process exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        child = json.load(open(out))
    replay = range(d["drill_ckpt"] + 1, d["drill_steps"] + 1)
    check(sorted(map(int, child["loss"])) == list(replay)
          and child["restarts"] == 0, f"[{tag}] (d) the fresh process ran "
          f"steps {sorted(child['loss'])}, {child['restarts']} restarts")
    check(child["b8_tc"] == 2 * per_fwd * len(replay) and child["plain"] == 0,
          f"[{tag}] (d) the fresh process: {child['b8_tc']} B8-TC launches, "
          f"{child['plain']} plain calls")
    diffs = {s: max(_rel(child["loss"][str(s)], whole["loss"][s]),
                    _rel(child["grad_norm"][str(s)], whole["grad_norm"][s]))
             for s in replay}
    exact = all(child[k][str(s)] == whole[k][s] for s in replay
                for k in ("loss", "grad_norm"))
    check(exact, f"[{tag}] (d) steps {replay.start}-{replay.stop - 1} after "
          f"the restore differ from the uninterrupted run's: {diffs}")
    log(f"[{tag}] (d) drill on the mesh (depth cut to {d['drill_layers']} "
        f"layers): checkpoint at step {d['drill_ckpt']}, restored into a "
        f"fresh mesh {child['mesh']} in a fresh process ({child_s:.1f} s), "
        f"steps {replay.start}-{replay.stop - 1}: "
        + ", ".join(f"{child['loss'][str(s)]:.6f}/{whole['loss'][s]:.6f}"
                    for s in replay)
        + f" (max rel {max(diffs.values()):.3g}, bit for bit)")
    torch.cuda.empty_cache()
    return ({body: {"meshed_train_drill": counts[body],
                    "meshed_train_drill_resumed": child["b8_tc"]}},
            dict(replay_max_rel=max(diffs.values()), exact=exact,
                 child_s=child_s))


def phase_meshed(train_figures,
                 parts=("serve", "train", "twin", "drill")):
    """Phase 24: the meshed launchers (module docstring; ``parts`` picks
    (a)-(d), all of them in the smoke).  Returns (B8's launches by body
    and path, the figures)."""
    import torch
    from repro_torch.launch.train import build_mesh_for_available
    from repro_torch.runtime import join_group
    from repro_torch.sharding import make_plan

    t0 = time.perf_counter()
    launches = {"B8-TC": {}, "B8-TF32": {}}
    figures = {}

    def record(paths):
        for body, by_path in paths.items():
            launches[body].update(by_path)

    # one group for the phase: the launchers run on its plan (a world of
    # one would run them without a mesh), which lives across them
    with join_group(torch.device(CARD).type) as (rank, world):
        plan = make_plan(build_mesh_for_available(torch.device(CARD).type))
        check(world == 1 and _mesh_shape(plan) == {"data": 1, "model": 1},
              f"[24] mesh {_mesh_shape(plan)} over {world} ranks")
        if "serve" in parts:
            paths, figures["serve"] = _meshed_serve(plan)
            record(paths)
        if "train" in parts:
            paths, figures["train"] = _meshed_train(
                plan, train_figures["main_path"])
            record(paths)
        if "twin" in parts:
            paths, figures["f32_twin"] = _meshed_twin(plan)
            record(paths)
        if "drill" in parts:
            paths, figures["drill"] = _meshed_drill(plan)
            record(paths)
    figures["phase_s"] = time.perf_counter() - t0
    log(f"[24] phase 24 in {figures['phase_s']:.1f} s")
    return launches, figures


# -- phase 25: every LM family under the plan on the card's mesh -----------

MESHED_FAMILIES = ("minicpm-2b", "qwen2-vl-7b", "qwen2-moe-a2.7b",
                   "grok-1-314b", "minicpm3-4b", "jamba-1.5-large-398b",
                   "rwkv6-7b", "musicgen-medium")
FAMILY_MESH = dict(batch=4, seq=16, prompt=12, gen=4)


class _Routing:
    """Records every MoE routing call's expert ids and kept mask, whole
    (``moe.route``, in order)."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route, self.picks = moe, moe.route, []

        def route(p, cfg, xt, C):
            got = self._route(p, cfg, xt, C)
            self.picks += [_whole(got[1]).cpu(), _whole(got[3]).cpu()]
            return got

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _family_steps(arch, plan):
    """One train step, a prefill and 4 greedy decode steps of ``arch``'s
    reduced f32 sibling on ``plan``'s mesh (None: unmeshed), the weights
    and batches of a seed: (host tensors of every value, B8 launches of
    the train step and of the serving steps)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import reduced
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.train import place_batch
    from repro_torch.models import init_params
    from repro_torch.models.convert import place
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    cfg = reduced(get_config(arch))
    B, S, P, G = (FAMILY_MESH[k] for k in ("batch", "seq", "prompt", "gen"))
    c = {} if plan is None else {"constrain": plan.constrain}
    out, launches = {}, {}

    def batch(seed, seq, labels):
        b = make_batch(cfg, DataConfig(seed=seed), step=0, shard=0,
                       batch=B, seq_len=seq)
        b = {k: torch.from_numpy(v).to(CARD) for k, v in b.items()
             if labels or k != "labels"}
        return b if plan is None else place_batch(b, cfg, plan)

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = init_params(prng.PRNGKey(1), cfg, device=CARD)
    state = init_train_state(params if plan is None
                             else place(params, cfg, plan), opt)
    step = make_train_step(cfg, opt, attn_impl="cuda", **c)
    reset_counts()
    with _Routing() as r:
        state, m = step(state, batch(3, S, True))
    torch.cuda.synchronize()
    launches["train"] = read_counts()
    for k in ("loss", "grad_norm", "drop_frac"):
        out[k] = _whole(m[k]).cpu()
    out["embed"] = _whole(state.params.embed.detach()).cpu()
    out["train_picks"] = r.picks
    del state, params

    params = init_params(prng.PRNGKey(2), cfg, device=CARD)
    if plan is not None:
        place(params, cfg, plan)
    prefill = make_prefill_step(cfg, max_len=P + G, attn_impl="cuda",
                                plan=plan, **c)
    decode = make_decode_step(cfg, **c)
    reset_counts()
    with _Routing() as r:
        logits, cache = prefill(params, batch(0, P, False))
        out["prefill"] = _whole(logits).cpu()
        tok = _whole(logits)[..., -1, :].argmax(-1).to(torch.int32)[..., None]
        toks = []
        for g in range(G):
            pos = torch.full((3, B, 1) if cfg.mrope_sections else (B, 1),
                             P + g, dtype=torch.int32, device=CARD)
            tok, lg, cache = decode(params, cache, tok, pos)
            tok = _whole(tok)
            toks.append(tok.cpu())
    torch.cuda.synchronize()
    launches["serve"] = read_counts()
    out["tokens"] = torch.stack(toks)
    out["decode"] = _whole(lg).cpu()
    out["cache"] = [_whole(t).cpu() for layer in cache for t in layer.values()]
    out["serve_picks"] = r.picks
    return out, launches


def _same_values(a, b):
    """Whether two trees of host tensors are equal bit for bit."""
    import torch
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_values(x, y)
                                        for x, y in zip(a, b))
    def bits(t):
        t = t.reshape(-1)
        return t.view(torch.uint8) if t.is_floating_point() else t

    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(bits(a), bits(b)))


def phase_meshed_families(tag="25"):
    """Phase 25: each of the eight families' reduced f32 siblings on the
    card's (1, 1) plan, one train step, a prefill and 4 greedy decode
    steps (parameters by ``plan.param_specs``, caches by
    ``plan.cache_specs``), bit for bit equal to the same steps unmeshed:
    loss, ``grad_norm``, ``drop_frac``, the updated embedding, logits,
    caches, tokens and every MoE routing call's picks and kept mask.
    B8-TF32 runs where the family's attention reaches it (the reduced
    siblings are f32 at D 16), as many launches on the mesh as off it.
    Returns (B8's launches by path, the figures)."""
    import torch
    from repro_torch.launch.train import build_mesh_for_available
    from repro_torch.runtime import join_group
    from repro_torch.sharding import make_plan

    t0 = time.perf_counter()
    kind = torch.device(CARD).type
    figures, totals = {}, {"train": 0, "serve": 0}
    with join_group(kind) as (rank, world):
        plan = make_plan(build_mesh_for_available(kind))
        check(world == 1 and _mesh_shape(plan) == {"data": 1, "model": 1},
              f"[{tag}] mesh {_mesh_shape(plan)} over {world} ranks")
        failed = []
        for arch in MESHED_FAMILIES:
            # a family that fails is reported and the next one runs; the
            # phase fails after the last
            try:
                figures[arch] = _meshed_family(arch, plan, totals, tag)
            except Exception as e:
                traceback.print_exc()
                log(f"[{tag}] {arch}: FAILED ({type(e).__name__}: {e})")
                failed.append(arch)
        check(not failed, f"[{tag}] failed families: {failed}")
    check(totals["train"] > 0 and totals["serve"] > 0,
          f"[{tag}] B8-TF32 never ran: {totals}")
    figures["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase 25 in {figures['phase_s']:.1f} s")
    return {"B8-TF32": {"meshed_families_train": totals["train"],
                        "meshed_families_serve": totals["serve"]}}, figures


def _meshed_family(arch, plan, totals, tag):
    """Phase 25 for one family (its docstring): the checks, the family's
    figures; ``totals`` gains its B8-TF32 launches."""
    t1 = time.perf_counter()
    want, off = _family_steps(arch, None)
    t2 = time.perf_counter()
    got, on = _family_steps(arch, plan)
    t3 = time.perf_counter()
    bad = [k for k in want if not _same_values(got[k], want[k])]
    check(not bad, f"[{tag}] {arch}: the meshed steps differ from the "
          f"unmeshed ones in {bad}")
    for part in ("train", "serve"):
        check(on[part] == off[part], f"[{tag}] {arch} {part}: launches "
              f"{on[part]} on the mesh, {off[part]} off")
        check_counts(f"[{tag}] {arch} {part}", on[part],
                     **{"B8-TF32": on[part]["B8-TF32"]})
        totals[part] += on[part]["B8-TF32"]
    picks = len(want["train_picks"]) // 2
    log(f"[{tag}] {arch} (reduced, f32) on {_mesh_shape(plan)}: train "
        f"step, prefill {FAMILY_MESH['batch']}x{FAMILY_MESH['prompt']} and "
        f"{FAMILY_MESH['gen']} decode steps bit for bit equal to the "
        f"unmeshed ones (loss {float(got['loss']):.6f}, grad_norm "
        f"{float(got['grad_norm']):.6f}, drop_frac "
        f"{float(got['drop_frac']):.6f}, {picks} routing calls equal); "
        f"B8-TF32 {on['train']['B8-TF32']} + {on['serve']['B8-TF32']} "
        f"launches; {t2 - t1:.2f} s unmeshed, {t3 - t2:.2f} s meshed")
    return dict(loss=float(got["loss"]), grad_norm=float(got["grad_norm"]),
                drop_frac=float(got["drop_frac"]), routing_calls=picks,
                b8_tf32_train=on["train"]["B8-TF32"],
                b8_tf32_serve=on["serve"]["B8-TF32"],
                unmeshed_s=t2 - t1, meshed_s=t3 - t2)


# -- phase 26: the roofline on the card -------------------------------------

ROOFLINE = dict(arch="smollm-360m", batch=8, prompt=1960, decode_len=2048,
                train_seq=2048)


def _start_dryrun_cell(out_dir):
    """One dry-run cell (smollm-360m train_4k on both production meshes)
    in a subprocess of this machine's torch: (process, its output
    file)."""
    import os
    log_f = open(Path(out_dir) / "dryrun.log", "w+")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "train_4k", "--mesh", "both", "--out",
         str(out_dir)], cwd=str(ROOT), env=env, stdout=log_f,
        stderr=subprocess.STDOUT, text=True)
    return proc, log_f, out_dir


def _finish_dryrun_cell(proc, log_f, out_dir, tag="26"):
    try:
        rc = proc.wait(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log_f.seek(0)
    text = log_f.read()
    log_f.close()
    for line in text.splitlines():
        if line.startswith("[dryrun]"):
            log(f"[{tag}] (d) {line}")
    check(rc == 0, f"[{tag}] (d) the dry run exited {rc}: {text[-2000:]}")
    recs = {}
    for mesh in ("16x16", "2x16x16"):
        with open(Path(out_dir) / f"smollm-360m__train_4k__{mesh}.json") as f:
            recs[mesh] = json.load(f)
    ratio = recs["2x16x16"]["flops_per_chip"] / \
        recs["16x16"]["flops_per_chip"]
    check(0.45 <= ratio <= 0.55, f"[{tag}] (d) per-card FLOPs on "
          f"(2, 16, 16) over (16, 16): {ratio}")
    check(all(r["replication"] >= 1 and r["compute_s"] > 0
              for r in recs.values()), f"[{tag}] (d) records: {recs}")
    log(f"[{tag}] (d) the dry-run cell on this machine's torch: per-card "
        f"FLOPs (2,16,16)/(16,16) = {ratio:.4f}, replication "
        f"{recs['16x16']['replication']:.3f}")
    return {m: {k: r[k] for k in ("flops_per_chip", "hbm_bytes_per_chip",
                                  "collective_link_bytes", "compute_s",
                                  "memory_s", "collective_s", "bound",
                                  "replication", "run_seconds")}
            for m, r in recs.items()}


def _roofline_step(label, run, counter_args, card, tag="26"):
    """Count ``run`` on the card and the same step on meta tensors at the
    same shapes; check the counts equal; time ``run`` again with the
    profiler.  Returns the figures."""
    import torch
    from repro_torch.launch.dryrun import _step_args
    from repro_torch.roofline import StepCounter, analyze_step
    reset_counts()
    with StepCounter() as c:
        run()
        torch.cuda.synchronize()
    counts = read_counts()
    step, args = _step_args(*counter_args)
    with StepCounter() as meta:
        step(*args)
    del step, args
    check(dict(c.flops_by_dtype) == dict(meta.flops_by_dtype),
          f"[{tag}] {label}: FLOPs on the card {dict(c.flops_by_dtype)} "
          f"vs on meta tensors {dict(meta.flops_by_dtype)}")
    check(c.bytes == meta.bytes, f"[{tag}] {label}: bytes on the card "
          f"{c.bytes} vs on meta tensors {meta.bytes}")
    rec = analyze_step(c, chips=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    split = _device_time(run, wall, label, tag=tag) or {}
    busy = split.get("busy_ms")
    bound_ms = max(rec["compute_s"], rec["memory_s"]) * 1e3
    b8 = [r for (op, _, _), r in c.records.items() if op == "flash_attn_fwd"]
    fig = dict(flops_by_dtype=dict(c.flops_by_dtype), hbm_bytes=c.bytes,
               compute_s=rec["compute_s"], memory_s=rec["memory_s"],
               bound=rec["bound"], wall_ms=wall, device_busy_ms=busy,
               roofline_share=None if not busy else bound_ms / busy,
               b8_calls=sum(r.calls for r in b8),
               b8_flops=sum(r.flops for r in b8), launches=counts,
               card=card)
    log(f"[{tag}] {label}: FLOPs by dtype "
        f"{ {d: f'{f:.6e}' for d, f in c.flops_by_dtype.items()} }, "
        f"{c.bytes:.6e} HBM bytes, equal on meta tensors; compute_s "
        f"{rec['compute_s'] * 1e3:.3f} ms, memory_s "
        f"{rec['memory_s'] * 1e3:.3f} ms ({rec['bound']}-bound) against "
        f"{'not measured' if not busy else f'{busy:.3f} ms'} device busy "
        f"and {wall:.3f} ms wall: roofline share "
        f"{'not measured' if not busy else f'{bound_ms / busy:.4f}'} | "
        f"{card}")
    return fig


def phase_roofline(dryrun, card, tag="26"):
    """Phase 26: SmolLM-360M at full width and depth (bf16) under the
    step counter on the card: (a) the 8 x 1960 prefill, (b) one decode
    step at batch 8 over a 2,048-slot cache, (c) one 8 x 2048 train step
    (remat ``"full"``), each through B8-TC: FLOPs by dtype, B8's FLOPs
    through its custom operator's formula (``4·B·Hq·Sq²·D/2`` at each of
    its launches), the count equal to the same step counted on meta
    tensors at the same shapes, ``compute_s``/``memory_s`` at H100 rates
    beside the profiler's device-busy ms, and the roofline share (the
    larger term over the busy time); then (d) the dry-run cell started
    with phase 25 (smollm-360m train_4k on both production meshes, in a
    subprocess of this machine's torch).  ``card`` is ``nvidia-smi``'s
    name and power limit.  Returns (B8's launches by path, the
    figures)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step

    t0 = time.perf_counter()
    cfg = get_config(ROOFLINE["arch"])
    B, S, D = ROOFLINE["batch"], ROOFLINE["prompt"], cfg.head_dim
    L, Hq = cfg.num_layers, cfg.num_heads
    figures = {}
    params = init_params(prng.PRNGKey(0), cfg, device=CARD)

    prefill = make_prefill_step(cfg, max_len=S, attn_impl="cuda")
    batch = _serve_batch(cfg, B, S, CARD)
    figures["prefill"] = _roofline_step(
        f"(a) prefill {B}x{S}", lambda: prefill(params, batch),
        (cfg, ShapeSpec("prefill", S, B, "prefill"), None, {},
               "full", "cuda"), card, tag)
    per_launch = 4 * B * Hq * S * S * D // 2
    f = figures["prefill"]
    check(f["b8_calls"] == L and f["b8_flops"] == L * per_launch and
          f["launches"]["B8-TC"] == L, f"[{tag}] (a) B8: {f['b8_calls']} "
          f"calls, {f['b8_flops']} FLOPs, {f['launches']['B8-TC']} "
          f"launches; expected {L} x {per_launch}")
    check_counts(f"[{tag}] (a) prefill", f["launches"], **{"B8-TC": L})

    decode = make_decode_step(cfg)
    T = ROOFLINE["decode_len"]
    cache = init_cache(cfg, B, T, device=CARD)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=CARD)
    pos = torch.full((B, 1), S, dtype=torch.int32, device=CARD)
    figures["decode"] = _roofline_step(
        f"(b) decode step, batch {B}, {T}-slot cache",
        lambda: decode(params, cache, tok, pos),
        (cfg, ShapeSpec("decode", T, B, "decode"), None, {}, "full",
         "cuda"), card, tag)
    check_counts(f"[{tag}] (b) decode", figures["decode"]["launches"])
    del cache

    Tt = ROOFLINE["train_seq"]
    opt = AdamWConfig()
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, remat="full", attn_impl="cuda")
    b = make_batch(cfg, DataConfig(seed=0), step=0, shard=0, batch=B,
                   seq_len=Tt)
    b = {k: torch.from_numpy(v).to(CARD) for k, v in b.items()}
    figures["train"] = _roofline_step(
        f"(c) train step {B}x{Tt}", lambda: step(state, b),
        (cfg, ShapeSpec("train", Tt, B, "train"), None, {}, "full",
         "cuda"), card, tag)
    per_launch = 4 * B * Hq * Tt * Tt * D // 2
    f = figures["train"]
    # the forward, then its recomputation under remat "full"
    check(f["b8_calls"] == 2 * L and f["b8_flops"] == 2 * L * per_launch,
          f"[{tag}] (c) B8: {f['b8_calls']} calls, {f['b8_flops']} FLOPs")
    check_counts(f"[{tag}] (c) train", f["launches"], **{"B8-TC": 2 * L})
    del state, step, params
    torch.cuda.empty_cache()

    figures["dryrun"] = _finish_dryrun_cell(*dryrun)
    figures["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase 26 in {figures['phase_s']:.1f} s")
    return {"B8-TC": {"roofline_prefill": figures["prefill"]["launches"][
        "B8-TC"], "roofline_train": figures["train"]["launches"]["B8-TC"]}
    }, figures


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'}: "
              f"{e}", file=sys.stderr)
        return 1
    import os
    import tempfile
    from repro_torch.core import failover
    failover.add_degrade_listener(DEGRADES.append)
    # a cache of this run's own, so that no cache on the machine steers a
    # phase; the committed seed rows still apply
    tune = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(tune.name) / "autotune.json")
    try:
        card = phase_card_and_build()
        dense_err, rows = phase_kernel()
        sparse_err, sparse_rows = phase_sparse_kernel()
        b1 = phase_paper()
        b1["full_width_explore"], dense_res = phase_full_width()
        b2 = {"full_width_ell_explore": phase_full_width_ell(dense_res)}
        b3 = {"full_width_hybrid_explore": phase_full_width_hybrid()}
        (b1["traces_first"], b1["traces_random"],
         b3["traces_random_hybrid"]) = phase_traces()
        delay_err, delay_rows = phase_delay_kernels()
        b4, b5e, b5c = phase_delay_full_width()
        delayed = phase_delay_paper_and_traces()
        shard_err, shard_rows = phase_shard_kernels()
        sharded, sharded_res = phase_sharded(dense_res)
        (sharded["B7"]["sharded_large_explore"],
         b2["ring_lattice_explore"]) = phase_sharded_large()
        attn_errs, attn_rows = phase_attention_kernel()
        served = phase_serving()
        snp_paths, snp_figures = phase_snp_service(dense_res, sharded_res)
        del dense_res, sharded_res
        shapes = phase_planner_kernels()
        planned, _ = phase_planner()
        planned["open_plans"] = phase_open_plans()
        dense_paths, dense_figures = phase_dense_rows()
        sync_paths, probe_err, probe_rows, sync_figures = phase_zero_sync()
        family_paths, family_rows, family_figures = phase_lm_families()
        train_paths, train_rows, train_figures = phase_training()
        mesh_paths, mesh_figures = phase_meshed(train_figures)
        # phase 26's dry-run cell runs in a subprocess beside phase 25
        dry_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
        dry = _start_dryrun_cell(dry_dir.name)
        try:
            family_mesh_paths, family_mesh_figures = phase_meshed_families()
            roof_paths, roof_figures = phase_roofline(dry, card)
        finally:
            if dry[0].poll() is None:
                dry[0].kill()
                dry[0].wait()
            dry_dir.cleanup()
        check(DEGRADES == [], f"degradations recorded: {DEGRADES}")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        tune.cleanup()
    delayed["B4"]["full_width_delayed_explore"] = b4
    delayed["B5-ELL"]["full_width_delayed_ell_explore"] = b5e
    delayed["B5-COO"]["full_width_delayed_hybrid_explore"] = b5c
    main_path = {"B1": "full_width_explore", "B2": "full_width_ell_explore",
                 "B3": "full_width_hybrid_explore",
                 "B4": "full_width_delayed_explore",
                 "B5-ELL": "full_width_delayed_ell_explore",
                 "B5-COO": "full_width_delayed_hybrid_explore",
                 "B6": "sharded_contiguous_explore",
                 "B7": "sharded_contiguous_explore",
                 "B8-TC": "full_width_prefill", "B8-TF32": "f32_prefill",
                 "H1": "zero_sync_full_width_explore",
                 "H2": "zero_sync_full_width_explore"}
    by_path = {"B1": b1, "B2": b2, "B3": b3, **delayed, **sharded,
               **served, "H1": {}, "H2": {}}
    for k, paths in (list(snp_paths.items()) + list(dense_paths.items())
                     + list(sync_paths.items())
                     + list(family_paths.items())
                     + list(train_paths.items())
                     + list(mesh_paths.items())
                     + list(family_mesh_paths.items())
                     + list(roof_paths.items())):
        by_path[k].update(paths)
    # B8 at the training launch (phase 23) beside the families' launches
    for k, row in train_rows.items():
        family_rows.setdefault(k, {})["smollm-360m train"] = row
    waves = {"B1": rows["scaled_pi(682) wave"],
             "B2": sparse_rows["scaled_pi(682) wave"],
             "B3": sparse_rows["power_law(8192) hybrid wave"],
             "B4": delay_rows[("B4", "scaled_pi(682) delayed wave")],
             "B5-ELL": delay_rows[("B5-ELL", "scaled_pi(682) delayed wave")],
             "B5-COO": delay_rows[("B5-COO",
                                   "power_law(8192) delayed hybrid wave")],
             "B6": shard_rows[("B6", "scaled_pi(682) wave S=4")],
             "B7": shard_rows[("B7", "scaled_pi(682) wave S=4")],
             **attn_rows, **probe_rows}
    # B2's and the shard kernels' other waves, beside their main path's
    other_waves = {k: {name: row for (kk, name), row in shard_rows.items()
                       if kk == k and row is not waves[k]}
                   for k in ("B6", "B7")}
    other_waves["B2"] = {"ring_lattice(32768,8) wave":
                         sparse_rows["ring_lattice(32768,8) wave"]}
    errs = {"B1": dense_err, **sparse_err, **delay_err, **shard_err,
            **{k: max(e.values()) for k, e in attn_errs.items()},
            **probe_err}
    # B8's extras, per body: its error per dtype, the f32-pipe and
    # split-TF32 figures and which way binds, the rate, a second timing,
    # SDPA on repeated k/v, the launch
    extras = {k: dict(max_abs_err_by_dtype=attn_errs[k],
                      f32_pipe_ms=row["f32_pipe_ms"],
                      tf32x3_ms=row["tf32x3_ms"], ops_route=row["ops_route"],
                      tflops=row["tflops"],
                      ms_again=row["ms_again"],
                      library_mha_ms=row["library_mha_ms"],
                      launch={f: row[f] for f in (
                          "B", "Hq", "Hkv", "Sq", "D", "dtype", "gflop")})
              for k, row in attn_rows.items()}
    # H1's bodies and H2's routes: their launches by body on the main path,
    # the other bodies', routes' and waves' figures
    for k in PROBE_KERNELS:
        extras[k] = dict(
            {f: v for f, v in probe_rows[k].items()
             if f in ("hash_body", "keys_body", "waves", "routes",
                      "claim_route",
                      "ctas", "slots", "K", "w", "bytes", "threads_a_row",
                      "bound_ms_table_in_memory")},
            launches_by_body=sync_figures[main_path[k]]["launches_by_body"])
    figures = []
    for k, meta in KERNELS.items():
        w = waves[k]
        figures.append(dict(
            meta, id=k, launches=by_path[k][main_path[k]],
            launches_by_path=by_path[k], max_abs_err=errs[k], ms=w["ms"],
            plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
            bound_by=w["bound_by"], library_ms=w["library_ms"],
            library_call=LIBRARY_CALL[k],
            **({"other_waves": other_waves[k]} if k in other_waves else {}),
            **({"bound_ms_matrices_dense": w["bound_dense_ms"]}
               if "bound_dense_ms" in w else {}),
            **({"device_ms": w["device_ms"]} if "device_ms" in w else {}),
            **({"block": w["block"]} if "block" in w else {}),
            **({"shapes_checked": shapes[k]} if k in shapes else {}),
            **({"other_launches": family_rows[k]} if family_rows.get(k)
               else {}),
            **extras.get(k, {})))
        log(f"[27] {k} {meta['name']} ({meta['route']}): "
            f"{figures[-1]['launches']} launches on its main path "
            f"({main_path[k]}); per path {json.dumps(by_path[k])}")
    log(f"[27] SNP service figures: {json.dumps(snp_figures)}")
    log(f"[27] planner figures: {json.dumps(planned)}")
    log(f"[27] dense-row and distributed-trace figures: "
        f"{json.dumps(dense_figures)}")
    log(f"[27] zero-host-sync explore figures: {json.dumps(sync_figures)}")
    log(f"[27] LM family figures: {json.dumps(family_figures)}")
    log(f"[27] training figures: {json.dumps(train_figures)}")
    log(f"[27] meshed launcher figures: {json.dumps(mesh_figures)}")
    log(f"[27] meshed family figures: {json.dumps(family_mesh_figures)}")
    log(f"[27] roofline figures: {json.dumps(roof_figures)}")
    log(f"[27] card: {card}")
    check(all(f["route"] in ("cuda", "triton") for f in figures),
          "a kernel's route on the kernels line is not cuda or triton: "
          + json.dumps({f["id"]: f["route"] for f in figures}))
    print(json.dumps({"kernels": figures}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
