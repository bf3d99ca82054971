#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card, nvcc and PyTorch built for CUDA. It builds the
kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source, side
by side) and runs these phases, each printing one JSON line; any failed
check raises, so the script exits non-zero and prints no result line:

1. environment: the card, its power limit, torch/CUDA versions, build time,
   each kernel instance's ptxas registers, stack frame and spill bytes;
2. the host-fed path's kernels against their plain versions on the card
   at its shapes (chunk 65,536 and 65,536 - 37, K = 10, q in {1, 3}, seeded
   carries, ``scd_fused_hist`` at its default tile ``MAP_TILE``, the
   finalize at ``ops.pick_tile``'s 512): both bitwise on random and dyadic
   inputs; the finalize also at each K branch (K in 1, 8, 9, 16, 17, 64;
   tiles 128, 512 and 1,024; with and without the histograms) and as one
   call over 10^6 rows, bitwise; times from CUDA events beside the byte
   bound and the plain version's time, after a line with each call's
   profiler split (``launch/kernel_split.py``);
3. determinism: repeated kernel runs bitwise; a host-fed solve at chunk
   65,536 and 131,072 (tile 512): lam, iterations and the finalize's
   histograms bitwise, and each chunking's (r, primal, dual, tau) bitwise
   its chunk-grouped fold (each chunk's sums from 0.0, added chunk by
   chunk, as the reference's default path groups them);
4. the same host-fed solve (n = 262,144) on the card and on the CPU;
5. host-fed end to end: the §6 table1 shape (K = 10, Q = 1, tightness
   0.5) at N = 10,000,000 (``--scale 0.1``), chunk 65,536, through the
   launcher's ``run_streaming``, with launch counts and the per-epoch split;
6. the resident path's kernels against their plain versions:
   ``scd_candidates`` at N = 10^7 and 10^7 - 37, q in {1, 3}, and at each
   K branch and staged row width (K in 1, 8, 9, 10, 16, 17, 64; q in {0,
   1, 3, K}; 262,107 rows with b = 0, b < 0 and tied rows, aligned and one
   row in), bitwise, timed at K = 10 (after its profiler split), 8 and 16;
   ``bucket_hist`` at the dense shape (100,000 users x 55 candidates, K =
   10, default tile), seeded and unseeded, random and dyadic, bitwise;
   ``scd_fused_hist`` at the resident shape (N = 10^7, default tile),
   bitwise; times beside bounds and plain versions, after the profiler
   split of both histogram calls (kernel time against the call's wall);
7. resident end to end: table1 at N = 10^7 through the launcher's ``run``,
   bucketed and ``reduce="exact"``, with the map kernel launched once per
   iteration and ``adjusted_topc`` once (the final metrics pass), feasible
   and dual >= primal, and the per-iteration and final-pass times; the
   default bucketed solve of the same rows equals phase 5's host-fed solve
   in lam and iterations (the map tile divides the chunk);
8. dense end to end: ``dense_instance`` n = 25,000, M = 10, K = 10, C223,
   mixed b, sync bucketed; ``bucket_hist`` launches == iterations, and
   chunk 16,384 (tile 512) bitwise equal to unchunked;
9. contracts at n = 262,144: resident chunked == unchunked bitwise and ==
   the host-fed solve (lam, iterations), pinned at tile 512 and at the
   default tiles; repeated exact solves bitwise;
   the card's resident solves within tolerance of the CPU's (lam rtol
   1e-5 / atol 1e-6, iterations within one, primal and dual 1e-5); the
   card's screened host-fed solve (banded, chunk 16,384) equal to the
   CPU's (lam and iterations bitwise, the same streamed-chunk profile);
   host-fed DD equal to the resident chunked DD at chunk 65,536 (lam and
   iterations bitwise);
10. the slice-3 kernels against their plain versions, bitwise:
   ``screen_bound`` at a 65,536-row chunk and 65,536 - 37 rows, K = 6 and
   10, random and dyadic rows, with rows and a whole column at b = 0,
   written through ``out=`` into one row of a buffer as the screened
   driver does, and timed so after its profiler split;
   ``adjusted_topc`` at N = 10^7 and 10^7 - 37, K = 10, q in {1, 3}, also
   against ``select_sparse``, and at each K branch (K in 1, 8, 9, 16, 17,
   64; q in {0, 1, 3, K}; 262,107 rows with b = 0 and tied rows); times
   beside bounds and plain versions, after the profiler split of
   ``adjusted_topc`` at N = 10^7 and at a chunk;
11. screened host-fed end to end: ``banded_host_chunk_source`` with the
   reference screening bench's settings (K = 6, Q = 2, tightness 0.08,
   band 0.05, ``bucket_half=12``, ``max_iters=30``) at N = 10^7, chunk
   65,536 (153 chunks), screened and unscreened: every result field
   bitwise equal, ``screen_bound`` launched once per chunk, the fused
   kernel once per streamed chunk (fallbacks included), some epoch
   streaming fewer than 153 chunks; walls, per-epoch split and profile;
12. DD end to end: table1 resident at N = 10^7 (``adjusted_topc`` launched
   iterations + 1 times and nothing else) and host-fed at N = 10^6;
13. the slot solve (``slots=4``) at table1's full width, N = 2^21, chunk
   65,536 (32 chunks, 8 columns; 10^7 until phase 24 was added):
   uninterrupted, with ``scd_fused_hist`` launched iters x 4 x 8 times and
   ``scd_finalize_hist`` 4 x 8, feasible, within tolerance of the
   single-slot (resident, bitwise host-fed) solve of the same rows; then
   against that solve: checkpointed every 4 iterations and columns with a ``Tracer`` journal,
   bitwise equal, with the journal's spans and at most ``checkpoint_keep``
   states left; SIGKILLed mid-iterate in a fresh interpreter and resumed
   here, bitwise equal; from the oldest state the checkpointed solve left,
   resumed and SIGKILLed between finalize columns in a fresh interpreter,
   then resumed here, bitwise equal, reading exactly the fingerprint probe
   and the real chunks of the columns left; at N = 2^18 a ``FaultPlan`` run (drops,
   corruption, ``verify_refetch``) bitwise the clean one and an exhausting
   plan raising ``ChunkFetchError`` naming the chunk; at n = 2^17 the
   card's SCD, screened banded, DD and presolve slot solves bitwise the
   CPU's (the screened profile too); walls, the per-epoch split and the
   cost of a save;
14. the device-streamed driver (``core/chunked.solve_streaming``): table1
   generated on the card (``data/synth.sparse_chunk_source``) through the
   launcher at N = 10^7 and uncut at 10^8, chunk 65,536, with the wall,
   iterations, primal, dual, ``max_violation``, the launches per solve
   (``scd_fused_hist`` iters x chunks, the finalize once a chunk, nothing
   else) and the peak device memory at both sizes, which must stay flat,
   each beside the dry-run's account (``launch/dryrun.account_paper_kp``:
   the launches equal, the streamed state within 15 % or 8 MiB of what the
   peak rose by);
   phase 5's rows through ``array_source`` bitwise the host-fed solve of
   the same bytes, fused (and phase 5's row) and legacy, the source read
   iters + 1 and iters + 3 times; ``bucket_hist`` at the legacy finalize's
   shape (three real chunks' p~ and consumption at the solved lam, E = 512,
   ``removable_tile``'s tile, a non-zero seed, as given and dyadic) bitwise
   its plain version, timed into the kernels line's ``legacy_shape``; DD at
   N = 10^7; the sampled history
   (``metrics_every=4``) at N = 10^6 bitwise the host-fed one; the banded
   N = 10^7 of phase 11 screened == unscreened == phase 11's host-fed
   screened solve, with the active-chunk profile;
15. the serving layer: ``launch/refresh.run_scenario`` at the reference's
   serving shape (K = 8, Q = 2, tightness 0.4, 8 slots, chunk 65,536,
   N = 2^21, 3 generations): warm iterations below cold, 512 lookups
   bitwise ``decisions_chunk``, batched and single QPS; a warm refresh
   SIGKILLed in a fresh interpreter and recovered here, its record bitwise
   the uninterrupted one; ``run_chaos`` at n = 2^17 (chaos == clean);
   and the card's generation records bitwise the CPU's there;
16. operations at the serving shape (8 slots): ``launch/supervisor.run_chaos_soak``
   at N = 2^20 and 2 generations, its references in this process
   and the supervised solve and refresh in worker processes on the card
   under one SIGKILL and one SIGSTOP each plus a fetch-level fault plan,
   both records bitwise the references', the poisoned task contained in
   ``FAILED.json`` with LIVE unmoved, the exercised counters (workers of
   one rank: no degrade; phase 18 runs them as worlds), recovery times and
   the card's free memory before and
   after; then ``launch/front.run_front_scenario`` with 2 replica processes
   on the card under concurrent ``/decide_batch`` traffic while the engine
   refreshes with ``keep=2``: every answered row bitwise the
   materialisation of the generation that answered it, ``/diff`` the
   brute-force comparison at one grouped fill pass per replica and zero on
   the repeat, lookups per second and the p50/p99 of ``/decide`` (N = 2^21,
   3 generations);
17. a world of ranks (``launch/mesh.run_local_world``): 4 rank processes
   sharing the card, gloo over host tensors. In one world of 4: the
   host-fed table1 N = 2^21 at 4 slots bitwise phase 13's in-process row
   (lam, iterations, r, primal, dual, tau, ``fin_hist``; rank 0 launching
   the fused kernel iters x 8 times and the finalize 8); the same bytes
   device-streamed, one shard a rank, bitwise that; generated on the card
   at N = 10^7 (10^8 until phase 25), each rank's peak memory flat against
   phase 14's at that N, lam within
   the stopping rule's ``tol * (1 + max lam)`` of phase 14's one-shard run
   and iterations within one; ``solve_sharded`` at 10^7 bucketed against
   phase 7 (the same rule), chunked at 65,536 bitwise unchunked, and exact
   at 10^6 against the single-device exact solve; banded N = 10^7
   screened == unscreened == the in-process 4-slot solve (and within the
   rule of phase 11's single slot); ``partial_fraction=0.5`` at 10^6
   bitwise the in-process 4-slot solve, feasible. Then a checkpointed
   world of 4 at 10^6 whose every rank is SIGKILLed mid-iterate, resumed
   on a world of 2 and in process, both bitwise the uninterrupted solve;
   beside it, a world of 2 whose rank 1 cannot fetch a chunk (no retries)
   failing well within its timeout with ``ChunkFetchError`` naming it;
   worlds of 1 (one rank, in this process), 2 and 4 on one host-fed solve
   at 16 chunks, bitwise, with their walls and seconds in collectives
   (recorded, not claimed: the ranks share one card);
18. serving and operations over a world of 4 ranks sharing the card, at
   phase 15's shape (K = 8, Q = 2, 8 slots, chunk 65,536) and half its N
   (2^20; 2^21 until phase 25), its references (the scenario's 3 generations at that N, and
   the screened delta refreshes) refreshed in this process beside the
   worlds: in one world, the device-streamed legacy finalize against the fused one
   (lam, iterations and dual bitwise; every field bitwise without the
   projection; ``bucket_hist`` and ``adjusted_topc`` launched), screened
   delta refreshes on the banded workload (a budget change inheriting
   every chunk) bitwise this process's ``slots=8`` engine, and
   ``launch/front.run_front_scenario`` whose 3 generations the world
   publishes, bitwise the in-process records, while 2 replica processes
   serve them (every row bitwise its generation's); beside it a world of 4
   whose warm refresh is SIGKILLed on every rank mid-solve, re-driven on
   a world of 2 to the in-process generation 1, bitwise; then a supervised
   solve task starting as a world of 4, its lease holder SIGKILLed once,
   respawned as a world of 2, its record bitwise the in-process generation 0;
19. the LM serving path (``models/``, ``launch/serve.py``) at
   moonshot-v1-16b-a3b's full width and depth (48 layers, 64 experts, top-6,
   bf16): the knapsack-priced router at the prefill's shape (4,096 tokens x
   64 experts) on the card, every field bitwise the CPU's from the same
   probabilities, ``scd_fused_hist`` and ``adjusted_topc`` bitwise their
   plain versions there and timed; ``launch/serve.serve_loop`` (8 requests,
   ``max_batch=4``, ``cache_len=256``) with its admitted sets, completion
   order and admission iterations equal to the CPU port's on the smoke
   reduction; one ``make_prefill_step`` at B = 4, S = 1,024 through the SCD
   router, launching ``scd_fused_hist`` 4 x 48 and ``adjusted_topc`` 48 times
   and nothing else; the decode step's wall at the serving shape beside its
   weight-read floor, the peak memory; 16 decode steps against one
   teacher-forced forward (top-k router on both) within ``LM_DECODE_REL``;
   smoke moonshot and gemma in float32, prefill and decode, on the card
   against the CPU with TF32 off. The prefill and the first decode step
   (the peak reset right before each) against the dry-run's account of
   the cell (``launch/dryrun.account_cell``, on meta): (a) the launches
   equal ``ops.LAUNCHES``, (b) the held bytes equal the card's params,
   caches and batch, (c) the peak within 15 % of the held bytes plus what
   ``max_memory_allocated`` rose by; the decode floor is the dry-run's
   bytes;
20. the LM training path (``optim/``, ``models/model.make_train_step``,
   ``launch/train.py``) at moonshot-v1-16b-a3b's full width and 4 of its 48
   layers (bf16, SCD router, remat): ``train()`` for 4 steps at B = 4, S =
   1,024, each step launching ``scd_fused_hist`` 2 x 4 x 4 and
   ``adjusted_topc`` 2 x 4 times (forward and remat recompute) and nothing
   else, its step walls beside the executed FLOPs over the bf16 peak, the
   peak memory, the parameters moved, and a second ``train()`` from the same
   seed bitwise in parameters and moments, then one more step of it against
   the dry-run's account (every layer on meta; checks (a)-(c), the moments
   held too; the executed FLOPs beside the bf16 peak are the dry-run's);
   one train step of smoke moonshot
   and gemma in float32 on the card against the CPU (TF32 off): loss,
   gradients, ``grad_norm``, the update from the same gradients and the
   card's own step; 6 steps against 3, a resume and 3 more on the card,
   bitwise, in float32 and with bf16 parameters; ``python -m
   repro_torch.launch.train --arch gemma-2b --smoke ... --simulate-failure-at
   5`` (in a thread from the phase's start) exits 42 at step 4 and its
   rerun resumes from step 4 and finishes;
21. the other mixers (``models/mamba2.py``, ``models/encdec.py``):
   jamba-v0.1-52b at full width and 16 of its 32 layers (two periods of its
   8-slot pattern, 52.0 GB of bf16 weights): its router at 4,096 tokens x
   16 experts, q = 2, bitwise the CPU's and both kernels bitwise their plain
   versions and timed; ``serve_loop`` with phase 19's settings, its schedule
   equal to the CPU port's on the smoke reduction; a prefill at B = 4, S =
   1,024 launching ``scd_fused_hist`` 4 x 8 and ``adjusted_topc`` 8 times
   (path ``lm_prefill_hybrid``), the decode step beside its weight-read
   floor, the peak memory under 80 GB, 16 decode steps against one forward
   within ``MIX_DECODE_REL``; mamba2-370m and seamless-m4t-medium at full
   width and depth: the prefill (seamless: 1,024 frames encoded), the
   decode step, decode against forward, ``train()`` for 4 steps twice from
   one seed bitwise, mamba2's resumed from a checkpoint bitwise; the three
   smoke configs in float32 on the card against the CPU (TF32 off):
   prefill, decode and one train step;
22. MLA and the router's kernels at K = 160 (``models/attention.py``'s
   ``mla_attention`` and ``decode_mla``; the ``KWIDE`` instances of
   ``scd_fused_hist`` and ``adjusted_topc``): deepseek-v2-236b at full
   width, its dense ``block0`` and 6 of its 60 MoE layers (50.4 GB of bf16
   weights): its router at 4,096 tokens x 160 experts, q = 6, bitwise the
   CPU's, both kernels bitwise their plain versions there and at a ragged
   token count, and timed; ``serve_loop`` with phase 19's settings, its
   schedule equal to the CPU port's on the smoke reduction; a prefill at
   B = 4, S = 1,024 launching ``scd_fused_hist`` 4 x 6 and ``adjusted_topc``
   6 times (path ``lm_prefill_mla``), the decode step beside its
   weight-read floor, the peak memory under 80 GB, 16 decode steps against
   one forward within ``MLA_DECODE_REL``; the prefill against the
   dry-run's account, checks (a)-(c); its smoke config and the smoke
   config with the router kept at 160 experts, top-6, in float32 on the
   card against the CPU (TF32 off): prefill and decode;
23. the MoE forward over a world of ranks (``models/sharding.py``,
   ``moe_train``'s a2a path, ``scd_route_shmap``, ``Mesh.all_to_all``):
   moonshot-v1-16b-a3b at full width and 8 of its 48 layers (10.5 GB of
   bf16 weights), first in this process (a prefill at B = 4, S = 1,024 and
   16 decode steps, the weights then freed), then over worlds of 2 and 4
   gloo ranks sharing the card under the batch binding, each rank drawing
   the same weights from the seed and keeping its E / D experts: the
   world's lam from 4,096 x 64 probabilities bitwise the one-process lam;
   rank 0 launching ``scd_fused_hist`` 4 x 8 and ``adjusted_topc`` 8 times
   a prefill and nothing else (path ``lm_prefill_world``); each row's
   last-position logits within ``WORLD_LM_REL`` and every decode step's
   within ``WORLD_LM_DECODE_REL`` (relative L2) of the one-process run; the
   prefill and decode walls
   beside the one-process ones, rank 0's seconds in collectives, the pairs
   dropped by ``cap_send`` and ``cap_e``, each rank's held and peak memory;
   and the smoke config in float32 (TF32 off) over the card's world of 2
   against a world of 2 on the CPU: ``moe_train``, the prefill and 4
   decode steps; then, in the same world of 2, training over the world
   (``launch/train.train(mesh=)``, the backward through the all-to-alls,
   the replicated gradients folded in rank order): moonshot at phase 20's
   config (4 layers), seed, batch (4 x 1,024, 2 x 1,024 a rank) and AdamW
   settings for 3 steps (``train(mesh=)`` for 2, the third by hand under the
   batch binding, the peak reset right before it, against the dry-run's
   account of rank 0 on a ``DryMesh`` of 2: checks (a)-(c) and (d), the
   bytes each collective sent equal rank 0's ``comm_bytes``), its losses
   within ``WORLD_TRAIN_LOSS_RTOL`` of
   phase 20's first 3, rank 0 launching ``scd_fused_hist`` 32 and
   ``adjusted_topc`` 8 times a step and nothing else (path
   ``lm_train_world``), each step's wall, rank 0's seconds in collectives
   by kind (the all-to-alls; the gathers, which the gradient fold
   dominates), each rank's held and peak memory, the ranks' peaks together
   under 80 GB; and the smoke config's 3 train steps over the card's world
   against the CPU world's (float32, TF32 off, weights drawn on the CPU)
   within rtol 1e-5, atol 1e-5, with ``train(mesh=)`` saved at step 2 and
   resumed to step 3 bitwise on each;
24. the forward under tensor and sequence parallelism
   (``sharding.PRODUCTION_RULES``, the reference's ``production_rules(False)``):
   moonshot-v1-16b-a3b at full width and phase 23's 8 layers (its heads,
   KV heads and caches, the sequence, the vocab and the experts split) and
   gemma-2b at full width and depth (its q heads and the FFN's columns
   split, its one KV head whole and its caches split by position, its tied
   head by vocab), each over a world of 2 gloo ranks sharing the card, each
   rank drawing the whole tree from the seed and keeping its blocks
   (``model.shard_params``): a prefill at B = 4, S = 1,024 and 6 decode
   steps (gemma's crossing its cache's block boundary) against the
   one-process run (moonshot's from phase 23, gemma's here) within
   ``TP_REL`` (relative L2 of each row), both ranks' logits bitwise equal,
   rank 0 launching ``scd_fused_hist`` 4 x 8 and ``adjusted_topc`` 8 times
   a moonshot prefill (path ``lm_prefill_tp``); each rank's held and
   collective bytes equal to the dry-run's account (``--rules
   production``), its peak within ``TP_PEAK_REL``, for the prefill and a
   decode step at the cache's last position; the prefill and decode walls
   with their seconds in the host-staged collectives;
25. training under the same rules (``train(mesh=, rules="production")``,
   the backward through ``core.mesh``'s autograd collectives, the
   vocab-parallel loss, the partial gradients folded in rank order):
   moonshot's router kernels at a rank's 2,048 tokens bitwise their plain
   versions; gemma-2b at full width and depth and moonshot-v1-16b-a3b at
   phase 20's 4 layers, each trained 3 steps over a world of 2 sharing the
   card at phase 20's batch (4 x 1,024, every rank every row) and
   settings, the third step by hand, measured: both ranks' losses and
   grad norms bitwise, the losses within ``TP_TRAIN_LOSS_RTOL`` of one
   process (gemma's run here, moonshot's phase 20's), rank 0 launching
   ``scd_fused_hist`` 32 and ``adjusted_topc`` 8 times a moonshot step
   (path ``lm_train_tp``), each rank's held and collective bytes equal to
   the dry-run's account and its peak within ``TP_PEAK_REL``, the peaks
   together under 80 GB; moonshot's full-width world run a second time,
   bitwise the first (parameters, moments, losses and grad norms); beside
   phase 23, a world of 2 training smoke moonshot under the rules killed
   after step 2 (exit 42), then in the world of 2 resumed to step 3
   bitwise the uninterrupted run (parameters, moments and losses).
   Phases 24 and 25 share one world of 2 (``phase_lm_tp_both``: both
   phases' one-process runs first, then the world, the dry-run's accounts
   made while it runs);
26. the smoke's wall, which must stay within its 900 s budget on a fast
   host (``SMOKE_BUDGET_S``, ``FAST_HOST_PHASE5_S``; the dry-run's host
   seconds and phases 24's and 25's in it), the ``kernels`` line
   (launches summed over the paths run in phases 5, 7, 8, 11, 12, 13, 14,
   15, 16, 19, 20, 21, 22, 23, 24 and 25, and rank 0's of each world of
   phases 17, 18, 23, 24 and 25, training included, with the split), the
   card's ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.
"""
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

C_MAIN, K, Q_MAIN = 65536, 10, 1
N_RES = 10_000_000                 # table1 at --scale 0.1
DENSE_N, DENSE_M = 100_000, 10     # Figure 1 (C223, mixed b) at 100x its N: phase 6's shape
DENSE_N_E2E = 25_000                # phase 8's solves at 25x (cut from 10^5 for phases 19, 20)
CSRC = "src/repro_torch/kernels/csrc/"
N_HOST_DD = 1_000_000               # host-fed DD
BANDED = dict(k=6, q=2, tightness=0.08, band=0.05)   # benchmarks/bench_screening.py
FIN_TILE = 512                      # ops.pick_tile at a 65,536-row chunk
SLOTS, CKPT_EVERY = 4, 4            # the slot phase: 39 columns, 156 chunk slots
# The slot phase's solves (uninterrupted and counted, checkpointed, killed
# and resumed): 32 chunks, 8 columns (cut from N_RES for the smoke's time;
# the uninterrupted one, which phase 17's worlds are held against, since
# phase 24 was added).
N_SLOTS_CKPT = 1 << 21
# The fault-layer run of the slot phase (4 chunks, the exhausting plan's
# offender the last; cut from 10^6 for phase 23's training over a world).
N_FAULTS = 1 << 18
# Card against CPU in the slot phase (13) and the serving phase (15): 2^17
# rows (cut from 2^18 for phase 23's training over a world); phases 3, 4
# and 9 keep n = 262,144.
N_VS_CPU = 1 << 17
BRANCH_K = (1, 8, 9, 16, 17, 64)    # each KC branch of the finalize and adjusted_topc
CAND_K = (1, 8, 9, 10, 16, 17, 64)  # scd_candidates: each KC branch and row width
SOURCE = {"scd_fused_hist": CSRC + "scd_fused.cu",
          "scd_finalize_hist": CSRC + "scd_fused.cu",
          "scd_candidates": CSRC + "scd_candidates.cu",
          "bucket_hist": CSRC + "bucket_hist.cu",
          "screen_bound": CSRC + "screen_bound.cu",
          "adjusted_topc": CSRC + "adjusted_topc.cu"}
REPLACES = {"scd_fused_hist": "src/repro/kernels/scd_fused.py:93",
            "scd_finalize_hist": "src/repro/kernels/scd_fused.py:256,279",
            "scd_candidates": "src/repro/kernels/scd_candidates.py:85",
            "bucket_hist": "src/repro/kernels/bucket_hist.py:67",
            "screen_bound": "src/repro/kernels/screen_bound.py:66",
            "adjusted_topc": "src/repro/kernels/adjusted_topc.py:69"}


N_STREAM = 100_000_000              # the device-streamed table1, uncut
N_HISTORY = 1_000_000               # the sampled history, host-fed against streamed
SERVE = dict(k=8, q=2, tightness=0.4)   # the reference's serving shape (launch/refresh.py)
N_SERVE, SERVE_SLOTS, SERVE_GENS = 1 << 21, 8, 3   # 32 chunks, cut from 10^8 (and from 2^22)
SERVE_CKPT_EVERY = 2
# Phase 16: the soak at half the serving N and 2 generations (cut from 2^21
# and 3 for phase 23), and its kill/stop thresholds on the lease's progress
# (chunk reads, two a fetch under verify_refetch): 1-3.5 epochs of 16
# chunks, inside the first worker life of a cold solve of ~10 epochs (320
# reads) at phase 15's ladder (bucket_half 24; the soak's 16 runs to
# max_iters).
N_SOAK, SOAK_GENS = 1 << 20, 2
SOAK_LO, SOAK_HI = 32, 112
FRONT_REPLICAS, FRONT_DIFF_STRIDE = 2, 64   # /diff asks about 32,768 users
HOST_RESULTS = {}                   # host-fed results later phases compare against
# The smoke's wall budget, which holds on a fast host: one whose phase 5
# (table1 host-fed at N_RES, CPU-bound) takes at most FAST_HOST_PHASE5_S
# (24.5-30.1 s on the fast hosts of earlier runs, 38.1-46.5 s on the slow
# ones). On a slower host an overrun is reported, not failed.
SMOKE_BUDGET_S, FAST_HOST_PHASE5_S = 900, 32.0


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    """One JSON line of a phase's facts; ``at_s`` is the smoke's wall so far."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - T_START}), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(c):
    """(least time in ms, "bytes" or "operations") of one launch's
    ``kernels.cost`` account: the formulas the dry-run counts with."""
    from repro_torch.kernels import cost
    return cost.bound_ms(c.bytes, c.ops)


def inputs(torch, np, c, q, dyadic, seed, dev):
    """Chunk rows, lam and seeded carries on the card (numpy-seeded)."""
    g = np.random.default_rng(seed)
    if dyadic:
        p, b = g.integers(0, 64, (c, K)) / 64.0, g.integers(1, 64, (c, K)) / 64.0
        lam = g.integers(0, 12, (K,)) / 8.0
        grid = lambda *s: g.integers(0, 256, s) / 64.0  # noqa: E731
    else:
        p, b = g.random((c, K)), g.uniform(0.0, 1.0, (c, K))
        lam = g.uniform(0.3, 1.2, (K,))
        grid = lambda *s: g.random(s) * 4.0  # noqa: E731
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    fused_seed = {"hist_init": t(grid(K, 50)), "top_init": t(grid(K) - 1.0)}
    fin_seed = {"cons_hist_init": t(grid(K, 513)), "gain_hist_init": t(grid(513)),
                "r_init": t(grid(K)), "sums_init": t(grid(2) * 64),
                "maxs_init": t([0.5, -0.25])}
    return t(p), t(b), t(lam), fused_seed, fin_seed


def phase_kernels(torch, np, dev):
    from repro_torch.core.bucketing import make_edges
    from repro_torch.core.postprocess import profit_edges_fixed
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.launch.kernel_split import split

    pedges = profit_edges_fixed(512, 1e-6, 1e6, device=dev)
    err = {"scd_fused_hist": 0.0, "scd_finalize_hist": 0.0}
    cases = phase_finalize_branches(torch, np, dev, pedges)
    for c in (C_MAIN, C_MAIN - 37):
        for q in (1, 3):
            for dyadic in (False, True):
                p, b, lam, fs, gs = inputs(torch, np, c, q, dyadic, 100 * q + c % 7, dev)
                edges = make_edges(lam, 1e-4, 1.6, 24)
                kh, kt = ops.scd_fused_hist(p, b, lam, edges, q, **fs)
                ph, pt = ref.scd_fused_hist_plain(p, b, lam, edges, q, **fs)
                kf = ops.scd_finalize_hist(p, b, lam, pedges, q, **gs)
                pf = ref.scd_finalize_plain(p, b, lam, pedges, q, **gs)
                torch.cuda.synchronize()
                tag = f"C={c} q={q} dyadic={dyadic}"
                check(torch.equal(kt, pt), f"fused top differs ({tag})")
                # The fused kernel and its plain version add in one order.
                check(torch.equal(kh, ph), f"scd_fused_hist not bitwise ({tag})")
                # So does the finalize: every output bitwise.
                check(all(torch.equal(a, e) for a, e in zip(kf, pf)),
                      f"scd_finalize_hist not bitwise ({tag})")
                if q == 1 and not dyadic:
                    # Bucket indices: with one item per row every value is
                    # exact, so the unseeded histograms have the same support.
                    kh0, _ = ops.scd_fused_hist(p, b, lam, edges, q)
                    ph0, _ = ref.scd_fused_hist_plain(p, b, lam, edges, q)
                    kf0 = ops.scd_finalize_hist(p, b, lam, pedges, q)
                    pf0 = ref.scd_finalize_plain(p, b, lam, pedges, q)
                    check(torch.equal(kh0 > 0, ph0 > 0), f"fused buckets differ ({tag})")
                    check(torch.equal(kf0[0] > 0, pf0[0] > 0),
                          f"finalize buckets differ ({tag})")
                cases += 1

    # Times at the main path's shape (q = 1, random rows, seeded carries).
    p, b, lam, fs, gs = inputs(torch, np, C_MAIN, Q_MAIN, False, 7, dev)
    edges = make_edges(lam, 1e-4, 1.6, 24)
    e, ep = edges.shape[-1], pedges.shape[0]
    timing = {
        "scd_fused_hist": (
            lambda: ops.scd_fused_hist(p, b, lam, edges, Q_MAIN, **fs),
            lambda: ref.scd_fused_hist_plain(p, b, lam, edges, Q_MAIN, **fs),
            bound(cost.scd_fused_hist(C_MAIN, K, e, Q_MAIN))),
        "scd_finalize_hist": (
            lambda: ops.scd_finalize_hist(p, b, lam, pedges, Q_MAIN, tile_n=FIN_TILE,
                                          **gs),
            lambda: ref.scd_finalize_plain(p, b, lam, pedges, Q_MAIN, tile_n=FIN_TILE,
                                           **gs),
            bound(cost.scd_finalize_hist(C_MAIN, K, ep, Q_MAIN, FIN_TILE))),
    }
    emit("kernel_split", kernel="scd_fused_hist", rows=C_MAIN, tile=ops.MAP_TILE,
         **split(timing["scd_fused_hist"][0], reps=50))
    emit("kernel_split", kernel="scd_finalize_hist", rows=C_MAIN, tile=FIN_TILE,
         **split(timing["scd_finalize_hist"][0], reps=50))
    out = {}
    for name, (kern, plain, (b_ms, b_by)) in timing.items():
        ms = time_ms(torch, kern, reps=50)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        out[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    out["scd_fused_hist"]["tile"] = ops.MAP_TILE
    out["scd_finalize_hist"]["tile"] = FIN_TILE

    # The finalize as one call over 10^6 rows (1,953 tile records to fold).
    n1 = 1_000_000
    g = np.random.default_rng(5)
    p1, b1 = (torch.tensor(g.random((n1, K)), dtype=torch.float32, device=dev)
              for _ in range(2))
    call = lambda: ops.scd_finalize_hist(p1, b1, lam, pedges, Q_MAIN, **gs)  # noqa: E731
    got = call()
    want = ref.scd_finalize_plain(p1, b1, lam, pedges, Q_MAIN, **gs)
    torch.cuda.synchronize()
    check(all(torch.equal(a, e) for a, e in zip(got, want)),
          "scd_finalize_hist not bitwise at 10^6 rows")
    emit("kernel_split", kernel="scd_finalize_hist", rows=n1, tile=FIN_TILE,
         **split(call, reps=20))
    out["scd_finalize_hist"]["rows_1e6"] = {
        "rows": n1, "ms": time_ms(torch, call, reps=20),
        "plain_ms": time_ms(torch, lambda: ref.scd_finalize_plain(
            p1, b1, lam, pedges, Q_MAIN, **gs), reps=1, warmup=0),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(cost.scd_finalize_hist(n1, K, ep, Q_MAIN, FIN_TILE))))}
    emit("kernels_vs_plain", cases=cases + 1, chunk=C_MAIN, k=K, **out)
    return out


def branch_rows(torch, np, n, k, seed, dyadic, dev):
    """Rows at width k with b = 0 rows and rows whose adjusted profits all
    tie (b = 0, equal p), numpy-seeded, on the card."""
    g = np.random.default_rng(seed)
    if dyadic:
        p, b = g.integers(0, 64, (n, k)) / 64.0, g.integers(0, 64, (n, k)) / 64.0
        lam = g.integers(0, 12, (k,)) / 8.0
    else:
        p, b, lam = g.random((n, k)), g.uniform(0.0, 1.0, (n, k)), g.uniform(0.3, 1.2, k)
    b[::7] = 0.0
    p[1::5] = p[1::5, :1]
    b[1::5] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in (p, b, lam))


def phase_finalize_branches(torch, np, dev, pedges):
    """The finalize at each compile-time K branch (KC = 8, 16, 64) and its
    edges, tiles 128, 512 and 1,024, with and without the histograms,
    seeded and not, at a ragged chunk (65,536 - 37 rows): bitwise its plain
    version. K = 64 at tile 1,024 needs more shared memory than a block has
    (the wrapper refuses it; ``tests/test_torch_cuda.py`` checks that)."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels._wrap import MAX_SMEM

    lib = _build.load()
    cases = 0
    for k in BRANCH_K:
        for tile, q in ((128, 1), (512, min(3, k)), (1024, k)):
            if lib.scd_finalize_smem_bytes(k, pedges.shape[0], tile) > MAX_SMEM:
                check(k * tile > 32768, f"finalize has no room for K={k} at tile {tile}")
                continue
            p, b, lam = branch_rows(torch, np, C_MAIN - 37, k, k + tile, k % 2 == 0, dev)
            for with_hist in (True, False):
                seeds = {}
                if with_hist:
                    g = np.random.default_rng(k)
                    t = lambda *s: torch.tensor(g.random(s), dtype=torch.float32,  # noqa: E731
                                                device=dev)
                    seeds = {"cons_hist_init": t(k, 513), "gain_hist_init": t(513),
                             "r_init": t(k), "sums_init": t(2) * 64,
                             "maxs_init": torch.tensor([0.5, -0.25], device=dev)}
                got = ops.scd_finalize_hist(p, b, lam, pedges, q, tile_n=tile,
                                            with_hist=with_hist, **seeds)
                want = ref.scd_finalize_plain(p, b, lam, pedges, q, tile_n=tile,
                                              with_hist=with_hist, **seeds)
                torch.cuda.synchronize()
                check(all((a is None and e is None) or torch.equal(a, e)
                          for a, e in zip(got, want)),
                      f"scd_finalize_hist not bitwise (K={k} tile={tile} q={q} "
                      f"with_hist={with_hist})")
                cases += 1
    emit("finalize_branches", cases=cases, k=BRANCH_K, rows=C_MAIN - 37, bitwise=True)
    return cases


def host_instance(np, n, seed):
    from repro_torch.data.synth import sparse_host_chunk_source
    src = sparse_host_chunk_source(seed, n, K, C_MAIN)
    ps, bs = zip(*(src.fn(i) for i in range(-(-n // C_MAIN))))
    return np.concatenate(ps)[:n], np.concatenate(bs)[:n], src.budgets


def chunk_grouped(torch, res, src, q, tile, dev):
    """(r, primal, dual, tau) of a host-fed solve as its finalize groups
    the scalar sums: each chunk's finalize at the solved lam from 0.0 on
    the card, the chunks added onto the carry in order, then the §5.4
    projection off the run's removable histograms."""
    from repro_torch.core.postprocess import profit_edges_fixed, threshold_and_removed
    from repro_torch.kernels import ops

    pedges, lam = profit_edges_fixed(device=dev), res.lam.to(dev)
    r = torch.zeros(src.k, device=dev)
    primal, dual = torch.zeros((), device=dev), torch.zeros((), device=dev)
    for i in range(-(-src.n // src.chunk)):
        p_c, b_c = (torch.from_numpy(a).to(dev) for a in src.fn(i))
        _, _, r_c, primal_c, dual_c, _, _ = ops.scd_finalize_hist(
            p_c, b_c, lam, pedges, q, tile_n=tile)
        r, primal, dual = r + r_c, primal + primal_c, dual + dual_c
    budgets = torch.from_numpy(src.budgets)
    r, primal = r.cpu(), primal.cpu()
    dual = dual.cpu() + torch.sum(res.lam * budgets)
    tau, rm_cons, rm_gain = threshold_and_removed(*res.fin_hist, profit_edges_fixed(),
                                                  r, budgets)
    return {"r": r - rm_cons, "primal": primal - rm_gain, "dual": dual, "tau": tau}


def same(a, b):
    import torch
    fields = [a.iters == b.iters] + [
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("lam", "r", "primal", "dual", "tau")]
    fields += [torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.fin_hist, b.fin_hist)]
    return all(fields)


def phase_determinism_and_cpu(torch, np, dev):
    from repro_torch.core.bucketing import make_edges
    from repro_torch.core.postprocess import profit_edges_fixed
    from repro_torch.core.prefetch import host_array_source, solve_streaming_host
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops

    p, b, lam, fs, gs = inputs(torch, np, C_MAIN, Q_MAIN, False, 11, dev)
    edges = make_edges(lam, 1e-4, 1.6, 24)
    pedges = profit_edges_fixed(device=dev)
    for fn in (lambda: ops.scd_fused_hist(p, b, lam, edges, Q_MAIN, **fs),
               lambda: ops.scd_finalize_hist(p, b, lam, pedges, Q_MAIN, **gs)):
        one, two = fn(), fn()
        check(all(torch.equal(x, y) for x, y in zip(one, two) if x is not None),
              "repeated kernel runs differ")

    n = 262_144
    ph, bh, budgets = host_instance(np, n, seed=1)
    cfg = SolverConfig(max_iters=40, kernel_tile=512)
    runs = {}
    for chunk in (C_MAIN, 2 * C_MAIN):
        runs[chunk] = solve_streaming_host(host_array_source(ph, bh, budgets, chunk),
                                           cfg, q=Q_MAIN, device=dev)
    a, b = runs[C_MAIN], runs[2 * C_MAIN]
    check(a.iters == b.iters and torch.equal(a.lam, b.lam)
          and all(torch.equal(x, y) for x, y in zip(a.fin_hist, b.fin_hist)),
          "host-fed iteration or finalize histograms differ between chunk 65536 "
          "and 131072")
    # The scalar sums group by chunk (the reference's default path): each
    # chunking's are bitwise its own chunk-grouped fold.
    for chunk, res in runs.items():
        want = chunk_grouped(torch, res, host_array_source(ph, bh, budgets, chunk),
                             Q_MAIN, 512, dev)
        check(all(torch.equal(getattr(res, f), w) for f, w in want.items()),
              f"chunk {chunk}: the finalize's scalar sums are not its chunk-grouped fold")
    emit("determinism", kernel_reruns_bitwise=True, iteration_chunk_invariance_bitwise=True,
         chunk_grouped_sums_bitwise=True, n=n, iters=a.iters,
         primal_by_chunk={c: float(r.primal) for c, r in runs.items()})

    t0 = time.perf_counter()
    cpu = solve_streaming_host(host_array_source(ph, bh, budgets, C_MAIN), cfg,
                               q=Q_MAIN, device="cpu")
    cpu_s = time.perf_counter() - t0
    gpu = runs[C_MAIN]
    check(np.allclose(gpu.lam.numpy(), cpu.lam.numpy(), rtol=1e-5, atol=1e-6),
          "lam differs from the CPU solve")
    check(abs(gpu.iters - cpu.iters) <= 1, "iters differ from the CPU solve")
    for f in ("primal", "dual"):
        g, c = float(getattr(gpu, f)), float(getattr(cpu, f))
        check(abs(g - c) <= 1e-5 * abs(c), f"{f} differs from the CPU solve")
    check(float(gpu.tau) == float(cpu.tau), "tau differs from the CPU solve")
    emit("against_cpu", n=n, bitwise=same(gpu, cpu), iters=[gpu.iters, cpu.iters],
         lam_max_abs_diff=float((gpu.lam - cpu.lam).abs().max()),
         primal=[float(gpu.primal), float(cpu.primal)],
         dual=[float(gpu.dual), float(cpu.dual)], tau=repr(float(gpu.tau)),
         cpu_wall_s=cpu_s)


def phase_end_to_end(torch, dev):
    from repro_torch.configs.paper_kp import WORKLOADS, KPWorkload
    from repro_torch.core.prefetch import FeedStats
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.solve import run_streaming

    wl = WORKLOADS["table1"]
    n = int(wl.n_users * 0.1)
    work = KPWorkload(wl.name, n, wl.k, wl.q, wl.tightness)
    stats = FeedStats()
    ops.reset_launches()
    row = run_streaming(work, SolverConfig(max_iters=40), C_MAIN, device=dev,
                        stats=stats)
    launches = dict(ops.LAUNCHES)
    chunks = -(-n // C_MAIN)
    iters = row["iterations"]
    check(launches["scd_fused_hist"] == iters * chunks,
          f"scd_fused_hist launched {launches['scd_fused_hist']} times, "
          f"expected iters x chunks = {iters * chunks}")
    check(launches["scd_finalize_hist"] == chunks,
          f"scd_finalize_hist launched {launches['scd_finalize_hist']} times, "
          f"expected chunks = {chunks}")
    check(row["max_violation"] <= 1e-4, f"max_violation {row['max_violation']}")
    check(row["dual"] >= row["primal"], "dual below primal")
    check(all(map(lambda v: v == v and abs(v) != float("inf"),
                  (row["primal"], row["dual"], row["max_violation"]))),
          "non-finite metrics")
    it = [e for e in stats.epochs if e["kind"] == "iterate"]
    fin = [e for e in stats.epochs if e["kind"] == "finalize"]
    keys = ("fetch_s", "stage_s", "h2d_ms", "step_ms", "wall_s")
    per_epoch = {k: statistics.mean(e[k] for e in it) for k in keys}
    emit("end_to_end", workload="table1", n=n, chunk=C_MAIN, chunks=chunks,
         iters=iters, primal=row["primal"], dual=row["dual"],
         gap=row["duality_gap"], max_violation=row["max_violation"],
         wall_s=row["wall_s"], launches=launches,
         iterate_epoch_mean=per_epoch,
         finalize_epoch={k: fin[0][k] for k in keys})
    return launches, row


def same_solve(a, b):
    import torch
    return a.iters == b.iters and all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("lam", "x", "r", "primal", "dual"))


def close_solve(gpu, cpu):
    """lam rtol 1e-5 / atol 1e-6, iterations within one, primal and dual 1e-5."""
    import numpy as np
    return (np.allclose(gpu.lam.numpy(), cpu.lam.numpy(), rtol=1e-5, atol=1e-6)
            and abs(gpu.iters - cpu.iters) <= 1
            and all(abs(float(getattr(gpu, f)) - float(getattr(cpu, f)))
                    <= 1e-5 * abs(float(getattr(cpu, f))) for f in ("primal", "dual")))


def phase_resident_kernels(torch, np, dev):
    """The resident path's kernels against their plain versions, timed."""
    from repro_torch.core.bucketing import make_edges
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.launch.kernel_split import split

    gen = torch.Generator(device=dev)
    out, cases = {}, 0

    def rows(n, seed, k=K):
        gen.manual_seed(seed)
        p = torch.rand((n, k), generator=gen, device=dev)
        b = torch.rand((n, k), generator=gen, device=dev)
        b[::7, 3] = 0.0                           # no candidate at b = 0
        lam = 0.3 + torch.rand((k,), generator=gen, device=dev)
        return p, b, lam

    for n in (N_RES, N_RES - 37):
        for q in (1, 3):
            p, b, lam = rows(n, n % 97 + q)
            kv = ops.scd_candidates(p, b, lam, q)
            pv = ref.candidates_block(p, b, lam, q)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(kv, pv)),
                  f"scd_candidates differs from its plain version (n={n}, q={q})")
            cases += 1
            del kv, pv
    # Each K branch and staged row width (K odd, 2 mod 4, swizzled 8, 16,
    # 64), q from none to all K, aligned and one row in (unaligned copies).
    for k in CAND_K:
        for q in sorted({0, 1, 3, k}):
            for dyadic in (False, True):
                pk, bk, lk = branch_rows(torch, np, 4 * C_MAIN - 36, k, 5 * k + q, dyadic,
                                         dev)
                bk[2::11] = -bk[2::11]
                for tag, pa, ba in (("aligned", pk[:-1], bk[:-1]),
                                    ("one row in", pk[1:], bk[1:])):
                    kv = ops.scd_candidates(pa, ba, lk, q)
                    want = ref.candidates_block(pa, ba, lk, q)
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(kv, want)),
                          f"scd_candidates differs from its plain version (K={k} q={q} "
                          f"dyadic={dyadic} {tag})")
                    cases += 1
    del pk, bk, kv, want

    def cand_row(k):
        pk, bk, lk = rows(N_RES, 5, k)
        call = lambda: ops.scd_candidates(pk, bk, lk, Q_MAIN)  # noqa: E731
        return pk, bk, lk, call, {
            "ms": time_ms(torch, call, reps=20),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(cost.scd_candidates(N_RES, k, Q_MAIN))))}

    other_k = {f"k{k}": cand_row(k)[-1] for k in (8, 16)}
    p, b, lam, cand_call, row = cand_row(K)
    emit("kernel_split", kernel="scd_candidates", rows=N_RES, k=K, **split(cand_call, reps=20))
    out["scd_candidates"] = {
        "max_abs_err": 0.0, **row,
        "plain_ms": time_ms(torch, lambda: ref.candidates_block(p, b, lam, Q_MAIN),
                            reps=3, warmup=1),
        "library_ms": None, "n": N_RES, "k": K, "q": Q_MAIN, "other_k": other_k}

    # The fused kernel at the resident shape: one call over N rows, at the
    # map's default tile (what the resident solve runs).
    edges = make_edges(lam.cpu(), 1e-4, 1.6, 24).to(dev)
    e = edges.shape[-1]
    tile = ops.MAP_TILE
    kh, kt = ops.scd_fused_hist(p, b, lam, edges, Q_MAIN)
    ph, pt = ref.scd_fused_hist_plain(p, b, lam, edges, Q_MAIN)
    torch.cuda.synchronize()
    check(torch.equal(kt, pt) and torch.equal(kh, ph),
          "scd_fused_hist not bitwise its plain version at the resident shape")
    cases += 1
    fused_call = lambda: ops.scd_fused_hist(p, b, lam, edges, Q_MAIN)  # noqa: E731
    emit("kernel_split", kernel="scd_fused_hist", rows=N_RES, tile=tile,
         **split(fused_call, reps=20))
    fused_res = {
        "n": N_RES, "tile": tile, "bitwise": True, "max_abs_err": 0.0,
        "ms": time_ms(torch, fused_call, reps=20),
        "plain_ms": time_ms(torch, lambda: ref.scd_fused_hist_plain(
            p, b, lam, edges, Q_MAIN), reps=1, warmup=0),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(cost.scd_fused_hist(N_RES, K, e, Q_MAIN))))}
    del p, b, kh, ph

    # bucket_hist at the dense shape: n * P candidate rows, default tile.
    nrows = DENSE_N * (DENSE_M * (DENSE_M - 1) // 2 + DENSE_M)
    for dyadic in (False, True):
        for seeded in (False, True):
            gen.manual_seed(17 + 2 * dyadic + seeded)
            v1 = lam[None, :] + (torch.rand((nrows, K), generator=gen, device=dev)
                                 - 0.5) * 0.1
            v2 = torch.rand((nrows, K), generator=gen, device=dev)
            invalid = torch.rand((nrows, K), generator=gen, device=dev) < 0.3
            if dyadic:
                v2 = torch.round(v2 * 64) / 64
            v1, v2 = torch.where(invalid, -1.0, v1), torch.where(invalid, 0.0, v2)
            init = (torch.round(torch.rand((K, e + 1), generator=gen, device=dev)
                                * 256) / 64 if seeded else None)
            kh = ops.bucket_hist(v1, v2, edges, hist_init=init)
            ph = ref.bucket_hist_plain(v1, v2, edges, hist_init=init)
            torch.cuda.synchronize()
            check(torch.equal(kh, ph),
                  f"bucket_hist not bitwise (dyadic={dyadic} seeded={seeded})")
            cases += 1
    bucket_call = lambda: ops.bucket_hist(v1, v2, edges, hist_init=init)  # noqa: E731
    emit("kernel_split", kernel="bucket_hist", rows=nrows, tile=ops.MAP_TILE,
         **split(bucket_call, reps=20))
    out["bucket_hist"] = {
        "max_abs_err": 0.0, "tile": ops.MAP_TILE,
        "ms": time_ms(torch, bucket_call, reps=20),
        "plain_ms": time_ms(torch, lambda: ref.bucket_hist_plain(
            v1, v2, edges, hist_init=init), reps=2, warmup=1),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(cost.bucket_hist(nrows, K, e)))),
        "library_ms": None, "rows": nrows}
    emit("resident_kernels_vs_plain", cases=cases, k=K, scd_fused_hist_resident=fused_res,
         **out)
    return out, fused_res


def phase_resident_end_to_end(torch, dev, host_fed):
    """table1 at N = 10^7, solved resident, bucketed and exact; the default
    bucketed solve against ``host_fed``, phase 5's row on the same rows."""
    from repro_torch.configs.paper_kp import WORKLOADS, KPWorkload
    from repro_torch.core import solver
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.solve import run

    wl = WORKLOADS["table1"]
    work = KPWorkload(wl.name, N_RES, wl.k, wl.q, wl.tightness)
    paths = {}
    for reduce, kernel in (("bucketed", "scd_fused_hist"), ("exact", "scd_candidates")):
        cfg = SolverConfig(max_iters=40, reduce=reduce)
        ops.reset_launches()
        row = run(work, cfg, device=dev)
        launches = dict(ops.LAUNCHES)
        iters = row["iterations"]
        check(launches[kernel] == iters,
              f"{kernel} launched {launches[kernel]} times in the resident "
              f"{reduce} solve, expected iterations = {iters}")
        check(launches["adjusted_topc"] == 1,
              f"adjusted_topc launched {launches['adjusted_topc']} times in the "
              f"resident {reduce} solve, expected 1 (the final metrics pass)")
        check(sum(launches.values()) == iters + 1,
              f"other kernels launched in the resident {reduce} solve: {launches}")
        check(row["max_violation"] <= 1e-4, f"max_violation {row['max_violation']}")
        check(row["dual"] >= row["primal"], "dual below primal")
        paths[f"resident_{reduce}"] = launches

        # Where the time goes: one iteration's map + reduce (at lam = 1,
        # synchronised by the host read of its result), and the final
        # metrics and exact projection (a solve with max_iters = 0).
        kp, q = sparse_instance(0, N_RES, K, wl.q, tightness=wl.tightness, device=dev)
        same_as_host_fed = None
        if reduce == "bucketed":
            res = solver.solve(kp, cfg, q=q, device=dev)
            HOST_RESULTS["resident_bucketed"] = res._replace(x=None)
            same_as_host_fed = (res.iters == host_fed["iterations"]
                                and res.lam.tolist() == host_fed["lam"])
            check(same_as_host_fed, "the default resident bucketed solve differs from "
                  "the host-fed one on the same rows (lam or iterations)")
        lam = torch.ones(K)
        solver._scd_pass(kp, lam, q, cfg)
        iter_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            solver._scd_pass(kp, lam, q, cfg)
            iter_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(kp, cfg.replace(max_iters=0), q=q, device=dev)
        final_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        solver.solve(kp, cfg.replace(max_iters=1), q=q, device=dev)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        del kp
        emit("resident_end_to_end", workload="table1", n=N_RES, reduce=reduce,
             iters=iters, primal=row["primal"], dual=row["dual"],
             gap=row["duality_gap"], max_violation=row["max_violation"],
             wall_s=row["wall_s"], launches=launches,
             iteration_s=statistics.median(iter_s), final_pass_s=final_s,
             peak_gb_one_iteration=peak_gb, map_tile=ops.MAP_TILE,
             lam_iters_equal_host_fed=same_as_host_fed)
    return paths


def phase_dense_end_to_end(torch, dev):
    """Figure 1's dense setup at n = DENSE_N_E2E, sync bucketed, chunked and not."""
    from repro_torch.core import solver
    from repro_torch.core.instances import dense_instance
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops

    kp = dense_instance(0, DENSE_N_E2E, DENSE_M, K, local="C223", mixed_b=True, device=dev)
    cfg = SolverConfig(max_iters=40, kernel_tile=512)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(kp, cfg, q=0, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["bucket_hist"] == res.iters,
          f"bucket_hist launched {launches['bucket_hist']} times, expected "
          f"iterations = {res.iters}")
    check(sum(launches.values()) == res.iters, f"other kernels launched: {launches}")
    t0 = time.perf_counter()
    chunked = solver.solve(kp, cfg.replace(chunk_size=16384), q=0, device=dev)
    wall_chunked = time.perf_counter() - t0
    check(same_solve(res, chunked), "dense chunked solve differs from unchunked")
    budgets = kp.budgets.cpu()
    check(bool(torch.all(res.r <= budgets)), "dense solve over budget")
    check(float(res.dual) >= float(res.primal), "dense dual below primal")
    emit("dense_end_to_end", n=DENSE_N_E2E, m=DENSE_M, k=K, local="C223", mixed_b=True,
         iters=res.iters, primal=float(res.primal), dual=float(res.dual),
         gap=float(res.dual - res.primal),
         max_violation=float(torch.max((res.r - budgets) / budgets)),
         wall_s=wall, wall_chunked_s=wall_chunked, chunked_bitwise=True,
         launches=launches)
    return {"dense_bucketed": launches}


def phase_contracts(torch, dev):
    """Resident chunked == unchunked == host-fed; exact reruns; card vs CPU."""
    from repro_torch.core import solver
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.types import SolverConfig
    from repro_torch.data.synth import sparse_host_chunk_source

    n = 262_144
    kp, q = sparse_instance(1, n, K, chunk=C_MAIN, device=dev)
    cfg = SolverConfig(max_iters=40, kernel_tile=512)
    whole = solver.solve(kp, cfg, q=q, device=dev)
    chunked = solver.solve(kp, cfg.replace(chunk_size=C_MAIN), q=q, device=dev)
    host = solve_streaming_host(sparse_host_chunk_source(1, n, K, C_MAIN), cfg, q=q,
                                device=dev)
    exact_cfg = cfg.replace(reduce="exact")
    exact = solver.solve(kp, exact_cfg, q=q, device=dev)
    exact_again = solver.solve(kp, exact_cfg, q=q, device=dev)
    default = SolverConfig(max_iters=40)          # MAP_TILE divides the chunk
    whole_default = solver.solve(kp, default, q=q, device=dev)
    host_default = solve_streaming_host(sparse_host_chunk_source(1, n, K, C_MAIN),
                                        default, q=q, device=dev)
    gpu = {"bucketed": whole, "exact": exact}
    cpu = {"bucketed": solver.solve(kp, cfg, q=q, device="cpu"),
           "exact": solver.solve(kp, exact_cfg, q=q, device="cpu")}
    facts = {"chunked_bitwise": same_solve(whole, chunked),
             "host_fed_bitwise": (host.iters == chunked.iters
                                  and torch.equal(host.lam, chunked.lam)),
             "exact_rerun_bitwise": same_solve(exact, exact_again),
             "default_tile_host_fed_bitwise": (host_default.iters == whole_default.iters
                                               and torch.equal(host_default.lam,
                                                               whole_default.lam))}
    emit("resident_contracts", n=n, **facts,
         against_cpu={name: {"within_tolerance": close_solve(res, cpu[name]),
                             "bitwise": same_solve(res, cpu[name]),
                             "iters": [res.iters, cpu[name].iters],
                             "lam_max_abs_diff": float((res.lam - cpu[name].lam)
                                                       .abs().max()),
                             "primal": [float(res.primal), float(cpu[name].primal)],
                             "dual": [float(res.dual), float(cpu[name].dual)]}
                      for name, res in gpu.items()})
    check(facts["chunked_bitwise"], "resident chunked differs from unchunked")
    check(facts["host_fed_bitwise"], "resident chunked differs from the host-fed solve")
    check(facts["exact_rerun_bitwise"], "repeated exact solves differ")
    check(facts["default_tile_host_fed_bitwise"],
          "at the default tiles the resident solve differs from the host-fed one")
    for name, res in gpu.items():
        check(close_solve(res, cpu[name]), f"resident {name} solve differs from the CPU")


def phase_slice3_contracts(torch, np, dev):
    """Screened host-fed card == CPU; host-fed DD == resident chunked DD."""
    from repro_torch.core import solver
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.types import SolverConfig
    from repro_torch.data.synth import banded_host_chunk_source, sparse_host_chunk_source

    n = 262_144
    src = banded_host_chunk_source(7, n, BANDED["k"], 16_384, q=BANDED["q"],
                                   tightness=BANDED["tightness"], band=BANDED["band"])
    cfg = SolverConfig(max_iters=30, bucket_half=12, kernel_tile=512, screening=True)
    gpu = solve_streaming_host(src, cfg, q=BANDED["q"], device=dev)
    cpu = solve_streaming_host(src, cfg, q=BANDED["q"], device="cpu")
    profile = [gpu.screen["streamed_chunks"].tolist(), cpu.screen["streamed_chunks"].tolist()]
    screened = {"lam_iters_bitwise": gpu.iters == cpu.iters and torch.equal(gpu.lam, cpu.lam),
                "all_fields_bitwise": same(gpu, cpu),
                "bmax_bitwise": bool(np.array_equal(gpu.screen["bmax"], cpu.screen["bmax"])),
                "streamed_chunks": profile}
    dd_cfg = SolverConfig(algo="dd", max_iters=20)
    kp, q = sparse_instance(1, n, K, chunk=C_MAIN, device=dev)
    resident = solver.solve(kp, dd_cfg.replace(chunk_size=C_MAIN), q=q, device=dev)
    host = solve_streaming_host(sparse_host_chunk_source(1, n, K, C_MAIN), dd_cfg, q=q,
                                device=dev)
    dd = {"lam_iters_bitwise": host.iters == resident.iters
          and torch.equal(host.lam, resident.lam), "iters": host.iters}
    emit("slice3_contracts", n=n, screened_card_vs_cpu=screened,
         host_fed_dd_vs_resident_chunked=dd)
    check(screened["lam_iters_bitwise"], "screened host-fed solve differs from the CPU's")
    check(profile[0] == profile[1], "streamed-chunk profiles differ from the CPU's")
    check(screened["bmax_bitwise"], "certificates differ from the CPU's")
    check(dd["lam_iters_bitwise"], "host-fed DD differs from the resident chunked DD")


def phase_slice3_kernels(torch, np, dev):
    """screen_bound and adjusted_topc against their plain versions, timed."""
    from repro_torch.core.sparse_scd import select_sparse
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.launch.kernel_split import split

    cases = 0
    for k in (6, 10):
        for c in (C_MAIN, C_MAIN - 37):
            for dyadic in (False, True):
                g = np.random.default_rng(31 * k + c % 11 + dyadic)
                if dyadic:
                    p, b = g.integers(0, 64, (c, k)) / 64.0, g.integers(0, 64, (c, k)) / 64.0
                else:
                    p, b = g.random((c, k)), g.uniform(-0.05, 1.0, (c, k))
                b[::9] = 0.0                       # rows without a valid item
                b[:, 1] = 0.0                      # a column without one: -inf
                pt = torch.tensor(p, dtype=torch.float32, device=dev)
                bt = torch.tensor(b, dtype=torch.float32, device=dev)
                # Into row 1 of a (3, K) buffer, as the screened driver
                # writes its certificates; rows 0 and 2 must stay.
                buf = torch.full((3, k), 7.0, dtype=torch.float32, device=dev)
                got = ops.screen_bound(pt, bt, out=buf[1])
                want = ref.screen_bound_plain(pt, bt)
                torch.cuda.synchronize()
                tag = f"K={k} n={c} dyadic={dyadic}"
                check(torch.equal(got, want) and torch.equal(buf[1], want),
                      f"screen_bound not bitwise ({tag})")
                check(bool(torch.all(buf[0::2] == 7.0)), f"screen_bound wrote outside out ({tag})")
                check(float(got[1]) == float("-inf"), f"screen_bound column not -inf ({tag})")
                cases += 1
    kb = BANDED["k"]
    g = np.random.default_rng(3)
    pt = torch.tensor(g.random((C_MAIN, kb)) * 0.05, dtype=torch.float32, device=dev)
    bt = torch.tensor(0.5 + g.random((C_MAIN, kb)) * 0.5, dtype=torch.float32, device=dev)
    bound_row = torch.empty((kb,), dtype=torch.float32, device=dev)
    screen_call = lambda: ops.screen_bound(pt, bt, out=bound_row)  # noqa: E731
    emit("kernel_split", kernel="screen_bound", rows=C_MAIN, k=kb,
         **split(screen_call, reps=50))
    out = {"screen_bound": {
        "max_abs_err": 0.0, "rows": C_MAIN, "k": kb,
        "ms": time_ms(torch, screen_call, reps=50),
        "plain_ms": time_ms(torch, lambda: ref.screen_bound_plain(pt, bt), reps=20),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(cost.screen_bound(C_MAIN, kb, out=True)))),
        "library_ms": None}}

    gen = torch.Generator(device=dev)
    for n in (N_RES - 37, N_RES):          # the last case, n = N_RES and q = 1, is timed
        for q in (3, 1):
            gen.manual_seed(n % 89 + q)
            p = torch.rand((n, K), generator=gen, device=dev)
            b = torch.rand((n, K), generator=gen, device=dev)
            b[::7, 3] = 0.0
            lam = 0.3 + torch.rand((K,), generator=gen, device=dev)
            x, v = ops.adjusted_topc(p, b, lam, q)
            px, pv = ref.adjusted_topc_plain(p, b, lam, q)
            sx = select_sparse(p, b, lam, q)
            torch.cuda.synchronize()
            tag = f"n={n} q={q}"
            check(torch.equal(x, px) and torch.equal(v, pv),
                  f"adjusted_topc differs from its plain version ({tag})")
            check(torch.equal(x, sx), f"adjusted_topc differs from select_sparse ({tag})")
            cases += 1
            del x, v, px, pv, sx
    for k in BRANCH_K:
        for q in sorted({0, 1, 3, k}):
            for dyadic in (False, True):
                pk, bk, lk = branch_rows(torch, np, 4 * C_MAIN - 37, k, 7 * k + q, dyadic,
                                         dev)
                x, v = ops.adjusted_topc(pk, bk, lk, q)
                px, pv = ref.adjusted_topc_plain(pk, bk, lk, q)
                torch.cuda.synchronize()
                check(torch.equal(x, px) and torch.equal(v, pv),
                      f"adjusted_topc differs from its plain version (K={k} q={q} "
                      f"dyadic={dyadic})")
                cases += 1
    del pk, bk, x, v, px, pv
    topc_call = lambda: ops.adjusted_topc(p, b, lam, Q_MAIN)  # noqa: E731
    emit("kernel_split", kernel="adjusted_topc", rows=N_RES, **split(topc_call, reps=20))
    out["adjusted_topc"] = {
        "max_abs_err": 0.0, "n": N_RES, "k": K, "q": Q_MAIN,
        "ms": time_ms(torch, topc_call, reps=20),
        "plain_ms": time_ms(torch, lambda: ref.adjusted_topc_plain(p, b, lam, Q_MAIN),
                            reps=5, warmup=1),
        "select_sparse_ms": time_ms(torch, lambda: select_sparse(p, b, lam, Q_MAIN),
                                    reps=3, warmup=1),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(cost.adjusted_topc(N_RES, K, Q_MAIN)))),
        "library_ms": None}
    # The host-fed DD calls it once per 65,536-row chunk.
    pc, bc = p[:C_MAIN].contiguous(), b[:C_MAIN].contiguous()
    emit("kernel_split", kernel="adjusted_topc", rows=C_MAIN,
         **split(lambda: ops.adjusted_topc(pc, bc, lam, Q_MAIN), reps=50))
    out["adjusted_topc"]["chunk_shape"] = {
        "rows": C_MAIN,
        "ms": time_ms(torch, lambda: ops.adjusted_topc(pc, bc, lam, Q_MAIN), reps=50),
        "plain_ms": time_ms(torch, lambda: ref.adjusted_topc_plain(pc, bc, lam, Q_MAIN),
                            reps=20),
        "bound_ms": bound(cost.adjusted_topc(C_MAIN, K, Q_MAIN))[0]}
    emit("slice3_kernels_vs_plain", cases=cases, **out)
    return out


def feed_epochs(stats):
    keys = ("kind", "chunks", "fetch_s", "stage_s", "h2d_ms", "step_ms", "wall_s")
    return [{k: e[k] for k in keys} for e in stats.epochs]


def phase_screened_end_to_end(torch, dev):
    """The banded workload at N = 10^7, host-fed, unscreened and screened."""
    from repro_torch.core.prefetch import FeedStats, solve_streaming_host
    from repro_torch.core.types import SolverConfig
    from repro_torch.data.synth import banded_host_chunk_source
    from repro_torch.kernels import ops

    chunks = -(-N_RES // C_MAIN)
    src = banded_host_chunk_source(7, N_RES, BANDED["k"], C_MAIN, q=BANDED["q"],
                                   tightness=BANDED["tightness"], band=BANDED["band"])
    budgets = torch.as_tensor(src.budgets)
    runs, paths = {}, {}
    for screening in (False, True):
        stats = FeedStats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solve_streaming_host(
            src, SolverConfig(max_iters=30, bucket_half=12, screening=screening),
            q=BANDED["q"], device=dev, stats=stats)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        name = "host_fed_banded_screened" if screening else "host_fed_banded"
        runs[screening], paths[name] = res, launches
        viol = float(torch.max((res.r - budgets) / budgets))
        screen = None
        if screening:
            screen = {"streamed_chunks": res.screen["streamed_chunks"].tolist(),
                      "resets": res.screen["resets"],
                      "fallbacks": res.screen["fallbacks"],
                      "retired_at_end": int((~res.screen["active"]).sum())}
        emit("screened_end_to_end", workload="banded", n=N_RES, chunk=C_MAIN,
             chunks=chunks, screening=screening, iters=res.iters,
             primal=float(res.primal), dual=float(res.dual), max_violation=viol,
             wall_s=wall, launches=launches, screen=screen,
             epochs=feed_epochs(stats))
        check(viol <= 1e-4, f"max_violation {viol}")
        check(float(res.dual) >= float(res.primal), "dual below primal")
        check(launches["scd_finalize_hist"] == chunks, "finalize launches != chunks")
    base, scr = runs[False], runs[True]
    HOST_RESULTS["banded_screened"] = scr
    check(same(base, scr), "screened solve differs from the unscreened one")
    streamed = scr.screen["streamed_chunks"]
    got = paths["host_fed_banded_screened"]
    check(got["screen_bound"] == chunks,
          f"screen_bound launched {got['screen_bound']} times, expected {chunks}")
    check(got["scd_fused_hist"] == int(streamed.sum()),
          f"scd_fused_hist launched {got['scd_fused_hist']} times, the streamed-chunk "
          f"profile sums to {int(streamed.sum())}")
    check(int(streamed.min()) < chunks, "no epoch streamed fewer chunks: nothing retired")
    check(paths["host_fed_banded"]["scd_fused_hist"] == base.iters * chunks,
          "unscreened scd_fused_hist launches != iters x chunks")
    check(paths["host_fed_banded"]["screen_bound"] == 0, "unscreened solve launched screen_bound")
    return paths


def phase_dd_end_to_end(torch, dev):
    """DD: table1 resident at N = 10^7 and host-fed at N = 10^6."""
    from repro_torch.configs.paper_kp import WORKLOADS, KPWorkload
    from repro_torch.core.prefetch import FeedStats
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.solve import run, run_streaming

    wl = WORKLOADS["table1"]
    cfg = SolverConfig(algo="dd", max_iters=40)
    ops.reset_launches()
    row = run(KPWorkload(wl.name, N_RES, wl.k, wl.q, wl.tightness), cfg, device=dev)
    resident = dict(ops.LAUNCHES)
    iters = row["iterations"]
    check(resident["adjusted_topc"] == iters + 1,
          f"adjusted_topc launched {resident['adjusted_topc']} times in the resident DD "
          f"solve, expected iterations + 1 = {iters + 1}")
    check(sum(resident.values()) == iters + 1, f"other kernels launched: {resident}")
    emit("dd_end_to_end", workload="table1", mode="resident", n=N_RES, iters=iters,
         primal=row["primal"], dual=row["dual"], gap=row["duality_gap"],
         max_violation=row["max_violation"], wall_s=row["wall_s"], launches=resident)
    stats = FeedStats()
    ops.reset_launches()
    hrow = run_streaming(KPWorkload(wl.name, N_HOST_DD, wl.k, wl.q, wl.tightness), cfg,
                         C_MAIN, device=dev, stats=stats)
    host = dict(ops.LAUNCHES)
    chunks = -(-N_HOST_DD // C_MAIN)
    check(host["adjusted_topc"] == hrow["iterations"] * chunks,
          "host-fed DD: adjusted_topc launches != iters x chunks")
    check(host["scd_finalize_hist"] == chunks, "host-fed DD: finalize launches != chunks")
    check(sum(host.values()) == (hrow["iterations"] + 1) * chunks,
          f"host-fed DD: other kernels launched: {host}")
    emit("dd_end_to_end", workload="table1", mode="host_fed", n=N_HOST_DD, chunk=C_MAIN,
         iters=hrow["iterations"], primal=hrow["primal"], dual=hrow["dual"],
         gap=hrow["duality_gap"], max_violation=hrow["max_violation"],
         wall_s=hrow["wall_s"], launches=host, epochs=feed_epochs(stats))
    for r in (row, hrow):
        check(r["max_violation"] <= 1e-4, f"DD max_violation {r['max_violation']}")
        check(r["dual"] >= r["primal"], "DD dual below primal")
        check(all(v == v and abs(v) != float("inf")
                  for v in (r["primal"], r["dual"], r["max_violation"])),
              "non-finite DD metrics")
    return {"resident_dd": resident, "host_fed_dd": host}


_KILL_CHILD = """
import os, signal, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.paper_kp import WORKLOADS
from repro_torch.core.prefetch import solve_streaming_host
from repro_torch.core.types import SolverConfig
from repro_torch.data.synth import sparse_host_chunk_source
from repro_torch.kernels import _build

n, kill_after, ckpt_dir, resume = (int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                   sys.argv[5] == "1")
_build.load()                       # the parent's library, from the build/ cache
wl = WORKLOADS["table1"]
src = sparse_host_chunk_source(0, n, wl.k, int(sys.argv[6]), q=wl.q,
                               tightness=wl.tightness)
calls = {"n": 0}
inner = src.fn

def fn(i):
    calls["n"] += 1
    if calls["n"] > kill_after:
        os.kill(os.getpid(), signal.SIGKILL)
    return inner(i)

solve_streaming_host(src._replace(fn=fn),
                     SolverConfig(max_iters=40, checkpoint_every=int(sys.argv[7])),
                     q=wl.q, slots=int(sys.argv[8]), checkpoint_dir=ckpt_dir,
                     resume_from=ckpt_dir if resume else None)
"""


def table1_source(n, seed=0):
    """table1's rows in chunks of C_MAIN, as the launcher's ``run_streaming``
    draws them."""
    from repro_torch.configs.paper_kp import WORKLOADS
    from repro_torch.data.synth import sparse_host_chunk_source
    wl = WORKLOADS["table1"]
    return sparse_host_chunk_source(seed, n, wl.k, C_MAIN, q=wl.q,
                                    tightness=wl.tightness), wl.q


def counting(src):
    calls = {"n": 0}
    inner = src.fn

    def fn(i):
        calls["n"] += 1
        return inner(i)

    return src._replace(fn=fn), calls


def start_killed(ckpt_dir, n, kill_after, resume):
    """The slot solve of table1 at ``n`` rows started in a fresh
    interpreter, which SIGKILLs itself at its (kill_after + 1)-th chunk
    read: (process, start time) for :func:`wait_killed`."""
    proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, str(ROOT / "src"), str(n),
                             str(kill_after), str(ckpt_dir), "1" if resume else "0",
                             str(C_MAIN), str(CKPT_EVERY), str(SLOTS)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def wait_killed(started):
    """The wall of a :func:`start_killed` solve, which must have ended by
    its SIGKILL."""
    proc, t0 = started
    _, err = proc.communicate(timeout=600)
    check(proc.returncode == -signal.SIGKILL,
          f"the killed solve ended with {proc.returncode}: {err[-3000:]}")
    return time.perf_counter() - t0


def latest_state(ckpt, d):
    step = ckpt.latest_step(d)
    check(step is not None, f"no checkpoint in {d}")
    st = ckpt.restore_auto(d, step)
    return step, {k: int(st[k]) for k in ("phase", "iters", "cursor", "slots")}


def solve_metrics(torch, res, budgets):
    viol = float(torch.max((res.r - budgets) / budgets))
    return {"iters": res.iters, "primal": float(res.primal), "dual": float(res.dual),
            "gap": float(res.dual - res.primal), "max_violation": viol}


def phase_slots(torch, np, dev):
    """The slot solve at table1's full width, checkpointed, killed and
    resumed, under faults, and on the card against the CPU (phase 13)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import prefetch as tpf
    from repro_torch.core.faults import ChunkFetchError, FaultPlan, faulty_source
    from repro_torch.core.faults import process_registry
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, read_trace

    import threading

    src, q = table1_source(N_SLOTS_CKPT)
    budgets = torch.as_tensor(src.budgets)
    c = -(-N_SLOTS_CKPT // C_MAIN)
    cps = -(-c // SLOTS)
    cfg = SolverConfig(max_iters=40)
    ckpt_cfg = cfg.replace(checkpoint_every=CKPT_EVERY)
    work = ROOT / "build" / "smoke_slots"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def solve(source, config, device=dev, q=q, **kw):
        t0 = time.perf_counter()
        res = tpf.solve_streaming_host(source, config, q=q, slots=SLOTS, device=device,
                                       **kw)
        return res, time.perf_counter() - t0

    # Step 6's cases (card against CPU at n = 2^17): their CPU solves run in
    # a thread from here, beside steps 1-5, whose host work leaves cores idle.
    from repro_torch.data.synth import banded_host_chunk_source
    n = N_VS_CPU
    rows, _ = table1_source(n, seed=1)
    banded = banded_host_chunk_source(7, n, BANDED["k"], n // 16, q=BANDED["q"],
                                      tightness=BANDED["tightness"], band=BANDED["band"])
    cases = {"scd": (rows, cfg, q),
             "screened_banded": (banded, SolverConfig(max_iters=30, bucket_half=12,
                                                      screening=True), BANDED["q"]),
             "dd": (rows, SolverConfig(algo="dd", max_iters=12), q),
             "presolve": (rows, cfg.replace(presolve_samples=65_536), q)}
    on_cpu = {}

    def solve_on_cpu():
        try:
            for name, (source, config, qq) in cases.items():
                on_cpu[name] = solve(source, config, device="cpu", q=qq)
        except BaseException as e:          # re-raised at step 6
            on_cpu["error"] = e

    cpu_thread = threading.Thread(target=solve_on_cpu, daemon=True)
    cpu_thread.start()

    # 1. Uninterrupted, counted.
    stats = tpf.FeedStats()
    ops.reset_launches()
    base, wall = solve(src, cfg, stats=stats)
    launches = dict(ops.LAUNCHES)
    HOST_RESULTS["slots4"], HOST_RESULTS["slots4_wall"] = base, wall
    iters = base.iters
    m = solve_metrics(torch, base, budgets)
    # The single slot: the resident solve of the same rows at the default
    # map tile, bitwise the host-fed single-slot solve (phase 5's at N_RES).
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.solver import solve as solve_resident
    from repro_torch.configs.paper_kp import WORKLOADS
    kp, _ = sparse_instance(0, N_SLOTS_CKPT, src.k, q,
                            tightness=WORKLOADS["table1"].tightness, device=dev, chunk=C_MAIN)
    tiles = {t: solve_resident(kp, cfg.replace(kernel_tile=t), q=q, device=dev)
             for t in (8192, 4096, 16384)}
    del kp
    one = tiles[8192]
    single = {"lam": one.lam.numpy(), "iters": one.iters, "primal": float(one.primal),
              "dual": float(one.dual)}
    lam_diff = np.abs(base.lam.numpy() - single["lam"])
    it = [e for e in stats.epochs if e["kind"] == "iterate"]
    keys = ("fetch_s", "stage_s", "h2d_ms", "step_ms", "wall_s")
    emit("slots_end_to_end", workload="table1", n=N_SLOTS_CKPT, chunk=C_MAIN, slots=SLOTS,
         chunks=c, columns=cps, chunk_slots=SLOTS * cps, wall_s=wall, launches=launches,
         **m, single_slot={"iters": single["iters"], "primal": single["primal"],
                           "dual": single["dual"],
                           "lam_max_abs_diff": float(lam_diff.max()),
                           "lam_max_rel_diff": float((lam_diff / np.abs(single["lam"]))
                                                     .max())},
         lam=base.lam.tolist(), single_lam=single["lam"].tolist(),
         iterate_epoch_mean={k: statistics.mean(e[k] for e in it) for k in keys},
         finalize_epoch={k: stats.epochs[-1][k] for k in keys})
    check(launches["scd_fused_hist"] == iters * SLOTS * cps,
          f"scd_fused_hist launched {launches['scd_fused_hist']} times, expected "
          f"iters x slots x cps = {iters * SLOTS * cps}")
    check(launches["scd_finalize_hist"] == SLOTS * cps,
          f"scd_finalize_hist launched {launches['scd_finalize_hist']} times, "
          f"expected slots x cps = {SLOTS * cps}")
    check(m["max_violation"] <= 1e-4, f"slots: max_violation {m['max_violation']}")
    check(m["dual"] >= m["primal"], "slots: dual below primal")
    check(all(v == v and abs(v) != float("inf") for v in m.values()), "slots: non-finite")
    # Another slot count groups the float32 sums differently, and lam is
    # fixed only to the stopping rule's tolerance, tol * (1 + max lam): the
    # check holds lam to that, iterations within one, primal and dual to
    # 1e-5. Beside it, the grouping floor: the single-slot solve with only
    # its map tile changed.
    floor = {t: float((np.abs(r.lam.numpy() - single["lam"]) / np.abs(single["lam"])).max())
             for t, r in tiles.items() if t != 8192}
    stop_tol = cfg.tol * (1.0 + float(single["lam"].max()))
    emit("slots_vs_single_slot", lam_max_abs_diff=float(lam_diff.max()),
         lam_max_rel_diff=float((lam_diff / np.abs(single["lam"])).max()),
         stopping_tolerance=stop_tol,
         grouping_floor_lam_max_rel_diff_by_map_tile=floor,
         iters={"slots": iters, "single": single["iters"],
                "by_map_tile": {t: r.iters for t, r in tiles.items()}})
    check(float(lam_diff.max()) <= stop_tol and abs(iters - single["iters"]) <= 1
          and all(abs(m[f] - single[f]) <= 1e-5 * abs(single[f]) for f in ("primal", "dual")),
          "the slots=4 solve is not within tolerance of the single slot (lam within "
          "tol * (1 + max lam), iterations within one, primal and dual 1e-5)")

    # Steps 2-4 (checkpointed and traced, then killed twice and resumed) are
    # held against step 1's solve; phase 17 holds its worlds against it too.
    # Each killed interpreter runs beside this process's next steps: the
    # mid-iterate one (3) from here, the mid-finalize one (4) from step 2's
    # states on.
    def real(cols):
        """Chunk reads of these finalize columns (inert chunk slots read nothing)."""
        return sum(1 for j in cols for s in range(SLOTS) if s * cps + j < c)

    kill_epoch = max(CKPT_EVERY, iters // 2)
    d1, d2 = work / "kill1", work / "kill2"
    kills = [start_killed(d1, N_SLOTS_CKPT, 1 + kill_epoch * c + c // 2, resume=False)]
    try:
        # 2. Checkpointed every CKPT_EVERY iterations and columns, traced.
        saves = []
        real_save = ckpt.save

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            out = real_save(*a, **kw)
            saves.append(time.perf_counter() - t0)
            return out

        ckpt.save = timed_save
        try:
            with Tracer(work / "journal.jsonl") as tr:
                traced, ck_wall = solve(src, ckpt_cfg, checkpoint_dir=work / "ck", tracer=tr)
        finally:
            ckpt.save = real_save
        spans = read_trace(work / "journal.jsonl")
        n_iter = sum(s["phase"] == "solve.iterate" for s in spans)
        n_fin = sum(s["phase"] == "solve.finalize" for s in spans)
        left = sorted(p.name for p in (work / "ck").iterdir())
        check(same(traced, base), "the checkpointed, traced solve differs from the plain one")
        check(n_iter == iters and n_fin == 1,
              f"journal holds {n_iter} solve.iterate and {n_fin} solve.finalize spans")
        check(len(left) <= ckpt_cfg.checkpoint_keep, f"states left: {left}")
        emit("slots_checkpointed", n=N_SLOTS_CKPT, chunks=c, columns=cps, wall_s=ck_wall,
             plain_wall_s=wall, saves=len(saves),
             save_mean_s=statistics.mean(saves), save_max_s=max(saves),
             states_left=left, spans={p: sum(s["phase"] == p for s in spans)
                                      for p in sorted({s["phase"] for s in spans})})

        # 4. From the oldest state step 2 left: resumed in a fresh interpreter,
        # SIGKILLed between finalize columns after its next save, resumed here,
        # its chunk reads counted.
        shutil.copytree(work / "ck", d2)
        states = sorted(p for p in d2.iterdir() if p.name.startswith("step_"))
        for p in states[1:]:
            shutil.rmtree(p)
        _, st0 = latest_state(ckpt, d2)
        c0 = st0["cursor"]
        c1 = c0 + CKPT_EVERY
        check(c1 < cps, f"no finalize save after column {c0}: {st0}")
        epochs_left = (iters - st0["iters"]) if st0["phase"] == 0 else 0
        kills.append(start_killed(d2, N_SLOTS_CKPT,
                                  1 + epochs_left * c + real(range(c0, c1)) + 2, resume=True))

        # 3. The mid-iterate kill, resumed here.
        kill1_wall = wait_killed(kills[0])
        step1, st1 = latest_state(ckpt, d1)
        check(st1["phase"] == 0 and 0 < st1["iters"] <= kill_epoch,
              f"not a mid-iterate state: {st1}")
        res1, resume1_wall = solve(src, ckpt_cfg, resume_from=d1)
        check(same(res1, base), "resume after the mid-iterate kill differs")

        # 5. The fault layer at N = 2^18.
        fsrc, _ = table1_source(N_FAULTS)
        clean, clean_wall = solve(fsrc, cfg)
        retries = process_registry().counter("faults_retries_total")
        before = retries.value
        chaos_cfg = cfg.replace(fetch_retries=8, fetch_backoff=1e-4, fetch_backoff_cap=1e-3,
                                verify_refetch=True)
        chaos, chaos_wall = solve(faulty_source(fsrc, FaultPlan(seed=0, drop=0.08,
                                                                corrupt=0.04)), chaos_cfg)
        check(same(chaos, clean), "the fault-plan solve differs from the clean one")
        try:
            solve(faulty_source(fsrc, FaultPlan(offenders=(3,), offender_failures=10 ** 6)),
                  cfg.replace(fetch_retries=2, fetch_backoff=1e-5, fetch_backoff_cap=1e-4))
        except ChunkFetchError as e:
            check(e.chunk == 3 and "chunk 3" in str(e) and len(e.history) == 3,
                  f"exhaustion error does not name chunk 3: {e}")
        else:
            check(False, "an exhausting fault plan did not raise ChunkFetchError")
        emit("slots_faults", n=N_FAULTS, iters=clean.iters, clean_wall_s=clean_wall,
             fault_plan_wall_s=chaos_wall, retries=retries.value - before, bitwise=True,
             exhaustion="ChunkFetchError names chunk 3 after 3 attempts")

        # 6. Card against CPU at n = 2^17 (the CPU's solves from the thread).
        out, paths, gpus = {}, {"host_fed_slots4": launches}, {}
        for name, (source, config, qq) in cases.items():
            ops.reset_launches()
            gpus[name] = solve(source, config, q=qq)
            if name != "scd":
                paths[f"host_fed_slots4_{name}"] = dict(ops.LAUNCHES)
            out[name] = {"launches": dict(ops.LAUNCHES)}
        cpu_thread.join()
        if "error" in on_cpu:
            raise on_cpu["error"]
        for name in cases:
            (gpu, card_s), (cpu, cpu_s) = gpus[name], on_cpu[name]
            out[name].update(iters=gpu.iters, bitwise=same(gpu, cpu), card_wall_s=card_s,
                             cpu_wall_s=cpu_s)
            check(out[name]["bitwise"], f"slots {name}: the card's solve differs from the CPU's")
            if gpu.screen is not None:
                profile = [gpu.screen["streamed_chunks"].tolist(),
                           cpu.screen["streamed_chunks"].tolist()]
                out[name]["streamed_chunks"] = profile[0]
                check(profile[0] == profile[1], "slots: screened profiles differ")
                check(min(profile[0]) < 16, "slots: the banded solve retired nothing")
        emit("slots_card_vs_cpu", n=n, slots=SLOTS, cases=out)

        # 4, resumed: the mid-finalize kill, resumed here, its chunk reads counted.
        kill2_wall = wait_killed(kills[1])
        step2, st2 = latest_state(ckpt, d2)
        check(st2["phase"] == 1 and st2["cursor"] == c1,
              f"not the mid-finalize state at column {c1}: {st2}")
        counted, calls = counting(src)
        res2, resume2_wall = solve(counted, ckpt_cfg, resume_from=d2)
        left_real = real(range(c1, cps))
        check(same(res2, base), "resume after the mid-finalize kill differs")
        check(calls["n"] == 1 + left_real,
              f"the mid-finalize resume read {calls['n']} chunks, expected the probe and "
              f"the {left_real} real chunks of columns {c1}..{cps - 1}")
        emit("slots_killed_and_resumed", n=N_SLOTS_CKPT, kill_mid_iterate={
            "killed_wall_s": kill1_wall, "state": {"step": step1, **st1},
            "resumed_wall_s": resume1_wall, "bitwise": True},
            kill_between_finalize_columns={
            "resumed_from": st0, "killed_wall_s": kill2_wall, "state": {"step": step2, **st2},
            "resumed_wall_s": resume2_wall, "chunks_read": calls["n"],
            "formula_1_plus_cols_left_x_slots": 1 + (cps - st2["cursor"]) * SLOTS,
            "bitwise": True})

    finally:
        for proc, _ in kills:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def chunk_slots(chunk):
        return SLOTS * -(-(-(-n // chunk)) // SLOTS)

    check(out["screened_banded"]["launches"]["screen_bound"] == chunk_slots(n // 16),
          "slots: screen_bound not launched once per chunk slot of the screened solve")
    check(out["dd"]["launches"]["adjusted_topc"] == out["dd"]["iters"] * chunk_slots(C_MAIN),
          "slots: adjusted_topc not launched iters x slots x cps times in DD")
    check(out["presolve"]["launches"]["adjusted_topc"] == 1,
          "slots: the presolve's resident solve did not launch adjusted_topc once")
    shutil.rmtree(work, ignore_errors=True)
    return paths


def counted(src):
    """A ChunkSource whose reads are counted."""
    calls = {"n": 0}
    inner = src.fn

    def fn(i):
        calls["n"] += 1
        return inner(i)

    return src._replace(fn=fn), calls


def removable_vs_plain(torch, chunk_fn, lam, q, dev, indices):
    """``bucket_hist`` at the legacy finalize's shape (pass 2): real chunks'
    (p~, consumption) at the solved lam, binned by ``removable_hist`` on
    the card (the kernel at E = 512 and ``removable_tile``'s tile, v1 = p~
    over the K columns) onto a non-zero seed, against
    ``ref.bucket_hist_plain`` on the same inputs, as given and rounded to
    dyadic values; bitwise. Returns the kernel's entry at this shape."""
    from repro_torch.core.chunked import _chunk_primal
    from repro_torch.core.postprocess import profit_edges, removable_hist, removable_tile
    from repro_torch.kernels import cost, ref

    lam_d = lam.to(dev)
    gen = torch.Generator(device=dev)
    cases = 0
    for i in indices:
        p_c, b_c = chunk_fn(i)
        x, cons, pt = _chunk_primal(p_c, b_c, lam_d, q)
        sel = x.any(dim=1)
        edges = profit_edges(float(pt[sel].min()), float(pt[sel].max())).to(dev)
        k, e = cons.shape[1], edges.shape[0]
        tile = removable_tile(k, e)
        for dyadic in (False, True):
            v1 = torch.round(pt * 64) / 64 if dyadic else pt
            v2 = torch.round(cons * 64) / 64 if dyadic else cons
            gen.manual_seed(31 + 2 * int(i) + dyadic)
            init = torch.round(torch.rand((k, e + 1), generator=gen, device=dev)
                               * 256) / 64
            kh = removable_hist(v1, v2, edges, init=init)
            w1 = v1[:, None].expand(-1, k).contiguous()
            e2 = edges[None, :].expand(k, e).contiguous()
            ph = ref.bucket_hist_plain(w1, v2.contiguous(), e2, tile_n=tile,
                                       hist_init=init)
            torch.cuda.synchronize()
            check(torch.equal(kh, ph), f"bucket_hist at the legacy shape not bitwise "
                                       f"(chunk {i}, dyadic={dyadic})")
            cases += 1
    call = lambda: removable_hist(v1, v2, edges, init=init)  # noqa: E731
    rows = v2.shape[0]
    entry = {"rows": rows, "k": k, "edges": e, "tile": tile, "cases": cases,
             "chunks": list(indices), "max_abs_err": 0.0,
             "ms": time_ms(torch, call, reps=20),
             "plain_ms": time_ms(torch, lambda: ref.bucket_hist_plain(
                 w1, v2.contiguous(), e2, tile_n=tile, hist_init=init), reps=2, warmup=1),
             **dict(zip(("bound_ms", "bound_by"),
                        bound(cost.bucket_hist(rows, k, e, tile, v1_width=1)))),
             "library_ms": None}
    emit("removable_hist_vs_plain", **entry)
    return entry


def _dry_vs_streamed(n, wl, iters, launches, rise, raw_peak):
    """Phase 14's checks against the dry-run (``account_paper_kp``, the
    device-streamed driver at this N, chunk and iteration count): the
    launches exactly, and the streamed state within DRY_PEAK_REL or
    DRY_STREAM_FLOOR of what the solve's peak rose by on the card."""
    import dataclasses
    from repro_torch.launch.dryrun import account_paper_kp

    t0 = time.perf_counter()
    rec = account_paper_kp(dataclasses.replace(wl, n_users=n), 1, streaming=True,
                           chunk_size=C_MAIN, iters=iters)
    DRY_S[0] += time.perf_counter() - t0
    state = rec["memory"]["state"]
    want = {k: v["launches"] for k, v in rec["kernels"].items()}
    facts = {"launches_equal": want == {k: v for k, v in launches.items() if v},
             "state_within": abs(state - rise) <= max(DRY_PEAK_REL * rise, DRY_STREAM_FLOOR)}
    emit("dryrun_vs_card", cell=f"streamed_table1_{n}", chunk=C_MAIN, iters=iters,
         accounting={"launches": want, "state": state, "account_s": rec["account_s"]},
         card={"launches": launches, "rise": rise, "max_memory_allocated": raw_peak},
         bar=DRY_PEAK_REL, floor_bytes=DRY_STREAM_FLOOR, **facts)
    check(all(facts.values()), f"dry-run against the streamed solve at N = {n}: {facts}")


def phase_streamed(torch, np, dev):
    """The device-streamed driver (phase 14): table1 generated on the card
    at N = 10^7 and uncut 10^8, phase 5's bytes against the host-fed
    driver (fused and legacy), screened banded, DD and the sampled
    history."""
    from repro_torch.configs.paper_kp import WORKLOADS, KPWorkload
    from repro_torch.core.chunked import array_source, solve_streaming
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.prefetch import host_array_source, solve_streaming_host
    from repro_torch.core.types import SolverConfig, SparseKP
    from repro_torch.kernels import ops
    from repro_torch.launch.solve import run_streaming

    wl = WORKLOADS["table1"]
    cfg = SolverConfig(max_iters=40)
    paths, peaks = {}, {}

    # 1. Generated on the card: peak memory at 10^7 and 10^8.
    for n in (N_RES, N_STREAM):
        chunks = -(-n // C_MAIN)
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated(dev) / 1e9
        ops.reset_launches()
        row = run_streaming(KPWorkload(wl.name, n, wl.k, wl.q, wl.tightness), cfg,
                            C_MAIN, device=dev, host_feed=False)
        launches = dict(ops.LAUNCHES)
        iters = row["iterations"]
        peaks[n] = row["peak_device_gb"] - base_gb
        HOST_RESULTS[f"streamed_{n}"] = dict(row, peak_over_before_gb=peaks[n])
        emit("streamed_end_to_end", workload="table1", source="generated on the card",
             n=n, chunk=C_MAIN, chunks=chunks, iters=iters, primal=row["primal"],
             dual=row["dual"], gap=row["duality_gap"],
             max_violation=row["max_violation"], wall_s=row["wall_s"],
             peak_device_gb=row["peak_device_gb"], allocated_before_gb=base_gb,
             peak_over_before_gb=peaks[n], launches=launches)
        check(launches["scd_fused_hist"] == iters * chunks,
              f"streamed: scd_fused_hist launched {launches['scd_fused_hist']} times, "
              f"expected iters x chunks = {iters * chunks}")
        check(launches["scd_finalize_hist"] == chunks, "streamed: finalize launches != chunks")
        check(sum(launches.values()) == (iters + 1) * chunks,
              f"streamed: other kernels launched: {launches}")
        check(row["max_violation"] <= 1e-4, f"streamed max_violation {row['max_violation']}")
        check(row["dual"] >= row["primal"], "streamed dual below primal")
        check(all(v == v and abs(v) != float("inf")
                  for v in (row["primal"], row["dual"], row["max_violation"])),
              "streamed: non-finite metrics")
        paths[f"streamed_table1_{n:.0e}".replace("+", "")] = launches
        _dry_vs_streamed(n, wl, iters, launches, peaks[n] * 1e9, row["peak_device_gb"] * 1e9)
    check(peaks[N_STREAM] <= 1.05 * peaks[N_RES] + 0.01,
          f"streamed peak memory grew with N: {peaks}")

    # 2. Phase 5's bytes through array_source: bitwise the host-fed solve,
    # fused and legacy; the source read iters + 1 and iters + 3 times.
    chunks = -(-N_RES // C_MAIN)
    kp, q = sparse_instance(0, N_RES, wl.k, wl.q, tightness=wl.tightness, device=dev,
                            chunk=C_MAIN)
    ph, bh = kp.p.cpu().numpy(), kp.b.cpu().numpy()
    host_src = host_array_source(ph, bh, kp.budgets.cpu().numpy(), C_MAIN)
    out = {}
    for finalize, extra in (("fused", 1), ("legacy", 3)):
        fcfg = cfg.replace(stream_finalize=finalize)
        t0 = time.perf_counter()
        host = solve_streaming_host(host_src, fcfg, q=q, device=dev)
        host_s = time.perf_counter() - t0
        src, calls = counted(array_source(kp, C_MAIN, device=dev))
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_streaming(src, fcfg, q=q, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        out[finalize] = {"iters": res.iters, "wall_s": wall, "host_fed_wall_s": host_s,
                         "reads": calls["n"], "launches": launches,
                         "bitwise_host_fed": same_stream(res, host),
                         "tau": repr(float(res.tau)), "primal": float(res.primal)}
        check(out[finalize]["bitwise_host_fed"],
              f"streamed {finalize} solve differs from the host-fed one on the same bytes")
        check(calls["n"] == (res.iters + extra) * chunks,
              f"streamed {finalize}: {calls['n']} reads, expected (iters + {extra}) x "
              f"chunks = {(res.iters + extra) * chunks}")
        paths[f"streamed_{finalize}"] = launches
        if finalize == "fused":
            check(res.iters == HOST_RESULTS["table1"]["iterations"]
                  and res.lam.tolist() == HOST_RESULTS["table1"]["lam"]
                  and float(res.primal) == HOST_RESULTS["table1"]["primal"]
                  and float(res.dual) == HOST_RESULTS["table1"]["dual"],
                  "streamed solve differs from phase 5's host-fed row")
        else:
            check(launches["bucket_hist"] == chunks
                  and launches["adjusted_topc"] == 2 * chunks
                  and launches["scd_finalize_hist"] == chunks,
                  f"streamed legacy launches: {launches}")
            legacy_shape = removable_vs_plain(torch, src.fn, res.lam, q, dev,
                                              (0, chunks // 2, chunks - 1))
    emit("streamed_vs_host_fed", n=N_RES, chunk=C_MAIN, chunks=chunks, finalize=out)

    # 3. DD, and the sampled history against the host-fed one.
    ops.reset_launches()
    t0 = time.perf_counter()
    dd = solve_streaming(array_source(kp, C_MAIN, device=dev),
                         cfg.replace(algo="dd"), q=q, device=dev)
    dd_wall = time.perf_counter() - t0
    paths["streamed_dd"] = dict(ops.LAUNCHES)
    m = solve_metrics(torch, dd, kp.budgets.cpu())
    check(paths["streamed_dd"]["adjusted_topc"] == dd.iters * chunks,
          "streamed DD: adjusted_topc launches != iters x chunks")
    check(m["max_violation"] <= 1e-4 and m["dual"] >= m["primal"], f"streamed DD: {m}")
    emit("streamed_dd", n=N_RES, wall_s=dd_wall, launches=paths["streamed_dd"], **m)
    del kp
    hkp = SparseKP(*(torch.from_numpy(a[:N_HISTORY]) for a in (ph, bh)),
                   torch.full((wl.k,), wl.tightness * N_HISTORY * wl.q * 0.5 / wl.k))
    hcfg = cfg.replace(record_history=True, metrics_every=4)
    t0 = time.perf_counter()
    dev_h = solve_streaming(array_source(hkp, C_MAIN, device=dev), hcfg, q=q, device=dev)
    t1 = time.perf_counter()
    host_h = solve_streaming_host(host_array_source(hkp.p.numpy(), hkp.b.numpy(),
                                                    hkp.budgets.numpy(), C_MAIN),
                                  hcfg, q=q, device=dev)
    hist_same = all(np.array_equal(dev_h.history[k].numpy(), host_h.history[k].numpy(),
                                   equal_nan=True) for k in dev_h.history)
    emit("streamed_history", n=N_HISTORY, metrics_every=4, iters=dev_h.iters,
         rows=int(dev_h.history["lam"].shape[0]), wall_s=t1 - t0,
         host_fed_wall_s=time.perf_counter() - t1,
         bitwise=hist_same and same_stream(dev_h, host_h),
         primal_rows=[float(v) for v in dev_h.history["primal"][:8]])
    check(hist_same and same_stream(dev_h, host_h),
          "sampled history: streamed differs from host-fed")
    del ph, bh

    # 4. Screened banded (phase 11's settings) == unscreened, streamed, and
    # == phase 11's host-fed screened solve.
    from repro_torch.data.synth import banded_host_chunk_source
    bsrc = banded_host_chunk_source(7, N_RES, BANDED["k"], C_MAIN, q=BANDED["q"],
                                    tightness=BANDED["tightness"], band=BANDED["band"])
    bp = np.concatenate([bsrc.fn(i)[0] for i in range(chunks)])[:N_RES]
    bb = np.concatenate([bsrc.fn(i)[1] for i in range(chunks)])[:N_RES]
    bkp = SparseKP(torch.from_numpy(bp), torch.from_numpy(bb), torch.from_numpy(bsrc.budgets))
    del bp, bb
    dsrc = array_source(bkp, C_MAIN, device=dev)
    scfg = SolverConfig(max_iters=30, bucket_half=12)
    runs = {}
    for screening in (False, True):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[screening] = solve_streaming(dsrc, scfg.replace(screening=screening),
                                          q=BANDED["q"], device=dev)
        torch.cuda.synchronize()
        runs[screening, "wall"] = time.perf_counter() - t0
        runs[screening, "launches"] = dict(ops.LAUNCHES)
    scr = runs[True]
    active = scr.screen["active_chunks"].numpy()
    profile = active[active >= 0].tolist()
    host = HOST_RESULTS["banded_screened"]
    facts = {"bitwise_unscreened": same_stream(scr, runs[False]),
             "bitwise_host_fed": same_stream(scr, host)}
    emit("streamed_screened", workload="banded", n=N_RES, chunk=C_MAIN, chunks=chunks,
         iters=scr.iters, active_chunks_per_iter=profile, fallbacks=scr.screen["fallbacks"],
         resets=scr.screen["resets"], host_fed_profile=host.screen["streamed_chunks"].tolist(),
         wall_s={"unscreened": runs[False, "wall"], "screened": runs[True, "wall"]},
         launches={"unscreened": runs[False, "launches"], "screened": runs[True, "launches"]},
         **facts)
    check(all(facts.values()), f"streamed screened: {facts}")
    got = runs[True, "launches"]
    check(got["screen_bound"] == chunks, "streamed screened: screen_bound launches != chunks")
    check(got["scd_fused_hist"] == sum(profile) + chunks * scr.screen["fallbacks"],
          "streamed screened: fused launches != the active-chunk profile")
    check(min(profile) < chunks, "streamed screened: nothing retired")
    paths["streamed_screened_banded"] = got
    return paths, legacy_shape


def same_stream(a, b):
    """Every result field bitwise (the finalize histograms where both have
    them)."""
    import torch
    ok = a.iters == b.iters and all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
                                    for f in ("lam", "r", "primal", "dual", "tau"))
    if a.fin_hist is not None and b.fin_hist is not None:
        ok = ok and all(torch.equal(x, y) for x, y in zip(a.fin_hist, b.fin_hist))
    return ok


_SERVE_KILL = """
import json, os, signal, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.core.types import SolverConfig
from repro_torch.kernels import _build
from repro_torch.serve import RefreshEngine, WorkloadSpec, synthetic_source

root, kill_after, scale = sys.argv[2], int(sys.argv[3]), float(sys.argv[4])
spec = WorkloadSpec.from_json(json.loads(sys.argv[5]))
_build.load()                       # the parent's library, from the build/ cache
calls = {"n": 0}

def make(s):
    src = synthetic_source(s)
    inner = src.fn

    def fn(i):
        calls["n"] += 1
        if calls["n"] > kill_after:
            os.kill(os.getpid(), signal.SIGKILL)
        return inner(i)

    return src._replace(fn=fn)

RefreshEngine(root, spec, make_source=make,
              cfg=SolverConfig(max_iters=60, checkpoint_every=int(sys.argv[6])),
              slots=int(sys.argv[7])).refresh(budget_scale=scale)
"""


def same_generation(np, a, b):
    fields = ("lam", "tau", "iters", "r", "primal", "dual", "fingerprint")
    return (all(np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
                for f in fields)
            and all(x.tobytes() == y.tobytes() for x, y in zip(a.fin_hist, b.fin_hist)))


def phase_serving(torch, np, dev):
    """The serving layer (phase 15): ``run_scenario`` at the reference's
    serving shape, a SIGKILLed refresh recovered, ``run_chaos``, and the
    card's generation records against the CPU's."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.refresh import _budget_schedule, run_chaos, run_scenario
    from repro_torch.serve import RefreshEngine, WorkloadSpec

    import threading

    work = ROOT / "build" / "smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spec = WorkloadSpec(seed=0, n=N_SERVE, chunk=C_MAIN, **SERVE)
    cfg = SolverConfig(max_iters=60, checkpoint_every=SERVE_CKPT_EVERY)
    small = spec.replace(n=N_VS_CPU, chunk=N_VS_CPU // 16)

    def records(name, where):
        t0 = time.perf_counter()
        eng = RefreshEngine(work / f"records_{name}", small, cfg=cfg, device=where,
                            slots=SERVE_SLOTS)
        return ([eng.refresh(budget_scale=s) for s in _budget_schedule(SERVE_GENS, small.seed)],
                time.perf_counter() - t0)

    # Step 3's CPU records run in a thread from here, beside steps 1-3.
    on_cpu = {}

    def records_on_cpu():
        try:
            on_cpu["cpu"] = records("cpu", "cpu")
        except BaseException as e:          # re-raised at step 3
            on_cpu["error"] = e

    cpu_thread = threading.Thread(target=records_on_cpu, daemon=True)
    cpu_thread.start()

    # 1. The scenario: warm against cold, lookups round-trip bitwise.
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run_scenario(spec, SERVE_GENS, work / "scenario", cfg, device=dev,
                       slots=SERVE_SLOTS, lookups=512)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    emit("serving", n=N_SERVE, chunk=C_MAIN, slots=SERVE_SLOTS, generations=SERVE_GENS,
         wall_s=wall, per_generation=out["per_generation"],
         warm_iters_total=out["warm_iters_total"], cold_iters_total=out["cold_iters_total"],
         lookups=out["lookup"], lookups_bitwise=out["lookups_bitwise"], launches=launches)
    check(out["warm_iters_total"] < out["cold_iters_total"],
          f"serving: warm {out['warm_iters_total']} did not beat cold "
          f"{out['cold_iters_total']}")
    check(out["lookups_bitwise"], "serving: lookups differ from decisions_chunk")
    check(launches["scd_fused_hist"] > 0 and launches["scd_finalize_hist"] > 0,
          f"serving launched no solve kernel: {launches}")

    # 2. A warm refresh SIGKILLed in a fresh interpreter mid-iterate (beside
    # step 3), then recovered here: the record is bitwise the scenario's
    # generation 1.
    root = work / "killed"
    root.mkdir()
    shutil.copytree(work / "scenario" / "gen_000000", root / "gen_000000")
    ckpt.write_json(root, "LIVE.json", {"gen": 0})
    chunks = -(-N_SERVE // C_MAIN)
    scale = _budget_schedule(SERVE_GENS, spec.seed)[1]
    kill_after = 1 + 2 * chunks + chunks // 2
    t_kill = time.perf_counter()
    killed = subprocess.Popen(
        [sys.executable, "-c", _SERVE_KILL, str(ROOT / "src"), str(root), str(kill_after),
         repr(scale), json.dumps(spec.to_json()), str(SERVE_CKPT_EVERY), str(SERVE_SLOTS)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        # 3. Chaos == clean, and the card's records == the CPU's, at n = 2^17.
        t0 = time.perf_counter()
        ok, chaos = run_chaos(small, SERVE_GENS, work / "chaos", cfg, device=dev,
                              slots=SERVE_SLOTS, lookups=256)
        chaos_s = time.perf_counter() - t0
        check(ok, "run_chaos: the chaos records differ from the clean ones")
        card = records("card", dev)
        cpu_thread.join()
        if "error" in on_cpu:
            raise on_cpu["error"]
        recs = {"card": card[0], "cpu": on_cpu["cpu"][0]}
        walls = {"card": card[1], "cpu": on_cpu["cpu"][1]}
        card_cpu = all(same_generation(np, a, b) for a, b in zip(recs["card"], recs["cpu"]))
        emit("serving_chaos_and_cpu", n=N_VS_CPU, chunk=small.chunk, chaos_bitwise=ok,
             chaos_wall_s=chaos_s,
             chaos_stale_serves=chaos["chaos"]["lookup"]["cache"]["stale_serves"],
             chaos_retries=chaos["chaos"]["lookup"]["cache"]["retries"],
             records_card_equal_cpu=card_cpu, walls_s=walls)
        check(card_cpu, "the card's generation records differ from the CPU's")

        # 2, recovered.
        _, err = killed.communicate(timeout=600)
        killed_s = time.perf_counter() - t_kill
        check(killed.returncode == -signal.SIGKILL,
              f"the killed refresh ended with {killed.returncode}: {err[-3000:]}")
        eng = RefreshEngine(root, spec, cfg=cfg, device=dev, slots=SERVE_SLOTS)
        left = ckpt.latest_step(root / "gen_000001" / "ckpt")
        check(eng.live_gen_id() == 0 and left is not None,
              f"after the kill: live {eng.live_gen_id()}, resume state {left}")
        t0 = time.perf_counter()
        rec = eng.recover()
        recover_s = time.perf_counter() - t0
        want = RefreshEngine(work / "scenario", spec, cfg=cfg, device=dev).generation(1)
        bitwise = rec is not None and rec.gen == 1 and same_generation(np, rec, want)
        emit("serving_kill", killed_after_reads=kill_after, killed_wall_s=killed_s,
             resume_step=left, recover_s=recover_s, iters=rec.iters, bitwise=bitwise)
        check(bitwise, "the recovered refresh's record differs from the uninterrupted one")
    finally:
        if killed.poll() is None:
            killed.kill()
            killed.wait()
    shutil.rmtree(work, ignore_errors=True)
    return {"serving": launches}


def phase_operations(torch, np, dev):
    """Operations (phase 16) at the serving phase's shape: the supervised
    chaos soak (workers on the card) and the HTTP front over replica
    processes on the card."""
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.front import run_front_scenario
    from repro_torch.launch.supervisor import SoakShape, run_chaos_soak
    from repro_torch.serve import WorkloadSpec

    work = ROOT / "build" / "smoke_ops"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = {}

    # 1. The soak. The references run here (their launches are this path's
    # count); the supervised solve and refresh run in worker processes.
    shape = SoakShape(n=N_SOAK, chunk=C_MAIN, generations=SOAK_GENS, max_iters=60,
                      lo=SOAK_LO, hi=SOAK_HI, slots=SERVE_SLOTS, bucket_half=24)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    ops.reset_launches()
    t0 = time.perf_counter()
    ok, rep = run_chaos_soak(work / "soak", seed=0, device="cuda", shape=shape, world=1)
    soak_s = time.perf_counter() - t0
    paths["operations_soak"] = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info(dev)[0]
    emit("operations_soak", n=N_SOAK, chunk=C_MAIN, slots=SERVE_SLOTS,
         generations=SOAK_GENS, thresholds=[SOAK_LO, SOAK_HI], wall_s=soak_s,
         walls_s=rep["walls_s"], iters=rep["iters"], solve=rep.get("solve"),
         refresh=rep.get("refresh"),
         poison=rep.get("poison"), exercised=rep["exercised"], degrade=rep["degrade"],
         solve_recovery_s=rep.get("solve_recovery_s"),
         refresh_recovery_s=rep.get("refresh_recovery_s"),
         free_gb_before=free0 / 1e9, free_gb_after=free1 / 1e9,
         launches_in_process=paths["operations_soak"], diffs=rep["diffs"])
    check(ok, f"chaos soak failed: {rep['diffs']}")
    check(free1 >= free0 - (256 << 20),
          f"the card's free memory did not come back after the soak: "
          f"{free0 / 1e9:.3f} GB before, {free1 / 1e9:.3f} GB after")
    check(paths["operations_soak"]["scd_fused_hist"] > 0
          and paths["operations_soak"]["scd_finalize_hist"] > 0,
          f"the soak's references launched no solve kernel: {paths['operations_soak']}")

    # 2. The front: replicas on the card, refresh churn under HTTP traffic.
    spec = WorkloadSpec(seed=0, n=N_SERVE, chunk=C_MAIN, **SERVE)
    chunks = -(-N_SERVE // C_MAIN)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run_front_scenario(spec, SERVE_GENS, work / "front",
                             SolverConfig(max_iters=60, checkpoint_every=0),
                             replicas=FRONT_REPLICAS, slots=SERVE_SLOTS, device="cuda",
                             cache_chunks=2 * chunks, diff_stride=FRONT_DIFF_STRIDE)
    front_s = time.perf_counter() - t0
    paths["operations_front"] = dict(ops.LAUNCHES)
    emit("operations_front", n=N_SERVE, chunk=C_MAIN, replicas=FRONT_REPLICAS,
         generations=SERVE_GENS, wall_s=front_s, sustained=out["sustained"],
         generations_served=out["generations_served"], rebinds=out["rebinds"],
         parity=out["parity"], stale_rows=out["stale_rows"], diff=out["diff"],
         front_stats=out["front_stats"], metrics_consistent=out["metrics"]["consistent"],
         launches_in_process=paths["operations_front"])
    check(out["parity"], "front: an answered row differs from its generation's "
          "materialisation (or was served stale)")
    check(out["diff"]["parity"], f"front: /diff differs from the brute force or its "
          f"fill passes: {out['diff']['passes']}")
    check(all(r >= 1 for r in out["rebinds"]), f"front: a replica never rebound: "
          f"{out['rebinds']}")
    check(out["metrics"]["consistent"], f"front: /metrics disagrees with /health: "
          f"{out['metrics']['failures']}")
    check(paths["operations_front"]["scd_fused_hist"] > 0,
          f"the front's refreshes launched no solve kernel: {paths['operations_front']}")
    shutil.rmtree(work, ignore_errors=True)
    return paths


# --------------------------------------------------------------------------
# Phase 17: a world of ranks on the one card (launch/mesh.py).
# --------------------------------------------------------------------------

WORLD = 4
N_WORLD_SMALL = 1_000_000           # the exact reduce, the straggler mask, kill, fault
# The world's generated solve, a shard a rank, against phase 14's one-shard
# run at the same N: 10^7 (cut from 10^8 for phase 25; phase 14 keeps 10^8).
N_WORLD_GEN = N_RES
WORLD_TIMEOUT = 300
WORLD_CKPT_EVERY = 2
# A rank of the killed world reads the fingerprint probe, then S / D * cps =
# 4 chunks an epoch (16 chunks, 4 slots): it dies in iteration 6, after the
# save at iteration 4.
WORLD_KILL_AFTER = 1 + 4 * 5
WORLD_FAULT_CHUNK = 12              # slot 1 of 2 (8 columns): rank 1's
N_WALLS = 16 * C_MAIN               # worlds 1, 2 and 4 on one host-fed solve


def _rank_array_source(torch, mesh, src, cps):
    """Rank r's chunks [r*cps, (r+1)*cps) of a host source, on its device, as
    a ``ChunkSource`` (the rows of phase 5 without the whole instance on any
    rank); other indices are inert zeros."""
    from repro_torch.core.chunked import ChunkSource
    lo = mesh.rank * cps
    c = -(-src.n // src.chunk)
    mine = [i for i in range(lo, lo + cps) if i < c]
    p = torch.stack([torch.from_numpy(src.fn(i)[0]) for i in mine]).to(mesh.device)
    b = torch.stack([torch.from_numpy(src.fn(i)[1]) for i in mine]).to(mesh.device)
    zero = torch.zeros((src.chunk, src.k), dtype=torch.float32, device=mesh.device)

    def fn(i):
        i = int(i)
        return (p[i - lo], b[i - lo]) if lo <= i < lo + len(mine) else (zero, zero)

    return ChunkSource(n=src.n, k=src.k, chunk=src.chunk,
                       budgets=torch.as_tensor(src.budgets), fn=fn)


def _world_host_fed(mesh, n=N_SLOTS_CKPT, **cfg_kw):
    from repro_torch.core.prefetch import FeedStats, solve_streaming_host
    from repro_torch.core.types import SolverConfig
    src, q = table1_source(n)
    stats = FeedStats()
    res = solve_streaming_host(src, SolverConfig(max_iters=40, **cfg_kw), q=q,
                               slots=SLOTS, mesh=mesh, stats=stats)
    it = [e for e in stats.epochs if e["kind"] == "iterate"]
    keys = ("fetch_s", "stage_s", "comm_s", "wall_s")
    return res, {"iterate_epoch_mean": {k: statistics.mean(e[k] for e in it)
                                        for k in keys},
                 "finalize_epoch": {k: stats.epochs[-1][k] for k in keys}}


def world_main(mesh, tasks, resume_dir=None):
    """Phase 17 on every rank of a world on the card: ``tasks`` in order,
    each with its wall, its seconds in collectives and this rank's launches;
    rank 0's view comes back."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_kp import WORKLOADS, KPWorkload
    from repro_torch.core.chunked import solve_streaming
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.solver import solve_shard
    from repro_torch.core.types import SolverConfig
    from repro_torch.data.synth import banded_host_chunk_source
    from repro_torch.kernels import ops
    from repro_torch.launch.solve import run_streaming

    t_enter = time.time()
    check(mesh.device.type == "cuda", f"rank {mesh.rank} runs on {mesh.device}")
    wl = WORKLOADS["table1"]
    cfg = SolverConfig(max_iters=40)
    out, launches = {}, {name: 0 for name in ops.LAUNCHES}

    def rows(n):
        d = mesh.size
        return sparse_instance(0, n, wl.k, wl.q, tightness=wl.tightness,
                               device=mesh.device, chunk=C_MAIN,
                               rows=(mesh.rank * n // d, (mesh.rank + 1) * n // d))[0]

    def task(name):
        if name == "host_fed":
            return _world_host_fed(mesh)
        if name == "walls":
            return _world_host_fed(mesh, N_WALLS)
        if name == "streamed_same_bytes":
            src, q = table1_source(N_SLOTS_CKPT)
            cps = -(-(-(-src.n // src.chunk)) // mesh.size)
            dsrc = _rank_array_source(torch, mesh, src, cps)
            res = solve_streaming(dsrc, cfg, q=q, mesh=mesh)
            del dsrc
            return res, {}
        if name == "generated":
            torch.cuda.synchronize(mesh.device)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(mesh.device) / 1e9
            row = run_streaming(KPWorkload(wl.name, N_WORLD_GEN, wl.k, wl.q, wl.tightness),
                                cfg, C_MAIN, host_feed=False, mesh=mesh)
            over = mesh.gather(torch.tensor(
                [torch.cuda.max_memory_allocated(mesh.device) / 1e9 - base],
                dtype=torch.float64))[:, 0].tolist()
            return row, {"peak_over_before_gb_by_rank": over}
        if name == "sharded":
            kp = rows(N_RES)
            one = solve_shard(kp, mesh, cfg, q=wl.q)
            chunked = solve_shard(kp, mesh, cfg.replace(chunk_size=C_MAIN), q=wl.q)
            x_same = mesh.gather(torch.tensor([int(torch.equal(one.x, chunked.x))]))
            del kp
            exact = solve_shard(rows(N_WORLD_SMALL), mesh, cfg.replace(reduce="exact"),
                                q=wl.q)
            strip = {"x": None}
            return {"bucketed": one._replace(**strip), "chunked": chunked._replace(**strip),
                    "exact": exact._replace(**strip)}, {"x_equal_by_rank": x_same.tolist()}
        if name == "banded":
            bsrc = banded_host_chunk_source(7, N_RES, BANDED["k"], C_MAIN, q=BANDED["q"],
                                            tightness=BANDED["tightness"],
                                            band=BANDED["band"])
            scfg = SolverConfig(max_iters=30, bucket_half=12)
            return {s: solve_streaming_host(bsrc, scfg.replace(screening=s),
                                            q=BANDED["q"], slots=SLOTS, mesh=mesh)
                    for s in (False, True)}, {}
        if name == "straggler":
            return _world_host_fed(mesh, N_WORLD_SMALL, partial_fraction=0.5)
        if name == "resume":
            src, q = table1_source(N_WORLD_SMALL)
            return solve_streaming_host(
                src, SolverConfig(max_iters=40, checkpoint_every=WORLD_CKPT_EVERY), q=q,
                mesh=mesh, resume_from=resume_dir), {}
        raise ValueError(name)

    for name in tasks:
        torch.cuda.synchronize(mesh.device)
        ops.reset_launches()
        comm0, t0 = mesh.comm_s, time.perf_counter()
        res, extra = task(name)
        torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        mesh.barrier()
        out[name] = {"result": res, "wall_s": wall, "collective_s": mesh.comm_s - comm0,
                     "launches": dict(ops.LAUNCHES), **extra}
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
    out["launches"] = launches
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def world_killed(mesh, ckpt_dir):
    """The checkpointed host-fed solve at N = 10^6, 4 slots; every rank
    SIGKILLs itself at its (WORLD_KILL_AFTER + 1)-th chunk read."""
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.types import SolverConfig
    src, q = table1_source(N_WORLD_SMALL)
    inner, calls = src.fn, [0]

    def fn(i):
        calls[0] += 1
        if calls[0] > WORLD_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGKILL)
        return inner(i)

    solve_streaming_host(src._replace(fn=fn),
                         SolverConfig(max_iters=40, checkpoint_every=WORLD_CKPT_EVERY),
                         q=q, slots=SLOTS, mesh=mesh, checkpoint_dir=ckpt_dir)


def world_fault(mesh):
    """A host-fed solve at N = 10^6 over 2 slots whose chunk WORLD_FAULT_CHUNK
    never fetches, with no retries: rank 1 raises ``ChunkFetchError``."""
    from repro_torch.core.faults import FaultPlan, faulty_source
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.types import SolverConfig
    src, q = table1_source(N_WORLD_SMALL)
    src = faulty_source(src, FaultPlan(offenders=(WORLD_FAULT_CHUNK,),
                                       offender_failures=10 ** 6))
    solve_streaming_host(src, SolverConfig(max_iters=40, fetch_timeout=60.0), q=q,
                         mesh=mesh)


def world_walls(out, t_start):
    """A world's start (to rank 0 entering its tasks) and its wall to rank 0
    leaving them, on the host clock."""
    return {"start_s": out["t_enter"] - t_start, "to_exit_s": out["t_exit"] - t_start}


def within_stop(a_lam, b_lam, cfg_tol=1e-3):
    """lam within the stopping rule's tol * (1 + max lam) of b's."""
    import numpy as np
    a, b = np.asarray(a_lam, np.float64), np.asarray(b_lam, np.float64)
    return float(np.abs(a - b).max()), cfg_tol * (1.0 + float(b.max()))


def phase_world(torch, np, dev):
    """A world of 4 ranks on the one card, and the worlds that die (phase
    17). The ranks share the card; nothing here measures several cards."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.solver import solve
    from repro_torch.core.types import SolverConfig
    from repro_torch.configs.paper_kp import WORKLOADS
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.synth import banded_host_chunk_source
    from repro_torch.launch.mesh import WorldError, start_local_world

    wl = WORKLOADS["table1"]
    work = ROOT / "build" / "smoke_world"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths, walls = {}, {}
    tasks = ["host_fed", "streamed_same_bytes", "generated", "sharded", "banded",
             "straggler", "walls"]

    # The world of 4 runs, and beside it the world of 4 that is SIGKILLed
    # mid-iterate (check 7) and the world of 2 whose rank 1 cannot fetch
    # (check 8); this process computes the in-process references.
    import threading

    ck = work / "ckpt"
    t_start = time.time()
    four = start_local_world(world_main, WORLD, (tasks,), timeout=WORLD_TIMEOUT)
    t0 = time.perf_counter()
    dying = {"killed": start_local_world(world_killed, WORLD, (str(ck),),
                                         timeout=WORLD_TIMEOUT),
             "faulted": start_local_world(world_fault, 2, timeout=WORLD_TIMEOUT)}
    ends = {name: {} for name in dying}

    def wait_dying(name):
        # each dying world's end, on its own clock: its error and seconds
        try:
            dying[name].wait()
        except WorldError as e:
            ends[name]["error"] = e
        ends[name]["s"] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait_dying, args=(name,), daemon=True)
               for name in dying]
    for t in waiters:
        t.start()
    try:
        src_small, q = table1_source(N_WORLD_SMALL)
        kp_small, _ = sparse_instance(0, N_WORLD_SMALL, wl.k, wl.q, tightness=wl.tightness,
                                      device=dev, chunk=C_MAIN)
        exact_one = solve(kp_small, SolverConfig(max_iters=40, reduce="exact"), q=q,
                          device=dev)
        del kp_small
        bsrc = banded_host_chunk_source(7, N_RES, BANDED["k"], C_MAIN, q=BANDED["q"],
                                        tightness=BANDED["tightness"], band=BANDED["band"])
        banded_slots = solve_streaming_host(
            bsrc, SolverConfig(max_iters=30, bucket_half=12, screening=True),
            q=BANDED["q"], slots=SLOTS, device=dev)
        straggler_slots = solve_streaming_host(
            src_small, SolverConfig(max_iters=40, partial_fraction=0.5), q=q,
            slots=SLOTS, device=dev)
        plain_small = solve_streaming_host(src_small, SolverConfig(max_iters=40), q=q,
                                           slots=SLOTS, device=dev)
        for t in waiters:
            t.join()
    finally:
        for world in dying.values():
            world.kill()
        w4 = four.wait()
    for name, end in ends.items():
        if "error" not in end:
            raise SmokeFailure(f"the {name} world finished")
    fault, fault_s = ends["faulted"]["error"], ends["faulted"]["s"]
    codes, killed_s = ends["killed"]["error"].returncodes, ends["killed"]["s"]
    walls[WORLD] = world_walls(w4, t_start)
    paths["world4_rank0"] = w4["launches"]

    def summary(name, r):
        return {k: v for k, v in r.items() if k != "result"}

    emit("world_runs", world=WORLD, world_wall_s=walls[WORLD]["to_exit_s"],
         start_s=walls[WORLD]["start_s"],
         tasks={name: summary(name, w4[name]) for name in tasks})

    # 1. Host-fed N = 2^21, 4 slots over 4 ranks: bitwise phase 13's row.
    hf = w4["host_fed"]["result"]
    cps = -(-(-(-N_SLOTS_CKPT // C_MAIN)) // SLOTS)
    l0 = w4["host_fed"]["launches"]
    facts = {"bitwise_phase13_slots4": same_stream(hf, HOST_RESULTS["slots4"]),
             "fused_launches_rank0": l0["scd_fused_hist"] == hf.iters * cps,
             "finalize_launches_rank0": l0["scd_finalize_hist"] == cps}
    # 2. The same bytes through the device-streamed solve, one shard a rank.
    ds = w4["streamed_same_bytes"]["result"]
    facts["streamed_bitwise_host_fed"] = same_stream(ds, hf)
    emit("world_host_fed", n=N_SLOTS_CKPT, slots=SLOTS, world=WORLD, iters=hf.iters,
         primal=float(hf.primal), dual=float(hf.dual), **facts)
    check(all(facts.values()), f"world host-fed: {facts}")

    # 3. Generated on the card at N_WORLD_GEN, a shard a rank: flat memory, lam
    # within the stopping rule of phase 14's one-shard run.
    g = w4["generated"]
    row, one = g["result"], HOST_RESULTS[f"streamed_{N_WORLD_GEN}"]
    diff, tol = within_stop(row["lam"], one["lam"])
    peak_cap = 1.05 * one["peak_over_before_gb"] + 0.01
    emit("world_generated", n=N_WORLD_GEN, world=WORLD, iters=row["iterations"],
         one_shard_iters=one["iterations"], lam_max_abs_diff=diff, stopping_tolerance=tol,
         primal=row["primal"], dual=row["dual"], max_violation=row["max_violation"],
         wall_s=g["wall_s"], one_shard_wall_s=one["wall_s"], collective_s=g["collective_s"],
         peak_over_before_gb_by_rank=g["peak_over_before_gb_by_rank"],
         one_shard_peak_over_before_gb=one["peak_over_before_gb"])
    check(diff <= tol and abs(row["iterations"] - one["iterations"]) <= 1,
          "world generated: lam or iterations off phase 14's one-shard run")
    check(max(g["peak_over_before_gb_by_rank"]) <= peak_cap,
          f"world generated: a rank's peak memory is not flat: {g}")
    check(row["max_violation"] <= 1e-4 and row["dual"] >= row["primal"],
          "world generated: infeasible or dual below primal")

    # 4. solve_sharded: bucketed at 10^7 against phase 7, chunked bitwise
    # unchunked; exact at 10^6 against the single-device exact solve.
    sh = w4["sharded"]["result"]
    res7 = HOST_RESULTS["resident_bucketed"]
    d_b, tol_b = within_stop(sh["bucketed"].lam, res7.lam)
    d_e, tol_e = within_stop(sh["exact"].lam, exact_one.lam)
    chunked_same = (all(w4["sharded"]["x_equal_by_rank"])
                    and sh["bucketed"].iters == sh["chunked"].iters
                    and all(torch.equal(getattr(sh["bucketed"], f), getattr(sh["chunked"], f))
                            for f in ("lam", "r", "primal", "dual")))
    emit("world_sharded", world=WORLD, n_bucketed=N_RES, n_exact=N_WORLD_SMALL,
         iters={"bucketed": sh["bucketed"].iters, "phase7": res7.iters,
                "exact": sh["exact"].iters, "exact_one_device": exact_one.iters},
         lam_max_abs_diff={"bucketed": d_b, "exact": d_e},
         stopping_tolerance={"bucketed": tol_b, "exact": tol_e},
         primal={"bucketed": float(sh["bucketed"].primal), "phase7": float(res7.primal)},
         chunked_bitwise=chunked_same, wall_s=w4["sharded"]["wall_s"],
         collective_s=w4["sharded"]["collective_s"])
    check(d_b <= tol_b and abs(sh["bucketed"].iters - res7.iters) <= 1,
          "solve_sharded 10^7 not within the stopping rule of phase 7")
    check(d_e <= tol_e and abs(sh["exact"].iters - exact_one.iters) <= 1,
          "solve_sharded exact 10^6 not within the stopping rule of one device")
    check(chunked_same, "chunked solve_sharded differs from unchunked")
    for name, n in (("bucketed", N_RES), ("exact", N_WORLD_SMALL)):
        budgets = torch.as_tensor(table1_source(n)[0].budgets)
        v = float(torch.max((sh[name].r - budgets) / budgets))
        check(v <= 1e-4 and float(sh[name].dual) >= float(sh[name].primal),
              f"solve_sharded {name}: max_violation {v} or dual below primal")

    # 5. Screened banded: world screened == world unscreened == this
    # process's 4 slots; phase 11's single slot within the stopping rule.
    bd = w4["banded"]["result"]
    d_11, tol_11 = within_stop(bd[True].lam, HOST_RESULTS["banded_screened"].lam)
    facts = {"screened_bitwise_unscreened": same_stream(bd[True], bd[False]),
             "bitwise_in_process_slots4": same_stream(bd[True], banded_slots),
             "streamed_profile_equal": bd[True].screen["streamed_chunks"].tolist()
             == banded_slots.screen["streamed_chunks"].tolist()}
    emit("world_banded", n=N_RES, world=WORLD, slots=SLOTS, iters=bd[True].iters,
         streamed_chunks=bd[True].screen["streamed_chunks"].tolist(),
         phase11_single_slot={"iters": HOST_RESULTS["banded_screened"].iters,
                              "lam_max_abs_diff": d_11, "stopping_tolerance": tol_11},
         wall_s=w4["banded"]["wall_s"], **facts)
    check(all(facts.values()), f"world banded: {facts}")
    check(d_11 <= tol_11 and abs(bd[True].iters - HOST_RESULTS["banded_screened"].iters) <= 1,
          "world banded not within the stopping rule of phase 11's single slot")

    # 6. The straggler mask at 10^6: bitwise this process's 4 slots, feasible.
    st = w4["straggler"]["result"]
    budgets = torch.as_tensor(src_small.budgets)
    facts = {"bitwise_in_process_slots4": same_stream(st, straggler_slots),
             "feasible": bool(torch.all(st.r <= budgets)),
             "differs_from_unmasked": not torch.equal(st.lam, plain_small.lam)}
    emit("world_straggler", n=N_WORLD_SMALL, partial_fraction=0.5, iters=st.iters,
         primal=float(st.primal), plain_primal=float(plain_small.primal), **facts)
    check(all(facts.values()), f"world straggler: {facts}")

    # 7. Every rank SIGKILLed mid-iterate (beside the world of 4); resumed on
    # a world of 2 (which then times the walls' host-fed solve) and in
    # process: bitwise.
    step = ckpt.latest_step(ck)
    check(step is not None, "the killed world left no state")
    st0 = ckpt.restore_auto(ck, step)
    state = {k: int(st0[k]) for k in ("phase", "iters", "slots")}
    for d in ("two", "here"):
        shutil.copytree(ck, work / d)
    t_start = time.time()
    two = start_local_world(world_main, 2, (["resume", "walls"],),
                            {"resume_dir": str(work / "two")}, timeout=WORLD_TIMEOUT)
    try:
        here = solve_streaming_host(src_small, SolverConfig(
            max_iters=40, checkpoint_every=WORLD_CKPT_EVERY), q=q, device=dev,
            resume_from=str(work / "here"))
    finally:
        w2 = two.wait()
    walls[2] = world_walls(w2, t_start)
    paths["world2_rank0"] = w2["launches"]
    facts = {"killed_by_sigkill": codes == [-signal.SIGKILL] * WORLD,
             "state_mid_iterate": state == {"phase": 0, "iters": 4, "slots": SLOTS},
             "world2_bitwise": same_stream(w2["resume"]["result"], plain_small),
             "in_process_bitwise": same_stream(here, plain_small)}
    emit("world_resume", n=N_WORLD_SMALL, killed_world=WORLD, returncodes=codes,
         killed_world_wall_s=killed_s, state=state, resumed_world=2,
         resumed_wall_s=w2["resume"]["wall_s"], **facts)
    check(all(facts.values()), f"world resume: {facts}")

    # 8. A rank whose fetch fails fails the world, naming the chunk.
    facts = {"rank1_failed": fault.rank == 1,
             "chunk_named": "ChunkFetchError" in fault.detail
             and f"chunk {WORLD_FAULT_CHUNK}" in fault.detail,
             "well_within_timeout": fault_s < WORLD_TIMEOUT / 4}
    emit("world_fault", world=2, wall_s=fault_s, timeout_s=WORLD_TIMEOUT,
         returncodes=fault.returncodes, error=fault.detail.strip().splitlines()[-1][:300],
         **facts)
    check(all(facts.values()), f"world fault: {facts}")

    # 9. One rank, in this process (a world of 1 has no collectives): the
    # walls' solve again. Worlds 1, 2 and 4: bitwise.
    t_start = time.time()
    w1 = world_main(Mesh(0, 1, dev), ["walls"])
    walls[1] = world_walls(w1, t_start)
    paths["world1_rank0"] = w1["launches"]
    runs = {1: w1["walls"], 2: w2["walls"], WORLD: w4["walls"]}
    check(all(same_stream(r["result"], runs[WORLD]["result"]) for r in runs.values()),
          "the host-fed solve differs between worlds of 1, 2 and 4")
    emit("world_walls", n=N_WALLS, slots=SLOTS, note="the ranks share one card and "
         "this host's cores; recorded, not claimed",
         host_fed_wall_s={d: r["wall_s"] for d, r in runs.items()},
         host_fed_collective_s={d: r["collective_s"] for d, r in runs.items()},
         iterate_epoch_mean={d: r["iterate_epoch_mean"] for d, r in runs.items()},
         phase13_in_process_slots4_wall_s=HOST_RESULTS["slots4_wall"],
         phase13_n=N_SLOTS_CKPT,
         world_walls_s=walls)
    shutil.rmtree(work, ignore_errors=True)
    return paths


# --------------------------------------------------------------------------
# Phase 18: serving and operations over a world of ranks on the one card.
# --------------------------------------------------------------------------

SERVE_WORLD = 4
# Phase 15's serving shape at half its N (16 chunks; cut from 2^22 to give
# phase 19 its time, and from 2^21 for phase 25): the world's records are
# held bitwise to this process's ``slots=8`` engine at the same N,
# refreshed beside the worlds.
N_SERVE_WORLD = 1 << 20
SERVE_WORLD_EPOCH = -(-N_SERVE_WORLD // C_MAIN) // SERVE_WORLD   # 4 chunk reads a rank
# A rank of the killed world refresh (8 slots over 4 ranks) reads the
# fingerprint probe, then dies half way through the warm refresh's third
# epoch, as phase 15's refresh does in one process.
SERVE_WORLD_KILL_AFTER = 1 + 2 * SERVE_WORLD_EPOCH + SERVE_WORLD_EPOCH // 2
# The supervised world's kill: rank 0's progress (its chunk reads) at the
# start of the cold solve's fourth epoch, after the save at iteration 2.
SUPERVISED_KILL_AT = 3 * SERVE_WORLD_EPOCH
SERVE_BANDED = dict(k=8, q=2, tightness=0.08, band=0.05)


def _serve_spec():
    from repro_torch.serve import WorkloadSpec
    return WorkloadSpec(seed=0, n=N_SERVE_WORLD, chunk=C_MAIN, **SERVE)


def _serve_cfg():
    from repro_torch.core.types import SolverConfig
    return SolverConfig(max_iters=60, checkpoint_every=SERVE_CKPT_EVERY)


def _screened_serving():
    """The screened delta refreshes of phase 18: the banded workload at the
    serving shape, then a budget change whose chunks are all inherited."""
    from repro_torch.core.types import SolverConfig
    from repro_torch.serve import WorkloadSpec
    spec = WorkloadSpec(seed=0, n=N_SERVE_WORLD, chunk=C_MAIN, **SERVE_BANDED)
    cfg = SolverConfig(max_iters=30, bucket_half=12, checkpoint_every=SERVE_CKPT_EVERY,
                       screening=True)
    return spec, cfg, ({}, {"budget_scale": 0.95})


def serve_world_main(mesh, work):
    """Phase 18 on every rank of a world of 4 on the card: the legacy and
    fused device-streamed finalizes, the screened delta refreshes, and the
    front's scenario whose 3 generations the world publishes; rank 0's
    results, walls and launches come back."""
    import torch
    from repro_torch.core.chunked import solve_streaming
    from repro_torch.kernels import ops
    from repro_torch.launch.front import run_front_scenario
    from repro_torch.serve import RefreshEngine, synthetic_source

    t_enter = time.time()
    check(mesh.device.type == "cuda", f"rank {mesh.rank} runs on {mesh.device}")
    spec, cfg = _serve_spec(), _serve_cfg()
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize(mesh.device)
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(mesh.device)
        out[name] = {"result": res, "wall_s": time.perf_counter() - t0,
                     "launches": dict(ops.LAUNCHES)}
        mesh.barrier()

    def finalizes():
        src = synthetic_source(spec)
        cps = -(-(-(-src.n // src.chunk)) // mesh.size)
        dsrc = _rank_array_source(torch, mesh, src, cps)
        scfg = cfg.replace(checkpoint_every=0)
        return {(fin, post): solve_streaming(
                    dsrc, scfg.replace(stream_finalize=fin, postprocess=post),
                    q=spec.q, mesh=mesh)
                for fin in ("fused", "legacy") for post in (True, False)}

    def screened():
        bspec, bcfg, deltas = _screened_serving()
        eng = RefreshEngine(Path(work) / "screened", bspec, cfg=bcfg, mesh=mesh,
                            slots=SERVE_SLOTS)
        return [eng.refresh(**d) for d in deltas]

    def front():
        chunks = -(-N_SERVE_WORLD // C_MAIN)
        return run_front_scenario(spec, SERVE_GENS, Path(work) / "front", cfg,
                                  replicas=FRONT_REPLICAS, keep=SERVE_GENS,
                                  slots=SERVE_SLOTS, cache_chunks=2 * chunks,
                                  diff_stride=FRONT_DIFF_STRIDE, mesh=mesh)

    timed("finalizes", finalizes)
    timed("screened", screened)
    timed("front", front)
    out["launches"] = {k: sum(out[t]["launches"][k] for t in
                              ("finalizes", "screened", "front"))
                       for k in out["finalizes"]["launches"]}
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def serve_world_killed(mesh, root):
    """Generation 0 of the serving scenario, then its warm refresh, over the
    world; every rank SIGKILLs itself at its (SERVE_WORLD_KILL_AFTER + 1)-th
    chunk read of the warm refresh."""
    from repro_torch.launch.refresh import _budget_schedule
    from repro_torch.serve import RefreshEngine, synthetic_source
    spec = _serve_spec()
    scales = _budget_schedule(SERVE_GENS, spec.seed)
    calls = [0]

    def make(s):
        src = synthetic_source(s)
        if s.budget_scale != scales[1]:
            return src
        inner = src.fn

        def fn(i):
            calls[0] += 1
            if calls[0] > SERVE_WORLD_KILL_AFTER:
                os.kill(os.getpid(), signal.SIGKILL)
            return inner(i)

        return src._replace(fn=fn)

    eng = RefreshEngine(root, spec, cfg=_serve_cfg(), mesh=mesh, slots=SERVE_SLOTS,
                        make_source=make)
    eng.refresh(budget_scale=scales[0])
    eng.refresh(budget_scale=scales[1])


def serve_world_redrive(mesh, root):
    """The killed warm refresh re-driven over this world: its record, wall
    and rank 0's launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import RefreshEngine
    torch.cuda.synchronize(mesh.device)
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = RefreshEngine(root, _serve_spec(), cfg=_serve_cfg(), mesh=mesh,
                        slots=SERVE_SLOTS)
    live_before = eng.live_gen_id()
    rec = eng.recover()
    torch.cuda.synchronize(mesh.device)
    return {"record": rec, "live_before": live_before, "wall_s": time.perf_counter() - t0,
            "launches": dict(ops.LAUNCHES)}


def _same_record(np, a, b):
    """Two published generations' records, every key bitwise."""
    from repro_torch.checkpoint import ckpt
    ra = ckpt.restore_auto(Path(a.path) / "record", 0)
    rb = ckpt.restore_auto(Path(b.path) / "record", 0)
    return sorted(ra) == sorted(rb) and all(
        np.asarray(ra[k]).tobytes() == np.asarray(rb[k]).tobytes() for k in ra)


def phase_world_serving(torch, np, dev):
    """Serving and operations over a world of 4 ranks on the one card
    (phase 18)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import WorldError, run_local_world, start_local_world
    from repro_torch.launch.supervisor import ChaosSchedule, Supervisor, SupervisorConfig
    from repro_torch.serve import RefreshEngine

    from repro_torch.launch.refresh import _budget_schedule

    work = ROOT / "build" / "smoke_world_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = {}
    t_phase = time.perf_counter()

    # The serving world and the killed world start together; this process
    # refreshes the references beside them: the serving scenario's 3
    # generations and the screened delta refreshes, in one process.
    t_start = time.time()
    world = start_local_world(serve_world_main, SERVE_WORLD, (str(work / "world"),),
                              timeout=WORLD_TIMEOUT)
    killed = start_local_world(serve_world_killed, SERVE_WORLD, (str(work / "killed"),),
                               timeout=WORLD_TIMEOUT)
    try:
        t0 = time.perf_counter()
        eng = RefreshEngine(work / "reference", _serve_spec(), cfg=_serve_cfg(), device=dev,
                            slots=SERVE_SLOTS)
        want, want_walls = [], []
        for scale in _budget_schedule(SERVE_GENS, _serve_spec().seed):
            t1 = time.perf_counter()
            want.append(eng.refresh(budget_scale=scale))
            want_walls.append(time.perf_counter() - t1)
        reference_s = time.perf_counter() - t0
        bspec, bcfg, deltas = _screened_serving()
        t0 = time.perf_counter()
        eng = RefreshEngine(work / "screened_here", bspec, cfg=bcfg, device=dev,
                            slots=SERVE_SLOTS)
        screened_here = [eng.refresh(**d) for d in deltas]
        screened_here_s = time.perf_counter() - t0
        try:
            killed.wait()
            raise SmokeFailure("the killed world refresh finished")
        except WorldError as e:
            codes = e.returncodes
        killed_s = time.time() - t_start
    finally:
        killed.kill()
        w = world.wait()
    world_s = time.time() - t_start
    paths["world_serving_rank0"] = w["launches"]

    # 1. The legacy device-streamed finalize over the world against the fused.
    fin = w["finalizes"]["result"]
    fused, legacy = fin[("fused", True)], fin[("legacy", True)]
    f0, l0 = fin[("fused", False)], fin[("legacy", False)]
    facts = {"lam_iters_dual_bitwise": fused.iters == legacy.iters
             and torch.equal(fused.lam, legacy.lam) and torch.equal(fused.dual, legacy.dual),
             "no_projection_every_field_bitwise": same_stream(f0, l0),
             "legacy_launched_bucket_hist_and_topc":
                 w["finalizes"]["launches"]["bucket_hist"] > 0
                 and w["finalizes"]["launches"]["adjusted_topc"] > 0}
    emit("world_serving_legacy", world=SERVE_WORLD, n=N_SERVE_WORLD, chunk=C_MAIN,
         iters=legacy.iters, primal_fused=float(fused.primal),
         primal_legacy=float(legacy.primal), tau_legacy=float(legacy.tau),
         wall_s=w["finalizes"]["wall_s"], launches_rank0=w["finalizes"]["launches"],
         **facts)
    check(all(facts.values()), f"world legacy finalize: {facts}")

    # 2. The screened delta refreshes: the world's records == this process's.
    scr = w["screened"]["result"]
    first = [int(np.asarray(ckpt.restore_auto(Path(g.path) / "record", 0)
                            ["screen_streamed"])[0]) for g in screened_here]
    facts = {"records_bitwise": all(_same_record(np, a, b)
                                    for a, b in zip(scr, screened_here)),
             "delta_inherited": first[1] < -(-N_SERVE_WORLD // C_MAIN),
             "screen_bound_launched": w["screened"]["launches"]["screen_bound"] > 0}
    emit("world_serving_screened", world=SERVE_WORLD, n=N_SERVE_WORLD, slots=SERVE_SLOTS,
         iters=[g.iters for g in scr], first_epoch_streamed=first,
         wall_s=w["screened"]["wall_s"], in_process_wall_s=screened_here_s,
         launches_rank0=w["screened"]["launches"], **facts)
    check(all(facts.values()), f"world screened delta refreshes: {facts}")

    # 3. The front: the world published the in-process engine's 3
    # generations (bitwise) while 2 replica processes served them.
    out = w["front"]["result"]
    pub = RefreshEngine(work / "world" / "front", _serve_spec(), cfg=_serve_cfg(),
                        device=dev)
    gens = [pub.generation(g) for g in range(SERVE_GENS)]
    facts = {"records_bitwise_in_process": all(same_generation(np, a, b)
                                               for a, b in zip(gens, want)),
             "rows_bitwise": out["parity"] and out["stale_rows"] == 0,
             "diff_parity": out["diff"]["parity"],
             "all_rebound": all(r >= 1 for r in out["rebinds"]),
             "metrics_consistent": out["metrics"]["consistent"]}
    emit("world_serving_front", world=SERVE_WORLD, n=N_SERVE_WORLD, slots=SERVE_SLOTS,
         replicas=FRONT_REPLICAS, generations=SERVE_GENS, iters=[g.iters for g in gens],
         wall_s=w["front"]["wall_s"], refresh_wall_s=out["refresh_wall_s"],
         in_process_refresh_wall_s=want_walls, in_process_wall_s=reference_s,
         sustained=out["sustained"],
         generations_served=out["generations_served"], rebinds=out["rebinds"],
         diff=out["diff"], launches_rank0=w["front"]["launches"],
         world_start_s=w["t_enter"] - t_start, world_wall_s=world_s, **facts)
    check(all(facts.values()), f"world front: {facts}")

    # 4 and 5 side by side: the killed world refresh re-driven on 2 ranks
    # (the in-process gen 1), and one supervised solve task in a thread
    # beside it: a world of 4, killed once (its lease holder), respawned on
    # 2 ranks; its record is the in-process generation 0 (the same cold
    # solve of the same workload).
    import threading

    root = work / "killed"
    left = ckpt.latest_step(root / "gen_000001" / "ckpt")
    task = {"kind": "solve", "spec": _serve_spec().to_json(),
            "cfg": {"max_iters": 60, "checkpoint_every": SERVE_CKPT_EVERY},
            "slots": SERVE_SLOTS, "device": "cuda"}
    sup = Supervisor(work / "supervised", task,
                     cfg=SupervisorConfig(ttl=2.5, poll=0.05, grace=120.0, max_restarts=3,
                                          progress_ttl=60.0),
                     devices=SERVE_WORLD,
                     chaos=ChaosSchedule(events=(("kill", SUPERVISED_KILL_AT),)))
    supervised = {}

    def run_supervised():
        t = time.perf_counter()
        try:
            supervised["s"] = sup.run()
        except BaseException as e:          # raised below, in this thread
            supervised["error"] = e
        supervised["wall_s"] = time.perf_counter() - t

    thread = threading.Thread(target=run_supervised, daemon=True)
    thread.start()
    try:
        t0 = time.time()
        r = run_local_world(serve_world_redrive, 2, (str(root),), timeout=WORLD_TIMEOUT)
        redrive_s = time.time() - t0
    finally:
        thread.join()
    if "error" in supervised:
        raise supervised["error"]
    paths["world_serving_redrive_rank0"] = r["launches"]
    rec = r["record"]
    facts = {"killed_by_sigkill": codes == [-signal.SIGKILL] * SERVE_WORLD,
             "gen0_live_and_state_left": r["live_before"] == 0 and left is not None,
             "record_bitwise_in_process": rec is not None and rec.gen == 1
             and same_generation(np, rec, want[1])}
    emit("world_serving_kill", killed_world=SERVE_WORLD, killed_after_reads=
         SERVE_WORLD_KILL_AFTER, returncodes=codes, killed_wall_s=killed_s,
         resume_step=left, redrive_world=2, redrive_wall_s=redrive_s,
         recover_s=r["wall_s"], **facts)
    check(all(facts.values()), f"world refresh kill: {facts}")

    s, sup_s = supervised["s"], supervised["wall_s"]
    got = ckpt.restore_auto(work / "supervised" / "result", 0) if s["ok"] else {}
    g0 = want[0]
    same = bool(got) and int(got["iters"]) == g0.iters and all(
        np.asarray(got[f]).tobytes() == np.asarray(getattr(g0, f)).tobytes()
        for f in ("lam", "tau", "r", "primal", "dual")) and all(
        np.asarray(got[k]).tobytes() == np.asarray(x).tobytes()
        for k, x in zip(("fin_ch", "fin_gh"), g0.fin_hist))
    facts = {"ok": s["ok"], "killed_once": s["kills_injected"] == 1 and s["restarts"] == 1,
             "degraded_to_2": s["degraded_spawns"] == 1 and s["devices"] == 2,
             "record_bitwise_in_process_gen0": same}
    emit("world_serving_supervised", start_world=SERVE_WORLD, kill_at_progress=
         SUPERVISED_KILL_AT, wall_s=sup_s, counters=s, recovery_s=sup.recovery_s, **facts)
    check(all(facts.values()), f"supervised world: {facts}")
    emit("world_serving_wall", seconds=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return paths


# --------------------------------------------------------------------------
# Phase 19: the LM serving path (models/, launch/serve.py) at
# moonshot-v1-16b-a3b's full width and depth.
# --------------------------------------------------------------------------

LM_ARCH = "moonshot-v1-16b-a3b"     # src/repro_torch/configs/moonshot_v1_16b_a3b.py, not cut
LM_PREFILL = (4, 1024)              # B x S: 4,096 tokens through the SCD router
LM_SERVE = dict(n_requests=8, max_batch=4, cache_len=256)
LM_DECODE = (2, 16)                 # decode against one teacher-forced forward
LM_DECODE_STEPS = 8                 # timed decode steps at the serving shape
# Decode against forward in bf16 at full width and depth, the top-k router
# on both: bf16 keeps 8 significant bits, the two paths round attention and
# the expert products at other places (one-token products against 16-token
# ones, a normalised softmax against the online one), and the hard top-6
# router flips an expert wherever two affinities sit within that rounding.
# Held to a relative L2 error of each position's logits of at most 0.15
# (unrelated logits give about 1.41).
LM_DECODE_REL = 0.15
LM_SMOKE = ("moonshot-v1-16b-a3b", "gemma-2b")
# Card against the port's CPU in float32 with TF32 off: the card's matrix
# products sum in another order than the CPU's BLAS.
LM_SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)


def _tree_bytes(lm, tree):
    sizes = []
    lm.tree_map(lambda a: sizes.append((a.numel(), a.numel() * a.element_size())), tree)
    return sum(n for n, _ in sizes), sum(b for _, b in sizes)


# The dry-run (launch/dryrun.py) against the card, in phases 14, 19, 20, 22
# and 23. Bars fixed before any chip run: (a) the kernels' launches equal
# ops.LAUNCHES exactly; (b) the held bytes equal the nbytes of what the card
# holds for the cell (params, moments, caches, batch) exactly; (c) the
# predicted peak within 15 % of the card's (the held bytes plus what
# max_memory_allocated rose by over the step, its peak reset right before
# it); phase 14 within 15 % or 8 MiB; (d) phase 23's collective bytes equal
# rank 0's comm_bytes exactly.
DRY_PEAK_REL = 0.15
DRY_STREAM_FLOOR = 8 << 20
DRY_S = [0.0]                       # the dry-run's host seconds in this smoke


def _dry_cell(arch, kind, b, s, world=1, cfg=None, rules=None):
    """The dry-run's account of one cell (B x S, ``kind``) over ``world``
    (under ``rules``: default the batch binding)."""
    from repro_torch.launch.dryrun import account_cell
    from repro_torch.models.model import ShapeCell

    t0 = time.perf_counter()
    rec = account_cell(arch, ShapeCell(f"{kind}_{b}x{s}", s, b, kind), world, cfg=cfg,
                       rules=rules)
    DRY_S[0] += time.perf_counter() - t0
    check(rec["status"] == "ok", f"dry-run of {arch} {kind}: {rec}")
    return rec


def _nbytes(lm, *trees):
    """Bytes of the tensors of ``trees`` (each counted by its own numel)."""
    return sum(_tree_bytes(lm, t)[1] for t in trees)


def _dry_vs_card(tag, rec, launches, held, rise, raw_peak, comm=None, bar=DRY_PEAK_REL):
    """Checks (a)-(d) of one cell: ``launches`` (ops.LAUNCHES over the step;
    None: not checked, a rank other than 0), ``held`` (nbytes the card holds
    for the cell), ``rise`` (what max_memory_allocated rose by over the
    step), ``comm`` (the rank's comm_bytes over it), the peak within
    ``bar``. Emits the accounting beside the measurement."""
    mem = rec["memory"]
    card_peak = held + rise
    want = {k: v["launches"] for k, v in rec["kernels"].items()}
    got = None if launches is None else {k: v for k, v in launches.items() if v}
    facts = {"launches_equal": got is None or want == got, "held_equal": mem["held"] == held,
             "peak_within": abs(mem["peak"] - card_peak) <= bar * card_peak}
    if comm is not None:
        facts["comm_bytes_equal"] = rec["collectives"]["bytes"] == {
            k: v for k, v in comm.items() if v}
    emit("dryrun_vs_card", cell=tag, arch=rec["arch"], kind=rec["kind"], world=rec["world"],
         batch=rec["global_batch"], seq=rec["seq_len"],
         accounting={"launches": want, "held": mem["held"], "peak": mem["peak"],
                     "flops_executed": rec["flops_executed"],
                     "model_flops": rec["model_flops"],
                     "collective_bytes": rec["collectives"]["bytes"],
                     "account_s": rec["account_s"]},
         card={"launches": got, "held": held, "peak": card_peak, "rise": rise,
               "max_memory_allocated": raw_peak, "comm_bytes": comm},
         peak_rel=(mem["peak"] - card_peak) / card_peak, bar=bar, **facts)
    check(all(facts.values()), f"dry-run against the card, {tag}: {facts}")


def _lm_router(torch, np, dev, cfg, tag="lm_router", n=None):
    """Phase 19a (and 21a at jamba's K = 16, 22a at deepseek's K = 160, 25a
    at a rank's 2,048 tokens under the production rules): the
    knapsack-priced router at the prefill's shape (``n`` tokens; default
    the prefill's 4,096) on the card, bitwise the CPU's from the same
    probabilities, and its two kernels bitwise there and at a ragged token
    count, and timed at the shape."""
    from repro_torch.core.bucketing import make_edges
    from repro_torch.core.moe_router import router_tile, scd_route_probs
    from repro_torch.kernels import cost, ops, ref

    moe, n = cfg.moe, LM_PREFILL[0] * LM_PREFILL[1] if n is None else n
    g = np.random.default_rng(19)
    logits = g.standard_normal((n, moe.n_experts)) * 2 + g.standard_normal(moe.n_experts)
    probs = torch.softmax(torch.tensor(logits, dtype=torch.float32), dim=-1)
    kw = dict(q=moe.topk, capacity_factor=moe.capacity_factor, iters=moe.scd_iters)
    want = scd_route_probs(probs, **kw)
    pc = probs.to(dev)
    got = scd_route_probs(pc, **kw)
    torch.cuda.synchronize()
    facts = {f"{f}_bitwise_cpu": torch.equal(getattr(got, f).cpu(), getattr(want, f))
             for f in ("lam", "mask", "load", "combine")}
    ones, lam, q = torch.ones_like(pc), got.lam, moe.topk
    edges = make_edges(lam, 1e-4, 1.8, 16)              # the router's ladder
    tile = router_tile(*edges.shape)
    fused = dict(tile_n=tile)
    # At the router's shape, and (ragged) with its last 37 tokens cut.
    for rows in (n, n - 37):
        pr, onr = pc[:rows], ones[:rows]
        kh, kt = ops.scd_fused_hist(pr, onr, lam, edges, q, **fused)
        ph, pt = ref.scd_fused_hist_plain(pr, onr, lam, edges, q, **fused)
        kx, kv = ops.adjusted_topc(pr, onr, lam, q)
        px, pv = ref.adjusted_topc_plain(pr, onr, lam, q)
        torch.cuda.synchronize()
        sfx = "" if rows == n else "_ragged"
        facts["fused_bitwise_plain" + sfx] = torch.equal(kh, ph) and torch.equal(kt, pt)
        facts["topc_bitwise_plain" + sfx] = torch.equal(kx, px) and torch.equal(kv, pv)
    facts["capacity_binds"] = float(want.lam.max()) > 0
    cap = moe.capacity_factor * q * n / moe.n_experts
    emit(tag, tokens=n, experts=moe.n_experts, q=q, iters=moe.scd_iters, tile=tile,
         capacity=cap, experts_priced=int((want.lam > 0).sum()),
         load_max=float(want.load.max()), routed=int(want.mask.sum()), **facts)
    check(all(facts.values()), f"router on the card: {facts}")
    k, e = moe.n_experts, edges.shape[-1]
    shape = {"rows": n, "k": k, "q": q}
    return {
        "scd_fused_hist": {
            **shape, "e": e, "tile": tile,
            "ms": time_ms(torch, lambda: ops.scd_fused_hist(pc, ones, lam, edges, q, **fused),
                          reps=50),
            "plain_ms": time_ms(torch, lambda: ref.scd_fused_hist_plain(
                pc, ones, lam, edges, q, **fused), reps=5, warmup=1),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(cost.scd_fused_hist(n, k, e, q, tile))))},
        "adjusted_topc": {
            **shape,
            "ms": time_ms(torch, lambda: ops.adjusted_topc(pc, ones, lam, q), reps=50),
            "plain_ms": time_ms(torch, lambda: ref.adjusted_topc_plain(pc, ones, lam, q),
                                reps=5, warmup=1),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(cost.adjusted_topc(n, k, q))))}}


def _smoke_cfg(registry, name):
    """``smoke()`` of the arch; ``NAME@k160`` keeps its router at the full
    config's expert count and top-k (deepseek: 160 and 6)."""
    import dataclasses
    arch, _, wide = name.partition("@")
    cfg = registry.get(arch).smoke()
    if wide:
        full = registry.get(arch).moe
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=full.n_experts,
                                                  topk=full.topk))
    return cfg


def _lm_smoke_vs_cpu(torch, np, dev, names=LM_SMOKE, tag="lm_smoke_card_vs_cpu",
                     tol=LM_SMOKE_TOL):
    """Phase 19d (and 21e): smoke configs in float32 on the card against
    the port on the CPU, TF32 off: prefill and four decode steps (an
    encoder-decoder's from the same frames)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, model as M

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name in names:
            cfg = _smoke_cfg(registry, name)
            cpu = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
            card = lm.tree_map(lambda a: a.to(dev), cpu)
            g = np.random.default_rng(1)
            batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab, (2, 64)))}
            if cfg.kind == "encdec":
                batch["frames"] = torch.from_numpy(
                    g.standard_normal((2, 32, cfg.d_model)).astype(np.float32))
            toks, frames = batch["tokens"], batch.get("frames")
            on_card = {k: v.to(dev) for k, v in batch.items()}
            step, dstep = M.make_prefill_step(cfg), M.make_decode_step(cfg)
            with torch.no_grad():
                pairs = [(step(card, on_card).cpu(), step(cpu, batch))]
                cc = M.init_cache(cfg, cpu, 2, 16, frames=frames)
                gc = M.init_cache(cfg, card, 2, 16, frames=on_card.get("frames"))
                for t in range(4):
                    wl, cc = dstep(cpu, cc, toks[:, t:t + 1], t)
                    gl, gc = dstep(card, gc, toks[:, t:t + 1].to(dev), t)
                    pairs.append((gl.cpu(), wl))
            err = max(float((a - b).abs().max()) for a, b in pairs)
            out[name] = {"max_abs_err": err, "all_close": all(
                torch.allclose(a, b, **tol) for a, b in pairs)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    emit(tag, tol=tol, tf32=False, **out)
    check(all(v["all_close"] for v in out.values()), f"smoke LM card vs CPU: {out}")


def _frames(torch, np, cfg, b, f, seed, dev):
    """Encoder frames as ``lm_batch`` draws them: N(0, 1) x 0.02 in cfg.dtype."""
    x = np.random.default_rng(seed).standard_normal((b, f, cfg.d_model), np.float32)
    return torch.from_numpy(x).to(dev, cfg.dtype) * 0.02


def _decode_vs_forward(torch, np, dev, params, cfg, tag, toks, bar):
    """Decode ``toks`` (B, S) through the caches against one teacher-forced
    forward in bf16 (the top-k router on both paths; an encoder-decoder's
    decoder against the same frames); emits and checks the relative L2
    error of each position's logits against ``bar``."""
    import dataclasses
    from repro_torch.models import encdec, lm, model as M
    from repro_torch.models.layers import unembed

    tcfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router="topk"))
    db, ds = toks.shape
    frames = _frames(torch, np, cfg, db, 32, 0, dev) if cfg.kind == "encdec" else None
    with torch.no_grad():
        if cfg.kind == "encdec":
            memory = encdec.encode(params, tcfg, frames)
            want = unembed(params["head"], encdec.decode_train(params, tcfg, toks, memory))
        else:
            want = unembed(lm.head_params(params), lm.forward(params, tcfg, toks))
        want = want.float()
        caches = M.init_cache(tcfg, params, db, ds, frames=frames)
        dstep = M.make_decode_step(tcfg)
        got = torch.stack([dstep(params, caches, toks[:, t:t + 1], t)[0][:, 0].float()
                           for t in range(ds)], dim=1)
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).flatten()
    facts = {"rel_l2_within": float(rel.max()) <= bar,
             "finite": bool(torch.isfinite(got).all())}
    emit(tag, arch=cfg.name, layers=cfg.n_layers, dtype="bfloat16", batch=db, tokens=ds,
         rel_l2_max=float(rel.max()), rel_l2_median=float(rel.median()),
         rel_l2_per_position=[round(float(x), 5) for x in rel],
         max_abs_err=float((got - want).abs().max()),
         logits_abs_max=float(want.abs().max()), bound=bar, **facts)
    check(all(facts.values()), f"{cfg.name} decode against forward: {facts}")


def _decode_walls(torch, np, dev, lm, M, params, cfg, tok, strict=False):
    """The decode step's walls at LM_SERVE's shape (``tok``: (max_batch, 1);
    an encoder-decoder's cross caches from the cell's frames,
    ``model._frames_len``), its weight-read floor from the dry-run's
    account of the cell (every weight but the embedding table, which is
    indexed, and the caches), and the dry-run against the first step on
    the card where ``strict`` (its checks fail the smoke; the peak is reset
    right before that step)."""
    from repro_torch.kernels import cost, ops

    b, cache_len = LM_SERVE["max_batch"], LM_SERVE["cache_len"]
    dry = _dry_cell(cfg.name, "decode", b, cache_len, cfg=cfg)
    frames = (_frames(torch, np, cfg, b, M._frames_len(cfg, cache_len), 3, dev)
              if cfg.kind == "encdec" else None)
    with torch.no_grad():
        caches = M.init_cache(cfg, params, b, cache_len, frames=frames)
    table = M.init(cfg, None, "meta")["embed"]["e"]
    dstep = M.make_decode_step(cfg)
    walls = []
    with torch.no_grad():
        for t in range(LM_DECODE_STEPS):
            torch.cuda.synchronize()
            if strict and not t:
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                ops.reset_launches()
            t0 = time.perf_counter()
            dstep(params, caches, tok, t)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if strict and not t:
                raw = torch.cuda.max_memory_allocated(dev)
                first = (dict(ops.LAUNCHES), _nbytes(lm, params, caches, tok), raw - before, raw)
    out = {}
    if strict:
        _dry_vs_card(f"{cfg.name}_decode", dry, *first)
        out = {"decode_dry_peak": dry["memory"]["peak"], "decode_card_peak": first[1] + first[2]}
    floor_ms = (dry["memory"]["params"] - table.numel() * table.element_size()
                + dry["memory"]["caches"]) / cost.HBM_BYTES_PER_S * 1e3
    return {"decode_batch": b, "decode_cache": cache_len, "decode_step_ms": walls,
            "decode_step_ms_median": statistics.median(walls[1:]),
            "weight_read_floor_ms": floor_ms, **out}


def phase_lm_serving(torch, np, dev):
    """The LM serving path (phase 19): the router on the card, moonshot at
    full width and depth through ``serve_loop`` and ``make_prefill_step``,
    decode against forward, and the smoke configs against the CPU."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import lm, model as M

    t_phase = time.perf_counter()
    cfg = registry.get(LM_ARCH)
    kern = _lm_router(torch, np, dev, cfg)

    # b. serve_loop at full width (its own seeded weights), its schedule
    # equal to the CPU port's on the smoke reduction: the same numpy queue.
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done, sets, stats = serve_loop(cfg, device=dev, **LM_SERVE)
    serve_s = time.perf_counter() - t0
    peak_serve = torch.cuda.max_memory_allocated(dev)
    cpu_done, cpu_sets, cpu_stats = serve_loop(cfg.smoke(), device="cpu", **LM_SERVE)
    facts = {"admitted_sets_equal_cpu_smoke": sets == cpu_sets,
             "completion_order_equal_cpu_smoke":
                 [r.rid for r in done] == [r.rid for r in cpu_done],
             "admission_iters_equal_cpu_smoke":
                 stats["admission_iters"] == cpu_stats["admission_iters"],
             "all_completed": len(done) == LM_SERVE["n_requests"]}
    emit("lm_serve_loop", arch=LM_ARCH, **LM_SERVE, wall_s=serve_s,
         loop_wall_s=stats["wall_s"], admissions=len(sets), admitted_sets=sets,
         completion_order=[r.rid for r in done], admission_iters=stats["admission_iters"],
         peak_gb=peak_serve / 1e9, **facts)
    check(all(facts.values()), f"serve_loop at full width: {facts}")

    # The prefill through the SCD router, its kernel launches counted.
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, param_bytes = _tree_bytes(lm, params)
    b, s = LM_PREFILL
    toks = torch.tensor(np.random.default_rng(20).integers(0, cfg.vocab, (b, s)),
                        device=dev)
    step = M.make_prefill_step(cfg)
    dry = _dry_cell(LM_ARCH, "prefill", b, s)
    init_peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        raw = torch.cuda.max_memory_allocated(dev)
        _dry_vs_card(f"{LM_ARCH}_prefill", dry, launches, _nbytes(lm, params, toks),
                     raw - before, raw)
        t0 = time.perf_counter()
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill2_s = time.perf_counter() - t0
    want = {name: 0 for name in launches}
    want.update(scd_fused_hist=cfg.moe.scd_iters * cfg.n_layers, adjusted_topc=cfg.n_layers)
    facts = {"launches_as_routed": launches == want,
             "logits_finite": bool(torch.isfinite(logits).all()),
             "logits_shape": tuple(logits.shape) == (b, cfg.vocab)}

    prefill_peak = torch.cuda.max_memory_allocated(dev)
    walls = _decode_walls(torch, np, dev, lm, M, params, cfg, toks[:LM_SERVE["max_batch"], :1],
                          strict=True)
    peak = max(init_peak, prefill_peak, torch.cuda.max_memory_allocated(dev))
    emit("lm_prefill", arch=LM_ARCH, params=n_params, param_gb=param_bytes / 1e9,
         init_s=init_s, batch=b, seq=s, prefill_s=prefill_s, prefill_again_s=prefill2_s,
         launches=launches, **walls, peak_gb=peak / 1e9, **facts)
    check(all(facts.values()), f"prefill at full width: {facts} {launches}")

    # c. Decode 16 tokens through the cache against one teacher-forced
    # forward, the top-k router on both paths.
    del logits
    _decode_vs_forward(torch, np, dev, params, cfg, "lm_decode_vs_forward",
                       toks[:LM_DECODE[0], :LM_DECODE[1]], LM_DECODE_REL)
    del params
    torch.cuda.empty_cache()

    _lm_smoke_vs_cpu(torch, np, dev)
    emit("lm_serving_wall", seconds=time.perf_counter() - t_phase)
    return {"lm_prefill": launches}, kern


# --------------------------------------------------------------------------
# Phase 20: LM training (optim/, the train step, launch/train.py) at
# moonshot-v1-16b-a3b's full width.
# --------------------------------------------------------------------------

# A trained parameter holds 12 bytes (bf16 weight and gradient, two float32
# moments): 337 GB at the config's 48 layers, 35.4 GB at 4. Depth is cut to
# 4 layers; every width stays the config's.
LM_TRAIN_LAYERS = 4
LM_TRAIN_BATCH = (4, 1024)          # 4,096 tokens: the router at (4,096, 64), q = 6
LM_TRAIN_STEPS = 4
# The reference CLI's lr without its warmup: bf16 keeps 8 significant bits,
# so an update moves a weight only where it exceeds half an ulp (3e-4 moves
# weights below 0.125, the init's d^-0.5 scale; a norm's 1.0 never moves).
LM_TRAIN_OPT = dict(lr=3e-4, warmup=1)
BF16_OPS_PER_S = 989e12             # H100 SXM data sheet, dense bf16
# Card against CPU at smoke(), float32, TF32 off (the CPU tests' bars): the
# loss rtol 1e-5, each gradient leaf a relative L2 error of 1e-4, the
# update from the same gradients rtol 1e-6 of the leaf's largest element.
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_REL, LM_TRAIN_UPDATE_RTOL = 1e-5, 1e-4, 1e-6
LM_TRAIN_CLI = ["--arch", "gemma-2b", "--smoke", "--steps", "8", "--batch", "2",
                "--seq", "64", "--ckpt-every", "2"]


def _lm_train_full(torch, np, dev):
    """Phase 20a: ``train()`` at full width, 4 layers, twice from one seed;
    then one more step of the second run against the dry-run's account."""
    from repro_torch.configs import registry
    from repro_torch.data.synth import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import lm, model as M
    from repro_torch.optim import OptConfig
    from repro_torch.models.lm import tree_leaves

    cfg = registry.get(LM_ARCH).replace(n_layers=LM_TRAIN_LAYERS)
    check(cfg.moe.router == "scd" and cfg.remat and cfg.param_dtype == torch.bfloat16,
          f"phase 20's config: router {cfg.moe.router}, remat {cfg.remat}")
    b, s = LM_TRAIN_BATCH

    def run():
        hist = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        params, opt, _ = train(cfg, OptConfig(**LM_TRAIN_OPT), LM_TRAIN_STEPS, seed=0,
                               batch_shape=LM_TRAIN_BATCH, log_every=0, device=dev,
                               history=hist)
        torch.cuda.synchronize()
        return (params, opt, hist, time.perf_counter() - t0, dict(ops.LAUNCHES),
                torch.cuda.max_memory_allocated(dev))

    params, opt, hist, wall, launches, peak = run()
    n_params, param_bytes = _tree_bytes(lm, params)
    init = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    changed = [int((a != z).sum()) for a, z in zip(tree_leaves(params), tree_leaves(init))]
    # The first run's weights and moments (29.5 GB) stay on the card beside
    # the second run (peak ~43 GB): the card holds both.
    first = [a.detach() for a in tree_leaves([params, opt.mu, opt.nu])]
    del init, params, opt
    params, opt, hist2, wall2, launches2, peak2 = run()
    bitwise = all(torch.equal(a.detach(), b)
                  for a, b in zip(tree_leaves([params, opt.mu, opt.nu]), first))
    del first

    # Step LM_TRAIN_STEPS + 1 of the second run, its peak reset right
    # before it: the dry-run's train cell (every layer run on meta).
    dry = _dry_cell(LM_ARCH, "train", b, s, cfg=cfg)
    batch = lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_STEPS, seed=0, device=dev)
    step_fn = M.make_train_step(cfg, OptConfig(**LM_TRAIN_OPT))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launches()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn(params, opt, batch)
    torch.cuda.synchronize()
    raw = torch.cuda.max_memory_allocated(dev)
    _dry_vs_card(f"{LM_ARCH}_train_{cfg.n_layers}_layers", dry, dict(ops.LAUNCHES),
                 _nbytes(lm, params, opt.mu, opt.nu, opt.step, batch), raw - before, raw)
    del params, opt, batch
    torch.cuda.empty_cache()

    per_step = {name: 0 for name in launches}
    per_step.update(scd_fused_hist=2 * cfg.moe.scd_iters * cfg.n_layers,
                    adjusted_topc=2 * cfg.n_layers)
    want = {k: v * LM_TRAIN_STEPS for k, v in per_step.items()}
    walls = [r["wall_s"] for r in hist]
    med = statistics.median(walls[1:])
    flops = dry["flops_executed"]
    facts = {"launches_as_routed": launches == want and launches2 == want,
             "finite": all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                           for r in hist + hist2),
             "params_moved": sum(changed) > 0,
             "two_runs_bitwise": bitwise,
             "same_losses": [r["loss"] for r in hist] == [r["loss"] for r in hist2]}
    emit("lm_train", arch=LM_ARCH, layers=cfg.n_layers, layers_of_config=48,
         dtype="bfloat16", remat=cfg.remat, router=cfg.moe.router, batch=b, seq=s,
         steps=LM_TRAIN_STEPS, params=n_params, param_gb=param_bytes / 1e9,
         state_gb=(2 * param_bytes + 8 * n_params) / 1e9,
         losses=[r["loss"] for r in hist], grad_norms=[r["grad_norm"] for r in hist],
         lrs=[r["lr"] for r in hist], step_wall_s=walls, step_wall_s_median=med,
         second_run_step_wall_s=[r["wall_s"] for r in hist2], train_wall_s=wall,
         second_train_wall_s=wall2, peak_gb=peak / 1e9,
         peak_gb_beside_first_run=peak2 / 1e9, launches=launches,
         launches_per_step=per_step, step_tflop=flops / 1e12,
         model_tflop=dry["model_flops"] / 1e12, flops_from="launch/dryrun.py (accounting)",
         bf16_peak_bound_ms=flops / BF16_OPS_PER_S * 1e3,
         achieved_tflops=flops / med / 1e12,
         opt=LM_TRAIN_OPT, moved_fraction=sum(changed) / n_params,
         moved_leaves=sum(c > 0 for c in changed), leaves=len(changed), **facts)
    check(all(facts.values()), f"training at full width: {facts} {launches}")
    return launches, [r["loss"] for r in hist]


def _grads(lm, M, tree_leaves, params, cfg, batch):
    """The loss and the gradient tree of ``params`` on ``batch``."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss = M.loss_fn(params, cfg, batch)
    loss.backward()
    grads = lm.tree_map(lambda p: p.grad, params)
    for p in tree_leaves(params):
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), grads


def _lm_train_smoke_vs_cpu(torch, np, dev, names=LM_SMOKE, tag="lm_train_card_vs_cpu"):
    """Phase 20b (and 21e): one train step of smoke configs in float32 on
    the card against the port on the CPU, TF32 off."""
    from repro_torch.configs import registry
    from repro_torch.data.synth import lm_batch
    from repro_torch.models import lm, model as M
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    from repro_torch.models.lm import tree_leaves

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name in names:
            cfg = registry.get(name).smoke()
            opt_cfg = OptConfig(lr=1e-3, warmup=2)
            cpu = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
            card = lm.tree_map(lambda a: a.to(dev), cpu)
            same = lm.tree_map(lambda a: a.to(dev), cpu)
            batch = lm_batch(cfg, (2, 64), 0, seed=1, device="cpu")
            wl, wg = _grads(lm, M, tree_leaves, cpu, cfg, batch)
            gl, gg = _grads(lm, M, tree_leaves, card, cfg,
                            {k: v.to(dev) for k, v in batch.items()})
            rel = [0.0 if not w.any() and not g.any() else
                   float((g.cpu() - w).norm() / w.norm())
                   for g, w in zip(tree_leaves(gg), tree_leaves(wg))]
            _, _, wm = apply_updates(cpu, wg, init_opt_state(cpu, opt_cfg), opt_cfg)
            _, _, gm = apply_updates(card, gg, init_opt_state(card, opt_cfg), opt_cfg)
            apply_updates(same, lm.tree_map(lambda g: g.to(dev), wg),
                          init_opt_state(same, opt_cfg), opt_cfg)
            lr1 = float(wm["lr"])
            upd = max(float((a.cpu() - w).abs().max() / w.abs().max())
                      for a, w in zip(tree_leaves(same), tree_leaves(cpu)))
            step_err = max(float((a.cpu() - w).abs().max())
                           for a, w in zip(tree_leaves(card), tree_leaves(cpu)))
            out[name] = {
                "loss_rel": abs(float(gl) - float(wl)) / abs(float(wl)),
                "grad_rel_l2_max": max(rel),
                "grad_norm_rel": abs(float(gm["grad_norm"]) - float(wm["grad_norm"]))
                / float(wm["grad_norm"]),
                "update_same_grads_rel_max": upd,
                # at step 1 an element moves by lr * (sign(g) + wd * p):
                # a gradient near 0 whose sign differs moves it 2 lr apart
                "step_abs_err_max": step_err, "step_bound": 2 * lr1 * (1 + 1e-3)}
            v = out[name]
            v["ok"] = (v["loss_rel"] <= LM_TRAIN_LOSS_RTOL
                       and v["grad_rel_l2_max"] <= LM_TRAIN_GRAD_REL
                       and v["grad_norm_rel"] <= LM_TRAIN_LOSS_RTOL
                       and v["update_same_grads_rel_max"] <= LM_TRAIN_UPDATE_RTOL
                       and v["step_abs_err_max"] <= v["step_bound"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    emit(tag, tf32=False, loss_rtol=LM_TRAIN_LOSS_RTOL,
         grad_rel_l2=LM_TRAIN_GRAD_REL, update_rtol=LM_TRAIN_UPDATE_RTOL, **out)
    check(all(v["ok"] for v in out.values()), f"smoke train step card vs CPU: {out}")


def _lm_train_resume(torch, np, dev):
    """Phase 20c: resume on the card at smoke size (moonshot, its SCD router
    on the card), bitwise, in float32 and with bf16 parameters."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.optim import OptConfig
    from repro_torch.models.lm import tree_leaves

    work = ROOT / "build" / "smoke_train" / "resume"
    facts = {}
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    kw = dict(seed=3, batch_shape=(2, 64), log_every=0, device=dev)
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        cfg = registry.get(LM_ARCH).smoke().replace(param_dtype=dtype)
        full = train(cfg, opt_cfg, steps=6, **kw)
        d = work / str(dtype).split(".")[-1]
        train(cfg, opt_cfg, steps=3, ckpt_dir=str(d), ckpt_every=3, **kw)
        res = train(cfg, opt_cfg, steps=6, ckpt_dir=str(d), ckpt_every=3, **kw)
        a, r = tree_leaves(full[:2]), tree_leaves(res[:2])
        facts[f"resume_bitwise_{str(dtype).split('.')[-1]}"] = (
            len(a) == len(r) and all(x.dtype == y.dtype and torch.equal(x, y)
                                     for x, y in zip(a, r))
            and res[2] == full[2][3:] and ckpt.latest_step(d) == 6)
    resume_s = time.perf_counter() - t0

    emit("lm_train_resume", arch=LM_ARCH, smoke=True, resume_wall_s=resume_s, **facts)
    check(all(facts.values()), f"resume on the card: {facts}")


def _lm_train_cli(d, out):
    """Phase 20d: the training CLI on the card, killed after step 5 by
    ``--simulate-failure-at``, then rerun (two cold interpreters, 16-30 s
    each). ``out["proc"]`` is the running one, for the phase to kill if it
    fails first."""
    from repro_torch.checkpoint import ckpt

    args = [sys.executable, "-m", "repro_torch.launch.train", *LM_TRAIN_CLI,
            "--ckpt-dir", str(d)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for key, extra in (("first", ["--simulate-failure-at", "5"]), ("second", [])):
        if out.get("stop"):
            return
        t0 = time.perf_counter()
        proc = out["proc"] = subprocess.Popen(args + extra, env=env, text=True,
                                              stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE)
        stdout, stderr = proc.communicate(timeout=300)
        out[key] = (proc.returncode, stdout, stderr, time.perf_counter() - t0,
                    ckpt.latest_step(d))


def start_lm_train_cli():
    """Phase 20d, started by ``main`` at phase 20's start in a thread (its
    cold interpreters import torch while phase 20's full-width runs are
    timed; started before phase 19 they perturbed its decode timing) and
    checked after phase 21 (:func:`finish_lm_train_cli`): (thread, the dict
    it fills, its directory)."""
    import threading

    work = ROOT / "build" / "smoke_train_cli"
    shutil.rmtree(work, ignore_errors=True)
    cli = {}
    thread = threading.Thread(target=_lm_train_cli, args=(work / "cli", cli), daemon=True)
    thread.start()
    return thread, cli, work


def stop_lm_train_cli(started):
    """Stop phase 20d's CLI: no next process, the running one killed."""
    thread, cli, _ = started
    cli["stop"] = True
    if thread.is_alive() and cli.get("proc") is not None:
        cli["proc"].kill()


def finish_lm_train_cli(started):
    """Phase 20d's checks: the CLI killed after step 5 left step 4, and its
    rerun resumed from step 4 to step 8."""
    thread, cli, work = started
    try:
        thread.join(timeout=700)
    finally:
        stop_lm_train_cli(started)
    (rc1, _, err1, s1, step1), (rc2, out2, err2, s2, step2) = \
        cli.get("first", (None,) * 5), cli.get("second", (None, "", "", None, None))
    facts = {"cli_exit_42": rc1 == 42, "cli_latest_after_kill_4": step1 == 4,
             "cli_rerun_exit_0": rc2 == 0, "cli_resumed_from_4": "resumed from step 4" in out2,
             "cli_done": "done" in out2, "cli_latest_8": step2 == 8}
    emit("lm_train_cli", cli=LM_TRAIN_CLI, killed_wall_s=s1, rerun_wall_s=s2,
         rerun_tail=out2.strip().splitlines()[-1:], **facts)
    check(all(facts.values()),
          f"the training CLI on the card: {facts} {(err1 or '')[-2000:]} {err2[-2000:]}")
    shutil.rmtree(work, ignore_errors=True)


def phase_lm_training(torch, np, dev):
    """The LM training path (phase 20): moonshot at full width and 4 layers
    through ``train()`` twice, the smoke step against the CPU and resume;
    the CLI killed and rerun (20d) runs beside it and phase 21
    (:func:`start_lm_train_cli`)."""
    t_phase = time.perf_counter()
    work = ROOT / "build" / "smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    launches, losses = _lm_train_full(torch, np, dev)
    _lm_train_smoke_vs_cpu(torch, np, dev)
    _lm_train_resume(torch, np, dev)
    shutil.rmtree(work, ignore_errors=True)
    emit("lm_training_wall", seconds=time.perf_counter() - t_phase)
    return {"lm_train": launches}, losses


# --------------------------------------------------------------------------
# Phase 21: the other mixers (models/mamba2.py, models/encdec.py): jamba's
# hybrid prefill through the SCD router at full width, mamba2-370m and
# seamless-m4t-medium served and trained at full width and depth.
# --------------------------------------------------------------------------

MIX_HYBRID = "jamba-v0.1-52b"       # src/repro_torch/configs/jamba_v01_52b.py
# Two periods of the 8-slot pattern: 25,998,437,824 parameters, 52.0 GB in
# bf16 (all 32 layers: 102.9 GB, above the card's 80 GB; one period would
# never index the period stack past 0). Every width is the config's.
MIX_HYBRID_LAYERS = 16
MIX_HYBRID_PARAMS = 25_998_437_824
MIX_SSM = "mamba2-370m"             # src/repro_torch/configs/mamba2_370m.py, not cut
MIX_ENCDEC = "seamless-m4t-medium"  # src/repro_torch/configs/seamless_m4t_medium.py, not cut
MIX_PARAMS = {MIX_SSM: 368_338_432, MIX_ENCDEC: 977_758_208}
MIX_PREFILL = (4, 1024)             # B x S tokens (seamless: and 1,024 frames)
MIX_FRAMES = 1024
MIX_TRAIN_STEPS = 4
# (B, S) of lm_batch: seamless splits S into frames and tokens, half each.
MIX_TRAIN_BATCH = {MIX_SSM: (4, 1024), MIX_ENCDEC: (4, 2048)}
MIX_SMOKE = (MIX_SSM, MIX_HYBRID, MIX_ENCDEC)
# Card against the port's CPU at smoke() in float32, TF32 off, for the
# mixers' configs: the prefill logits are unscaled (up to ~15), and float32
# rounding along jamba's 16-layer residual stream reaches a few 1e-6 of its
# scale; the reference's own eager and jitted prefills differ by up to
# 5.0e-5 there (ROADMAP C). Measured on the card: 5.2e-5 (jamba), 1.3e-5
# (mamba2), 1.1e-5 (seamless).
MIX_SMOKE_TOL = dict(rtol=1e-4, atol=1e-4)
# Decode against forward in bf16 at full width, the top-k router on both,
# as phase 19: the relative L2 error of each position's logits. The SSD's
# chunked scan and its one-token recurrence round in other places (bf16
# products of the quadratic form against a float32 state): mamba2 measured
# 0.038-0.064, seamless 0.011-0.013, held at phase 19's 0.15. jamba's
# top-2 of 16 experts flips an expert where two affinities sit within the
# bf16 rounding, and a flip moves half of that layer's FFN output:
# measured median 0.035, 0.08-0.19 at six of 32 positions; held at 0.3
# (unrelated logits give about 1.41).
MIX_DECODE_REL = {MIX_SSM: 0.15, MIX_ENCDEC: 0.15, MIX_HYBRID: 0.3}


def _mix_hybrid(torch, np, dev):
    """Phase 21a-b: jamba at full width and 16 layers: its router at
    (4,096, 16), ``serve_loop``, the prefill through both kernels, the
    decode step beside its floor, decode against forward, peak memory."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import lm, model as M

    cfg = registry.get(MIX_HYBRID).replace(n_layers=MIX_HYBRID_LAYERS)
    check(cfg.moe.router == "scd" and cfg.moe.n_experts == 16 and cfg.moe.topk == 2
          and cfg.n_periods == 2, f"phase 21's jamba config: {cfg.moe} {cfg.n_periods}")
    kern = _lm_router(torch, np, dev, cfg, tag="lm_router_hybrid")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done, sets, stats = serve_loop(cfg, device=dev, **LM_SERVE)
    serve_s = time.perf_counter() - t0
    peak_serve = torch.cuda.max_memory_allocated(dev)
    cpu_done, cpu_sets, cpu_stats = serve_loop(registry.get(MIX_HYBRID).smoke(),
                                               device="cpu", **LM_SERVE)
    facts = {"admitted_sets_equal_cpu_smoke": sets == cpu_sets,
             "completion_order_equal_cpu_smoke":
                 [r.rid for r in done] == [r.rid for r in cpu_done],
             "admission_iters_equal_cpu_smoke":
                 stats["admission_iters"] == cpu_stats["admission_iters"],
             "all_completed": len(done) == LM_SERVE["n_requests"]}
    emit("lm_serve_loop_hybrid", arch=MIX_HYBRID, layers=cfg.n_layers, **LM_SERVE,
         wall_s=serve_s, loop_wall_s=stats["wall_s"], admissions=len(sets),
         admitted_sets=sets, completion_order=[r.rid for r in done],
         admission_iters=stats["admission_iters"], peak_gb=peak_serve / 1e9, **facts)
    check(all(facts.values()), f"jamba serve_loop at full width: {facts}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, param_bytes = _tree_bytes(lm, params)
    b, s = MIX_PREFILL
    toks = torch.tensor(np.random.default_rng(21).integers(0, cfg.vocab, (b, s)),
                        device=dev)
    step = M.make_prefill_step(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill2_s = time.perf_counter() - t0
    moe_layers = cfg.ffn_pattern.count("moe") * cfg.n_periods
    want = {name: 0 for name in launches}
    want.update(scd_fused_hist=cfg.moe.scd_iters * moe_layers, adjusted_topc=moe_layers)
    walls = _decode_walls(torch, np, dev, lm, M, params, cfg, toks[:LM_SERVE["max_batch"], :1])
    peak = torch.cuda.max_memory_allocated(dev)
    facts = {"params_as_counted": n_params == MIX_HYBRID_PARAMS,
             "launches_as_routed": launches == want,
             "logits_finite": bool(torch.isfinite(logits).all()),
             "logits_shape": tuple(logits.shape) == (b, cfg.vocab),
             "peak_under_80gb": peak < 80e9}
    emit("lm_prefill_hybrid", arch=MIX_HYBRID, layers=cfg.n_layers, layers_of_config=32,
         params=n_params, param_gb=param_bytes / 1e9, init_s=init_s, batch=b, seq=s,
         prefill_s=prefill_s, prefill_again_s=prefill2_s, launches=launches,
         moe_layers=moe_layers, **walls, peak_gb=peak / 1e9, **facts)
    check(all(facts.values()), f"jamba prefill at full width: {facts} {launches}")
    del logits
    _decode_vs_forward(torch, np, dev, params, cfg, "lm_decode_vs_forward_hybrid",
                       toks[:LM_DECODE[0], :LM_DECODE[1]], MIX_DECODE_REL[MIX_HYBRID])
    del params
    torch.cuda.empty_cache()
    return launches, kern


def _mix_batch(torch, np, cfg, dev):
    """Phase 21's prefill batch for ``cfg`` (and phase 27's): MIX_PREFILL
    tokens drawn from seed 23 (an encoder-decoder's MIX_FRAMES frames too)."""
    b, s = MIX_PREFILL
    batch = {"tokens": torch.tensor(np.random.default_rng(23).integers(0, cfg.vocab, (b, s)),
                                    device=dev)}
    if cfg.kind == "encdec":
        batch["frames"] = _frames(torch, np, cfg, b, MIX_FRAMES, 23, dev)
    return batch


def _decode_steps(torch, M, params, cfg, batch, n_steps, cache_len):
    """One process's ``n_steps`` decode steps of the batch's first tokens
    from zero caches of ``cache_len`` (an encoder-decoder's cross K/V of
    its frames): (n_steps, B, V) float32 logits on the CPU."""
    caches = M.init_cache(cfg, params, batch["tokens"].shape[0], cache_len,
                          frames=batch.get("frames"))
    dstep = M.make_decode_step(cfg)
    with torch.no_grad():
        return torch.stack([dstep(params, caches, batch["tokens"][:, t:t + 1], t)[0][:, 0]
                            .float().cpu() for t in range(n_steps)])


def _mix_train(torch, np, dev, name):
    """Phase 21c-d: ``name`` at full width and depth: the prefill, the
    decode step, decode against forward, ``train()`` twice from one seed
    (bitwise) and, for mamba2, resumed from a checkpoint (bitwise).
    Returns what phase 27 holds its world against: the prefill's logits,
    MIX_TP_DECODE's decode steps and the first run's losses."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.models import lm, model as M
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import OptConfig

    cfg, short = registry.get(name), name.split("-")[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params, param_bytes = _tree_bytes(lm, params)
    b, s = MIX_PREFILL
    batch = _mix_batch(torch, np, cfg, dev)
    step = M.make_prefill_step(cfg)
    prefill_s = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(params, batch)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        encode_s = None
        if cfg.kind == "encdec":
            from repro_torch.models import encdec
            t0 = time.perf_counter()
            encdec.encode(params, cfg, batch["frames"])
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
    walls = _decode_walls(torch, np, dev, lm, M, params, cfg,
                          batch["tokens"][:LM_SERVE["max_batch"], :1])
    peak_serve = torch.cuda.max_memory_allocated(dev)
    facts = {"params_as_counted": n_params == MIX_PARAMS[name],
             "logits_finite": bool(torch.isfinite(logits).all()),
             "logits_shape": tuple(logits.shape) == (b, cfg.vocab)}
    emit("lm_prefill_" + short, arch=name, layers=cfg.n_layers,
         params=n_params, param_gb=param_bytes / 1e9, batch=b, seq=s,
         frames=MIX_FRAMES if cfg.kind == "encdec" else None, prefill_s=prefill_s,
         encode_s=encode_s, **walls, peak_gb=peak_serve / 1e9, **facts)
    check(all(facts.values()), f"{name} prefill at full width: {facts}")
    one = {"logits": logits.float().cpu(),
           "decode": _decode_steps(torch, M, params, cfg, batch, *MIX_TP_DECODE[name])}
    del logits
    _decode_vs_forward(torch, np, dev, params, cfg, "lm_decode_vs_forward_" + short,
                       batch["tokens"][:LM_DECODE[0], :LM_DECODE[1]], MIX_DECODE_REL[name])
    del params
    torch.cuda.empty_cache()

    bshape = MIX_TRAIN_BATCH[name]
    opt = OptConfig(**LM_TRAIN_OPT)

    def run(steps=MIX_TRAIN_STEPS, **kw):
        hist = []
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        p, o, _ = train(cfg, opt, steps, seed=0, batch_shape=bshape, log_every=0,
                        device=dev, history=hist, **kw)
        torch.cuda.synchronize()
        return p, o, hist, time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev)

    params, o, hist, wall, peak = run()
    first = [a.detach() for a in tree_leaves([params, o.mu, o.nu])]
    del params, o
    params, o, hist2, wall2, peak2 = run()
    bitwise = all(torch.equal(a.detach(), b)
                  for a, b in zip(tree_leaves([params, o.mu, o.nu]), first))
    del params, o
    resume = {}
    if cfg.kind != "encdec":
        d = ROOT / "build" / "smoke_mixers" / name
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        run(2, ckpt_dir=str(d), ckpt_every=2)
        params, o, hist3, _, _ = run(ckpt_dir=str(d), ckpt_every=0)
        resume = {"resume_bitwise": all(torch.equal(a.detach(), b) for a, b in zip(
            tree_leaves([params, o.mu, o.nu]), first))
            and [r["loss"] for r in hist3] == [r["loss"] for r in hist[2:]],
            "resume_wall_s": time.perf_counter() - t0}
        del params, o
        shutil.rmtree(d, ignore_errors=True)
    del first
    torch.cuda.empty_cache()
    walls_s = [r["wall_s"] for r in hist]
    facts = {"finite": all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                           for r in hist + hist2),
             "two_runs_bitwise": bitwise,
             "same_losses": [r["loss"] for r in hist] == [r["loss"] for r in hist2],
             **{k: v for k, v in resume.items() if k.endswith("bitwise")}}
    emit("lm_train_" + short, arch=name, layers=cfg.n_layers, dtype="bfloat16",
         remat=cfg.remat, batch=bshape, steps=MIX_TRAIN_STEPS, params=n_params,
         state_gb=(2 * param_bytes + 8 * n_params) / 1e9,
         losses=[r["loss"] for r in hist], grad_norms=[r["grad_norm"] for r in hist],
         step_wall_s=walls_s, step_wall_s_median=statistics.median(walls_s[1:]),
         second_run_step_wall_s=[r["wall_s"] for r in hist2], train_wall_s=wall,
         second_train_wall_s=wall2, peak_gb=peak / 1e9, peak_gb_beside_first_run=peak2 / 1e9,
         resume_wall_s=resume.get("resume_wall_s"), opt=LM_TRAIN_OPT, **facts)
    check(all(facts.values()), f"{name} training at full width: {facts}")
    one["losses"] = [r["loss"] for r in hist]
    return one


def phase_lm_mixers(torch, np, dev):
    """The other mixers (phase 21): jamba's hybrid prefill through the SCD
    router at full width and 16 layers, mamba2-370m and seamless-m4t-medium
    at full width and depth, and the three smoke configs against the CPU.
    Returns the kernels' path and timings, and mamba2's and seamless's
    one-process results that phase 27 reuses."""
    t_phase = time.perf_counter()
    launches, kern = _mix_hybrid(torch, np, dev)
    ones = {name: _mix_train(torch, np, dev, name) for name in (MIX_SSM, MIX_ENCDEC)}
    _lm_smoke_vs_cpu(torch, np, dev, MIX_SMOKE, tag="lm_mixers_smoke_card_vs_cpu",
                     tol=MIX_SMOKE_TOL)
    _lm_train_smoke_vs_cpu(torch, np, dev, MIX_SMOKE, tag="lm_mixers_train_card_vs_cpu")
    emit("lm_mixers_wall", seconds=time.perf_counter() - t_phase)
    return {"lm_prefill_hybrid": launches}, kern, ones


# --------------------------------------------------------------------------
# Phase 22: MLA and the router's two kernels at K = 160: deepseek-v2-236b's
# prefill and decode through the SCD router at full width.
# --------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-236b"       # src/repro_torch/configs/deepseek_v2_236b.py
# block0 (dense, d_ff 12,288) and 6 MoE blocks, cut from 60: 25,219,261,440
# parameters, 50.4 GB in bf16 (one MoE block 3.97 G parameters, 7.9 GB, 95 %
# of it the 160 experts). At 8 blocks the weights alone take 66.3 GB, and
# the dense-over-experts prefill holds (160, 4,096, 3,072), (160, 4,096,
# 1,536) and (160, 4,096, 5,120) bf16 transients (4.0, 2.0 and 6.7 GB)
# beside them. Every width is the config's.
MLA_LAYERS = 6
MLA_PARAMS = 25_219_261_440
MLA_PREFILL = (4, 1024)             # B x S: 4,096 tokens, the router at (4,096, 160), q = 6
# Decode against forward in bf16, the top-k router on both, as phase 19:
# measured on the card at a median of 0.015 and at most 0.061 over the 32
# positions (the absorbed decode and the decompressed prefill round in
# other places), held at phase 19's 0.15.
MLA_DECODE_REL = 0.15
MLA_SMOKE = (MLA_ARCH, MLA_ARCH + "@k160")


def phase_lm_mla(torch, np, dev):
    """Phase 22: deepseek-v2-236b at full width and MLA_LAYERS MoE blocks:
    its router at (4,096, 160), q = 6 through the kernels' wide instances,
    ``serve_loop``, the prefill through both kernels, the decode step beside
    its floor, decode against forward, the peak memory; then its smoke
    config and the wide-router smoke against the CPU."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import lm, model as M

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    cfg = registry.get(MLA_ARCH).replace(n_layers=MLA_LAYERS)
    check(cfg.use_mla and cfg.moe.router == "scd" and cfg.moe.n_experts == 160
          and cfg.moe.topk == 6 and cfg.first_dense_ff == 12288,
          f"phase 22's deepseek config: {cfg.moe} {cfg.mla}")
    kern = _lm_router(torch, np, dev, cfg, tag="lm_router_mla")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done, sets, stats = serve_loop(cfg, device=dev, **LM_SERVE)
    serve_s = time.perf_counter() - t0
    peak_serve = torch.cuda.max_memory_allocated(dev)
    cpu_done, cpu_sets, cpu_stats = serve_loop(registry.get(MLA_ARCH).smoke(),
                                               device="cpu", **LM_SERVE)
    facts = {"admitted_sets_equal_cpu_smoke": sets == cpu_sets,
             "completion_order_equal_cpu_smoke":
                 [r.rid for r in done] == [r.rid for r in cpu_done],
             "admission_iters_equal_cpu_smoke":
                 stats["admission_iters"] == cpu_stats["admission_iters"],
             "all_completed": len(done) == LM_SERVE["n_requests"]}
    emit("lm_serve_loop_mla", arch=MLA_ARCH, layers=cfg.n_layers, **LM_SERVE,
         wall_s=serve_s, loop_wall_s=stats["wall_s"], admissions=len(sets),
         admitted_sets=sets, completion_order=[r.rid for r in done],
         admission_iters=stats["admission_iters"], peak_gb=peak_serve / 1e9, **facts)
    check(all(facts.values()), f"deepseek serve_loop at full width: {facts}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, param_bytes = _tree_bytes(lm, params)
    b, s = MLA_PREFILL
    toks = torch.tensor(np.random.default_rng(22).integers(0, cfg.vocab, (b, s)),
                        device=dev)
    step = M.make_prefill_step(cfg)
    dry = _dry_cell(MLA_ARCH, "prefill", b, s, cfg=cfg)
    init_peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        raw = torch.cuda.max_memory_allocated(dev)
        _dry_vs_card(f"{MLA_ARCH}_prefill", dry, launches, _nbytes(lm, params, toks),
                     raw - before, raw)
        t0 = time.perf_counter()
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill2_s = time.perf_counter() - t0
    peak_prefill = max(init_peak, torch.cuda.max_memory_allocated(dev))
    want = {name: 0 for name in launches}
    want.update(scd_fused_hist=cfg.moe.scd_iters * cfg.n_layers, adjusted_topc=cfg.n_layers)
    walls = _decode_walls(torch, np, dev, lm, M, params, cfg, toks[:LM_SERVE["max_batch"], :1])
    peak = max(peak_prefill, torch.cuda.max_memory_allocated(dev))
    facts = {"params_as_counted": n_params == MLA_PARAMS,
             "launches_as_routed": launches == want,
             "logits_finite": bool(torch.isfinite(logits).all()),
             "logits_shape": tuple(logits.shape) == (b, cfg.vocab),
             "peak_under_80gb": peak < 80e9}
    emit("lm_prefill_mla", arch=MLA_ARCH, layers=cfg.n_layers, layers_of_config=60,
         dense_block0=True, params=n_params, param_gb=param_bytes / 1e9,
         held_before_gb=held_gb, init_s=init_s, batch=b, seq=s, prefill_s=prefill_s,
         prefill_again_s=prefill2_s, launches=launches, **walls,
         peak_prefill_gb=peak_prefill / 1e9, peak_gb=peak / 1e9, **facts)
    check(all(facts.values()), f"deepseek prefill at full width: {facts} {launches}")
    del logits
    _decode_vs_forward(torch, np, dev, params, cfg, "lm_decode_vs_forward_mla",
                       toks[:LM_DECODE[0], :LM_DECODE[1]], MLA_DECODE_REL)
    del params
    torch.cuda.empty_cache()

    _lm_smoke_vs_cpu(torch, np, dev, MLA_SMOKE, tag="lm_mla_smoke_card_vs_cpu")
    emit("lm_mla_wall", seconds=time.perf_counter() - t_phase)
    return {"lm_prefill_mla": launches}, kern


# --------------------------------------------------------------------------
# Phase 23: the MoE forward over a world of ranks (models/sharding.py, the
# a2a expert-parallel MoE, scd_route_shmap): moonshot-v1-16b-a3b's prefill
# and decode over worlds of 2 and 4 gloo ranks sharing the card.
# --------------------------------------------------------------------------

# One MoE layer's experts take 1.107 GB in bf16: the 48-layer model's
# weights (56.1 GB) do not fit twice, let alone once a rank; at 8 layers
# they take 10.5 GB, which each rank draws whole and cuts to its experts
# (about 6.0 GB a rank in a world of 2, 3.8 GB in a world of 4). Every
# width is the config's.
WORLD_LM_LAYERS = 8
WORLD_LM_SIZES = (2, 4)
WORLD_LM_PREFILL = (4, 1024)        # B x S: each rank routes its B / D rows
WORLD_LM_DECODE = (16, 256)         # decode steps, cache length
WORLD_LM_TIMEOUT = 300
# Against the one-process run in bf16 (relative L2 of each row's logits):
# the world routes without the §5.4 projection and drops pairs past
# cap_send and cap_e, its a2a sums k pairs where the one-process path sums
# E experts, and its decode folds the ranks' partial outputs. Where nothing
# drops, the decode-against-forward bar of phases 19-22 (0.15; the world
# of 2 measured 0.0099 for the prefill, 0.065 for decode). In the world of
# 4 each rank routes one sequence, whose tokens favour the same experts in
# the deeper layers, and cap_send (1.25x a rank's average share a target)
# drops 541 of its 24,576 pairs (2.2 %; the reference's rule): its prefill
# rows measured 0.091 (median) and 0.164 (max), held at 0.3, the bar of a
# router that flips experts (jamba's, phase 21). Decode drops nothing.
WORLD_LM_REL = {2: 0.15, 4: 0.3}
WORLD_LM_DECODE_REL = 0.15
WORLD_LM_SMOKE_X = (4, 32)          # moe_train's tokens at smoke()
# Training over the world of 2 (phase 23b): phase 20's config, seed, batch
# (4 x 1,024 global, 2 x 1,024 a rank) and AdamW settings, 3 steps; its
# losses against phase 20's first 3 on the same batches, in bf16, where the
# world routes without the §5.4 projection and its a2a sums k pairs.
WORLD_TRAIN_STEPS = 3
WORLD_TRAIN_LOSS_RTOL = 1e-2
# The smoke config's world training, card against CPU (float32, TF32 off):
# 3 steps (the losses and grad norms), then 2 steps saved and resumed to 3.
WORLD_TRAIN_SMOKE = dict(steps=3, save_at=2, batch=(4, 64), seed=3, opt=dict(lr=1e-3, warmup=2))
WORLD_TRAIN_SMOKE_TOL = dict(rtol=1e-5, atol=1e-5)
WORLD_TRAIN_DIR = ROOT / "build" / "smoke_world_train"


def _world_rules():
    """The batch binding: "batch" and "experts" on the world, nothing else."""
    from repro_torch.models import sharding

    return dict(sharding.DEFAULT_RULES, batch="model", seq=None, kv_seq=None, heads=None,
                kv_heads=None, ffn=None, vocab=None)


def _world_inputs(np, cfg):
    """The router's probabilities (4,096 x 64, as phase 19 draws them) and
    the prefill's tokens, the same in every process."""
    g = np.random.default_rng(23)
    n, e = WORLD_LM_PREFILL[0] * WORLD_LM_PREFILL[1], cfg.moe.n_experts
    logits = g.standard_normal((n, e)) * 2 + g.standard_normal(e)
    toks = g.integers(0, cfg.vocab, WORLD_LM_PREFILL)
    return logits, toks


def _rel_l2(torch, got, want):
    """Relative L2 error of each row (last dim) of ``got`` against ``want``."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).flatten()


def _lm_forward_and_decode(torch, M, params, cfg, toks, mesh=None):
    """Two prefills (the first's kernel launches, dropped pairs and seconds
    in collectives counted) and WORLD_LM_DECODE's decode steps from zero
    caches: the prefill's last-position logits and every step's on the
    host, and the walls."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    step, dstep = M.make_prefill_step(cfg), M.make_decode_step(cfg)
    comm = (lambda: mesh.comm_s) if mesh is not None else (lambda: 0.0)
    out = {}
    with torch.no_grad():
        for key in ("prefill_s", "prefill_again_s"):
            if mesh is not None:
                mesh.barrier()
            ops.reset_launches()
            moe.reset_dropped()
            c0 = comm()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            out[key] = time.perf_counter() - t0
            if key == "prefill_s":
                out.update(launches=dict(ops.LAUNCHES), dropped=dict(moe.DROPPED),
                           prefill_comm_s=comm() - c0)
        logits = logits.float().cpu()
        n_steps, cache_len = WORLD_LM_DECODE
        caches = M.init_cache(cfg, params, toks.shape[0], cache_len)
        dec, walls = [], []
        c0 = comm()
        for t in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = dstep(params, caches, toks[:, t:t + 1], t)[0]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            dec.append(lg[:, 0].float().cpu())
        out.update(decode_comm_s=comm() - c0, decode_step_ms=walls,
                   decode_step_ms_median=statistics.median(walls[1:]))
    return logits, torch.stack(dec), out


def _world_smoke(torch, np, mesh, dev):
    """moonshot's smoke() in float32 over ``mesh`` on ``dev`` (TF32 off):
    moe_train's output under the batch binding, the prefill's logits and 4
    decode steps', gathered in rank order, on the host."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, model as M, moe, sharding

    cfg = registry.get(LM_ARCH).smoke()
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = lm.tree_map(lambda a: a.to(dev), sharding.shard_experts(params, mesh))
    g = np.random.default_rng(24)
    x = torch.from_numpy(g.standard_normal(WORLD_LM_SMOKE_X + (cfg.d_model,)).astype(
        np.float32)).to(dev)
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (4, 64))).to(dev)
    lo, hi = sharding.rank_rows(x.shape[0], mesh)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sharding.set_rules(_world_rules(), mesh=mesh)
    try:
        with torch.no_grad():
            p0 = lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"])
            y = moe.moe_train(p0, cfg, x[lo:hi])
            logits = M.make_prefill_step(cfg)(params, {"tokens": toks})
            caches = M.init_cache(cfg, params, toks.shape[0], 16)
            dstep = M.make_decode_step(cfg)
            dec = torch.stack([dstep(params, caches, toks[:, t:t + 1], t)[0][:, 0]
                               for t in range(4)])
    finally:
        sharding.set_rules(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def joined(t, dim=0):
        return torch.cat(list(mesh.gather(t.cpu()).unbind(0)), dim=dim)

    return {"moe_train": joined(y), "prefill": joined(logits), "decode": joined(dec, 1)}


def _world_train_full(torch, mesh, dev, cfg=None, rules="batch", keep=False,
                      steps=WORLD_TRAIN_STEPS, batch_shape=LM_TRAIN_BATCH):
    """Phase 23b on a rank of the world of 2 (and phase 25 with ``cfg`` under
    the production rules): ``train(mesh=, rules=)`` of moonshot at phase
    20's config (or ``cfg``) and batch (or ``batch_shape``: phase 27) for
    ``steps`` - 1 steps (phase 26: under FSDP) from the seed, then its last
    step by hand under the same
    rules (the step
    ``train`` runs, on its batch), the card's peak reset right before it:
    the losses and grad norms (and whether both ranks' are bitwise equal),
    rank 0's launches and seconds in collectives by kind over the steps,
    each rank's held and peak memory; the last step's launches, held
    bytes, peak rise and ``comm_bytes`` (the dry-run's cell). With ``keep``
    the trained parameters and optimizer state too (``state``)."""
    from repro_torch.configs import registry
    from repro_torch.data.synth import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import lm, model as M, sharding
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import OptConfig

    if cfg is None:
        cfg = registry.get(LM_ARCH).replace(n_layers=LM_TRAIN_LAYERS)
    opt_cfg = OptConfig(**LM_TRAIN_OPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.barrier()
    comm0 = dict(mesh.comm_split)
    ops.reset_launches()
    hist = []
    t0 = time.perf_counter()
    params, opt, _ = train(cfg, opt_cfg, steps - 1, seed=0,
                           batch_shape=batch_shape, log_every=0, device=dev, mesh=mesh,
                           history=hist, rules=rules)
    peak_train = torch.cuda.max_memory_allocated(dev)
    launches = dict(ops.LAUNCHES)
    batch = lm_batch(cfg, batch_shape, steps - 1, seed=0, device=dev)
    step = M.make_train_step(cfg, opt_cfg)
    sharding.set_rules(sharding.rules_for(rules, cfg.fsdp_mode), mesh=mesh)
    try:
        torch.cuda.synchronize()
        mesh.barrier()
        ops.reset_launches()
        bytes0 = dict(mesh.comm_bytes)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t_step = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        hist.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "wall_s": time.perf_counter() - t_step})
        torch.cuda.synchronize()
    finally:
        sharding.set_rules(None)
    raw = torch.cuda.max_memory_allocated(dev)
    last = {"launches": dict(ops.LAUNCHES), "rise": raw - before, "raw_peak": raw,
            "held": _nbytes(lm, params, opt.mu, opt.nu, opt.step, batch),
            "comm_bytes": {k: v - bytes0.get(k, 0) for k, v in mesh.comm_bytes.items()}}
    launches = {k: v + last["launches"][k] for k, v in launches.items()}
    wall = time.perf_counter() - t0
    comm = {k: v - comm0.get(k, 0.0) for k, v in mesh.comm_split.items()}
    held, peak = torch.cuda.memory_allocated(dev), max(peak_train, raw)
    n_local = sum(a.numel() for a in tree_leaves(params))
    state = (params, opt) if keep else None
    del params, opt, batch
    torch.cuda.empty_cache()
    stats = mesh.gather(torch.tensor([held / 1e9, peak / 1e9, n_local], dtype=torch.float64))
    out = {"losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
           "lrs": [r["lr"] for r in hist], "step_wall_s": [r["wall_s"] for r in hist],
           "train_wall_s": wall, "launches": launches, "comm_s_by_kind": comm,
           "last_step": last,
           "ranks": [dict(zip(("held_gb", "peak_gb", "params"), s.tolist())) for s in stats]}
    both = mesh.gather(torch.tensor(out["losses"] + out["grad_norms"], dtype=torch.float64))
    out["ranks_bitwise"] = bool(all(torch.equal(both[0], b) for b in both))
    if keep:
        out["state"] = state
    return out


def _world_train_smoke(torch, mesh, dev, d):
    """Phase 23c: moonshot's smoke() in float32 (TF32 off) over ``mesh`` on
    ``dev``: WORLD_TRAIN_SMOKE's steps of the train step under the batch
    binding from weights drawn on the CPU (the same on every device), the
    losses and grad norms; then ``train(mesh=)`` from the seed straight,
    saved at its step and resumed, and whether every rank's resumed state
    is bitwise its straight run's."""
    from repro_torch.configs import registry
    from repro_torch.data.synth import lm_batch
    from repro_torch.launch.train import train
    from repro_torch.models import lm, model as M, sharding
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import OptConfig, init_opt_state

    c = WORLD_TRAIN_SMOKE
    cfg, opt = registry.get(LM_ARCH).smoke(), OptConfig(**c["opt"])
    kw = dict(seed=c["seed"], batch_shape=c["batch"], log_every=0, device=dev, mesh=mesh)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"losses": [], "grad_norms": []}
    try:
        drawn = M.init(cfg, torch.Generator().manual_seed(c["seed"]), device="cpu")
        params = lm.tree_map(lambda a: a.to(dev), sharding.shard_experts(drawn, mesh))
        state, step = init_opt_state(params, opt), M.make_train_step(cfg, opt)
        sharding.set_rules(sharding.BATCH_RULES, mesh=mesh)
        try:
            for i in range(c["steps"]):
                params, state, m = step(params, state,
                                        lm_batch(cfg, c["batch"], i, seed=c["seed"], device=dev))
                out["losses"].append(float(m["loss"]))
                out["grad_norms"].append(float(m["grad_norm"]))
        finally:
            sharding.set_rules(None)
        full = train(cfg, opt, c["steps"], **kw)
        train(cfg, opt, c["save_at"], ckpt_dir=str(d), ckpt_every=c["save_at"], **kw)
        res = train(cfg, opt, c["steps"], ckpt_dir=str(d), **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    a, b = tree_leaves(full[:2]), tree_leaves(res[:2])
    mine = (len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                     for x, y in zip(a, b))
            and res[2] == full[2][c["save_at"]:])
    out["resume_bitwise"] = bool(mesh.gather(torch.tensor(mine)).all())
    return out


def world_lm_main(mesh):
    """Phase 23 on every rank of a world sharing the card: the world's lam
    from phase 23's probabilities, then moonshot at WORLD_LM_LAYERS layers
    drawn from the seed, cut to the rank's experts, through the prefill and
    the decode steps under the batch binding; in a world of 2 also the smoke
    config (``_world_smoke``). Rank 0 returns the gathered logits, its own
    counts and every rank's memory."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.moe_router import scd_route_shmap_probs
    from repro_torch.models import model as M, sharding

    dev = mesh.device
    check(dev.type == "cuda", f"rank {mesh.rank} runs on {dev}")
    cfg = registry.get(LM_ARCH).replace(n_layers=WORLD_LM_LAYERS)
    logits_np, toks_np = _world_inputs(np, cfg)
    lo, hi = sharding.rank_rows(logits_np.shape[0], mesh)
    probs = torch.softmax(torch.tensor(logits_np, dtype=torch.float32), dim=-1)[lo:hi]
    lam = scd_route_shmap_probs(probs.to(dev), cfg.moe.topk, cfg.moe.capacity_factor,
                                cfg.moe.scd_iters, mesh).lam.cpu()

    # The whole tree from the seed, cut to this rank's experts at once.
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = sharding.shard_experts(
        M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev), mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    held, peak_init = torch.cuda.memory_allocated(dev), torch.cuda.max_memory_allocated(dev)
    experts = sorted({s["ffn"]["wi"].shape[1] for s in params["slots"]})
    torch.cuda.reset_peak_memory_stats(dev)
    sharding.set_rules(_world_rules(), mesh=mesh)
    try:
        logits, dec, walls = _lm_forward_and_decode(
            torch, M, params, cfg, torch.tensor(toks_np, device=dev), mesh)
    finally:
        sharding.set_rules(None)
    peak = torch.cuda.max_memory_allocated(dev)
    del params
    torch.cuda.empty_cache()

    def joined(t, dim=0):
        return torch.cat(list(mesh.gather(t).unbind(0)), dim=dim)

    stats = mesh.gather(torch.tensor([held / 1e9, peak_init / 1e9, peak / 1e9, init_s],
                                     dtype=torch.float64))
    drops = mesh.gather(torch.tensor([walls["dropped"]["cap_send"],
                                      walls["dropped"]["cap_e"]])).sum(0)
    walls["dropped"] = {"cap_send": int(drops[0]), "cap_e": int(drops[1])}
    out = {"lam": lam, "logits": joined(logits), "decode": joined(dec, 1),
           "walls": walls, "experts_held": experts,
           "ranks": [dict(zip(("held_gb", "peak_init_gb", "peak_gb", "init_s"), s.tolist()))
                     for s in stats]}
    if mesh.size == 2:
        out["smoke"] = _world_smoke(torch, np, mesh, dev)
        out["train"] = _world_train_full(torch, mesh, dev)
        out["smoke_train"] = _world_train_smoke(torch, mesh, dev, WORLD_TRAIN_DIR / "card")
    return out


def world_lm_smoke_cpu(mesh):
    """The CPU world of 2 that phase 23's card world of 2 is held against."""
    import numpy as np
    import torch

    return {"smoke": _world_smoke(torch, np, mesh, mesh.device),
            "smoke_train": _world_train_smoke(torch, mesh, mesh.device,
                                              WORLD_TRAIN_DIR / "cpu")}


def phase_lm_world(torch, np, dev, train_losses):
    """Phase 23: the one-process prefill and decode of moonshot at
    WORLD_LM_LAYERS layers, then the same over worlds of 2 and 4 ranks
    sharing the card; in the world of 2 also training at phase 20's config
    (its losses against phase 20's ``train_losses``); the smoke config's
    world of 2 on the card against a world of 2 on the CPU, forward and
    training; the world's lam bitwise the one-process lam. Returns the
    kernels' paths and the one-process logits (prefill, decode steps),
    which phase 24 holds its world against."""
    from repro_torch.configs import registry
    from repro_torch.core.moe_router import scd_route_probs
    from repro_torch.launch.mesh import run_local_world, start_local_world
    from repro_torch.models import lm, model as M

    t_phase = time.perf_counter()
    shutil.rmtree(WORLD_TRAIN_DIR, ignore_errors=True)
    cpu_world = start_local_world(world_lm_smoke_cpu, 2, device="cpu",
                                  timeout=WORLD_LM_TIMEOUT)
    try:
        cfg = registry.get(LM_ARCH).replace(n_layers=WORLD_LM_LAYERS)
        check(cfg.moe.router == "scd" and cfg.moe.n_experts == 64 and cfg.moe.topk == 6
              and not cfg.first_dense_ff, f"phase 23's moonshot config: {cfg.moe}")
        logits_np, toks_np = _world_inputs(np, cfg)
        probs = torch.softmax(torch.tensor(logits_np, dtype=torch.float32), dim=-1)
        lam_one = scd_route_probs(probs.to(dev), q=cfg.moe.topk,
                                  capacity_factor=cfg.moe.capacity_factor,
                                  iters=cfg.moe.scd_iters).lam.cpu()

        # The one-process reference, its weights freed before the worlds.
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        n_params, param_bytes = _tree_bytes(lm, params)
        toks = torch.tensor(toks_np, device=dev)
        one_logits, one_dec, one_walls = _lm_forward_and_decode(torch, M, params, cfg, toks)
        one_peak = torch.cuda.max_memory_allocated(dev)
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        routed = {name: 0 for name in one_walls["launches"]}
        routed.update(scd_fused_hist=cfg.moe.scd_iters * cfg.n_layers,
                      adjusted_topc=cfg.n_layers)
        emit("lm_world_one_process", arch=LM_ARCH, layers=cfg.n_layers, layers_of_config=48,
             params=n_params, param_gb=param_bytes / 1e9, batch=WORLD_LM_PREFILL[0],
             seq=WORLD_LM_PREFILL[1], **one_walls, peak_gb=one_peak / 1e9)
        check(one_walls["launches"] == routed, f"one-process launches: {one_walls}")

        paths, worlds = {}, {}
        for d in WORLD_LM_SIZES:
            t0 = time.perf_counter()
            w = run_local_world(world_lm_main, d, timeout=WORLD_LM_TIMEOUT)
            world_s = time.perf_counter() - t0
            rel_prefill = _rel_l2(torch, w["logits"], one_logits)
            rel_decode = _rel_l2(torch, w["decode"], one_dec)
            launches = w["walls"].pop("launches")
            facts = {"launches_as_routed": launches == routed,
                     "lam_bitwise_one_process": torch.equal(w["lam"], lam_one),
                     "experts_a_rank": w["experts_held"] == [cfg.moe.n_experts // d],
                     "prefill_rel_l2_within": float(rel_prefill.max()) <= WORLD_LM_REL[d],
                     "decode_rel_l2_within": float(rel_decode.max()) <= WORLD_LM_DECODE_REL,
                     "finite": bool(torch.isfinite(w["logits"]).all()
                                    and torch.isfinite(w["decode"]).all()),
                     "shapes": tuple(w["logits"].shape) == tuple(one_logits.shape)
                     and tuple(w["decode"].shape) == tuple(one_dec.shape)}
            worlds[d] = w
            paths[f"lm_prefill_world{d}"] = launches
            emit(f"lm_world{d}", arch=LM_ARCH, layers=cfg.n_layers, world=d,
                 batch=WORLD_LM_PREFILL[0], seq=WORLD_LM_PREFILL[1],
                 world_wall_s=world_s, **w["walls"],
                 one_process_prefill_s=one_walls["prefill_s"],
                 one_process_prefill_again_s=one_walls["prefill_again_s"],
                 one_process_decode_step_ms_median=one_walls["decode_step_ms_median"],
                 rank0_launches=launches, ranks=w["ranks"],
                 prefill_rel_l2_max=float(rel_prefill.max()),
                 prefill_rel_l2_median=float(rel_prefill.median()),
                 decode_rel_l2_max=float(rel_decode.max()),
                 decode_rel_l2_median=float(rel_decode.median()),
                 bound_prefill=WORLD_LM_REL[d], bound_decode=WORLD_LM_DECODE_REL, **facts)
            check(all(facts.values()), f"moonshot over a world of {d}: {facts} {launches}")
    finally:
        cpu = cpu_world.wait()
    card = worlds[2]["smoke"]
    err = {k: float((card[k] - cpu["smoke"][k]).abs().max()) for k in card}
    facts = {f"{k}_close": torch.allclose(card[k], cpu["smoke"][k], **LM_SMOKE_TOL)
             for k in card}
    emit("lm_world_smoke_card_vs_cpu", world=2, tol=LM_SMOKE_TOL, tf32=False,
         max_abs_err=err, **facts)
    check(all(facts.values()), f"smoke world of 2, card against CPU: {err}")

    # Training over the world of 2 at full width, against phase 20.
    t = worlds[2]["train"]
    routed = {name: 0 for name in t["launches"]}
    routed.update(scd_fused_hist=2 * cfg.moe.scd_iters * LM_TRAIN_LAYERS * WORLD_TRAIN_STEPS,
                  adjusted_topc=2 * LM_TRAIN_LAYERS * WORLD_TRAIN_STEPS)
    one = train_losses[:WORLD_TRAIN_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(t["losses"], one)]
    together = sum(r["peak_gb"] for r in t["ranks"])
    facts = {"launches_as_routed": t["launches"] == routed,
             "finite": all(np.isfinite(t["losses"])) and all(np.isfinite(t["grad_norms"])),
             "losses_within_phase20": len(rel) == WORLD_TRAIN_STEPS
             and max(rel) <= WORLD_TRAIN_LOSS_RTOL,
             "peaks_together_under_80gb": together < 80.0}
    emit("lm_train_world", arch=LM_ARCH, layers=LM_TRAIN_LAYERS, world=2,
         batch=LM_TRAIN_BATCH, rows_a_rank=LM_TRAIN_BATCH[0] // 2, steps=WORLD_TRAIN_STEPS,
         opt=LM_TRAIN_OPT, losses=t["losses"], phase20_losses=one, loss_rel=rel,
         loss_rtol=WORLD_TRAIN_LOSS_RTOL, grad_norms=t["grad_norms"], lrs=t["lrs"],
         step_wall_s=t["step_wall_s"], train_wall_s=t["train_wall_s"],
         rank0_comm_s_by_kind=t["comm_s_by_kind"], ranks=t["ranks"],
         peak_gb_together=together, rank0_launches=t["launches"],
         launches_per_step={k: v / WORLD_TRAIN_STEPS for k, v in t["launches"].items()},
         **facts)
    check(all(facts.values()), f"training over a world of 2: {facts} {t['launches']}")
    last = t["last_step"]
    _dry_vs_card(f"{LM_ARCH}_train_{LM_TRAIN_LAYERS}_layers_world2_rank0",
                 _dry_cell(LM_ARCH, "train", *LM_TRAIN_BATCH, world=2,
                           cfg=cfg.replace(n_layers=LM_TRAIN_LAYERS)),
                 last["launches"], last["held"], last["rise"], last["raw_peak"],
                 comm=last["comm_bytes"])
    card, on_cpu = worlds[2]["smoke_train"], cpu["smoke_train"]
    facts = {f"{k}_close": bool(np.allclose(card[k], on_cpu[k], **WORLD_TRAIN_SMOKE_TOL))
             for k in ("losses", "grad_norms")}
    facts.update(card_resume_bitwise=card["resume_bitwise"],
                 cpu_resume_bitwise=on_cpu["resume_bitwise"])
    emit("lm_train_world_smoke_card_vs_cpu", world=2, tol=WORLD_TRAIN_SMOKE_TOL, tf32=False,
         card=card, cpu=on_cpu, **facts)
    check(all(facts.values()), f"smoke training over a world of 2, card against CPU: {facts}")
    shutil.rmtree(WORLD_TRAIN_DIR, ignore_errors=True)

    # The kernels line's paths: rank 0's launches over both worlds'
    # prefills, and over the world of 2's training.
    paths = {"lm_prefill_world": {name: sum(p[name] for p in paths.values())
                                  for name in paths[f"lm_prefill_world{WORLD_LM_SIZES[0]}"]},
             "lm_train_world": t["launches"]}
    emit("lm_world_wall", seconds=time.perf_counter() - t_phase)
    return paths, (one_logits, one_dec)


# --------------------------------------------------------------------------
# Phase 24: the forward under tensor and sequence parallelism over a world
# of ranks (sharding.PRODUCTION_RULES, the reference's production_rules(False)):
# moonshot-v1-16b-a3b at phase 23's 8 layers (its 16 heads and 16 KV heads
# split, the residual's sequence, the vocab, the experts) and gemma-2b at
# full depth (its 8 q heads and the FFN's 16,384 columns split, its one KV
# head whole, so its caches split by position, and its tied head of
# 256,000 rows by vocab), each over a world of 2 ranks sharing the card.
# --------------------------------------------------------------------------

TP_ARCHS = {LM_ARCH: WORLD_LM_LAYERS, "gemma-2b": 18}   # arch: layers (gemma uncut)
TP_PREFILL = WORLD_LM_PREFILL       # B x S: every rank runs every row
# Decode steps and cache length: moonshot's caches split by KV heads, as
# phase 23's one-process run's (its first 6 of 16 steps, cache 256); gemma's
# by position, 8 a cache: steps 4 and 5 write rank 1's block, empty before.
TP_DECODE = {LM_ARCH: (6, WORLD_LM_DECODE[1]), "gemma-2b": (6, 8)}
TP_TIMEOUT = 300
# Against the one-process run on the card in bf16, relative L2 of each
# row's logits: phase 23's world-of-2 bar. The world folds its partials
# (attention's and the FFN's wo, the embedding, flash-decoding's sums) in
# float32 in rank order and rounds once, where one process rounds its
# products once; moonshot's router runs its world path (no projection).
TP_REL = 0.15
# The dry-run against each rank: held and collective bytes exactly, the
# peak within 5 % (the new cells' bar, fixed before their first chip run).
TP_PEAK_REL = 0.05


def _tp_step(torch, mesh, dev, run):
    """``run()`` once on this rank between barriers, the card's peak reset
    right before it: (output, seconds, {rise of max_memory_allocated, the
    raw peak, the bytes sent by kind, the launches})."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    mesh.barrier()
    ops.reset_launches()
    bytes0 = dict(mesh.comm_bytes)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    raw = torch.cuda.max_memory_allocated(dev)
    comm = {k: v - bytes0.get(k, 0) for k, v in mesh.comm_bytes.items() if v - bytes0.get(k, 0)}
    return out, wall, {"rise": raw - before, "raw_peak": raw, "comm": comm,
                       "launches": dict(ops.LAUNCHES)}


TP_COMM = ("gather", "all_to_all", "reduce", "all_gather", "reduce_scatter")


def _tp_numbers(m):
    """A step's held bytes, rise, raw peak and bytes sent by kind, as numbers
    (all below 2^53: exact in the float64 the ranks gather)."""
    return [m["held"], m["rise"], m["raw_peak"], *(m["comm"].get(k, 0) for k in TP_COMM)]


def _tp_rank(v, n_steps):
    """A rank's measurements from its gathered numbers (``tp_lm_main``)."""
    def step(part):
        return {"held": int(part[0]), "rise": int(part[1]), "raw_peak": int(part[2]),
                "comm": {k: int(b) for k, b in zip(TP_COMM, part[3:]) if b},
                "launches": None}
    n = 3 + len(TP_COMM)
    rest = v[2 * n:]
    return {"prefill": step(v[:n]), "decode": step(v[n:2 * n]), "prefill_s": rest[0],
            "prefill_again_s": rest[1], "prefill_comm_s": rest[2], "decode_comm_s": rest[3],
            "decode_last_ms": rest[4], "held_gb": rest[5],
            "decode_step_ms": rest[6:6 + n_steps]}


def _tp_arch(torch, mesh, dev, cfg, batch, n_steps, cache_len, again=True):
    """One arch of phases 24 and 27 on a rank: the whole tree drawn from the
    seed and cut to the rank's blocks (``model.shard_params``), then under
    the production rules a prefill of ``batch`` (counted: launches, bytes
    sent, peak), with ``again`` a second one (timed), ``n_steps`` decode
    steps into caches of ``cache_len`` (an encoder-decoder's cross K/V of
    the batch's frames), and one decode step at the cache's last position
    (the dry-run's decode cell). Rank 0 gets the logits, whether both
    ranks' are bitwise equal, and every rank's measurements. The ranks
    draw their trees one after the other."""
    from repro_torch.launch.dryrun import nbytes
    from repro_torch.models import model as M, sharding

    toks, frames = batch["tokens"], batch.get("frames")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sharding.set_rules(sharding.PRODUCTION_RULES, mesh=mesh)
    try:
        # one rank after the other draws the whole tree and keeps its
        # blocks: jamba's period (26 GB) whole on both ranks at once, beside
        # their blocks, would nearly fill the card
        for r in range(mesh.size):
            if r == mesh.rank:
                params = M.shard_params(cfg, M.init(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev), mesh)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            mesh.barrier()
        step, dstep = M.make_prefill_step(cfg), M.make_decode_step(cfg)
        with torch.no_grad():
            c0 = mesh.comm_s
            logits, prefill_s, prefill = _tp_step(torch, mesh, dev,
                                                  lambda: step(params, batch))
            prefill_comm_s = mesh.comm_s - c0
            prefill["held"] = nbytes([params, batch])
            again_s = _tp_step(torch, mesh, dev, lambda: step(params, batch))[1] if again \
                else 0.0
            caches = M.init_cache(cfg, params, toks.shape[0], cache_len, frames=frames)
            dec, walls = [], []
            c0 = mesh.comm_s
            for t in range(n_steps):
                lg, wall, _ = _tp_step(
                    torch, mesh, dev, lambda t=t: dstep(params, caches, toks[:, t:t + 1], t))
                dec.append(lg[0][:, 0].float().cpu())
                walls.append(wall * 1e3)
            decode_comm_s = mesh.comm_s - c0
            token = toks[:, :1].clone()
            _, last_s, decode = _tp_step(
                torch, mesh, dev, lambda: dstep(params, caches, token, cache_len - 1))
            decode["held"] = nbytes([params, caches, token])
    finally:
        sharding.set_rules(None)
    logits, dec = logits.float().cpu(), torch.stack(dec)
    both = mesh.gather(torch.cat([logits.flatten(), dec.flatten()]))
    mine = [*_tp_numbers(prefill), *_tp_numbers(decode), prefill_s, again_s,
            prefill_comm_s, decode_comm_s, last_s * 1e3,
            torch.cuda.memory_allocated(dev) / 1e9, *walls]
    del params, caches
    ranks = [_tp_rank(v.tolist(), n_steps)
             for v in mesh.gather(torch.tensor(mine, dtype=torch.float64))]
    ranks[mesh.rank]["prefill"]["launches"] = prefill["launches"]
    ranks[mesh.rank]["decode"]["launches"] = decode["launches"]
    return {"logits": logits, "decode": dec, "ranks": ranks,
            "ranks_bitwise": bool(torch.equal(both[0], both[1]))}


def tp_lm_main(mesh):
    """Phase 24 on every rank of a world of 2 sharing the card: for each arch
    of TP_ARCHS, :func:`_tp_arch` (phase 23's and the one-process run's
    weights and tokens)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry

    dev = mesh.device
    check(dev.type == "cuda", f"rank {mesh.rank} runs on {dev}")
    _, toks_np = _world_inputs(np, registry.get(LM_ARCH))
    out = {}
    for arch, layers in TP_ARCHS.items():
        cfg = registry.get(arch).replace(n_layers=layers)
        toks = torch.tensor(toks_np % cfg.vocab, device=dev)
        out[arch] = _tp_arch(torch, mesh, dev, cfg, {"tokens": toks}, *TP_DECODE[arch])
    return out


def _tp_one_process(torch, np, dev, arch):
    """gemma-2b's one-process prefill and decode steps on the card, from the
    seed, as ``tp_lm_main`` runs them; the weights freed after."""
    from repro_torch.configs import registry
    from repro_torch.models import model as M

    cfg = registry.get(arch).replace(n_layers=TP_ARCHS[arch])
    _, toks_np = _world_inputs(np, registry.get(LM_ARCH))
    toks = torch.tensor(toks_np % cfg.vocab, device=dev)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_steps, cache_len = TP_DECODE[arch]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = M.make_prefill_step(cfg)(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        caches = M.init_cache(cfg, params, toks.shape[0], cache_len)
        dstep = M.make_decode_step(cfg)
        dec, walls = [], []
        for t in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.append(dstep(params, caches, toks[:, t:t + 1], t)[0][:, 0].float().cpu())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    del params, caches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return logits.float().cpu(), torch.stack(dec), {"prefill_s": prefill_s,
                                                   "decode_step_ms": walls}


def _tp_ones(torch, np, dev, one_moonshot):
    """Phase 24's one-process runs on the card: gemma-2b's prefill and
    decode; moonshot's phase 23's (``one_moonshot``), run here when None."""
    from repro_torch.configs import registry

    ones = {"gemma-2b": _tp_one_process(torch, np, dev, "gemma-2b")}
    if one_moonshot is None:
        from repro_torch.models import model as M
        cfg = registry.get(LM_ARCH).replace(n_layers=TP_ARCHS[LM_ARCH])
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        _, toks_np = _world_inputs(np, cfg)
        one_moonshot = _lm_forward_and_decode(torch, M, params, cfg,
                                              torch.tensor(toks_np, device=dev))[:2]
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ones[LM_ARCH] = (*one_moonshot, None)
    return ones


def _tp_dry():
    """Phase 24's dry-run accounts, by arch and step kind."""
    from repro_torch.configs import registry
    from repro_torch.models import sharding

    return {arch: {kind: _dry_cell(arch, kind, TP_PREFILL[0],
                                   TP_PREFILL[1] if kind == "prefill" else TP_DECODE[arch][1],
                                   world=2, cfg=registry.get(arch).replace(n_layers=layers),
                                   rules=sharding.PRODUCTION_RULES)
                   for kind in ("prefill", "decode")}
            for arch, layers in TP_ARCHS.items()}


def _tp_checks(torch, np, ones, w, recs, world_s):
    """Phase 24's checks of the world's results ``w`` (``tp_lm_main``'s)
    against the one-process runs and the dry-run's accounts ``recs``."""
    from repro_torch.configs import registry

    paths = {}
    for arch, layers in TP_ARCHS.items():
        cfg = registry.get(arch).replace(n_layers=layers)
        one_logits, one_dec, one_walls = ones[arch]
        got = w[arch]
        n_steps, cache_len = TP_DECODE[arch]
        rel_p = _rel_l2(torch, got["logits"], one_logits)
        rel_d = _rel_l2(torch, got["decode"], one_dec[:n_steps])
        r0 = got["ranks"][0]
        routed = {name: 0 for name in r0["prefill"]["launches"]}
        if cfg.moe.n_experts:
            routed.update(scd_fused_hist=cfg.moe.scd_iters * layers, adjusted_topc=layers)
        facts = {"finite": bool(torch.isfinite(got["logits"]).all()
                                and torch.isfinite(got["decode"]).all()),
                 "shapes": tuple(got["logits"].shape) == tuple(one_logits.shape)
                 and tuple(got["decode"].shape) == tuple(one_dec[:n_steps].shape),
                 "ranks_bitwise": got["ranks_bitwise"],
                 "launches_as_routed": r0["prefill"]["launches"] == routed,
                 "prefill_rel_l2_within": float(rel_p.max()) <= TP_REL,
                 "decode_rel_l2_within": float(rel_d.max()) <= TP_REL}
        emit(f"lm_tp_{arch}", arch=arch, layers=layers, world=2, rules="production",
             batch=TP_PREFILL[0], seq=TP_PREFILL[1], decode_steps=n_steps, cache_len=cache_len,
             world_wall_s=world_s,
             ranks=[{k: v for k, v in r.items() if k not in ("prefill", "decode")}
                    for r in got["ranks"]],
             one_process=one_walls, rank0_launches=r0["prefill"]["launches"],
             prefill_rel_l2_max=float(rel_p.max()), prefill_rel_l2_median=float(rel_p.median()),
             decode_rel_l2_max=float(rel_d.max()), decode_rel_l2_median=float(rel_d.median()),
             bound=TP_REL, **facts)
        check(all(facts.values()), f"{arch} under the production rules: {facts}")
        for r, mine in enumerate(got["ranks"]):
            for kind, rec in recs[arch].items():
                m = mine[kind]
                _dry_vs_card(f"{arch}_{layers}_layers_tp_world2_rank{r}_{kind}", rec,
                             m["launches"] if r == 0 else None, m["held"], m["rise"],
                             m["raw_peak"], comm=m["comm"], bar=TP_PEAK_REL)
        if cfg.moe.n_experts:
            paths["lm_prefill_tp"] = r0["prefill"]["launches"]
    return paths


def phase_lm_tp(torch, np, dev, one_moonshot=None):
    """Phase 24 alone: moonshot (phase 23's one-process logits,
    ``one_moonshot``; run here when None) and gemma-2b at full depth over a
    world of 2 under the production rules, against the one-process run on
    the card; each rank's held, peak and collective bytes against the
    dry-run's account. ``main`` runs it in one world with phase 25
    (:func:`phase_lm_tp_both`)."""
    from repro_torch.launch.mesh import start_local_world

    t_phase = time.perf_counter()
    ones = _tp_ones(torch, np, dev, one_moonshot)
    t0 = time.perf_counter()
    world = start_local_world(tp_lm_main, 2, timeout=TP_TIMEOUT)
    recs = _tp_dry()                    # the host's accounts while the world runs
    w = world.wait()
    paths = _tp_checks(torch, np, ones, w, recs, time.perf_counter() - t0)
    emit("lm_tp_wall", seconds=time.perf_counter() - t_phase)
    return paths


# --------------------------------------------------------------------------
# Phase 25: training under tensor and sequence parallelism over a world of
# ranks (sharding.PRODUCTION_RULES, the reference's production_rules(False)
# with its make_train_step): gemma-2b at full width and depth (its 8 q
# heads over its one KV head, whose wk/wv stay whole and fold their
# gradients, the FFN's 16,384 columns, the tied 256,000-row vocab, the
# residual's sequence) and moonshot-v1-16b-a3b at phase 20's 4 layers (its
# 16 heads and 16 KV heads, the vocab, the sequence, the 64 experts under
# the SCD router), each trained over a world of 2 ranks sharing the card.
# --------------------------------------------------------------------------

TP_TRAIN_ARCHS = {"gemma-2b": 18, LM_ARCH: LM_TRAIN_LAYERS}   # arch: layers (gemma uncut)
TP_TRAIN_TIMEOUT = 600
# Against one process in bf16 (gemma's run here, moonshot's phase 20's
# first 3 steps, on the same batches): phase 23's bar for a world's losses.
TP_TRAIN_LOSS_RTOL = 1e-2
# moonshot's router under "seq": a rank routes its 2 x 1,024 of the 4 x
# 1,024 tokens; the two kernels are held bitwise their plain versions at
# that shape (phase 25a).
TP_ROUTER_ROWS = LM_TRAIN_BATCH[0] * LM_TRAIN_BATCH[1] // 2
# The arch whose full-width world run runs twice, the first run's state
# held for the bitwise comparison (moonshot: 14.8 GB a rank held beside the
# second run's 20.7 GB peak).
TP_TRAIN_TWICE = LM_ARCH
# The world killed after step 2 and resumed: moonshot's smoke config under
# the production rules (the full-width states are 25-30 GB a checkpoint).
TP_TRAIN_SMOKE = dict(steps=3, save_at=2, batch=(4, 64), seed=3, opt=dict(lr=1e-3, warmup=2))
TP_TRAIN_DIR = ROOT / "build" / "smoke_tp_train"


def _tp_train_rank_numbers(torch, mesh, last):
    """Every rank's last-step measurements (held, rise, raw peak, bytes sent
    by kind), gathered in rank order."""
    mine = _tp_numbers({"held": last["held"], "rise": last["rise"],
                        "raw_peak": last["raw_peak"], "comm": last["comm_bytes"]})
    n = len(mine)
    return [{"held": int(v[0]), "rise": int(v[1]), "raw_peak": int(v[2]),
             "comm": {k: int(b) for k, b in zip(TP_COMM, v[3:n]) if b}}
            for v in mesh.gather(torch.tensor(mine, dtype=torch.float64)).tolist()]


def tp_train_main(mesh, killed_dir):
    """Phase 25 on every rank of a world of 2 sharing the card: the killed
    smoke world's run resumed from ``killed_dir`` and run once more
    uninterrupted (``tp_train_resumed``); then for each arch of
    TP_TRAIN_ARCHS, ``train(mesh=, rules="production")`` from the seed at
    phase 20's batch and settings, its last step by hand, measured
    (``_world_train_full``), TP_TRAIN_TWICE's run twice. Rank 0 returns
    its runs, every rank's last-step measurements and the comparisons."""
    import torch
    from repro_torch.configs import registry

    dev = mesh.device
    check(dev.type == "cuda", f"rank {mesh.rank} runs on {dev}")
    t0 = time.perf_counter()
    out = {"resume": tp_train_resumed(mesh, killed_dir)}
    out["resume"]["wall_s"] = time.perf_counter() - t0
    for arch, layers in TP_TRAIN_ARCHS.items():
        cfg = registry.get(arch).replace(n_layers=layers)
        twice = arch == TP_TRAIN_TWICE
        run = _world_train_full(torch, mesh, dev, cfg=cfg, rules="production", keep=twice)
        run["rank_steps"] = _tp_train_rank_numbers(torch, mesh, run["last_step"])
        if twice:       # the same run again, its state held beside the first's
            again = _world_train_full(torch, mesh, dev, cfg=cfg, rules="production",
                                      keep=True)
            run["second_run_bitwise"] = _same_run(torch, mesh, run.pop("state"),
                                                  again.pop("state"),
                                                  again["losses"] == run["losses"]
                                                  and again["grad_norms"] == run["grad_norms"])
            run["second_run_step_wall_s"] = again["step_wall_s"]
            torch.cuda.empty_cache()
        out[arch] = run
    return out


def _same_run(torch, mesh, x, y, metrics):
    """Whether two runs' (params, opt) are bitwise equal on every rank, with
    ``metrics`` (this rank's losses and grad norms equal)."""
    from repro_torch.models.lm import tree_leaves

    a, b = (tree_leaves([r[0], r[1].mu, r[1].nu]) for r in (x, y))
    mine = (len(a) == len(b) and all(u.dtype == v.dtype and torch.equal(u, v)
                                     for u, v in zip(a, b)) and metrics)
    return bool(mesh.gather(torch.tensor(mine)).all())


def _tp_train_smoke_kw(mesh):
    from repro_torch.configs import registry
    from repro_torch.optim import OptConfig

    c = TP_TRAIN_SMOKE
    return (registry.get(LM_ARCH).smoke(), OptConfig(**c["opt"]),
            dict(seed=c["seed"], batch_shape=c["batch"], log_every=0, device=mesh.device,
                 mesh=mesh, rules="production"))


def tp_train_killed(mesh, d):
    """Phase 25's killed world: smoke moonshot under the production rules,
    ``train(mesh=)`` saving at step 2 and exiting there on every rank
    (``fail_at``: exit code 42)."""
    from repro_torch.launch.train import train

    cfg, opt, kw = _tp_train_smoke_kw(mesh)
    c = TP_TRAIN_SMOKE
    train(cfg, opt, c["steps"], ckpt_dir=d, ckpt_every=c["save_at"], fail_at=c["save_at"],
          **kw)
    raise SmokeFailure("the killed world trained past its failure")


def tp_train_resumed(mesh, d):
    """The killed world's run resumed from its step 2 to step 3, then the
    same run uninterrupted; whether every rank's parameters and moments,
    and the losses, are bitwise equal."""
    import torch
    from repro_torch.launch.train import train

    cfg, opt, kw = _tp_train_smoke_kw(mesh)
    steps, save_at = TP_TRAIN_SMOKE["steps"], TP_TRAIN_SMOKE["save_at"]
    resumed = train(cfg, opt, steps, ckpt_dir=d, **kw)
    full = train(cfg, opt, steps, **kw)
    return {"bitwise": _same_run(torch, mesh, resumed, full,
                                 resumed[2] == full[2][save_at:]),
            "losses": full[2], "resumed_losses": resumed[2]}


def start_tp_train_killed():
    """Phase 25's killed world, started in a thread (``main`` starts it
    before phase 23, whose work its rank processes overlap, as phase 23's
    CPU world overlaps its card work): (thread, the dict it fills)."""
    import threading

    shutil.rmtree(TP_TRAIN_DIR, ignore_errors=True)
    out = {}
    thread = threading.Thread(target=_tp_train_killed_world, args=(out,), daemon=True)
    thread.start()
    return thread, out


def _tp_train_killed_world(out):
    """The killed world (phase 25, in a thread): its exit codes, wall and
    the step it saved."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import WorldError, run_local_world

    d = str(TP_TRAIN_DIR / "ckpt")
    t0 = time.perf_counter()
    try:
        run_local_world(tp_train_killed, 2, (d,), timeout=TP_TRAIN_TIMEOUT)
        out["killed_codes"] = None
    except WorldError as e:
        out["killed_codes"] = e.returncodes
    out["killed_s"] = time.perf_counter() - t0
    out["saved_step"] = ckpt.latest_step(d)


def _tp_train_one_process(torch, dev, arch):
    """``train()`` of ``arch`` at TP_TRAIN_ARCHS' depth in this process from
    the seed, at phase 20's batch and settings: the losses, grad norms,
    step walls and peak; the weights freed after."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.optim import OptConfig

    cfg = registry.get(arch).replace(n_layers=TP_TRAIN_ARCHS[arch])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    hist = []
    params, opt, _ = train(cfg, OptConfig(**LM_TRAIN_OPT), WORLD_TRAIN_STEPS, seed=0,
                           batch_shape=LM_TRAIN_BATCH, log_every=0, device=dev, history=hist)
    peak = torch.cuda.max_memory_allocated(dev)
    del params, opt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
            "step_wall_s": [r["wall_s"] for r in hist], "peak_gb": peak / 1e9}


def _tp_train_ones(torch, np, dev, train_losses):
    """Phase 25's one-process runs on the card (gemma's ``train()`` here,
    moonshot's phase 20's ``train_losses``, run here when None) and 25a:
    moonshot's router kernels at a rank's shape, bitwise their plain
    versions (and timed there). Returns (the runs, the router's timings)."""
    from repro_torch.configs import registry

    ones = {"gemma-2b": _tp_train_one_process(torch, dev, "gemma-2b")}
    ones[LM_ARCH] = (_tp_train_one_process(torch, dev, LM_ARCH) if train_losses is None
                     else {"losses": list(train_losses[:WORLD_TRAIN_STEPS])})
    router = _lm_router(torch, np, dev, registry.get(LM_ARCH), tag="lm_train_tp_router",
                        n=TP_ROUTER_ROWS)
    return ones, router


def _tp_train_dry():
    """Phase 25's dry-run accounts of a train step, by arch."""
    from repro_torch.configs import registry
    from repro_torch.models import sharding

    return {arch: _dry_cell(arch, "train", *LM_TRAIN_BATCH, world=2,
                            cfg=registry.get(arch).replace(n_layers=layers),
                            rules=sharding.PRODUCTION_RULES)
            for arch, layers in TP_TRAIN_ARCHS.items()}


def _join_tp_train_killed(killed):
    """The killed smoke world's record (:func:`start_tp_train_killed`),
    once it has finished."""
    thread, smoke = killed
    thread.join(timeout=TP_TRAIN_TIMEOUT)
    check(not thread.is_alive(), "phase 25's killed world did not finish")
    return smoke


def _tp_train_checks(torch, np, ones, w, recs, smoke, world_s):
    """Phase 25's checks of the world's results ``w`` (``tp_train_main``'s)
    against the one-process runs, the dry-run's accounts ``recs`` and the
    killed smoke world's record ``smoke``; returns the kernels' path."""
    from repro_torch.configs import registry

    # 25b: the full-width runs.
    paths = {}
    for arch, layers in TP_TRAIN_ARCHS.items():
        cfg = registry.get(arch).replace(n_layers=layers)
        t, one = w[arch], ones[arch]
        rel = [abs(a - b) / abs(b) for a, b in zip(t["losses"], one["losses"])]
        routed = {name: 0 for name in t["launches"]}
        if cfg.moe.n_experts:
            routed.update(scd_fused_hist=2 * cfg.moe.scd_iters * layers * WORLD_TRAIN_STEPS,
                          adjusted_topc=2 * layers * WORLD_TRAIN_STEPS)
        together = sum(r["peak_gb"] for r in t["ranks"])
        facts = {"finite": all(np.isfinite(t["losses"])) and all(np.isfinite(t["grad_norms"])),
                 "ranks_bitwise": t["ranks_bitwise"],
                 "losses_within_one_process": len(rel) == WORLD_TRAIN_STEPS
                 and max(rel) <= TP_TRAIN_LOSS_RTOL,
                 "launches_as_routed": t["launches"] == routed,
                 "peaks_together_under_80gb": together < 80.0}
        if arch == TP_TRAIN_TWICE:
            facts["second_run_bitwise"] = t["second_run_bitwise"]
        emit(f"lm_train_tp_{arch}", arch=arch, layers=layers, world=2, rules="production",
             batch=LM_TRAIN_BATCH, steps=WORLD_TRAIN_STEPS, opt=LM_TRAIN_OPT,
             losses=t["losses"], one_process_losses=one["losses"], loss_rel=rel,
             loss_rtol=TP_TRAIN_LOSS_RTOL, grad_norms=t["grad_norms"],
             one_process_grad_norms=one.get("grad_norms"), lrs=t["lrs"],
             step_wall_s=t["step_wall_s"], one_process_step_wall_s=one.get("step_wall_s"),
             one_process_peak_gb=one.get("peak_gb"), train_wall_s=t["train_wall_s"],
             world_wall_s=world_s, rank0_comm_s_by_kind=t["comm_s_by_kind"],
             ranks=t["ranks"], peak_gb_together=together, rank0_launches=t["launches"],
             launches_per_step={k: v / WORLD_TRAIN_STEPS for k, v in t["launches"].items()},
             second_run_step_wall_s=t.get("second_run_step_wall_s"), **facts)
        check(all(facts.values()), f"{arch} trained under the production rules: {facts} "
              f"{t['launches']}")
        for r, m in enumerate(t["rank_steps"]):
            _dry_vs_card(f"{arch}_train_{layers}_layers_tp_world2_rank{r}", recs[arch],
                         t["last_step"]["launches"] if r == 0 else None, m["held"],
                         m["rise"], m["raw_peak"], comm=m["comm"], bar=TP_PEAK_REL)
        if cfg.moe.n_experts:
            paths["lm_train_tp"] = t["launches"]

    # 25c: the smoke world killed after step 2 and resumed, bitwise.
    res = w["resume"]
    facts = {"killed_exit_42": smoke["killed_codes"] == [42, 42],
             "saved_at_step_2": smoke["saved_step"] == TP_TRAIN_SMOKE["save_at"],
             "resumed_bitwise": res["bitwise"],
             "finite": all(np.isfinite(res["losses"]))}
    emit("lm_train_tp_resume", arch=LM_ARCH, config="smoke", world=2, rules="production",
         killed_returncodes=smoke["killed_codes"], killed_wall_s=smoke["killed_s"],
         resumed_wall_s=res["wall_s"], losses=res["losses"],
         resumed_losses=res["resumed_losses"], **facts)
    check(all(facts.values()), f"the world killed and resumed under the production "
          f"rules: {facts}")
    shutil.rmtree(TP_TRAIN_DIR, ignore_errors=True)
    return paths


def phase_lm_tp_train(torch, np, dev, train_losses=None, killed=None):
    """Phase 25 alone: gemma-2b at full depth and moonshot at 4 layers
    trained over a world of 2 under the production rules, against the
    one-process runs (:func:`_tp_train_ones`); each rank's held, peak and
    collective bytes against the dry-run's account; the smoke world killed
    after step 2 (``killed``, from :func:`start_tp_train_killed`; started
    here when None) and resumed in the world of 2. ``main`` runs it in one
    world with phase 24 (:func:`phase_lm_tp_both`). Returns the kernels'
    path and the router's timings."""
    from repro_torch.launch.mesh import start_local_world

    t_phase = time.perf_counter()
    killed = start_tp_train_killed() if killed is None else killed
    try:
        ones, router = _tp_train_ones(torch, np, dev, train_losses)
    finally:
        smoke = _join_tp_train_killed(killed)
    t0 = time.perf_counter()
    world = start_local_world(tp_train_main, 2, (str(TP_TRAIN_DIR / "ckpt"),),
                              timeout=TP_TRAIN_TIMEOUT)
    recs = _tp_train_dry()              # the host's accounts while the world runs
    w = world.wait()
    paths = _tp_train_checks(torch, np, ones, w, recs, smoke, time.perf_counter() - t0)
    emit("lm_train_tp_wall", seconds=time.perf_counter() - t_phase)
    return paths, router


# --------------------------------------------------------------------------
# Phase 26: FSDP over a world of ranks (sharding.FSDP_RULES: the reference's
# (D, 1) mesh, "batch" and "fsdp" on the world, the experts on an axis of
# size 1): moonshot-v1-16b-a3b at full width and 2 layers, trained under
# "full" for 2 steps at phase 20's 4 x 1,024 tokens (2 rows a rank) beside
# a one-process run at that depth, each rank storing half of every leaf
# the reference's _leaf_spec
# gives an FSDP entry and gathering each block's leaves at use (the remat
# recompute gathers them again; the backward reduce-scatters their
# gradients), its router over the world at a rank's 2,048 tokens; one
# prefill of 4 x 1,024; and the other four fsdp_mode layouts for one step
# each on the smoke config, card == CPU. It runs in phases 24-25's world
# of 2, after phase 25, whose state it frees first.
# --------------------------------------------------------------------------

FSDP_STEPS = 2
# 2 layers: at 4 (phase 20's depth) a step sent 11.1 GB and took 51-61 s
# over gloo on an H100 host, twice the smoke's room (PERF.md, Findings).
FSDP_LAYERS = 2
# Against the one-process run at that depth (the same batches): phase
# 23's bar for a world's losses.
FSDP_LOSS_RTOL = 1e-2
FSDP_PEAK_REL = 0.05
FSDP_TIMEOUT = 300
# A rank's tokens: its 2 rows of 1,024 (the router's kernels at (2,048, 64)).
FSDP_ROUTER_ROWS = LM_TRAIN_BATCH[0] * LM_TRAIN_BATCH[1] // 2
FSDP_SMOKE_MODES = ("zero1", "none", "fsdp_only", "dp_full")
FSDP_SMOKE = dict(batch=(4, 64), seed=3, opt=dict(lr=1e-3, warmup=2))
FSDP_SMOKE_TOL = 1e-5


def _fsdp_smoke_steps(mesh):
    """Phase 26c on every rank of a world of 2 (on the card, or on the CPU
    beside it): one train step of smoke moonshot laid out by each mode of
    FSDP_SMOKE_MODES under ``sharding.rules_for("fsdp", mode)``, float32,
    TF32 off, from weights drawn on the CPU; rank 0 returns each mode's
    loss and grad norm and whether both ranks' are bitwise."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.synth import lm_batch
    from repro_torch.models import lm, model as M, sharding
    from repro_torch.optim import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c, dev, out = FSDP_SMOKE, mesh.device, {}
    for mode in FSDP_SMOKE_MODES:
        cfg, opt = registry.get(LM_ARCH).smoke().replace(fsdp_mode=mode), OptConfig(**c["opt"])
        params = lm.tree_map(lambda t: t.to(dev), M.init(
            cfg, torch.Generator().manual_seed(c["seed"]), device="cpu"))
        batch = {k: v.to(dev) for k, v in lm_batch(cfg, c["batch"], 0, seed=c["seed"],
                                                    device="cpu").items()}
        sharding.set_rules(sharding.rules_for("fsdp", mode), mesh=mesh)
        try:
            params = M.shard_params(cfg, params, mesh)
            state = M.init_opt(cfg, params, opt, mesh)
            _, _, m = M.make_train_step(cfg, opt)(params, state, batch)
        finally:
            sharding.set_rules(None)
        mine = torch.tensor([float(m["loss"]), float(m["grad_norm"])], dtype=torch.float64)
        both = mesh.gather(mine)
        out[mode] = {"loss": float(mine[0]), "grad_norm": float(mine[1]),
                     "ranks_bitwise": bool(torch.equal(both[0], both[1]))}
    return out


def _fsdp_prefill(torch, mesh, dev, cfg):
    """Phase 26b: one prefill of 4 x 1,024 tokens under FSDP "full" (each
    rank its 2 rows), the weights drawn from the seed and cut to the rank's
    blocks: the rank's logits' shape, whether they are finite, rank 0's
    launches, the wall and the bytes sent by kind."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M, sharding

    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(26)
    tokens = torch.randint(0, cfg.vocab, LM_TRAIN_BATCH, generator=g).to(dev)
    sharding.set_rules(sharding.FSDP_RULES, mesh=mesh)
    try:
        params = M.shard_params(cfg, params, mesh)
        torch.cuda.empty_cache()
        mesh.barrier()
        ops.reset_launches()
        bytes0 = dict(mesh.comm_bytes)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = M.make_prefill_step(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sharding.set_rules(None)
    out = {"shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
           "launches": dict(ops.LAUNCHES), "wall_s": wall,
           "comm_bytes": {k: v - bytes0.get(k, 0) for k, v in mesh.comm_bytes.items()}}
    del params, logits
    torch.cuda.empty_cache()
    return out


def fsdp_main(mesh):
    """Phase 26 on every rank of the world of 2 that ran phases 24 and 25:
    phase 25's state freed; moonshot at full width and 4 layers trained for
    FSDP_STEPS under FSDP "full" (``_world_train_full``, its last step
    measured); its prefill (:func:`_fsdp_prefill`); the smoke steps of the
    other modes (:func:`_fsdp_smoke_steps`). Rank 0 returns all, with every
    rank's last-step measurements."""
    import gc

    import torch
    from repro_torch.configs import registry

    gc.collect()
    torch.cuda.empty_cache()
    dev = mesh.device
    cfg = registry.get(LM_ARCH).replace(n_layers=FSDP_LAYERS)
    t0 = time.perf_counter()
    run = _world_train_full(torch, mesh, dev, cfg=cfg, rules="fsdp", steps=FSDP_STEPS)
    run["rank_steps"] = _tp_train_rank_numbers(torch, mesh, run["last_step"])
    run["train_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    prefill = _fsdp_prefill(torch, mesh, dev, cfg)
    prefill["ranks"] = mesh.gather(torch.tensor([prefill["finite"]])).tolist()
    prefill["phase_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    smoke = _fsdp_smoke_steps(mesh)
    return {"train": run, "prefill": prefill, "smoke": smoke,
            "smoke_s": time.perf_counter() - t2}


def _fsdp_dry():
    """Phase 26's dry-run accounts: the train step and the prefill."""
    from repro_torch.configs import registry
    from repro_torch.models import sharding

    cfg = registry.get(LM_ARCH).replace(n_layers=FSDP_LAYERS)
    return {kind: _dry_cell(LM_ARCH, kind, *LM_TRAIN_BATCH, world=2, cfg=cfg,
                            rules=sharding.FSDP_RULES) for kind in ("train", "prefill")}


def _fsdp_one_process(torch, dev):
    """``train()`` of moonshot at FSDP_LAYERS in this process from the seed,
    at phase 20's batch and settings, for FSDP_STEPS: the losses, grad
    norms, step walls and peak; the weights freed after."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.optim import OptConfig

    cfg = registry.get(LM_ARCH).replace(n_layers=FSDP_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    hist = []
    params, opt, _ = train(cfg, OptConfig(**LM_TRAIN_OPT), FSDP_STEPS, seed=0,
                           batch_shape=LM_TRAIN_BATCH, log_every=0, device=dev, history=hist)
    peak = torch.cuda.max_memory_allocated(dev)
    del params, opt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
            "step_wall_s": [r["wall_s"] for r in hist], "peak_gb": peak / 1e9}


def _fsdp_checks(torch, np, one_run, w, recs, cpu_smoke, world_s):
    """Phase 26's checks of the world's results ``w`` (``fsdp_main``'s)
    against the one-process run at the same depth (``one_run``,
    :func:`_fsdp_one_process`'s), the dry-run's accounts ``recs`` and the
    CPU world's smoke steps; returns the kernels' path."""
    from repro_torch.configs import registry

    cfg = registry.get(LM_ARCH).replace(n_layers=FSDP_LAYERS)
    t = w["train"]
    one = list(one_run["losses"])
    rel = [abs(a - b) / abs(b) for a, b in zip(t["losses"], one)]
    per_step = {"scd_fused_hist": 2 * cfg.moe.scd_iters * FSDP_LAYERS,
                "adjusted_topc": 2 * FSDP_LAYERS}
    routed = {name: 0 for name in t["launches"]}
    routed.update({k: v * FSDP_STEPS for k, v in per_step.items()})
    together = sum(r["peak_gb"] for r in t["ranks"])
    facts = {"finite": all(np.isfinite(t["losses"])) and all(np.isfinite(t["grad_norms"])),
             "ranks_bitwise": t["ranks_bitwise"],
             "losses_within_one_process": len(rel) == FSDP_STEPS
             and max(rel) <= FSDP_LOSS_RTOL,
             "launches_as_routed": t["launches"] == routed,
             "peaks_together_under_80gb": together < 80.0}
    emit("lm_train_fsdp", arch=LM_ARCH, layers=FSDP_LAYERS, world=2, rules="fsdp",
         fsdp_mode="full", batch=LM_TRAIN_BATCH, steps=FSDP_STEPS, opt=LM_TRAIN_OPT,
         losses=t["losses"], one_process_losses=one, loss_rel=rel, loss_rtol=FSDP_LOSS_RTOL,
         one_process_grad_norms=one_run["grad_norms"],
         one_process_step_wall_s=one_run["step_wall_s"],
         one_process_peak_gb=one_run["peak_gb"],
         grad_norms=t["grad_norms"], lrs=t["lrs"], step_wall_s=t["step_wall_s"],
         train_wall_s=t["train_wall_s"], rank0_comm_s_by_kind=t["comm_s_by_kind"],
         ranks=t["ranks"], peak_gb_together=together, rank0_launches=t["launches"],
         launches_per_step=per_step, phase_s=t["train_s"], **facts)
    check(all(facts.values()), f"moonshot trained under FSDP: {facts} {t['launches']}")
    for r, m in enumerate(t["rank_steps"]):
        _dry_vs_card(f"{LM_ARCH}_train_{FSDP_LAYERS}_layers_fsdp_world2_rank{r}",
                     recs["train"], t["last_step"]["launches"] if r == 0 else None,
                     m["held"], m["rise"], m["raw_peak"], comm=m["comm"], bar=FSDP_PEAK_REL)

    p = w["prefill"]
    want = {k: v["launches"] for k, v in recs["prefill"]["kernels"].items()}
    facts = {"finite": all(x for row in p["ranks"] for x in row),
             "shape": p["shape"] == [LM_TRAIN_BATCH[0] // 2, cfg.vocab],
             "launches_equal_dryrun": {k: v for k, v in p["launches"].items() if v} == want,
             "comm_bytes_equal_dryrun": recs["prefill"]["collectives"]["bytes"]
             == {k: v for k, v in p["comm_bytes"].items() if v}}
    emit("lm_prefill_fsdp", arch=LM_ARCH, layers=FSDP_LAYERS, world=2, rules="fsdp",
         batch=LM_TRAIN_BATCH, rank_logits_shape=p["shape"], wall_s=p["wall_s"],
         rank0_launches=p["launches"], comm_bytes=p["comm_bytes"],
         dryrun_comm_bytes=recs["prefill"]["collectives"]["bytes"], **facts)
    check(all(facts.values()), f"moonshot's prefill under FSDP: {facts}")

    rows, ok = [], True
    for mode in FSDP_SMOKE_MODES:
        card, cpu = w["smoke"][mode], cpu_smoke[mode]
        good = (card["ranks_bitwise"]
                and abs(card["loss"] - cpu["loss"]) <= FSDP_SMOKE_TOL * (1 + abs(cpu["loss"]))
                and abs(card["grad_norm"] - cpu["grad_norm"])
                <= FSDP_SMOKE_TOL * (1 + abs(cpu["grad_norm"])))
        ok = ok and good
        rows.append({"mode": mode, "card": card, "cpu": cpu, "within": good})
    emit("lm_train_fsdp_modes", arch=LM_ARCH, config="smoke", world=2, rules="fsdp",
         tol=FSDP_SMOKE_TOL, modes=rows, wall_s=w["smoke_s"], world_wall_s=world_s)
    check(ok, f"the smoke config's FSDP modes, card against CPU: {rows}")
    return {"lm_train_fsdp": t["launches"]}


# --------------------------------------------------------------------------
# Phase 27: MLA, Mamba2 and the encoder-decoder under tensor and sequence
# parallelism (sharding.PRODUCTION_RULES) in the world of 2 of phases
# 24-26, at full width: mamba2-370m and seamless-m4t-medium uncut (served
# and trained 2 steps), jamba-v0.1-52b at one period and deepseek-v2-236b
# at block0 and 2 MoE layers (served; their routers at a rank's 2,048
# tokens, K = 16 and 160), each against one process on the card; then
# deepseek's and jamba's smoke train steps on the card world against a CPU
# world (neither trains at full width on one card).
# --------------------------------------------------------------------------

MIX_TP = {MIX_SSM: 48, MIX_ENCDEC: 12, MIX_HYBRID: 8, MLA_ARCH: 2}    # arch: layers
# Decode steps and cache length: deepseek's latent cache split by position,
# 2 a rank, so steps 2 and 3 write rank 1's block, empty before; seamless's
# of 2,048, the decode cell to which the dry-run gives phase 21's 1,024
# frames (model._frames_len); mamba2's state has no positions; jamba's KV
# heads split.
MIX_TP_DECODE = {MIX_SSM: (4, 256), MIX_ENCDEC: (4, 2 * MIX_FRAMES), MIX_HYBRID: (4, 256),
                 MLA_ARCH: (4, 4)}
MIX_TP_TRAIN = (MIX_SSM, MIX_ENCDEC)    # at phase 21's batches and settings
MIX_TP_STEPS = 2
MIX_TP_SMOKE = (MLA_ARCH, MIX_HYBRID)
MIX_TP_SMOKE_RUN = dict(batch=(4, 64), seed=3, opt=dict(lr=1e-3, warmup=2))
MIX_TP_TIMEOUT = 300
# Against one process on the card in bf16: phase 24's bar, jamba's phase
# 21's (its top-2 of 16 experts flips where two affinities sit within the
# bf16 rounding: ROADMAP C).
MIX_TP_REL = {MIX_SSM: TP_REL, MIX_ENCDEC: TP_REL, MIX_HYBRID: 0.3, MLA_ARCH: TP_REL}
MIX_TP_LOSS_RTOL = 1e-2
MIX_TP_PEAK_REL = TP_PEAK_REL
MIX_TP_SMOKE_TOL = FSDP_SMOKE_TOL
# A rank's tokens under "seq": its block of the prefill's 4 x 1,024.
MIX_TP_ROUTER_ROWS = MIX_PREFILL[0] * MIX_PREFILL[1] // 2
MIX_TP_PATHS = {MIX_HYBRID: "lm_prefill_hybrid_tp", MLA_ARCH: "lm_prefill_mla_tp"}


def _mix_tp_cfg(arch):
    from repro_torch.configs import registry
    return registry.get(arch).replace(n_layers=MIX_TP[arch])


def _mix_tp_one(torch, np, dev, arch):
    """Phase 27's one-process run of ``arch`` at its MIX_TP depth on the card
    (jamba's and deepseek's: phases 21 and 22 run other depths): the
    prefill's logits and MIX_TP_DECODE's decode steps from the seed; the
    weights freed after."""
    from repro_torch.models import model as M

    cfg = _mix_tp_cfg(arch)
    torch.cuda.empty_cache()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = _mix_batch(torch, np, cfg, dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = M.make_prefill_step(cfg)(params, batch).float().cpu()
        prefill_s = time.perf_counter() - t0
    dec = _decode_steps(torch, M, params, cfg, batch, *MIX_TP_DECODE[arch])
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"logits": logits, "decode": dec, "prefill_s": prefill_s}


def _mix_smoke_steps(mesh):
    """Phase 27c on every rank of a world of 2 (on the card, or on the CPU
    beside it): one train step of smoke deepseek and jamba under the
    production rules, float32, TF32 off, from weights drawn on the CPU;
    rank 0 returns each arch's loss and grad norm and whether both ranks'
    are bitwise."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.synth import lm_batch
    from repro_torch.models import lm, model as M, sharding
    from repro_torch.optim import OptConfig, init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c, dev, out = MIX_TP_SMOKE_RUN, mesh.device, {}
    for arch in MIX_TP_SMOKE:
        cfg, opt = registry.get(arch).smoke(), OptConfig(**c["opt"])
        params = lm.tree_map(lambda t: t.to(dev), M.init(
            cfg, torch.Generator().manual_seed(c["seed"]), device="cpu"))
        batch = {k: v.to(dev) for k, v in lm_batch(cfg, c["batch"], 0, seed=c["seed"],
                                                    device="cpu").items()}
        sharding.set_rules(sharding.PRODUCTION_RULES, mesh=mesh)
        try:
            params = M.shard_params(cfg, params, mesh)
            _, _, m = M.make_train_step(cfg, opt)(params, init_opt_state(params, opt), batch)
        finally:
            sharding.set_rules(None)
        mine = torch.tensor([float(m["loss"]), float(m["grad_norm"])], dtype=torch.float64)
        both = mesh.gather(mine)
        out[arch] = {"loss": float(mine[0]), "grad_norm": float(mine[1]),
                     "ranks_bitwise": bool(torch.equal(both[0], both[1]))}
    return out


def cpu_smoke_steps(mesh):
    """Phases 26c and 27c on a CPU world of 2 beside the card's."""
    return {"fsdp": _fsdp_smoke_steps(mesh), "mix": _mix_smoke_steps(mesh)}


def mix_tp_main(mesh):
    """Phase 27 on every rank of the world of 2 that ran phases 24-26: for
    each arch of MIX_TP, :func:`_tp_arch` at phase 21's batch; mamba2's and
    seamless's MIX_TP_STEPS train steps under the production rules at phase
    21's batches (``_world_train_full``, its last step measured); the smoke
    train steps (:func:`_mix_smoke_steps`)."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    dev, out = mesh.device, {}
    for arch in MIX_TP:
        cfg = _mix_tp_cfg(arch)
        t0 = time.perf_counter()
        out[arch] = _tp_arch(torch, mesh, dev, cfg, _mix_batch(torch, np, cfg, dev),
                             *MIX_TP_DECODE[arch], again=False)
        out[arch]["wall_s"] = time.perf_counter() - t0
    for arch in MIX_TP_TRAIN:
        t0 = time.perf_counter()
        run = _world_train_full(torch, mesh, dev, cfg=_mix_tp_cfg(arch), rules="production",
                                steps=MIX_TP_STEPS, batch_shape=MIX_TRAIN_BATCH[arch])
        run["rank_steps"] = _tp_train_rank_numbers(torch, mesh, run["last_step"])
        run["phase_s"] = time.perf_counter() - t0
        out["train_" + arch] = run
    t0 = time.perf_counter()
    out["smoke"] = _mix_smoke_steps(mesh)
    out["smoke_s"] = time.perf_counter() - t0
    return out


def _mix_tp_dry():
    """Phase 27's dry-run accounts: each arch's prefill and decode cells,
    mamba2's and seamless's train cells."""
    from repro_torch.models import sharding

    recs = {}
    for arch in MIX_TP:
        cfg = _mix_tp_cfg(arch)
        # an encoder-decoder's cell splits its positions into frames and
        # tokens, half each (model._frames_len): phase 21's 1,024 of each
        b, s = MIX_PREFILL[0], MIX_PREFILL[1] + (MIX_FRAMES if cfg.kind == "encdec" else 0)
        recs[arch] = {kind: _dry_cell(arch, kind, b, s if kind == "prefill"
                                      else MIX_TP_DECODE[arch][1], world=2, cfg=cfg,
                                      rules=sharding.PRODUCTION_RULES)
                      for kind in ("prefill", "decode")}
        if arch in MIX_TP_TRAIN:
            recs[arch]["train"] = _dry_cell(arch, "train", *MIX_TRAIN_BATCH[arch], world=2,
                                            cfg=_mix_tp_cfg(arch),
                                            rules=sharding.PRODUCTION_RULES)
    return recs


def _mix_tp_checks(torch, np, ones, w, recs, cpu_smoke, world_s):
    """Phase 27's checks of the world's results ``w`` (``mix_tp_main``'s)
    against the one-process runs ``ones``, the dry-run's accounts ``recs``
    and the CPU world's smoke steps; returns the kernels' paths."""
    paths = {}
    for arch in MIX_TP:
        cfg, one, got = _mix_tp_cfg(arch), ones[arch], w[arch]
        n_steps, cache_len = MIX_TP_DECODE[arch]
        rel_p = _rel_l2(torch, got["logits"], one["logits"])
        rel_d = _rel_l2(torch, got["decode"], one["decode"])
        r0 = got["ranks"][0]
        routed = {name: 0 for name in r0["prefill"]["launches"]}
        if cfg.moe.n_experts:
            moe_layers = cfg.ffn_pattern.count("moe") * cfg.n_periods
            routed.update(scd_fused_hist=cfg.moe.scd_iters * moe_layers,
                          adjusted_topc=moe_layers)
        together = sum(max(r["prefill"]["raw_peak"], r["decode"]["raw_peak"])
                       for r in got["ranks"]) / 1e9
        facts = {"finite": bool(torch.isfinite(got["logits"]).all()
                                and torch.isfinite(got["decode"]).all()),
                 "shapes": tuple(got["logits"].shape) == tuple(one["logits"].shape)
                 and tuple(got["decode"].shape) == tuple(one["decode"].shape),
                 "ranks_bitwise": got["ranks_bitwise"],
                 "launches_as_routed": r0["prefill"]["launches"] == routed,
                 "prefill_rel_l2_within": float(rel_p.max()) <= MIX_TP_REL[arch],
                 "decode_rel_l2_within": float(rel_d.max()) <= MIX_TP_REL[arch],
                 "peaks_together_under_80gb": together < 80.0}
        emit(f"lm_tp_mix_{arch}", arch=arch, layers=cfg.n_layers, world=2, rules="production",
             batch=MIX_PREFILL[0], seq=MIX_PREFILL[1],
             frames=MIX_FRAMES if cfg.kind == "encdec" else None, decode_steps=n_steps,
             cache_len=cache_len, wall_s=got["wall_s"], world_wall_s=world_s,
             ranks=[{k: v for k, v in r.items() if k not in ("prefill", "decode")}
                    for r in got["ranks"]],
             one_process_prefill_s=one.get("prefill_s"), rank0_launches=r0["prefill"]["launches"],
             prefill_rel_l2_max=float(rel_p.max()), prefill_rel_l2_median=float(rel_p.median()),
             decode_rel_l2_max=float(rel_d.max()), decode_rel_l2_median=float(rel_d.median()),
             bound=MIX_TP_REL[arch], prefill_peaks_together_gb=together, **facts)
        check(all(facts.values()), f"{arch} under the production rules: {facts}")
        for r, mine in enumerate(got["ranks"]):
            for kind in ("prefill", "decode"):
                m = mine[kind]
                _dry_vs_card(f"{arch}_{cfg.n_layers}_layers_tp_world2_rank{r}_{kind}",
                             recs[arch][kind], m["launches"] if r == 0 else None, m["held"],
                             m["rise"], m["raw_peak"], comm=m["comm"], bar=MIX_TP_PEAK_REL)
        if arch in MIX_TP_PATHS:
            paths[MIX_TP_PATHS[arch]] = r0["prefill"]["launches"]

    for arch in MIX_TP_TRAIN:
        t, cfg = w["train_" + arch], _mix_tp_cfg(arch)
        one = ones[arch]["losses"][:MIX_TP_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(t["losses"], one)]
        together = sum(r["peak_gb"] for r in t["ranks"])
        facts = {"finite": all(np.isfinite(t["losses"])) and all(np.isfinite(t["grad_norms"])),
                 "ranks_bitwise": t["ranks_bitwise"],
                 "losses_within_one_process": len(rel) == MIX_TP_STEPS
                 and max(rel) <= MIX_TP_LOSS_RTOL,
                 "peaks_together_under_80gb": together < 80.0}
        emit(f"lm_train_tp_mix_{arch}", arch=arch, layers=cfg.n_layers, world=2,
             rules="production", batch=MIX_TRAIN_BATCH[arch], steps=MIX_TP_STEPS,
             opt=LM_TRAIN_OPT, losses=t["losses"], one_process_losses=one, loss_rel=rel,
             loss_rtol=MIX_TP_LOSS_RTOL, grad_norms=t["grad_norms"],
             step_wall_s=t["step_wall_s"], train_wall_s=t["train_wall_s"],
             rank0_comm_s_by_kind=t["comm_s_by_kind"], ranks=t["ranks"],
             peak_gb_together=together, phase_s=t["phase_s"], **facts)
        check(all(facts.values()), f"{arch} trained under the production rules: {facts}")
        for r, m in enumerate(t["rank_steps"]):
            _dry_vs_card(f"{arch}_train_{cfg.n_layers}_layers_tp_world2_rank{r}",
                         recs[arch]["train"], t["last_step"]["launches"] if r == 0 else None,
                         m["held"], m["rise"], m["raw_peak"], comm=m["comm"],
                         bar=MIX_TP_PEAK_REL)

    rows, ok = [], True
    for arch in MIX_TP_SMOKE:
        card, cpu = w["smoke"][arch], cpu_smoke[arch]
        good = (card["ranks_bitwise"]
                and abs(card["loss"] - cpu["loss"]) <= MIX_TP_SMOKE_TOL * (1 + abs(cpu["loss"]))
                and abs(card["grad_norm"] - cpu["grad_norm"])
                <= MIX_TP_SMOKE_TOL * (1 + abs(cpu["grad_norm"])))
        ok = ok and good
        rows.append({"arch": arch, "card": card, "cpu": cpu, "within": good})
    emit("lm_train_tp_mix_smoke", config="smoke", world=2, rules="production",
         tol=MIX_TP_SMOKE_TOL, archs=rows, wall_s=w["smoke_s"], world_wall_s=world_s)
    check(ok, f"the smoke configs' train steps under the production rules, card against "
              f"CPU: {rows}")
    return paths


def tp_main(mesh, killed_dir):
    """Phases 24, 25, 26 and 27 on every rank of one world of 2 (one world's
    start for all four): ``tp_lm_main``, ``tp_train_main``, ``fsdp_main``,
    then ``mix_tp_main``; rank 0 returns them and the seconds of each."""
    t0 = time.perf_counter()
    out = {"tp": tp_lm_main(mesh)}
    out["tp_s"] = time.perf_counter() - t0
    out["train"] = tp_train_main(mesh, killed_dir)
    out["train_s"] = time.perf_counter() - t0 - out["tp_s"]
    t1 = time.perf_counter()
    out["fsdp"] = fsdp_main(mesh)
    out["fsdp_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["mix"] = mix_tp_main(mesh)
    out["mix_s"] = time.perf_counter() - t1
    return out


def phase_lm_tp_both(torch, np, dev, one_moonshot, train_losses, killed, ones21):
    """Phases 24, 25, 26 and 27 as ``main`` runs them: the one-process runs
    on the card (phase 27's: ``ones21``, mamba2's and seamless's from phase
    21, and jamba's and deepseek's at their depth here) and the routers'
    kernels at a rank's tokens, the killed smoke world (started before
    phase 23) joined, then one world of 2 runs :func:`tp_main` while this
    process accounts the dry-run's cells and a CPU world of 2 runs phases
    26's and 27's smoke steps; then each phase's checks. Returns the
    kernels' paths, the routers' timings and the world's seconds."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import start_local_world

    t_phase = time.perf_counter()
    try:
        ones24 = _tp_ones(torch, np, dev, one_moonshot)
        ones25, router = _tp_train_ones(torch, np, dev, train_losses)
        # 26a: the router's kernels at a rank's tokens under FSDP, and the
        # one-process run at phase 26's depth
        router26 = _lm_router(torch, np, dev, registry.get(LM_ARCH),
                              tag="lm_train_fsdp_router", n=FSDP_ROUTER_ROWS)
        one26 = _fsdp_one_process(torch, dev)
        # 27a: the routers' kernels at a rank's tokens, K = 16 and 160, and
        # the one-process runs at phase 27's depths
        routers27 = {arch: _lm_router(torch, np, dev, _mix_tp_cfg(arch),
                                      tag=f"lm_tp_router_{MIX_TP_PATHS[arch]}",
                                      n=MIX_TP_ROUTER_ROWS) for arch in MIX_TP_PATHS}
        ones27 = {**{arch: _mix_tp_one(torch, np, dev, arch) for arch in MIX_TP
                     if arch not in ones21}, **ones21}
    finally:
        smoke = _join_tp_train_killed(killed)
    t0 = time.perf_counter()
    world = start_local_world(tp_main, 2, (str(TP_TRAIN_DIR / "ckpt"),),
                              timeout=TP_TIMEOUT + TP_TRAIN_TIMEOUT + FSDP_TIMEOUT
                              + MIX_TP_TIMEOUT)
    cpu = start_local_world(cpu_smoke_steps, 2, device="cpu", timeout=FSDP_TIMEOUT)
    recs24, recs25, recs26 = _tp_dry(), _tp_train_dry(), _fsdp_dry()
    recs27 = _mix_tp_dry()
    cpu_smoke = cpu.wait()
    w = world.wait()
    world_s = time.perf_counter() - t0
    paths = _tp_checks(torch, np, ones24, w["tp"], recs24, w["tp_s"])
    emit("lm_tp_wall", seconds=w["tp_s"], world_wall_s=world_s)
    paths.update(_tp_train_checks(torch, np, ones25, w["train"], recs25, smoke, w["train_s"]))
    emit("lm_train_tp_wall", seconds=w["train_s"], world_wall_s=world_s)
    paths.update(_fsdp_checks(torch, np, one26, w["fsdp"], recs26, cpu_smoke["fsdp"],
                              world_s))
    emit("lm_train_fsdp_wall", seconds=w["fsdp_s"], world_wall_s=world_s)
    paths.update(_mix_tp_checks(torch, np, ones27, w["mix"], recs27, cpu_smoke["mix"],
                                world_s))
    emit("lm_tp_mix_wall", seconds=w["mix_s"], world_wall_s=world_s,
         phases_24_27_s=time.perf_counter() - t_phase)
    return paths, router, router26, routers27, world_s


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib, log = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "Compiling entry" in line or "spill" in line]
    emit("env", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         library=lib.name, ptxas=ptxas)

    kern = phase_kernels(torch, np, dev)
    phase_determinism_and_cpu(torch, np, dev)
    host_fed_launches, host_fed_row = phase_end_to_end(torch, dev)
    HOST_RESULTS["table1"] = host_fed_row
    paths = {"host_fed": host_fed_launches}
    new_kern, fused_resident = phase_resident_kernels(torch, np, dev)
    kern.update(new_kern)
    kern["scd_fused_hist"]["resident_shape"] = fused_resident
    paths.update(phase_resident_end_to_end(torch, dev, host_fed_row))
    paths.update(phase_dense_end_to_end(torch, dev))
    phase_contracts(torch, dev)
    phase_slice3_contracts(torch, np, dev)
    kern.update(phase_slice3_kernels(torch, np, dev))
    paths.update(phase_screened_end_to_end(torch, dev))
    paths.update(phase_dd_end_to_end(torch, dev))
    paths.update(phase_slots(torch, np, dev))
    streamed_paths, kern["bucket_hist"]["legacy_shape"] = phase_streamed(torch, np, dev)
    paths.update(streamed_paths)
    paths.update(phase_serving(torch, np, dev))
    paths.update(phase_operations(torch, np, dev))
    paths.update(phase_world(torch, np, dev))
    paths.update(phase_world_serving(torch, np, dev))
    lm_paths, lm_kern = phase_lm_serving(torch, np, dev)
    paths.update(lm_paths)
    kern["scd_fused_hist"]["router_shape"] = lm_kern["scd_fused_hist"]
    kern["adjusted_topc"]["router_shape"] = lm_kern["adjusted_topc"]
    cli = start_lm_train_cli()
    try:
        train_paths, train_losses = phase_lm_training(torch, np, dev)
        paths.update(train_paths)
        mix_paths, mix_kern, ones21 = phase_lm_mixers(torch, np, dev)
        paths.update(mix_paths)
    except BaseException:
        stop_lm_train_cli(cli)
        raise
    finish_lm_train_cli(cli)
    kern["scd_fused_hist"]["router_shape_k16"] = mix_kern["scd_fused_hist"]
    kern["adjusted_topc"]["router_shape_k16"] = mix_kern["adjusted_topc"]
    mla_paths, mla_kern = phase_lm_mla(torch, np, dev)
    paths.update(mla_paths)
    kern["scd_fused_hist"]["router_shape_k160"] = mla_kern["scd_fused_hist"]
    kern["adjusted_topc"]["router_shape_k160"] = mla_kern["adjusted_topc"]
    killed = start_tp_train_killed()    # phase 25's, beside phase 23
    world_paths, one_moonshot = phase_lm_world(torch, np, dev, train_losses)
    paths.update(world_paths)
    t_tp = time.perf_counter()
    tp_paths, tp_router, fsdp_router, mix_routers, tp_world_s = phase_lm_tp_both(
        torch, np, dev, one_moonshot, train_losses, killed, ones21)
    kern["scd_fused_hist"]["router_shape_tp"] = tp_router["scd_fused_hist"]
    kern["adjusted_topc"]["router_shape_tp"] = tp_router["adjusted_topc"]
    kern["scd_fused_hist"]["router_shape_fsdp"] = fsdp_router["scd_fused_hist"]
    kern["adjusted_topc"]["router_shape_fsdp"] = fsdp_router["adjusted_topc"]
    for arch, k in ((MIX_HYBRID, "k16"), (MLA_ARCH, "k160")):
        for name in ("scd_fused_hist", "adjusted_topc"):
            kern[name][f"router_shape_tp_{k}"] = mix_routers[arch][name]
    paths.update(tp_paths)
    tp_s = time.perf_counter() - t_tp

    rows = [{"name": name, "route": "cuda", "source": SOURCE[name],
             "replaces": REPLACES[name],
             "launches": sum(p[name] for p in paths.values()),
             "launches_by_path": {path: p[name] for path, p in paths.items()},
             **kern[name]}
            for name in REPLACES]
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} was launched on no path")
    wall = time.perf_counter() - T_START
    phase5_s = HOST_RESULTS["table1"]["wall_s"]
    fast = phase5_s <= FAST_HOST_PHASE5_S
    emit("smoke_wall", seconds=wall, budget_s=SMOKE_BUDGET_S,
         within_budget=wall <= SMOKE_BUDGET_S, phase5_s=phase5_s, fast_host=fast, dryrun_s=DRY_S[0], lm_tp_s=tp_s,
         lm_tp_world_s=tp_world_s)
    check(wall <= SMOKE_BUDGET_S or not fast,
          f"the smoke took {wall:.1f} s on a fast host (phase 5 {phase5_s:.1f} s), over its "
          f"{SMOKE_BUDGET_S} s budget")
    if wall > SMOKE_BUDGET_S:
        print(f"chip_smoke: {wall:.1f} s, over the {SMOKE_BUDGET_S} s budget on a slow host "
              f"(phase 5 {phase5_s:.1f} s)", file=sys.stderr, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
