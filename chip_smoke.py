#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card, nvcc and PyTorch built for CUDA. It builds the
kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source, side
by side) and runs these phases, each printing one JSON line; any failed
check raises, so the script exits non-zero and prints no result line:

1. environment: the card, its power limit, torch/CUDA versions, build time;
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
8. dense end to end: ``dense_instance`` n = 100,000, M = 10, K = 10, C223,
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
13. the slot solve (``slots=4``) at table1's full width, N = 10^7, chunk
   65,536 (153 chunks, 39 columns, 3 inert chunk slots): uninterrupted,
   with ``scd_fused_hist`` launched iters x 4 x 39 times and
   ``scd_finalize_hist`` 4 x 39, feasible, within tolerance of phase 5;
   checkpointed every 4 iterations and columns with a ``Tracer`` journal,
   bitwise equal, with the journal's spans and at most ``checkpoint_keep``
   states left; SIGKILLed mid-iterate in a fresh interpreter and resumed
   here, bitwise equal; from the oldest state the checkpointed solve left,
   resumed and SIGKILLed between finalize columns in a fresh interpreter,
   then resumed here, bitwise equal, reading exactly the fingerprint probe
   and the real chunks of the columns left; at N = 10^6 a ``FaultPlan`` run (drops,
   corruption, ``verify_refetch``) bitwise the clean one and an exhausting
   plan raising ``ChunkFetchError`` naming the chunk; at n = 262,144 the
   card's SCD, screened banded, DD and presolve slot solves bitwise the
   CPU's (the screened profile too); walls, the per-epoch split and the
   cost of a save;
14. the device-streamed driver (``core/chunked.solve_streaming``): table1
   generated on the card (``data/synth.sparse_chunk_source``) through the
   launcher at N = 10^7 and uncut at 10^8, chunk 65,536, with the wall,
   iterations, primal, dual, ``max_violation``, the launches per solve
   (``scd_fused_hist`` iters x chunks, the finalize once a chunk, nothing
   else) and the peak device memory at both sizes, which must stay flat;
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
   N = 2^22, 3 generations): warm iterations below cold, 512 lookups
   bitwise ``decisions_chunk``, batched and single QPS; a warm refresh
   SIGKILLed in a fresh interpreter and recovered here, its record bitwise
   the uninterrupted one; ``run_chaos`` at n = 262,144 (chaos == clean);
   and the card's generation records bitwise the CPU's there;
16. operations at the serving shape (N = 2^22, 8 slots, 3 generations):
   ``launch/supervisor.run_chaos_soak``, its references in this process
   and the supervised solve and refresh in worker processes on the card
   under one SIGKILL and one SIGSTOP each plus a fetch-level fault plan,
   both records bitwise the references', the poisoned task contained in
   ``FAILED.json`` with LIVE unmoved, the exercised counters (no degrade
   on one card), recovery times and the card's free memory before and
   after; then ``launch/front.run_front_scenario`` with 2 replica processes
   on the card under concurrent ``/decide_batch`` traffic while the engine
   refreshes with ``keep=2``: every answered row bitwise the
   materialisation of the generation that answered it, ``/diff`` the
   brute-force comparison at one grouped fill pass per replica and zero on
   the repeat, lookups per second and the p50/p99 of ``/decide``;
17. the ``kernels`` line (launches summed over the paths run in phases 5,
   7, 8, 11, 12, 13, 14, 15 and 16, with the split), the card's
   ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.
"""
import json
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
C_MAIN, K, Q_MAIN = 65536, 10, 1
N_RES = 10_000_000                 # table1 at --scale 0.1
DENSE_N, DENSE_M = 100_000, 10     # Figure 1 (C223, mixed b) at 100x its N
CSRC = "src/repro_torch/kernels/csrc/"
N_HOST_DD = 1_000_000               # host-fed DD
BANDED = dict(k=6, q=2, tightness=0.08, band=0.05)   # benchmarks/bench_screening.py
FIN_TILE = 512                      # ops.pick_tile at a 65,536-row chunk
SLOTS, CKPT_EVERY = 4, 4            # the slot phase: 39 columns, 156 chunk slots
N_FAULTS = 1_000_000                # the fault-layer run of the slot phase
N_VS_CPU = 262_144                  # card against CPU (phases 4, 9 and 13)
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
N_SERVE, SERVE_SLOTS, SERVE_GENS = 1 << 22, 8, 3   # 64 chunks, cut from 10^8
SERVE_CKPT_EVERY = 2
# Phase 16: the soak's kill/stop thresholds on the lease's progress (chunk
# reads, two a fetch under verify_refetch): 1-3.5 epochs of 64 chunks,
# inside the first worker life of a cold solve of ~10 epochs (1,280 reads)
# at phase 15's ladder (bucket_half 24; the soak's 16 runs to max_iters).
SOAK_LO, SOAK_HI = 128, 448
FRONT_REPLICAS, FRONT_DIFF_STRIDE = 2, 64   # /diff asks about 65,536 users
HOST_RESULTS = {}                   # host-fed results later phases compare against


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def bound(bytes_, ops):
    """Least time in ms for this work, and what bounds it."""
    tb, to = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


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
    from repro_torch.kernels import ops, ref
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
    rec_f, rec_g = ref.fused_layout(K, e)[0], ref.finalize_layout(K, ep, True)[0]
    read = 4 * (2 * C_MAIN * K + K)
    timing = {
        "scd_fused_hist": (
            lambda: ops.scd_fused_hist(p, b, lam, edges, Q_MAIN, **fs),
            lambda: ref.scd_fused_hist_plain(p, b, lam, edges, Q_MAIN, **fs),
            bound(read + 4 * (K * e + 2 * rec_f),
                  C_MAIN * K * (8 + e + Q_MAIN + 1))),
        "scd_finalize_hist": (
            lambda: ops.scd_finalize_hist(p, b, lam, pedges, Q_MAIN, tile_n=FIN_TILE,
                                          **gs),
            lambda: ref.scd_finalize_plain(p, b, lam, pedges, Q_MAIN, tile_n=FIN_TILE,
                                           **gs),
            bound(read + 4 * (ep + 2 * rec_g),
                  C_MAIN * K * (5 + Q_MAIN) + C_MAIN * (ep + K + 1))),
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
                   bound(4 * (2 * n1 * K + K) + 4 * (ep + 2 * rec_g),
                         n1 * K * (5 + Q_MAIN) + n1 * (ep + K + 1))))}
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
    from repro_torch.kernels import ops, ref
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
                       bound(4 * (4 * N_RES * k + k), N_RES * k * (11 + 2 * Q_MAIN))))}

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
                   bound(4 * (2 * N_RES * K + K + K * e + 2 * (K * (e + 1) + K)),
                         N_RES * K * (8 + e + Q_MAIN + 1))))}
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
                   bound(4 * (2 * nrows * K + K * e + 2 * K * (e + 1)),
                         nrows * K * (e + 1)))),
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
    """Figure 1's dense setup at n = 10^5, sync bucketed, chunked and not."""
    from repro_torch.core import solver
    from repro_torch.core.instances import dense_instance
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops

    kp = dense_instance(0, DENSE_N, DENSE_M, K, local="C223", mixed_b=True, device=dev)
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
    emit("dense_end_to_end", n=DENSE_N, m=DENSE_M, k=K, local="C223", mixed_b=True,
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
    from repro_torch.kernels import ops, ref
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
                   bound(4 * (2 * C_MAIN * kb + kb), 2 * C_MAIN * kb))),
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
                   bound(4 * (2 * N_RES * K + K) + 5 * N_RES * K,
                         N_RES * K * (2 + 2 * Q_MAIN)))),
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
        "bound_ms": bound(4 * (2 * C_MAIN * K + K) + 5 * C_MAIN * K,
                          C_MAIN * K * (2 + 2 * Q_MAIN))[0]}
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


def run_killed(ckpt_dir, kill_after, resume):
    """The slot solve in a fresh interpreter, SIGKILLed at its
    (kill_after + 1)-th chunk read; returns its wall."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _KILL_CHILD, str(ROOT / "src"),
                          str(N_RES), str(kill_after), str(ckpt_dir),
                          "1" if resume else "0", str(C_MAIN), str(CKPT_EVERY),
                          str(SLOTS)], capture_output=True, text=True, timeout=600)
    check(out.returncode == -signal.SIGKILL,
          f"the killed solve ended with {out.returncode}: {out.stderr[-3000:]}")
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


def phase_slots(torch, np, dev, host_fed_row):
    """The slot solve at table1's full width, checkpointed, killed and
    resumed, under faults, and on the card against the CPU (phase 13)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import prefetch as tpf
    from repro_torch.core.faults import ChunkFetchError, FaultPlan, faulty_source
    from repro_torch.core.faults import process_registry
    from repro_torch.core.types import SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, read_trace

    src, q = table1_source(N_RES)
    budgets = torch.as_tensor(src.budgets)
    c = -(-N_RES // C_MAIN)
    cps = -(-c // SLOTS)
    cfg = SolverConfig(max_iters=40)
    ckpt_cfg = cfg.replace(checkpoint_every=CKPT_EVERY)
    work = ROOT / "build" / "smoke_slots"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def solve(source, config, device=dev, **kw):
        t0 = time.perf_counter()
        res = tpf.solve_streaming_host(source, config, q=q, slots=SLOTS, device=device,
                                       **kw)
        return res, time.perf_counter() - t0

    # 1. Uninterrupted, counted.
    stats = tpf.FeedStats()
    ops.reset_launches()
    base, wall = solve(src, cfg, stats=stats)
    launches = dict(ops.LAUNCHES)
    iters = base.iters
    m = solve_metrics(torch, base, budgets)
    single = {"lam": np.asarray(host_fed_row["lam"], np.float32),
              "iters": host_fed_row["iterations"], "primal": host_fed_row["primal"],
              "dual": host_fed_row["dual"]}
    lam_diff = np.abs(base.lam.numpy() - single["lam"])
    it = [e for e in stats.epochs if e["kind"] == "iterate"]
    keys = ("fetch_s", "stage_s", "h2d_ms", "step_ms", "wall_s")
    emit("slots_end_to_end", workload="table1", n=N_RES, chunk=C_MAIN, slots=SLOTS,
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
    # 1e-5. Beside it, the grouping floor: the single-slot solve (the
    # resident one, bitwise it at the default tile) with only its map tile
    # changed.
    from repro_torch.core.instances import sparse_instance
    from repro_torch.core.solver import solve as solve_resident
    from repro_torch.configs.paper_kp import WORKLOADS
    kp, _ = sparse_instance(0, N_RES, src.k, q, tightness=WORKLOADS["table1"].tightness,
                            device=dev, chunk=C_MAIN)
    tiles = {t: solve_resident(kp, cfg.replace(kernel_tile=t), q=q, device=dev)
             for t in (8192, 4096, 16384)}
    del kp
    check(tiles[8192].iters == single["iters"]
          and np.array_equal(tiles[8192].lam.numpy(), single["lam"]),
          "the resident solve at the default tile differs from phase 5's")
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
          "the slots=4 solve is not within tolerance of phase 5's single slot (lam within "
          "tol * (1 + max lam), iterations within one, primal and dual 1e-5)")

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
    emit("slots_checkpointed", wall_s=ck_wall, plain_wall_s=wall, saves=len(saves),
         save_mean_s=statistics.mean(saves), save_max_s=max(saves),
         states_left=left, spans={p: sum(s["phase"] == p for s in spans)
                                  for p in sorted({s["phase"] for s in spans})})

    # 3. SIGKILLed mid-iterate in a fresh interpreter, resumed here.
    def real(cols):
        """Chunk reads of these finalize columns (inert chunk slots read nothing)."""
        return sum(1 for j in cols for s in range(SLOTS) if s * cps + j < c)

    kill_epoch = max(CKPT_EVERY, iters // 2)
    d1, d2 = work / "kill1", work / "kill2"
    kill1_wall = run_killed(d1, 1 + kill_epoch * c + c // 2, resume=False)
    step1, st1 = latest_state(ckpt, d1)
    check(st1["phase"] == 0 and 0 < st1["iters"] <= kill_epoch,
          f"not a mid-iterate state: {st1}")
    res1, resume1_wall = solve(src, ckpt_cfg, resume_from=d1)
    check(same(res1, base), "resume after the mid-iterate kill differs")

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
    kill2_wall = run_killed(d2, 1 + epochs_left * c + real(range(c0, c1)) + 2, resume=True)
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
    emit("slots_killed_and_resumed", kill_mid_iterate={
        "killed_wall_s": kill1_wall, "state": {"step": step1, **st1},
        "resumed_wall_s": resume1_wall, "bitwise": True},
        kill_between_finalize_columns={
        "resumed_from": st0, "killed_wall_s": kill2_wall, "state": {"step": step2, **st2},
        "resumed_wall_s": resume2_wall, "chunks_read": calls["n"],
        "formula_1_plus_cols_left_x_slots": 1 + (cps - st2["cursor"]) * SLOTS,
        "bitwise": True})

    # 5. The fault layer at N = 10^6.
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

    # 6. Card against CPU at n = 262,144.
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
    out, paths = {}, {"host_fed_slots4": launches}
    for name, (source, config, qq) in cases.items():
        ops.reset_launches()
        t0 = time.perf_counter()
        gpu = tpf.solve_streaming_host(source, config, q=qq, slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        if name != "scd":
            paths[f"host_fed_slots4_{name}"] = dict(ops.LAUNCHES)
        cpu = tpf.solve_streaming_host(source, config, q=qq, slots=SLOTS, device="cpu")
        out[name] = {"iters": gpu.iters, "bitwise": same(gpu, cpu),
                     "card_wall_s": t1 - t0, "cpu_wall_s": time.perf_counter() - t1,
                     "launches": dict(ops.LAUNCHES)}
        check(out[name]["bitwise"], f"slots {name}: the card's solve differs from the CPU's")
        if gpu.screen is not None:
            profile = [gpu.screen["streamed_chunks"].tolist(),
                       cpu.screen["streamed_chunks"].tolist()]
            out[name]["streamed_chunks"] = profile[0]
            check(profile[0] == profile[1], "slots: screened profiles differ")
            check(min(profile[0]) < 16, "slots: the banded solve retired nothing")
    emit("slots_card_vs_cpu", n=n, slots=SLOTS, cases=out)
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
    from repro_torch.kernels import ref

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
                        bound(4 * (rows + rows * k + e + 2 * k * (e + 1)),
                              rows * k * (e + 1)))),
             "library_ms": None}
    emit("removable_hist_vs_plain", **entry)
    return entry


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

    work = ROOT / "build" / "smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    spec = WorkloadSpec(seed=0, n=N_SERVE, chunk=C_MAIN, **SERVE)
    cfg = SolverConfig(max_iters=60, checkpoint_every=SERVE_CKPT_EVERY)

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

    # 2. A warm refresh SIGKILLed in a fresh interpreter mid-iterate, then
    # recovered here: the record is bitwise the scenario's generation 1.
    root = work / "killed"
    root.mkdir()
    shutil.copytree(work / "scenario" / "gen_000000", root / "gen_000000")
    ckpt.write_json(root, "LIVE.json", {"gen": 0})
    chunks = -(-N_SERVE // C_MAIN)
    scale = _budget_schedule(SERVE_GENS, spec.seed)[1]
    kill_after = 1 + 2 * chunks + chunks // 2
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-c", _SERVE_KILL, str(ROOT / "src"), str(root), str(kill_after),
         repr(scale), json.dumps(spec.to_json()), str(SERVE_CKPT_EVERY), str(SERVE_SLOTS)],
        capture_output=True, text=True, timeout=600)
    killed_s = time.perf_counter() - t0
    check(killed.returncode == -signal.SIGKILL,
          f"the killed refresh ended with {killed.returncode}: {killed.stderr[-3000:]}")
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

    # 3. Chaos == clean, and the card's records == the CPU's, at n = 262,144.
    small = spec.replace(n=N_VS_CPU, chunk=N_VS_CPU // 16)
    t0 = time.perf_counter()
    ok, chaos = run_chaos(small, SERVE_GENS, work / "chaos", cfg, device=dev,
                          slots=SERVE_SLOTS, lookups=256)
    chaos_s = time.perf_counter() - t0
    check(ok, "run_chaos: the chaos records differ from the clean ones")
    recs, walls = {}, {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        eng = RefreshEngine(work / f"records_{name}", small, cfg=cfg, device=where,
                            slots=SERVE_SLOTS)
        recs[name] = [eng.refresh(budget_scale=s)
                      for s in _budget_schedule(SERVE_GENS, small.seed)]
        walls[name] = time.perf_counter() - t0
    card_cpu = all(same_generation(np, a, b) for a, b in zip(recs["card"], recs["cpu"]))
    emit("serving_chaos_and_cpu", n=N_VS_CPU, chunk=small.chunk, chaos_bitwise=ok,
         chaos_wall_s=chaos_s,
         chaos_stale_serves=chaos["chaos"]["lookup"]["cache"]["stale_serves"],
         chaos_retries=chaos["chaos"]["lookup"]["cache"]["retries"],
         records_card_equal_cpu=card_cpu, walls_s=walls)
    check(card_cpu, "the card's generation records differ from the CPU's")
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
    shape = SoakShape(n=N_SERVE, chunk=C_MAIN, generations=SERVE_GENS, max_iters=60,
                      lo=SOAK_LO, hi=SOAK_HI, slots=SERVE_SLOTS, bucket_half=24)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    ops.reset_launches()
    t0 = time.perf_counter()
    ok, rep = run_chaos_soak(work / "soak", seed=0, device="cuda", shape=shape)
    soak_s = time.perf_counter() - t0
    paths["operations_soak"] = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info(dev)[0]
    emit("operations_soak", n=N_SERVE, chunk=C_MAIN, slots=SERVE_SLOTS,
         generations=SERVE_GENS, thresholds=[SOAK_LO, SOAK_HI], wall_s=soak_s,
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
             if "registers" in line or "Compiling entry" in line]
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
    paths.update(phase_slots(torch, np, dev, host_fed_row))
    streamed_paths, kern["bucket_hist"]["legacy_shape"] = phase_streamed(torch, np, dev)
    paths.update(streamed_paths)
    paths.update(phase_serving(torch, np, dev))
    paths.update(phase_operations(torch, np, dev))

    rows = [{"name": name, "route": "cuda", "source": SOURCE[name],
             "replaces": REPLACES[name],
             "launches": sum(p[name] for p in paths.values()),
             "launches_by_path": {path: p[name] for path, p in paths.items()},
             **kern[name]}
            for name in REPLACES]
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} was launched on no path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
