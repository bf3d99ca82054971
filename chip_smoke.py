#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card, nvcc and PyTorch built for CUDA. It builds the
kernels from ``src/repro_torch/kernels/csrc`` and runs six phases, each
printing one JSON line; any failed check raises, so the script exits
non-zero and prints no result line:

1. environment: the card, its power limit, torch/CUDA versions, build time;
2. each kernel against its plain version on the card at the main path's
   shapes (chunk 65,536 and 65,536 - 37, K = 10, q in {1, 3}, seeded
   carries): bitwise on dyadic inputs, allclose (rtol 1e-5, atol 1e-5) on
   random ones with top, lo/hi and (q = 1) bucket patterns exact; times
   from CUDA events beside the byte bound and the plain version's time;
3. determinism: repeated kernel runs bitwise; a host-fed solve at chunk
   65,536 and 131,072 (tile 512) bitwise;
4. the same host-fed solve (n = 262,144) on the card and on the CPU;
5. end to end: the §6 table1 shape (K = 10, Q = 1, tightness 0.5) at
   N = 10,000,000 (``--scale 0.1``), chunk 65,536, through the launcher's
   ``run_streaming``, with launch counts and the per-epoch split;
6. the ``kernels`` line, the card's ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.
"""
import json
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
SOURCE = "src/repro_torch/kernels/csrc/scd_fused.cu"
REPLACES = {"scd_fused_hist": "src/repro/kernels/scd_fused.py:93",
            "scd_finalize_hist": "src/repro/kernels/scd_fused.py:279"}


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

    pedges = profit_edges_fixed(512, 1e-6, 1e6, device=dev)
    err = {"scd_fused_hist": 0.0, "scd_finalize_hist": 0.0}
    cases = 0
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
                check(torch.equal(kf[5], pf[5]) and torch.equal(kf[6], pf[6]),
                      f"finalize lo/hi differ ({tag})")
                pairs = {"scd_fused_hist": [(kh, ph)],
                         "scd_finalize_hist": list(zip(kf[:5], pf[:5]))}
                for name, prs in pairs.items():
                    for a, e in prs:
                        if dyadic:
                            check(torch.equal(a, e), f"{name} not bitwise ({tag})")
                        else:
                            check(torch.allclose(a, e, rtol=1e-5, atol=1e-5),
                                  f"{name} not allclose ({tag})")
                            err[name] = max(err[name], float((a - e).abs().max()))
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
            lambda: ops.scd_finalize_hist(p, b, lam, pedges, Q_MAIN, **gs),
            lambda: ref.scd_finalize_plain(p, b, lam, pedges, Q_MAIN, **gs),
            bound(read + 4 * (ep + 2 * rec_g),
                  C_MAIN * K * (5 + Q_MAIN) + C_MAIN * (ep + K + 1))),
    }
    out = {}
    for name, (kern, plain, (b_ms, b_by)) in timing.items():
        ms = time_ms(torch, kern, reps=50)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        out[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    emit("kernels_vs_plain", cases=cases, chunk=C_MAIN, k=K, **out)
    return out


def host_instance(np, n, seed):
    from repro_torch.data.synth import sparse_host_chunk_source
    src = sparse_host_chunk_source(seed, n, K, C_MAIN)
    ps, bs = zip(*(src.fn(i) for i in range(-(-n // C_MAIN))))
    return np.concatenate(ps)[:n], np.concatenate(bs)[:n], src.budgets


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
    check(same(runs[C_MAIN], runs[2 * C_MAIN]),
          "host-fed solve differs between chunk 65536 and 131072")
    emit("determinism", kernel_reruns_bitwise=True, chunk_invariance_bitwise=True,
         n=n, iters=runs[C_MAIN].iters)

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
    from repro_torch.kernels import scd_fused
    from repro_torch.launch.solve import run_streaming

    wl = WORKLOADS["table1"]
    n = int(wl.n_users * 0.1)
    work = KPWorkload(wl.name, n, wl.k, wl.q, wl.tightness)
    stats = FeedStats()
    scd_fused.reset_launches()
    row = run_streaming(work, SolverConfig(max_iters=40), C_MAIN, device=dev,
                        stats=stats)
    launches = dict(scd_fused.LAUNCHES)
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
    return launches


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
    launches = phase_end_to_end(torch, dev)

    rows = [{"name": name, "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[name], "launches": launches[name], **kern[name]}
            for name in ("scd_fused_hist", "scd_finalize_hist")]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
