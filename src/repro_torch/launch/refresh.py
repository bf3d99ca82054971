"""Refresh launcher: the paper's daily production loop, end to end, on the
card (``--device cpu`` for the CPU).

Drives a multi-day scenario through :class:`repro_torch.serve.RefreshEngine`:
N generations of deterministic budget perturbations, each solved
warm-started from the previous generation's multipliers and published
with an atomic pointer flip, then on-demand lookups against the live
generation through :class:`repro_torch.serve.DecisionService`.

Accounting printed per generation: the warm refresh's iteration count
next to a cold reference solve of the *same* workload (the paper's
daily-call argument in numbers — the warm path must win), then lookup
QPS (batched and single-user) with the chunk-cache hit rate, and a
roundtrip verification that sampled lookups are bitwise the rows full
materialisation (``chunked.decisions_chunk``) would produce.

Exit status 1 when the warm path fails to beat cold in total
iterations or a lookup mismatches materialisation — the serving smoke
gate (``--smoke``). ``--slots`` feeds each solve through that many
virtual slots on the one device.

``--chaos`` is the fault-domain gate: the scenario runs
twice — once clean, once with every chunk fetch injected with
deterministic drops, slow reads, corrupt payloads and a repeat-offender
chunk (:func:`repro_torch.core.faults.faulty_source`) under the retrying
ingest (``fetch_retries``/``verify_refetch``). Every generation's
published record must be **bitwise identical** between the two roots,
every lookup must verify against materialisation, and the chaos run's
serving stats must show zero stale (degraded) serves — the retries
absorbed every fault, no reader ever saw a torn or stale byte.

    PYTHONPATH=src python -m repro_torch.launch.refresh --smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.refresh --smoke --chaos
    PYTHONPATH=src python -m repro_torch.launch.refresh --users 1000000 \
        --generations 7 --root DIR
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..core.chunked import array_source, decisions_chunk
from ..core.faults import (
    FaultPlan,
    faulty_source,
    policy_from_cfg,
    resilient_source,
)
from ..core.prefetch import solve_streaming_host
from ..core.solver import resolve_device
from ..core.types import SolverConfig, SparseKP
from ..serve import RefreshEngine, WorkloadSpec, synthetic_source


def _budget_schedule(generations: int, seed: int):
    """Deterministic daily budget scales: ±15% around the base budgets."""
    rng = np.random.default_rng(seed + 1000)
    return [1.0] + [round(float(s), 4)
                    for s in 1.0 + rng.uniform(-0.15, 0.15, generations - 1)]


def _cold_iters(engine: RefreshEngine, spec: WorkloadSpec) -> int:
    """Iteration count of a cold reference solve of the same workload."""
    res = solve_streaming_host(
        engine.make_source(spec),
        engine.cfg.replace(checkpoint_every=0), q=spec.q,
        device=engine.device, slots=engine.slots)
    return int(res.iters)


def _verify_lookups(engine: RefreshEngine, svc, users) -> bool:
    """Sampled lookups vs full decisions_chunk materialisation, bitwise."""
    gen = svc.generation
    src = engine.make_source(gen.spec)
    # Under --chaos the raw source injects faults; the oracle read must
    # go through the same retry layer the solver used or the injected
    # corruption would poison the reference bytes.
    policy = policy_from_cfg(engine.cfg)
    if policy is not None:
        src = resilient_source(src, policy, verify=engine.cfg.verify_refetch)
    c = -(-src.n // src.chunk)
    p = np.concatenate([src.fn(i)[0] for i in range(c)])[:src.n]
    b = np.concatenate([src.fn(i)[1] for i in range(c)])[:src.n]
    kp = SparseKP(p=torch.from_numpy(p), b=torch.from_numpy(b),
                  budgets=torch.from_numpy(np.asarray(src.budgets)))
    asrc = array_source(kp, src.chunk, device=engine.device)
    got = svc.decide_batch(users)
    ok = True
    for ci in np.unique(np.asarray(users) // src.chunk):
        x, _ = decisions_chunk(asrc, gen.lam, gen.spec.q, int(ci),
                               tau=gen.tau)
        rows = np.asarray(users) // src.chunk == ci
        want = x.cpu().numpy()[np.asarray(users)[rows] % src.chunk]
        if not np.array_equal(got[rows], want):
            ok = False
            print(f"[refresh] LOOKUP MISMATCH in chunk {int(ci)}")
    return ok


def run_scenario(spec: WorkloadSpec, generations: int, root,
                 cfg: SolverConfig, device="cuda", slots=None, lookups=512,
                 verify=True, resume=False, make_source=synthetic_source):
    """The multi-day loop on ``device``; returns the accounting dict."""
    engine = RefreshEngine(root, spec, make_source=make_source, cfg=cfg,
                           device=device, slots=slots)
    if resume:
        rec = engine.recover()
        if rec is not None:
            print(f"[refresh] recovered pending generation {rec.gen}")
    scales = _budget_schedule(generations, spec.seed)
    start = (engine.live_gen_id() + 1
             if engine.live_gen_id() is not None else 0)
    per_gen = []
    for g in range(start, generations):
        t0 = time.perf_counter()
        gen = engine.refresh(budget_scale=scales[g])
        wall = time.perf_counter() - t0
        cold = gen.iters if g == 0 else _cold_iters(engine, gen.spec)
        per_gen.append({"gen": g, "budget_scale": scales[g],
                        "warm_iters": gen.iters, "cold_iters": cold,
                        "wall_s": round(wall, 3)})
        tag = "cold (first)" if g == 0 else f"cold would take {cold}"
        print(f"[refresh] gen {g}: budgets {scales[g] - 1.0:+.2%} -> "
              f"{gen.iters} iters warm ({tag}), primal "
              f"{float(gen.primal):,.1f}, {wall:.2f}s")

    warm_entries = [e for e in per_gen if e["gen"] > 0]
    warm_total = sum(e["warm_iters"] for e in warm_entries)
    cold_total = sum(e["cold_iters"] for e in warm_entries)
    if warm_entries:
        print(f"[refresh] totals over {len(warm_entries)} refreshes: "
              f"warm {warm_total} vs cold {cold_total} iterations "
              f"({cold_total / max(warm_total, 1):.2f}x)")
    else:
        # Single-generation scenario, or a --resume relaunch that found
        # everything already published: nothing warm to account.
        print("[refresh] no warm refreshes ran this invocation "
              f"(live generation: {engine.live_gen_id()})")

    svc = engine.decision_service()
    rng = np.random.default_rng(spec.seed)
    users = rng.integers(0, spec.n, lookups)
    t0 = time.perf_counter()
    svc.decide_batch(users)
    batched_s = time.perf_counter() - t0
    singles = users[:min(lookups, 128)]
    t0 = time.perf_counter()
    for u in singles:
        svc.decide(int(u))
    single_s = time.perf_counter() - t0
    lookup = {
        "users": int(lookups),
        "batched_qps": round(lookups / max(batched_s, 1e-9), 1),
        "single_qps": round(len(singles) / max(single_s, 1e-9), 1),
        "cache": dict(svc.stats),
    }
    print(f"[refresh] lookups: {lookup['batched_qps']:.0f}/s batched, "
          f"{lookup['single_qps']:.0f}/s single "
          f"(cache {svc.stats['hits']} hits / {svc.stats['fills']} fills)")

    ok = True
    if verify:
        ok = _verify_lookups(engine, svc, users[:256])
        print(f"[refresh] lookup roundtrip vs materialisation: "
              f"{'bitwise OK' if ok else 'MISMATCH'}")
    return {"per_generation": per_gen, "warm_refreshes": len(warm_entries),
            "warm_iters_total": warm_total,
            "cold_iters_total": cold_total,
            "cold_over_warm": round(cold_total / max(warm_total, 1), 3),
            "lookup": lookup, "lookups_bitwise": ok}


# The chaos injection plan and retry budget must respect the probability
# compounding: verify_refetch doubles every read, so an attempt succeeds
# with (1 - drop - corrupt)^2 and the per-chunk budget has to cover
# thousands of fetches without exhausting. drop 8% + corrupt 4% under 8
# retries keeps P(any exhaustion over a smoke run) negligible while
# still firing hundreds of injected faults.
_CHAOS_PLAN_KW = dict(drop=0.08, slow=0.05, slow_s=0.002, corrupt=0.04,
                      offenders=(1,), offender_failures=2)
_CHAOS_CFG_KW = dict(fetch_retries=8, fetch_backoff=1e-4,
                     fetch_backoff_cap=1e-3, verify_refetch=True)

_RECORD_FIELDS = ["lam", "tau", "iters", "r", "primal", "dual",
                  "fingerprint"]


def run_chaos(spec: WorkloadSpec, generations: int, root,
              cfg: SolverConfig, device="cuda", slots=None, lookups=256):
    """The fault-domain gate: chaos run bitwise-equals the clean run.

    Runs the scenario twice under ``root`` — ``clean/`` fault-free and
    ``chaos/`` with every chunk fetch going through
    :func:`~repro_torch.core.faults.faulty_source` injection absorbed by the
    retrying ingest — then compares every published generation's record
    field-for-field. Returns ``(ok, accounting)``.
    """
    root = pathlib.Path(root)
    print(f"[chaos] clean pass -> {root / 'clean'}")
    clean_out = run_scenario(spec, generations, root / "clean", cfg,
                             device=device, slots=slots, lookups=lookups)
    plan = FaultPlan(seed=spec.seed, **_CHAOS_PLAN_KW)
    chaos_cfg = cfg.replace(**_CHAOS_CFG_KW)
    print(f"[chaos] injected pass -> {root / 'chaos'} ({plan})")
    chaos_out = run_scenario(
        spec, generations, root / "chaos", chaos_cfg, device=device,
        slots=slots, lookups=lookups,
        make_source=lambda s: faulty_source(synthetic_source(s), plan))

    clean_eng = RefreshEngine(root / "clean", spec, cfg=cfg, device=device)
    chaos_eng = RefreshEngine(root / "chaos", spec, cfg=chaos_cfg, device=device)
    ok = True
    for g in range(generations):
        want, got = clean_eng.generation(g), chaos_eng.generation(g)
        for f in _RECORD_FIELDS:
            if np.asarray(getattr(want, f)).tobytes() \
                    != np.asarray(getattr(got, f)).tobytes():
                ok = False
                print(f"[chaos] FAIL: gen {g} field {f} differs from the "
                      "fault-free run")
        for i, (x, y) in enumerate(zip(want.fin_hist or (),
                                       got.fin_hist or ())):
            if np.asarray(x).tobytes() != np.asarray(y).tobytes():
                ok = False
                print(f"[chaos] FAIL: gen {g} fin_hist[{i}] differs")
    stats = chaos_out["lookup"]["cache"]
    if stats.get("stale_serves", 0) != 0:
        ok = False
        print(f"[chaos] FAIL: {stats['stale_serves']} stale serves — "
              "lookup retries did not absorb the injected faults")
    if not (clean_out["lookups_bitwise"] and chaos_out["lookups_bitwise"]):
        ok = False
    if ok:
        print(f"[chaos] OK: {generations} generations bitwise-identical "
              "under injected faults "
              f"({stats.get('retries', 0)} lookup retries absorbed, "
              "0 stale serves)")
    return ok, {"clean": clean_out, "chaos": chaos_out}


def main(argv=None):
    """CLI entry point; exits 1 on a failed gate."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=65536)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--tightness", type=float, default=0.4)
    ap.add_argument("--root", default=None,
                    help="generation root (default: a temp dir)")
    ap.add_argument("--slots", type=int, default=None,
                    help="virtual feed slots on the one device (default 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--lookups", type=int, default=512)
    ap.add_argument("--resume", action="store_true",
                    help="finish a preempted refresh in --root first")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the O(n) lookup-roundtrip check")
    ap.add_argument("--smoke", action="store_true",
                    help="small scenario (CI gate; exits 1 on any failure)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the scenario clean AND under injected "
                         "fetch faults; exit 1 unless every generation "
                         "is bitwise identical between the two")
    ap.add_argument("--screening", action="store_true",
                    help="active-set screening + delta refresh: retire "
                         "provably-inert chunks, seed each generation's "
                         "active set from the parent's certificates and "
                         "re-stream only changed chunks (bitwise "
                         "results)")
    ap.add_argument("--screening-floor", type=float, default=0.5)
    ap.add_argument("--band", type=float, default=0.0,
                    help="ratio-banded workload (cold-cohort profit "
                         "scale; 0 = uniform §6 generator). Screening "
                         "retires nothing on the uniform workload — "
                         "pair --screening with --band")
    ap.add_argument("--bucket-half", type=int, default=24,
                    help="bucket ladder half-width (smaller ladders "
                         "tighten the screening certificate)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.users, args.chunk, args.generations = 8192, 512, 3
        args.lookups = 256
    spec = WorkloadSpec(seed=args.seed, n=args.users, k=args.k,
                        chunk=args.chunk, q=args.q,
                        tightness=args.tightness, band=args.band)
    cfg = SolverConfig(reduce="bucketed", max_iters=args.max_iters,
                       checkpoint_every=args.checkpoint_every,
                       screening=args.screening,
                       screening_floor=args.screening_floor,
                       bucket_half=args.bucket_half)
    device = resolve_device(args.device)
    root = args.root or tempfile.mkdtemp(prefix="refresh_")
    print(f"[refresh] root {root}; device {device}, slots {args.slots or 1}")
    if args.chaos:
        ok, _ = run_chaos(spec, args.generations, root, cfg, device=device,
                          slots=args.slots, lookups=args.lookups)
        sys.exit(0 if ok else 1)
    out = run_scenario(spec, args.generations, root, cfg, device=device,
                       slots=args.slots, lookups=args.lookups,
                       verify=not args.no_verify, resume=args.resume)
    if out["warm_refreshes"] \
            and out["warm_iters_total"] >= out["cold_iters_total"]:
        print("[refresh] FAIL: warm refreshes did not beat cold "
              f"({out['warm_iters_total']} >= {out['cold_iters_total']})")
        sys.exit(1)
    if not out["lookups_bitwise"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
