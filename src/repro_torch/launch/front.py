"""Front launcher: HTTP serving over DecisionService replica processes.

Two entry modes:

* ``--replica`` — run ONE replica process: attach a
  :class:`~repro_torch.serve.engine.RefreshEngine` to the shared generation
  root (waiting for the first publication if needed), serve a
  :class:`~repro_torch.serve.front.ReplicaServer` on a free port and
  announce it atomically under ``<root>/front/replica_<i>.json``. Its
  lookups fill on ``--device`` (the card unless ``cpu``). The replica's
  pointer watcher follows LIVE flips on its own; the orchestrator never
  talks to it except over RPC.
* default — the orchestrated scenario (the CI front smoke gate):
  publish generation 0, spawn N replicas (child environments assembled
  by :func:`repro_torch.launch.env.worker_env` — one card per replica,
  or none for ``--device cpu``; each replica is its own interpreter with
  its own CUDA context, and no process forks after touching CUDA), boot
  the HTTP front over them,
  then hammer ``/decide_batch`` from concurrent client threads **while
  the engine refreshes further generations with ``keep=2`` prune churn
  underneath** — the pointer watchers rebind the replicas live. Every
  answered row is then verified **bitwise** against the full
  materialisation of the generation that answered it (every chunk of its
  source through ``chunked.decisions_rows``; each response
  names its generation, so answers from mid-flip replicas verify
  against the generation they claim, exactly like the in-process
  story), and the cross-generation ``/diff`` endpoint is checked
  against the brute-force comparison of two generations' decision
  matrices, with per-replica chunk-fill accounting proving one grouped
  pass per generation (second pass: zero fills — both generations
  cached).

    PYTHONPATH=src python -m repro_torch.launch.front --smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.front --users 65536 \
        --replicas 4 --root /tmp/front

Exit status 1 when any row, provenance flag or diff bit mismatches —
this is the CI gate; ``chip_smoke.py`` runs :func:`run_front_scenario`
on the card.
"""
from __future__ import annotations

import argparse
import http.client
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

from ..checkpoint import ckpt
from ..core.solver import resolve_device
from ..core.types import SolverConfig
from . import env as envmod
from .refresh import _budget_schedule
from ..serve import Front, RefreshEngine, ReplicaClient, ReplicaServer, \
    WorkloadSpec
from ..serve.front import poisoned_factory, unpack_array

_FRONT_DIR = "front"


# ---------------------------------------------------------------------------
# Replica process entry.
# ---------------------------------------------------------------------------

def run_replica(root, index: int, cache_chunks: int, retries: int,
                attach_timeout: float, poll_s: float,
                poison_scale: Optional[float] = None,
                poison_chunk: int = 0, obs: bool = False,
                device: str = "cuda") -> None:
    """The ``--replica`` body: attach, announce, serve until shutdown.
    Lookups fill on ``device`` (the card unless "cpu").

    With ``obs=True`` the replica traces to
    ``<root>/obs/replica<i>-<pid>.jsonl`` (serve.fill spans carrying
    front-minted request ids, replica.rebind spans); metrics are always
    on — the ``metrics`` RPC op and the front's ``/metrics`` read them.
    """
    from ..obs import make_obs
    from ..serve import synthetic_source

    make_source = synthetic_source
    if poison_scale is not None:
        make_source = poisoned_factory(synthetic_source, poison_scale,
                                       poison_chunk)
    cfg = SolverConfig(reduce="bucketed", fetch_retries=retries,
                       fetch_backoff=1e-4, fetch_backoff_cap=1e-3)
    obs_bundle = make_obs(root=root if obs else None,
                          role=f"replica{index}")
    engine = RefreshEngine.attach(root, timeout=attach_timeout, cfg=cfg,
                                  make_source=make_source, obs=obs_bundle,
                                  device=device)
    rep = ReplicaServer(engine, index=index, cache_chunks=cache_chunks,
                        poll_s=poll_s)
    port = rep.start()
    ckpt.write_json(pathlib.Path(root) / _FRONT_DIR,
                    f"replica_{index}.json",
                    {"port": port, "pid": os.getpid(), "index": index})
    print(f"[replica {index}] serving on 127.0.0.1:{port}", flush=True)
    rep.serve_forever()


def spawn_replicas(root, n: int, cache_chunks: int = 32,
                   retries: int = 2, devices: int = 1,
                   timeout: float = 120.0, poll_s: float = 0.05,
                   extra_args: tuple = (), device: str = "cuda") -> tuple:
    """Spawn ``n`` replica processes and wait for their announcements.

    Child environments come from :func:`repro_torch.launch.env.worker_env`
    (``devices`` cards, or none for ``device="cpu"``) with the running
    package's ``src`` prepended to PYTHONPATH, same as the supervisor's
    workers. Each replica is a fresh interpreter (``subprocess.Popen``),
    so each builds its own CUDA context. Returns ``(procs, clients)``;
    raises (after killing the children) if any replica dies or fails to
    announce in time.
    """
    root = pathlib.Path(root)
    wenv = envmod.worker_env(devices, device=device)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    pp = wenv.get("PYTHONPATH", "")
    if src not in pp.split(os.pathsep):
        wenv["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
    procs = []
    for i in range(n):
        argv = [sys.executable, "-m", "repro_torch.launch.front", "--replica",
                "--root", str(root), "--index", str(i),
                "--cache-chunks", str(cache_chunks),
                "--retries", str(retries), "--poll", str(poll_s),
                "--device", device, *extra_args]
        procs.append(subprocess.Popen(argv, env=wenv))
    clients, deadline = [], time.monotonic() + timeout
    try:
        for i in range(n):
            while True:
                doc = ckpt.read_json(root / _FRONT_DIR,
                                     f"replica_{i}.json")
                if doc is not None:
                    clients.append(ReplicaClient("127.0.0.1", doc["port"]))
                    break
                if procs[i].poll() is not None:
                    raise RuntimeError(
                        f"replica {i} exited rc={procs[i].returncode} "
                        "before announcing")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"replica {i} never announced")
                time.sleep(0.02)
    except Exception:
        for p in procs:
            p.kill()
        raise
    return procs, clients


def stop_replicas(procs, clients) -> None:
    """Ask every replica to shut down; kill those still up after 10 s."""
    for rc in clients:
        try:
            rc.call({"op": "shutdown"})
        except Exception:                    # noqa: BLE001 — best effort
            pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


# ---------------------------------------------------------------------------
# HTTP client helper (keep-alive; urllib reconnects per request).
# ---------------------------------------------------------------------------

class _HTTPClient:
    """A keep-alive JSON client for one front address (one per thread)."""

    def __init__(self, host: str, port: int):
        import socket

        self.conn = http.client.HTTPConnection(host, port, timeout=60)
        self.conn.connect()
        self.conn.sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)

    def get(self, path: str) -> dict:
        self.conn.request("GET", path)
        r = self.conn.getresponse()
        body = json.loads(r.read().decode("utf-8"))
        if r.status != 200:
            raise RuntimeError(f"GET {path} -> {r.status}: {body}")
        return body

    def get_text(self, path: str) -> str:
        self.conn.request("GET", path)
        r = self.conn.getresponse()
        body = r.read().decode("utf-8")
        if r.status != 200:
            raise RuntimeError(f"GET {path} -> {r.status}: {body}")
        return body

    def post(self, path: str, payload: dict) -> dict:
        self.conn.request("POST", path, body=json.dumps(payload),
                          headers={"Content-Type": "application/json"})
        r = self.conn.getresponse()
        body = json.loads(r.read().decode("utf-8"))
        if r.status != 200:
            raise RuntimeError(f"POST {path} -> {r.status}: {body}")
        return body

    def close(self) -> None:
        self.conn.close()


# ---------------------------------------------------------------------------
# The orchestrated scenario.
# ---------------------------------------------------------------------------

def _materialise(engine: RefreshEngine, gen) -> np.ndarray:
    """The full (n, K) decision matrix of one generation (reference):
    every chunk of its source through ``chunked.decisions_rows`` at the
    generation's (lam, tau) on the engine's device, one pass, without
    the DecisionService under test."""
    import torch

    from ..core.chunked import decisions_rows

    src = engine.make_source(gen.spec)
    dev = torch.device(engine.device)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    lam, tau = put(gen.lam), put(gen.tau)
    out = []
    for ci in range(-(-src.n // src.chunk)):
        p, b = map(put, src.fn(ci))
        rows = ci * src.chunk + torch.arange(src.chunk, device=dev)
        out.append(decisions_rows(p, b, lam, gen.spec.q, rows < src.n,
                                  tau).cpu().numpy())
    return np.concatenate(out)[:src.n]


def run_front_scenario(spec: WorkloadSpec, generations: int, root,
                       cfg: SolverConfig, replicas: int = 2,
                       client_threads: int = 4, batch: int = 128,
                       keep: int = 2, settle_s: float = 0.3,
                       slots=None, device: str = "cuda",
                       cache_chunks: int = 32, diff_stride: int = 1) -> dict:
    """Refresh churn under live HTTP traffic on ``device``; returns the
    accounting dict. ``cache_chunks`` sizes each replica's chunk LRU (the
    diff's zero-fill repeat needs it to hold every chunk); ``/diff`` asks
    about every ``diff_stride``-th user (at most ``spec.chunk``, so every
    chunk is spanned)."""
    if not 1 <= diff_stride <= spec.chunk:
        raise ValueError(f"diff_stride must be in [1, {spec.chunk}] so the "
                         f"diff spans every chunk, got {diff_stride}")
    root = pathlib.Path(root)
    engine = RefreshEngine(root, spec, cfg=cfg, slots=slots, keep=keep,
                           device=device)
    scales = _budget_schedule(generations, spec.seed)
    refs = {}
    gen0 = engine.refresh(budget_scale=scales[0])
    refs[gen0.gen] = _materialise(engine, gen0)
    print(f"[front] gen 0 published ({gen0.iters} iters); "
          f"spawning {replicas} replicas")

    procs, clients = spawn_replicas(root, replicas,
                                    cache_chunks=cache_chunks, device=device)
    front = None
    try:
        front = Front(clients)
        host, port = front.start()
        print(f"[front] http on {host}:{port}")

        stop = threading.Event()
        results, errors = [], []
        lock = threading.Lock()

        def hammer(seed: int) -> None:
            rng = np.random.default_rng(seed)
            cli = _HTTPClient(host, port)
            try:
                while not stop.is_set():
                    users = rng.integers(0, spec.n, batch)
                    r = cli.post("/decide_batch",
                                 {"users": users.tolist()})
                    with lock:
                        results.append((users, r))
            except Exception as e:               # noqa: BLE001 — joined below
                with lock:
                    errors.append(repr(e))
            finally:
                cli.close()

        threads = [threading.Thread(target=hammer, args=(1000 + t,))
                   for t in range(client_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()

        # The churn: further generations published + pruned while the
        # replicas keep answering; the watchers rebind on each flip.
        try:
            for g in range(1, generations):
                gen = engine.refresh(budget_scale=scales[g])
                refs[gen.gen] = _materialise(engine, gen)
                print(f"[front] gen {gen.gen} published "
                      f"({gen.iters} iters warm); retained "
                      f"{engine.generation_ids()}")
            final = generations - 1
            health_cli = _HTTPClient(host, port)
            deadline = time.monotonic() + 60
            while True:
                h = health_cli.get("/health")
                if h["ok"] and h["generations"] == [final]:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"replicas never converged on gen {final}: {h}")
                time.sleep(0.05)
            time.sleep(settle_s)                 # post-flip traffic too
        finally:
            stop.set()
            for t in threads:
                t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"client threads failed: {errors}")

        # Bitwise parity: every answered row against the materialisation of
        # the generation that answered it; provenance must be fresh.
        mismatches = stale_rows = total = 0
        gens_served = set()
        for users, r in results:
            x = unpack_array(r["x"])
            gens = unpack_array(r["gens"])
            stale = unpack_array(r["stale"])
            total += users.size
            stale_rows += int(stale.sum())
            for g in np.unique(gens):
                rows = gens == g
                gens_served.add(int(g))
                if x[rows].tobytes() != refs[int(g)][users[rows]].tobytes():
                    mismatches += 1
        parity = mismatches == 0 and stale_rows == 0
        qps = total / max(wall, 1e-9)
        print(f"[front] sustained: {total} lookups in {len(results)} batches "
              f"over {wall:.2f}s ({qps:,.0f}/s) across generations "
              f"{sorted(gens_served)}; parity "
              f"{'OK' if parity else 'MISMATCH'}")

        # Single-lookup QPS and latency (informational) on the converged
        # front, each /decide answer checked like the batches.
        cli = _HTTPClient(host, port)
        rng = np.random.default_rng(7)
        singles = rng.integers(0, spec.n, 256)
        lat = []
        t0 = time.perf_counter()
        for u in singles:
            t1 = time.perf_counter()
            r = cli.get(f"/decide?user={int(u)}")
            lat.append(time.perf_counter() - t1)
            if r["stale"] or r["x"] != [int(v) for v in refs[r["gen"]][int(u)]]:
                parity = False
        single_qps = singles.size / max(time.perf_counter() - t0, 1e-9)
        p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
        print(f"[front] /decide: {single_qps:,.1f} lookups/s single, p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms")

        # The diff endpoint: "which users changed since the previous
        # generation?" — brute-force-checked, with per-replica fill
        # accounting: the baseline costs one grouped pass (== chunks), the
        # repeat costs zero (both generations cached).
        base_gen = final - 1
        chunks = -(-spec.n // spec.chunk)
        diff_users = np.arange(0, spec.n, diff_stride)
        brute = (refs[final][diff_users] != refs[base_gen][diff_users]).any(axis=1)
        diff_calls, diff_parity, passes = [], True, []
        for _ in range(2 * replicas):
            d = cli.post("/diff", {"gen": base_gen,
                                   "users": diff_users.tolist()})
            changed = unpack_array(d["changed"])
            if changed.tobytes() != brute.tobytes() \
                    or d["from_gen"] != base_gen or d["to_gen"] != final \
                    or d["stale"]:
                diff_parity = False
            diff_calls.append(d)
        by_replica = {}
        for d in diff_calls:
            by_replica.setdefault(d["replica"], []).append(d["fills"])
        for rep, fills in sorted(by_replica.items()):
            passes.append({"replica": rep, "calls": fills})
            if fills[0]["old"] != chunks or \
                    any(f != {"new": 0, "old": 0} for f in fills[1:]):
                diff_parity = False
        print(f"[front] diff vs gen {base_gen}: {int(brute.sum())}/"
              f"{diff_users.size} "
              f"changed; parity {'OK' if diff_parity else 'FAIL'}; "
              f"passes {passes}")

        health = cli.get("/health")
        rebinds = [d["replica"]["rebinds"] for d in health["replicas"]]

        # The /metrics scrape: Prometheus text must agree with /health —
        # the front counter with the front stats dict, the unlabeled
        # aggregate with the sum of the replica="i" labeled series, and the
        # labeled serve_queries with each replica's own health document.
        # (Traffic is quiesced by now, so the two reads see the same state.)
        metrics = _check_metrics(cli.get_text("/metrics"), health, replicas)
        print(f"[front] /metrics: {metrics['series']} series; consistency "
              f"{'OK' if metrics['consistent'] else 'FAIL'}"
              + ("" if metrics["consistent"]
                 else f" ({metrics['failures']})"))
        cli.close()
        health_cli.close()

        return {
            "n": spec.n, "chunk": spec.chunk, "k": spec.k, "q": spec.q,
            "generations": generations, "replicas": replicas,
            "client_threads": client_threads, "batch": batch, "keep": keep,
            "sustained": {"lookups": total, "batches": len(results),
                          "wall_s": round(wall, 3),
                          "batched_qps": round(qps, 1),
                          "single_qps": round(single_qps, 1),
                          "decide_p50_ms": p50, "decide_p99_ms": p99},
            "generations_served": sorted(gens_served),
            "rebinds": rebinds,
            "parity": parity, "stale_rows": stale_rows,
            "diff": {"users": int(diff_users.size), "base_gen": base_gen,
                     "changed": int(brute.sum()), "chunks": chunks,
                     "parity": diff_parity, "passes": passes},
            "front_stats": health["front"],
            "metrics": metrics,
        }
    finally:
        if front is not None:
            front.shutdown()
        stop_replicas(procs, clients)


def _check_metrics(text: str, health: dict, replicas: int) -> dict:
    """Cross-check a /metrics scrape against the /health document."""
    from ..obs import parse_prometheus

    series = parse_prometheus(text)

    def val(name, **labels):
        return series.get((name, tuple(sorted(labels.items()))), 0.0)

    failures = []
    if val("front_requests") != health["front"]["requests"]:
        failures.append(
            f"front_requests {val('front_requests')} != "
            f"health requests {health['front']['requests']}")
    for name in ("serve_queries", "serve_fills", "serve_stale_serves",
                 "replica_rebinds"):
        per = sum(val(name, replica=str(i)) for i in range(replicas))
        if val(name) != per:
            failures.append(f"{name} aggregate {val(name)} != "
                            f"labeled sum {per}")
    for i, doc in enumerate(health["replicas"]):
        if "error" in doc:
            continue
        if val("serve_queries", replica=str(i)) != doc["queries"]:
            failures.append(
                f"replica {i} serve_queries "
                f"{val('serve_queries', replica=str(i))} != "
                f"health queries {doc['queries']}")
        if val("replica_rebinds", replica=str(i)) \
                != doc["replica"]["rebinds"]:
            failures.append(
                f"replica {i} replica_rebinds != health rebinds "
                f"{doc['replica']['rebinds']}")
    return {"series": len(series), "consistent": not failures,
            "failures": failures}


def main() -> None:
    """CLI entry point; exits 1 on a failed gate."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--users", type=int, default=65536)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tightness", type=float, default=0.4)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--client-threads", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the refresh engine and "
                         "every replica's lookups")
    ap.add_argument("--smoke", action="store_true",
                    help="small scenario (CI gate; exits 1 on any "
                         "parity failure)")
    # --replica mode (one serving process; spawned by the orchestrator).
    ap.add_argument("--replica", action="store_true")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--cache-chunks", type=int, default=32)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--attach-timeout", type=float, default=60.0)
    ap.add_argument("--poll", type=float, default=0.05)
    ap.add_argument("--poison-scale", type=float, default=None,
                    help="test/chaos: fail one chunk of the generation "
                         "at this budget_scale (degraded-path drills)")
    ap.add_argument("--poison-chunk", type=int, default=0)
    ap.add_argument("--obs", action="store_true",
                    help="replica mode: trace spans to <root>/obs/")
    args = ap.parse_args()

    if args.replica:
        if args.root is None:
            ap.error("--replica requires --root")
        run_replica(args.root, args.index, args.cache_chunks,
                    args.retries, args.attach_timeout, args.poll,
                    poison_scale=args.poison_scale,
                    poison_chunk=args.poison_chunk, obs=args.obs,
                    device=resolve_device(args.device).type)
        return

    if args.smoke:
        args.users, args.chunk, args.generations = 8192, 512, 3
    spec = WorkloadSpec(seed=args.seed, n=args.users, k=args.k,
                        chunk=args.chunk, q=args.q,
                        tightness=args.tightness)
    cfg = SolverConfig(reduce="bucketed", max_iters=args.max_iters,
                       checkpoint_every=0)
    device = resolve_device(args.device).type
    root = args.root or tempfile.mkdtemp(prefix="front_")
    print(f"[front] root {root}; {args.replicas} replicas on {device}")
    out = run_front_scenario(spec, args.generations, root, cfg,
                             replicas=args.replicas,
                             client_threads=args.client_threads,
                             batch=args.batch, device=device,
                             cache_chunks=args.cache_chunks)
    ok = out["parity"] and out["diff"]["parity"] \
        and all(r >= 1 for r in out["rebinds"]) \
        and out["metrics"]["consistent"]
    print(f"[front] {'OK' if ok else 'FAIL'}: "
          f"{out['sustained']['batched_qps']:,.0f} lookups/s sustained, "
          f"rebinds {out['rebinds']}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
