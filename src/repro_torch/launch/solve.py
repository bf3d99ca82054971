"""Solver launcher: the paper's production job, on the card.

    python -m repro_torch.launch.solve --workload table1 --scale 0.1 \\
        [--reduce exact] [--algo dd] [--presolve N] [--chunk-size C] \\
        [--device cpu]
    python -m repro_torch.launch.solve --workload table1 --scale 0.1 \\
        --host-feed --chunk-size 65536 [--algo dd] [--slots S] \\
        [--screening [--screening-floor F]] [--device cpu] \\
        [--checkpoint-dir DIR [--checkpoint-every N] [--resume]] \\
        [--stream-finalize legacy]
    python -m repro_torch.launch.solve --n 100000000 --streaming \\
        --chunk-size 65536 [--screening] [--algo dd] [--stream-finalize legacy]
    python -m repro_torch.launch.solve ... --world 4 [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.solve ... [--device cpu]

Without ``--host-feed`` the §6 sparse workload is generated on the host,
moved to the device and solved resident (``core/solver.solve``);
``--chunk-size`` then chunks the per-iteration map. With ``--host-feed``
it is produced as NumPy chunks and solved by the host-fed driver
(``core/prefetch.solve_streaming_host``: sync SCD with the bucketed
reduce, optionally screened, or DD), over ``--slots`` virtual slots, and
with ``--checkpoint-every`` and ``--checkpoint-dir`` it survives
preemption: relaunch with ``--resume`` and the same directory (a
directory with no checkpoint starts fresh, so a relaunch loop can always
pass it). Both print one ``key: value`` line per metric, the keys of the
reference launcher plus the device (and, screened, the streamed chunks
per iteration and the floor resets). With ``--streaming`` the chunks are
generated on the device (``data/synth.sparse_chunk_source``) and solved by
``core/chunked.solve_streaming``: nothing O(N) exists anywhere, no chunk
crosses the host link, and the peak device memory (printed on the card as
``peak_device_gb``) stays O(chunk x K) whatever N is.
``--stream-finalize legacy`` runs the three-pass finalize (single slot).
``--scale`` shrinks N, keeping the structure (budgets scale with N).

Over a world of ranks (``launch/mesh.py``): ``--world D`` starts D rank
processes on this host (``mesh.run_local_world``), and under ``torchrun``
each process is a rank already. The resident solve is then
``solver.solve_shard``: rank r draws only the chunks that hold its rows
[r*N/D, (r+1)*N/D) (D must divide N). The host-fed solve spreads its
``--slots`` (default D) over the ranks, and the device-streamed solve
gives each rank a shard of the chunks. Only rank 0 prints; the row adds
``world`` and ``collective_s`` (rank 0's seconds in collectives), and on
the card every rank's ``peak_device_gb_by_rank``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs.paper_kp import WORKLOADS, KPWorkload
from ..core.instances import sparse_instance
from ..core.chunked import solve_streaming
from ..core.prefetch import solve_streaming_host
from ..core.solver import resolve_device, solve, solve_shard
from ..core.types import SolverConfig
from ..data.synth import sparse_chunk_source, sparse_host_chunk_source
from .mesh import init_mesh, run_local_world


def _device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _objective_keys(res, budgets):
    """primal, dual, their gap and the worst budget violation."""
    return {"primal": float(res.primal), "dual": float(res.dual),
            "duality_gap": float(res.dual - res.primal),
            "max_violation": float(torch.max((res.r - budgets) / budgets))}


def _world_keys(mesh, dev):
    """A world's keys of the row: its size, rank 0's seconds in collectives
    and, on the card, every rank's peak device memory."""
    if mesh is None:
        return {}
    out = {"world": mesh.size, "collective_s": mesh.comm_s}
    if dev.type == "cuda":
        peak = torch.tensor([torch.cuda.max_memory_allocated(dev) / 1e9],
                            dtype=torch.float64)
        out["peak_device_gb_by_rank"] = mesh.gather(peak)[:, 0].tolist()
    return out


def run(workload: KPWorkload, cfg: SolverConfig, seed=0, device="cuda",
        mesh=None):
    """Resident solve of a §6 workload; returns the Table-1-style row dict.

    The instance is generated on the host, moved to the device and solved
    with ``solve`` (``cfg.chunk_size`` chunks the iteration map if set).
    Over a ``mesh`` each rank draws its own rows and the ranks solve
    together (``solve_shard``).
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    n = workload.n_users
    rows = None
    if mesh is not None:
        if n % mesh.size:
            raise ValueError(f"the user dimension ({n}) must divide the mesh size "
                             f"({mesh.size})")
        rows = (mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size)
    kp, q = sparse_instance(seed, n, workload.k, workload.q,
                            tightness=workload.tightness, device=dev, rows=rows)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = (solve(kp, cfg, q=q, device=dev) if mesh is None
           else solve_shard(kp, mesh, cfg, q=q))
    dt = time.time() - t0
    return {
        "n_users": workload.n_users,
        "k": workload.k,
        "iterations": int(res.iters),
        **_objective_keys(res, kp.budgets.cpu()),
        "wall_s": round(dt, 2),
        "device": _device_name(dev),
        **_world_keys(mesh, dev),
    }


def run_streaming(workload: KPWorkload, cfg: SolverConfig, chunk: int, seed=0,
                  double_buffer=True, device="cuda", stats=None,
                  checkpoint_dir=None, resume=False, slots=None, host_feed=True,
                  mesh=None):
    """Chunk-streamed solve of a §6 workload; returns the Table-1-style row
    dict (and the final multipliers, ``lam``).

    ``host_feed`` (default): NumPy chunks through the host-fed driver, over
    ``slots`` virtual slots; with ``cfg.checkpoint_every`` and
    ``checkpoint_dir`` the solve checkpoints there, and ``resume``
    restores the latest state in it first. ``host_feed=False``: chunks
    generated on the device and the device-streamed ``solve_streaming``;
    on the card the row also gives ``peak_device_gb``. ``gap_negative``
    says the dual came out below the primal of a feasible solution. Over a
    ``mesh`` both drivers run on every rank (``slots`` defaults to the
    world size).
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    if host_feed:
        src = sparse_host_chunk_source(seed, workload.n_users, workload.k, chunk,
                                       q=workload.q, tightness=workload.tightness)
        res = solve_streaming_host(src, cfg, q=workload.q,
                                   double_buffer=double_buffer, device=dev,
                                   stats=stats, slots=slots, mesh=mesh,
                                   checkpoint_dir=checkpoint_dir,
                                   resume_from=checkpoint_dir if resume else None)
    else:
        src = sparse_chunk_source(seed, workload.n_users, workload.k, chunk,
                                  q=workload.q, tightness=workload.tightness,
                                  device=dev)
        res = solve_streaming(src, cfg, q=workload.q, device=dev, mesh=mesh)
    dt = time.time() - t0
    out = {
        "n_users": workload.n_users,
        "k": workload.k,
        "chunk_size": chunk,
        "iterations": int(res.iters),
        **_objective_keys(res, torch.as_tensor(src.budgets)),
        "wall_s": round(dt, 2),
        "device": _device_name(dev),
        "lam": res.lam.tolist(),
    }
    if dev.type == "cuda":
        out["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out.update(_world_keys(mesh, dev))
    # A dual below the primal of a feasible solution is ruled out by weak
    # duality: the streamed float32 running sums carry a numerical fault.
    out["gap_negative"] = bool(out["dual"] < out["primal"]
                               and out["max_violation"] <= 0.0)
    if res.screen is not None:
        # Host-fed: streamed chunks per epoch; device-streamed: active
        # chunks per iteration (-1 past convergence).
        if "streamed_chunks" in res.screen:
            counts = np.asarray(res.screen["streamed_chunks"])
        else:
            ac = np.asarray(res.screen["active_chunks"])
            counts = ac[ac >= 0]
        out["screen_chunks_per_iter"] = counts.tolist()
        out["screen_resets"] = int(res.screen["resets"])
    return out


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=list(WORKLOADS), default="table1")
    ap.add_argument("--scale", type=float, default=1e-4,
                    help="shrink N by this factor (1.0 = full size)")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--q", type=int, default=None)
    ap.add_argument("--max-iters", type=int, default=40)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="resident: chunk the per-iteration map (bitwise "
                         "equal on the SCD bucketed path); host-fed: the "
                         "chunk of the source")
    ap.add_argument("--host-feed", action="store_true",
                    help="host-produced NumPy chunks, double-buffered upload "
                         "(requires --chunk-size)")
    ap.add_argument("--no-double-buffer", action="store_true",
                    help="synchronous upload and step (the baseline)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--algo", choices=["scd", "dd"], default="scd")
    ap.add_argument("--reduce", choices=["bucketed", "exact"], default="bucketed")
    ap.add_argument("--presolve", type=int, default=0)
    ap.add_argument("--streaming", action="store_true",
                    help="chunks generated on the device, solved by the "
                         "device-streamed driver (requires --chunk-size)")
    ap.add_argument("--stream-finalize", choices=["fused", "legacy"],
                    default="fused",
                    help="streaming finalize: one fused pass (iters + 1 source "
                         "passes) or the legacy three passes (iters + 3)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="host-feed only: directory of the atomic resume state")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write the resume state every N iterations (and every "
                         "N chunk columns of the finalize); 0 disables")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint of --checkpoint-dir "
                         "first (a fresh start when it has none)")
    ap.add_argument("--slots", type=int, default=None,
                    help="host-feed only: virtual slot count (default 1, or "
                         "the world size), fixed at first launch")
    ap.add_argument("--screening", action="store_true",
                    help="host-fed: safe active-set screening, bitwise the "
                         "unscreened solve (retired chunks are not fetched)")
    ap.add_argument("--screening-floor", type=float, default=0.5,
                    help="screening certifies multipliers down to lam * this")
    ap.add_argument("--world", type=int, default=None,
                    help="run as a world of this many rank processes on this "
                         "host (under torchrun, each process is a rank already)")
    return ap


def _execute(args, mesh=None):
    """The row dict of one parsed command line, on one process or as one
    rank of ``mesh``."""
    wl = WORKLOADS[args.workload]
    n = args.n or max(int(wl.n_users * args.scale), 1024)
    wl = KPWorkload(wl.name, n, args.k or wl.k, args.q or wl.q, wl.tightness)
    cfg = SolverConfig(algo=args.algo, reduce=args.reduce,
                       max_iters=args.max_iters, presolve_samples=args.presolve,
                       chunk_size=args.chunk_size, screening=args.screening,
                       screening_floor=args.screening_floor,
                       checkpoint_every=args.checkpoint_every,
                       stream_finalize=args.stream_finalize)
    if args.streaming or args.host_feed:
        return run_streaming(wl, cfg, args.chunk_size,
                             double_buffer=not args.no_double_buffer,
                             device=args.device,
                             checkpoint_dir=args.checkpoint_dir,
                             resume=args.resume, slots=args.slots,
                             host_feed=args.host_feed, mesh=mesh)
    return run(wl, cfg, device=args.device, mesh=mesh)


def _world_rank(mesh, argv):
    """One rank of ``--world``: the row of the parsed ``argv``."""
    return _execute(_parser().parse_args(argv), mesh)


def main(argv=None):
    """CLI entry point; prints one ``key: value`` line per metric (rank 0
    only, over a world)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.streaming and args.host_feed:
        raise SystemExit("--streaming and --host-feed are two different "
                         "drivers: pass one of them")
    if args.screening and not (args.streaming or args.host_feed):
        raise SystemExit("--screening requires --streaming or --host-feed "
                         "(only the chunk-streamed drivers carry an active "
                         "chunk set)")
    if ((args.checkpoint_every or args.checkpoint_dir or args.resume
         or args.slots) and not args.host_feed):
        raise SystemExit("--checkpoint-every/--checkpoint-dir/--resume/"
                         "--slots require --host-feed (only the host-fed "
                         "epoch driver is preemption-safe and slot-sharded)")
    if args.checkpoint_every and not args.checkpoint_dir:
        raise SystemExit("--checkpoint-every requires --checkpoint-dir")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if (args.streaming or args.host_feed) and not args.chunk_size:
        raise SystemExit("--streaming/--host-feed require --chunk-size")
    mesh = init_mesh(args.device)
    if args.world is not None:
        if mesh is not None:
            raise SystemExit("--world starts its own ranks: do not pass it "
                             "under torchrun")
        resolve_device(args.device)
        out = run_local_world(_world_rank, args.world, (argv,), device=args.device)
    else:
        out = _execute(args, mesh)
    if mesh is None or mesh.rank == 0:
        for k, v in out.items():
            print(f"{k}: {v}")
    if out.get("gap_negative"):
        raise SystemExit("the dual came out below the primal of a feasible "
                         "solution: the float32 running sums no longer hold "
                         "at this n (ROADMAP C)")


if __name__ == "__main__":
    main()
