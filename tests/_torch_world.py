"""Rank functions of the port's world tests (``launch.mesh.run_local_world``).

Each runs on every rank of a world and returns rank 0's view; the rank
processes import this module, which imports no JAX. The instances are the
NumPy sources', made from a seed, so every rank draws the same bytes.
"""
import os
import signal

import numpy as np
import torch

from repro_torch.core import chunked as tchunked
from repro_torch.core import prefetch as tpf
from repro_torch.core.faults import FaultPlan, faulty_source
from repro_torch.core.solver import solve_sharded
from repro_torch.core.types import SolverConfig, SparseKP
from repro_torch.data.synth import banded_host_chunk_source, sparse_host_chunk_source
from repro_torch.launch.front import run_front_scenario
from repro_torch.serve import RefreshEngine, WorkloadSpec, synthetic_source

N, K, Q, CHUNK, SLOTS = 20_000, 8, 2, 1024, 4
BANDED_N = 24 * 1024


def table_source(n=N):
    return sparse_host_chunk_source(11, n, K, CHUNK, q=Q, tightness=0.4)


def banded_source():
    return banded_host_chunk_source(5, BANDED_N, K, CHUNK, q=Q, tightness=0.08)


# The host-fed scenarios of the mesh tests: (source, cfg) by name.
SCENARIOS = {
    "scd": ("table", {}),
    "screened": ("banded", {"screening": True, "bucket_half": 12}),
    "unscreened": ("banded", {"bucket_half": 12}),
    "dd": ("table", {"algo": "dd", "max_iters": 10}),
    "history": ("table", {"record_history": True, "metrics_every": 3}),
    "straggler": ("table", {"partial_fraction": 0.5}),
}


def scenario(name):
    src, kw = SCENARIOS[name]
    source = table_source() if src == "table" else banded_source()
    return source, SolverConfig(**{"max_iters": 30, "kernel_tile": 256, **kw})


def host_fed(name, mesh=None, slots=SLOTS, **kw):
    source, cfg = scenario(name)
    return tpf.solve_streaming_host(source, cfg, q=Q, slots=slots, mesh=mesh,
                                    device="cpu", **kw)


def resident_kp(source):
    c = -(-source.n // source.chunk)
    parts = [source.fn(i) for i in range(c)]
    p = np.concatenate([a for a, _ in parts])[:source.n]
    b = np.concatenate([a for _, a in parts])[:source.n]
    return SparseKP(torch.from_numpy(p), torch.from_numpy(b),
                    torch.from_numpy(source.budgets))


def mesh_scenarios(mesh, names, streamed=False, resume_dir=None, resume_cfg=None,
                   slots=SLOTS):
    """Every host-fed scenario at ``slots`` slots over the world; with
    ``streamed`` also the device-streamed "scd" solve (one shard a rank)
    and the host-fed one at as many slots as ranks; with ``resume_dir`` the
    resume of the state there."""
    out = {name: host_fed(name, mesh, slots) for name in names}
    if streamed:
        source, cfg = scenario("scd")
        kp = resident_kp(source)
        out["streamed"] = tchunked.solve_streaming(
            tchunked.array_source(kp, CHUNK, device=mesh.device), cfg, q=Q,
            mesh=mesh)
        out["host_fed_world_slots"] = host_fed("scd", mesh, slots=mesh.size)
    if resume_dir is not None:
        out["resumed"] = tpf.solve_streaming_host(
            table_source(), resume_cfg, q=Q, mesh=mesh, device="cpu",
            resume_from=resume_dir)
    return out


def killed_solve(mesh, cfg, ckpt_dir, kill_after):
    """The checkpointed host-fed "scd" solve at ``SLOTS`` slots; every rank
    SIGKILLs itself at its (kill_after + 1)-th chunk read."""
    source = table_source()
    inner, calls = source.fn, [0]

    def fn(i):
        calls[0] += 1
        if calls[0] > kill_after:
            os.kill(os.getpid(), signal.SIGKILL)
        return inner(i)

    return tpf.solve_streaming_host(source._replace(fn=fn), cfg, q=Q, slots=SLOTS,
                                    mesh=mesh, device="cpu", checkpoint_dir=ckpt_dir)


def failing_fetch(mesh, chunk):
    """A host-fed solve whose chunk ``chunk`` always fails to fetch, with no
    retries: the rank that owns it raises ``ChunkFetchError``."""
    source = faulty_source(table_source(), FaultPlan(offenders=(chunk,),
                                                     offender_failures=10 ** 6))
    cfg = SolverConfig(max_iters=30, kernel_tile=256, fetch_timeout=60.0)
    return tpf.solve_streaming_host(source, cfg, q=Q, mesh=mesh, device="cpu")


def sharded_scenarios(mesh, instances, scenarios):
    """``solve_sharded`` of each (instance name, cfg kwargs, q) scenario;
    the ranks' x are gathered into the whole (n, ...) solution."""
    out = {}
    for name, (inst, kw, q) in scenarios.items():
        res = solve_sharded(instances[inst], mesh, SolverConfig(**kw), q=q)
        x = mesh.gather(res.x.cpu().to(torch.uint8))
        out[name] = res._replace(x=x.reshape((-1,) + tuple(x.shape[2:])).bool())
    return out


# --------------------------------------------------------------------------
# The legacy device-streamed finalize over a world.
# --------------------------------------------------------------------------

def legacy_finalize(mesh, p, b, budgets, chunk, q, kw):
    """The device-streamed solve of one rank's shard of the (p, b) rows
    (every rank holds them all and slices its own chunks, as
    ``array_source`` over the whole instance does), fused and legacy, with
    and without the projection, and ``solve_sharded`` of the same rows."""
    kp = SparseKP(torch.from_numpy(p), torch.from_numpy(b), torch.from_numpy(budgets))
    cfg = SolverConfig(**kw)
    out = {}
    for post in (True, False):
        for fin in ("fused", "legacy"):
            c = cfg.replace(postprocess=post, stream_finalize=fin)
            out[(fin, post)] = tchunked.solve_streaming(
                tchunked.array_source(kp, chunk, device=mesh.device), c, q=q,
                mesh=mesh)
    n = kp.p.shape[0] // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    shard = SparseKP(kp.p[rows], kp.b[rows], kp.budgets)
    from repro_torch.core.solver import solve_shard
    out["sharded"] = solve_shard(shard, mesh, cfg.replace(chunk_size=chunk), q=q)
    return out


# --------------------------------------------------------------------------
# Serving over a world (RefreshEngine(mesh=)).
# --------------------------------------------------------------------------

SERVE_SLOTS = 4
SERVE_CFG = SolverConfig(max_iters=60, checkpoint_every=2)
SERVE_SPEC = WorkloadSpec(seed=3, n=4000, k=8, chunk=256, q=2, tightness=0.4)
# Screened delta refreshes: the banded workload, a budget change (every
# chunk inherited) and then growth in n (the frontier chunks changed).
SCREEN_CFG = SolverConfig(max_iters=30, bucket_half=12, checkpoint_every=2,
                          screening=True)
SCREEN_SPEC = WorkloadSpec(seed=5, n=4096, k=6, chunk=256, q=2, tightness=0.08,
                           band=0.05)
ENGINES = {
    "plain": (SERVE_SPEC, SERVE_CFG, ({}, {"budget_scale": 0.9})),
    "screened": (SCREEN_SPEC, SCREEN_CFG,
                 ({}, {"budget_scale": 0.95}, {"n": 4096 + 1000})),
}
FRONT_SPEC = WorkloadSpec(seed=5, n=1024, k=4, chunk=128, q=1, tightness=0.4)


def serve_generations(root, name, mesh=None, slots=SERVE_SLOTS, device="cpu"):
    """The generations of engine ``name`` under ``root``, refreshed in
    order (over the world, or in this process on ``device``)."""
    spec, cfg, deltas = ENGINES[name]
    eng = RefreshEngine(root, spec, cfg=cfg, mesh=mesh, slots=slots, device=device)
    return [eng.refresh(**d) for d in deltas]


def serve_world_generations(mesh, roots):
    """Every engine's generations over the world (rank 0's records)."""
    return {name: serve_generations(roots[name], name, mesh) for name in ENGINES}


def serve_world(mesh, roots, front_root):
    """Every engine's generations over the world, then the front scenario
    with its refresh churn over the world; rank 0's records and report."""
    out = {name: serve_generations(roots[name], name, mesh) for name in ENGINES}
    out["front"] = run_front_scenario(
        FRONT_SPEC, 3, front_root, SolverConfig(max_iters=25, checkpoint_every=0),
        replicas=2, client_threads=2, batch=64, settle_s=0.1, device="cpu",
        cache_chunks=16, diff_stride=8, mesh=mesh)
    return out


def _killing(after, scale):
    """A ``make_source`` whose sources of budget scale ``scale`` SIGKILL
    this process at its (after + 1)-th chunk read."""
    calls = [0]

    def make(spec):
        src = synthetic_source(spec)
        if spec.budget_scale != scale:
            return src
        inner = src.fn

        def fn(i):
            calls[0] += 1
            if calls[0] > after:
                os.kill(os.getpid(), signal.SIGKILL)
            return inner(i)

        return src._replace(fn=fn)

    return make


def killed_refresh(mesh, root, after):
    """Generation 0 of the "plain" engine, then its warm refresh with every
    rank SIGKILLed at its (after + 1)-th chunk read."""
    spec, cfg, deltas = ENGINES["plain"]
    eng = RefreshEngine(root, spec, cfg=cfg, mesh=mesh, slots=SERVE_SLOTS,
                        device="cpu", make_source=_killing(after, deltas[1]["budget_scale"]))
    eng.refresh(**deltas[0])
    eng.refresh(**deltas[1])


def failing_refresh(mesh, root, chunk):
    """Generation 0 of the "plain" engine, then a warm refresh whose chunk
    ``chunk`` never fetches (one retry): its owner raises
    ``ChunkFetchError``."""
    spec, cfg, deltas = ENGINES["plain"]

    def make(s):
        src = synthetic_source(s)
        if s.budget_scale == 1.0:
            return src
        return faulty_source(src, FaultPlan(offenders=(chunk,),
                                            offender_failures=10 ** 6))

    cfg = cfg.replace(checkpoint_every=0, fetch_retries=1, fetch_backoff=1e-5,
                      fetch_backoff_cap=1e-5)
    eng = RefreshEngine(root, spec, cfg=cfg, mesh=mesh, slots=SERVE_SLOTS,
                        device="cpu", make_source=make)
    eng.refresh(**deltas[0])
    eng.refresh(**deltas[1])
