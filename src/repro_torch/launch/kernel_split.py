"""Where a kernel call's time goes on the card.

    python -m repro_torch.launch.kernel_split [--case fused:10000000:8192 ...]
    python -m repro_torch.launch.kernel_split --case streamed:10000000:65536

Each ``--case kind:rows[:arg]`` calls one kernel wrapper of
``kernels.ops`` on ``rows`` random rows (K = 10, q = 1 unless the case
sets K):

* ``fused:ROWS:TILE``: ``scd_fused_hist`` at ``tile``;
* ``bucket:ROWS:TILE``: ``bucket_hist`` on dense-like candidates at ``tile``;
* ``finalize:ROWS:TILE``: ``scd_finalize_hist`` with the histograms against
  the fixed 512-edge profit ladder, every seed passed (the carry of a
  chunked finalize, as ``chip_smoke.py`` seeds it), at ``tile`` (at most
  1,024);
* ``topc:ROWS``: ``adjusted_topc``;
* ``cand:ROWS[:K]``: ``scd_candidates`` (K = 10 by default);
* ``screen:ROWS[:K]``: ``screen_bound`` on banded-like rows (K = 6 by
  default, the banded workload's), written into a (K,) buffer through
  ``out=`` as the screened driver does (a wrapper without ``out=`` returns
  a new tensor).

It prints one JSON line per case:

* ``wall_ms``: CUDA events around ``reps`` back-to-back calls, per call;
* ``host_ms``: the host's time to enqueue one call (no synchronise);
* ``device_ms``: per device kernel (name shortened), its time per call from
  a ``torch.profiler`` trace of the same calls (the mean per recorded
  launch times its launches per call), and their sum; the trace's launches
  per call beside them (below one where the trace dropped events);
* ``gap_ms``: wall minus the device sum, the time the card waits on the host
  between the call's kernels and calls (launches, allocations, packing).

``streamed:N[:CHUNK]`` times a whole device-streamed table1 solve instead
(``core/chunked.solve_streaming`` over ``data/synth.sparse_chunk_source``,
the launcher's ``--streaming``, chunk 65,536 by default): ``wall_s`` is the
median of three untraced solves (host clock, synchronised), and one more
solve under ``torch.profiler`` gives ``device_busy_s``, the union of the
intervals of every device event it recorded (kernels of the generator, the
solver and the copies). ``busy_share`` is that over ``wall_s`` and
``idle_share`` the rest: the share of the solve the card spends waiting on
the host. ``device_ms`` sums each kernel's traced time over the solve.

Needs a CUDA card; the kernels are built at first use.
"""
from __future__ import annotations

import argparse
import inspect
import json
import re
import time

import torch

from ..core.bucketing import make_edges
from ..core.postprocess import profit_edges_fixed
from ..kernels import ops

K = 10
DEFAULT_CASES = ("fused:10000000:8192", "fused:65536:8192", "bucket:5500000:8192",
                 "finalize:65536:512", "finalize:10000000:512", "topc:65536",
                 "topc:10000000", "cand:10000000", "cand:65536", "screen:65536")


def _rows(kind, n, gen, dev, arg=None):
    """The case's call, a function of the tile (``arg`` is the tile of the
    histogram and finalize kinds, K of ``cand`` and ``screen``)."""
    if kind == "screen":
        k = arg or 6
        p = torch.rand((n, k), generator=gen, device=dev) * 0.05
        b = 0.5 + torch.rand((n, k), generator=gen, device=dev) * 0.5
        if "out" not in inspect.signature(ops.screen_bound).parameters:
            return lambda _tile: ops.screen_bound(p, b)
        out = torch.empty((k,), dtype=torch.float32, device=dev)
        return lambda _tile: ops.screen_bound(p, b, out=out)
    if kind == "cand":
        k = arg or K
        p = torch.rand((n, k), generator=gen, device=dev)
        b = torch.rand((n, k), generator=gen, device=dev)
        lam = 0.3 + torch.rand((k,), generator=gen, device=dev)
        return lambda _tile: ops.scd_candidates(p, b, lam, 1)
    p = torch.rand((n, K), generator=gen, device=dev)
    b = torch.rand((n, K), generator=gen, device=dev)
    lam = 0.3 + torch.rand((K,), generator=gen, device=dev)
    if kind == "topc":
        return lambda _tile: ops.adjusted_topc(p, b, lam, 1)
    if kind == "finalize":
        pedges = profit_edges_fixed(512, 1e-6, 1e6, device=dev)
        grid = lambda *s: torch.rand(s, generator=gen, device=dev) * 4.0  # noqa: E731
        seeds = {"cons_hist_init": grid(K, 513), "gain_hist_init": grid(513),
                 "r_init": grid(K), "sums_init": grid(2) * 64,
                 "maxs_init": torch.tensor([0.5, -0.25], device=dev)}
        return lambda tile: ops.scd_finalize_hist(p, b, lam, pedges, 1, tile_n=tile,
                                                  **seeds)
    edges = make_edges(lam.cpu(), 1e-4, 1.6, 24).to(dev)
    if kind == "fused":
        return lambda tile: ops.scd_fused_hist(p, b, lam, edges, 1, tile_n=tile)
    v1 = lam[None, :] + (p - 0.5) * 0.1
    v1 = torch.where(b < 0.3, -1.0, v1)
    v2 = torch.where(b < 0.3, 0.0, b)
    del p, b
    return lambda tile: ops.bucket_hist(v1, v2, edges, tile_n=tile)


def _short(name):
    """A kernel's name without its signature, template arguments and namespace."""
    name = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""))[0]
    return name.split(" ")[-1].split("::")[-1] or name


def device_split(fn, reps):
    """{kernel name: (ms per launch, launches per call)} from a profiler
    trace of ``reps`` calls. The mean is over the launches the trace
    recorded, so a trace that drops some events still times the others."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = _short(evt.name)
        total[name] = total.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
        count[name] = count.get(name, 0) + 1
    return {name: (total[name] / count[name], count[name] / reps) for name in total}


def split(fn, reps):
    """The case's wall, host and device split per call (see the module doc)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    wall = a.elapsed_time(b) / reps
    dev = device_split(fn, reps)
    # Each kernel's time per call: its mean per launch times its launches
    # per call, rounded to a whole number (at least one).
    per_call = {name: ms * max(1, round(n)) for name, (ms, n) in dev.items()}
    total = sum(per_call.values())
    return {"wall_ms": wall, "host_ms": host_ms, "device_ms": per_call,
            "traced_launches_per_call": {name: n for name, (_, n) in dev.items()},
            "device_sum_ms": total if dev else None,
            "gap_ms": wall - total if dev else None}


def _union_s(intervals):
    """Total length in seconds of the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e6


def streamed_busy(n, chunk=65536, reps=3):
    """Wall and device-busy time of one device-streamed table1 solve."""
    from torch.profiler import ProfilerActivity, profile

    from ..configs.paper_kp import WORKLOADS
    from ..core.chunked import solve_streaming
    from ..core.types import SolverConfig
    from ..data.synth import sparse_chunk_source

    dev = torch.device("cuda", 0)
    wl = WORKLOADS["table1"]
    src = sparse_chunk_source(0, n, wl.k, chunk, q=wl.q, tightness=wl.tightness,
                              device=dev)
    cfg = SolverConfig(max_iters=40)

    def solve():
        t0 = time.perf_counter()
        res = solve_streaming(src, cfg, q=wl.q, device=dev)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    solve()
    walls = sorted(solve()[1] for _ in range(reps))
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res, traced_wall = solve()
    launches = dict(ops.LAUNCHES)
    spans, per_kernel = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        name = _short(evt.name)
        per_kernel[name] = per_kernel.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    wall = walls[len(walls) // 2]
    busy = _union_s(spans)
    return {"n": n, "chunk": chunk, "iters": int(res.iters), "wall_s": wall,
            "walls_s": walls, "traced_wall_s": traced_wall,
            "device_busy_s": busy, "busy_share": busy / wall,
            "idle_share": 1.0 - busy / wall, "device_events": len(spans),
            "launches": launches,
            "device_ms": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", action="append", help="kind:rows[:arg] (kind fused, "
                    "bucket, finalize, topc, cand, screen or streamed; default "
                    f"{' '.join(DEFAULT_CASES)})")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in args.case or DEFAULT_CASES:
        kind, n, *arg = case.split(":")
        arg = int(arg[0]) if arg else None
        if kind == "streamed":
            row = streamed_busy(int(n), arg or 65536)
            print(json.dumps({"case": case, "device": torch.cuda.get_device_name(0),
                              **row}), flush=True)
            continue
        fn = _rows(kind, int(n), gen, dev, arg)
        row = split(lambda: fn(arg), args.reps)
        print(json.dumps({"case": case, "device": torch.cuda.get_device_name(0),
                          **row}), flush=True)
        del fn
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
