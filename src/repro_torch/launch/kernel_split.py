"""Where a histogram kernel call's time goes on the card.

    python -m repro_torch.launch.kernel_split [--case fused:10000000:8192 ...]

Each ``--case kind:rows:tile`` calls ``kernels.ops.scd_fused_hist``
(``fused``, K = 10, q = 1, random p and b) or ``kernels.ops.bucket_hist``
(``bucket``, K = 10, dense-like candidates) on ``rows`` rows at ``tile``, and
prints one JSON line per case:

* ``wall_ms``: CUDA events around ``reps`` back-to-back calls, per call;
* ``host_ms``: the host's time to enqueue one call (no synchronise);
* ``device_ms``: per device kernel (name shortened), its time per call from
  a ``torch.profiler`` trace of the same calls, and their sum;
* ``gap_ms``: wall minus the device sum, the time the card waits on the host
  between the call's kernels and calls (launches, allocations, packing).

Needs a CUDA card; the kernels are built at first use.
"""
from __future__ import annotations

import argparse
import json
import re
import time

import torch

from ..core.bucketing import make_edges
from ..kernels import ops

K = 10
DEFAULT_CASES = ("fused:10000000:8192", "fused:65536:8192", "bucket:5500000:8192")


def _rows(kind, n, gen, dev):
    p = torch.rand((n, K), generator=gen, device=dev)
    b = torch.rand((n, K), generator=gen, device=dev)
    lam = 0.3 + torch.rand((K,), generator=gen, device=dev)
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
    """{kernel name: ms per call} from a profiler trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = _short(evt.name)
        out[name] = out.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / reps
    return out


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
    total = sum(dev.values())
    return {"wall_ms": wall, "host_ms": host_ms, "device_ms": dev,
            "device_sum_ms": total if dev else None,
            "gap_ms": wall - total if dev else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", action="append", help="kind:rows:tile "
                    f"(kind fused or bucket; default {' '.join(DEFAULT_CASES)})")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in args.case or DEFAULT_CASES:
        kind, n, tile = case.split(":")
        fn = _rows(kind, int(n), gen, dev)
        row = split(lambda: fn(int(tile)), args.reps)
        print(json.dumps({"case": case, "device": torch.cuda.get_device_name(0),
                          **row}), flush=True)
        del fn
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
