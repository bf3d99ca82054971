"""Serving launcher: continuous-batching decode loop with KP admission
(``src/repro/launch/serve.py``).

At each admission tick the waiting queue is a small knapsack instance:
items = requests, one global constraint (projected KV-cache bytes), one
local cardinality cap (free batch slots), solved exactly by the port's
cyclic-SCD ``DenseKP`` solve. Successive ticks are the same KP under a
drifting workload, so each tick's solve is warm-started from the previous
tick's multipliers (``lam0``); the admitted sets equal those of cold
solves. The queue comes from ``np.random.default_rng(seed)``, so the
admitted sets and the completion order do not depend on the weights.

Runs on the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs import registry
from ..core.solver import resolve_device, solve
from ..core.types import DenseKP, SolverConfig, cardinality_set
from ..models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new: int
    done: int = 0


class Admission(NamedTuple):
    """One admission tick's outcome: who got in, at what KV price.

    ``lam`` is the (1,) multiplier vector of the admission KP, the KV-cache
    shadow price, handed back so the next tick can warm-start from it; None
    when no solve ran (empty queue or no free slots). ``iters`` is that
    solve's iteration count (0 when no solve ran).
    """

    picked: list
    lam: Optional[np.ndarray]
    iters: int


def admission_solve(waiting, kv_budget, free_slots, lam0=None, device="cuda") -> Admission:
    """Choose the admitted subset by solving the admission KP exactly on
    ``device``; ``lam0`` warm-starts the solve from the previous tick's
    multipliers, which buys iterations and never other admissions."""
    if not waiting or free_slots <= 0:
        return Admission([], None, 0)
    n = len(waiting)
    # value ~ completed-requests-per-token (shortest remaining first)
    p = np.asarray([1.0 + 1.0 / (1 + r.max_new - r.done) for r in waiting],
                   np.float32)
    kv = np.asarray([r.prompt_len + r.max_new for r in waiting], np.float32)
    sets = cardinality_set(n, min(free_slots, n))
    kp = DenseKP(p=torch.from_numpy(p)[None, :], b=torch.from_numpy(kv)[None, :, None],
                 budgets=torch.tensor([float(kv_budget)], dtype=torch.float32),
                 sets=sets.sets, caps=sets.caps)
    res = solve(kp, SolverConfig(reduce="exact", cd_mode="cyclic", max_iters=12),
                q=0, lam0=lam0, device=device)
    mask = res.x[0].cpu().numpy()
    return Admission([r.rid for r, m in zip(waiting, mask) if m],
                     res.lam.numpy(), int(res.iters))


def serve_loop(cfg, n_requests=8, cache_len=256, kv_budget=512.0, max_batch=4,
               seed=0, max_ticks=256, warm=True, device="cuda"):
    """Continuous decode loop with KP admission each tick, on ``device``.

    ``warm`` threads each admission solve's multipliers into the next
    tick's ``lam0`` (the default); ``warm=False`` solves every tick cold.
    Returns (completed requests, per-tick admitted sets, stats): the wall
    time and the per-tick admission iteration counts. The decode position
    ``tick % cache_len`` is shared by the whole batch, as in the reference.
    Mamba slots carry their conv windows and SSM states across requests,
    as the reference's loop carries every cache.

    An encoder-decoder raises ``ValueError``: its cache holds the encoded
    frames of a request, and the reference's loop has none to give it
    (``init_cache`` without ``frames``).
    """
    if cfg.kind == "encdec":
        raise ValueError(
            f"{cfg.name}: serve_loop cannot serve an encoder-decoder: its cache "
            "holds the cross K/V of encoded frames, and the loop's requests carry "
            "none (the reference's serve_loop calls init_cache without frames)")
    dev = resolve_device(device)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    dstep = M.make_decode_step(cfg)
    rng = np.random.default_rng(seed)
    queue = [
        Request(rid=i, prompt_len=int(rng.integers(4, 32)),
                max_new=int(rng.integers(4, 24)))
        for i in range(n_requests)
    ]
    caches = M.init_cache(cfg, params, max_batch, cache_len)
    token = torch.zeros((max_batch, 1), dtype=torch.int64, device=dev)
    active: dict[int, Request] = {}
    done: list[Request] = []
    admitted_sets = []
    admission_iters = []
    lam = None
    t0 = time.time()
    with torch.no_grad():
        for tick in range(max_ticks):
            if not queue and not active:
                break
            free = max_batch - len(active)
            if queue and free > 0:
                # budget shrinks by what the active set already holds
                held = sum(r.prompt_len + r.max_new for r in active.values())
                adm = admission_solve(queue, kv_budget - held, free,
                                      lam0=lam if warm else None, device=dev)
                if adm.lam is not None:
                    lam = adm.lam
                    admission_iters.append(adm.iters)
                admitted_sets.append(adm.picked)
                for rid in adm.picked[:free]:
                    req = next(r for r in queue if r.rid == rid)
                    queue.remove(req)
                    active[rid] = req
            if active:
                logits, caches = dstep(params, caches, token, tick % cache_len)
                token = torch.argmax(logits[:, -1:], dim=-1)
                for rid in list(active):
                    r = active[rid]
                    r.done += 1
                    if r.done >= r.max_new:
                        done.append(r)
                        del active[rid]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats = {"wall_s": time.time() - t0, "warm": warm,
             "admission_iters": admission_iters,
             "admission_iters_total": sum(admission_iters)}
    return done, admitted_sets, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card pass --device cpu")
    args = ap.parse_args(argv)
    cfg = registry.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    done, admitted, stats = serve_loop(cfg, n_requests=args.requests,
                                       max_batch=args.max_batch, device=args.device)
    print(f"[serve] completed {len(done)} requests in "
          f"{stats['wall_s']:.2f}s ({len(admitted)} admission solves, "
          f"{stats['admission_iters_total']} warm KP iterations)")


if __name__ == "__main__":
    main()
