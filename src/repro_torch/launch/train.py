"""Training launcher: --arch <id>, synthetic data, checkpoint and restart
(``src/repro/launch/train.py``).

Fault-tolerance contract:
  * checkpoints are atomic (``ckpt.save``) and pruned;
  * on startup the loop resumes from the newest complete checkpoint;
  * data is regenerated deterministically per (seed, step)
    (``data.synth.lm_batch``): a restart never replays or skips a batch;
  * ``--simulate-failure-at N`` kills the process after step N
    (``os._exit(42)``) to prove it.

Runs on the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --smoke --steps 30 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 8 \\
        --ckpt-dir /tmp/ck --ckpt-every 2 --simulate-failure-at 5

The reference's multi-device mesh (``--mesh``) waits for the port's world
slice of the LM stack (ROADMAP A10).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from ..checkpoint import ckpt
from ..configs import registry
from ..core.solver import resolve_device
from ..data.synth import lm_batch
from ..models import model as M
from ..optim import OptConfig, init_opt_state


def train(cfg, opt_cfg, steps, ckpt_dir=None, ckpt_every=0, seed=0,
          batch_shape=(4, 128), log_every=10, fail_at=None, mesh=None,
          keep=3, device="cuda", history=None):
    """Train ``cfg`` from seeded weights for ``steps`` steps in all
    (resuming from ``ckpt_dir``'s newest step where there is one).

    Returns (params, opt_state, losses), the losses of the steps this call
    ran. ``history``: a list that receives one dict per step run (``step``,
    ``loss``, ``grad_norm``, ``lr``, ``wall_s``, the step's wall through its
    losses' copy to the host)."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...): training over a mesh waits for ROADMAP A10's "
            "world slice (models/sharding.py, the a2a MoE); pass mesh=None")
    dev = resolve_device(device)
    start = 0
    last = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if last is None:
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        opt_state = init_opt_state(params, opt_cfg)
    else:
        # The checkpoint's tree holds every value: restore it onto the
        # device without drawing the weights it replaces.
        meta = M.init(cfg, None, "meta")
        like = {"params": meta, "opt": init_opt_state(meta, opt_cfg)}
        state = ckpt.restore(ckpt_dir, last, like, device_tree=dev)
        params, opt_state = state["params"], state["opt"]
        start = last
        print(f"[train] resumed from step {last}")

    step_fn = M.make_train_step(cfg, opt_cfg)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        t_step = time.perf_counter()
        batch = lm_batch(cfg, batch_shape, step, seed=seed, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append({"step": step + 1, "loss": losses[-1],
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]),
                            "wall_s": time.perf_counter() - t_step})
        if log_every and (step + 1) % log_every == 0:
            dt = (time.time() - t0) / max(len(losses), 1)
            print(f"[train] step {step + 1} loss {losses[-1]:.4f} "
                  f"({dt * 1e3:.0f} ms/step)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, {"params": params, "opt": opt_state})
            ckpt.prune(ckpt_dir, keep=keep)
        if fail_at is not None and step + 1 >= fail_at:
            print(f"[train] simulating hard failure at step {step + 1}",
                  flush=True)
            sys.stdout.flush()
            os._exit(42)
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--router", choices=["topk", "scd"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card pass --device cpu")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.router:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router=args.router))
    opt_cfg = OptConfig(lr=args.lr, warmup=20,
                        compress_grads=args.compress_grads)
    _, _, losses = train(
        cfg, opt_cfg, args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed,
        batch_shape=(args.batch, args.seq),
        fail_at=args.simulate_failure_at, device=args.device,
    )
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} last loss "
              f"{losses[-1]:.4f}")
    else:
        print(f"[train] done: no step left before step {args.steps}")


if __name__ == "__main__":
    main()
