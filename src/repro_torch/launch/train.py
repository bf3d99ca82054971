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

Over a world of ranks (``--world D`` starts D rank processes on this host,
``launch/mesh.run_local_world``; the port's counterpart of the
reference's multi-device run): every rank trains under the batch binding
(``models/sharding.BATCH_RULES``) on its ``B / D`` rows of the global
batch and its ``E / D`` experts, the other leaves replicated and their
gradients folded in rank order (``models/model.loss_and_grads``). The
world saves the one-process layout (``ckpt.save(mesh=, blocks=)``), and a
state restores at any world size that divides the experts (elastic):

    PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke \\
        --world 2 --device cpu --steps 8 --ckpt-dir /tmp/ckw --ckpt-every 2
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
from ..core.mesh import check_mesh
from ..core.solver import resolve_device
from ..data.synth import lm_batch
from ..models import model as M, sharding
from ..optim import OptConfig, init_opt_state
from .mesh import WorldError, run_local_world

# The exit code of ``--simulate-failure-at`` (every rank of a world).
FAIL_EXIT = 42


def _initial_state(cfg, opt_cfg, ckpt_dir, seed, dev, mesh):
    """(params, opt_state, start step): the newest checkpoint of
    ``ckpt_dir`` (this rank's blocks of it over a world), else the tree
    drawn from ``seed`` (cut to the rank's experts)."""
    last = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if last is None:
        params = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        if mesh is not None:
            params = sharding.shard_experts(params, mesh)
        return params, init_opt_state(params, opt_cfg), 0
    # The checkpoint's tree holds every value: restore it onto the device
    # without drawing the weights it replaces.
    meta = M.init(cfg, None, "meta")
    if mesh is not None:
        meta = sharding.shard_experts(meta, mesh)
    like = {"params": meta, "opt": init_opt_state(meta, opt_cfg)}
    state = ckpt.restore(ckpt_dir, last, like, device_tree=dev,
                         blocks=sharding.expert_blocks(like, mesh))
    if mesh is None or mesh.rank == 0:
        print(f"[train] resumed from step {last}")
    return state["params"], state["opt"], last


def train(cfg, opt_cfg, steps, ckpt_dir=None, ckpt_every=0, seed=0,
          batch_shape=(4, 128), log_every=10, fail_at=None, mesh=None,
          keep=3, device="cuda", history=None):
    """Train ``cfg`` from seeded weights for ``steps`` steps in all
    (resuming from ``ckpt_dir``'s newest step where there is one).

    Returns (params, opt_state, losses), the losses of the steps this call
    ran. ``history``: a list that receives one dict per step run (``step``,
    ``loss``, ``grad_norm``, ``lr``, ``wall_s``, the step's wall through its
    losses' copy to the host).

    ``mesh``: this rank's ``core.mesh.Mesh`` (every rank of the world calls
    ``train`` alike; ``TypeError`` for anything else). The rank runs on
    ``mesh.device`` under ``sharding.BATCH_RULES`` (cleared on return),
    holds its experts of the tree (``params`` and ``opt_state`` are its
    blocks), draws the global batch of each step and trains its rows; the
    losses are the world's. Rank 0 alone prints and prunes; ``fail_at``
    exits every rank."""
    mesh = check_mesh(mesh)
    dev = resolve_device(device if mesh is None else mesh.device)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        sharding.set_rules(sharding.BATCH_RULES, mesh=mesh)
    try:
        params, opt_state, start = _initial_state(cfg, opt_cfg, ckpt_dir, seed, dev, mesh)
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
            if lead and log_every and (step + 1) % log_every == 0:
                dt = (time.time() - t0) / max(len(losses), 1)
                print(f"[train] step {step + 1} loss {losses[-1]:.4f} "
                      f"({dt * 1e3:.0f} ms/step)")
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                state = {"params": params, "opt": opt_state}
                ckpt.save(ckpt_dir, step + 1, state, mesh=mesh,
                          blocks=sharding.expert_blocks(state, mesh))
                if lead:
                    ckpt.prune(ckpt_dir, keep=keep)
            if fail_at is not None and step + 1 >= fail_at:
                if lead:
                    print(f"[train] simulating hard failure at step {step + 1}",
                          flush=True)
                sys.stdout.flush()
                os._exit(FAIL_EXIT)
    finally:
        if mesh is not None:
            sharding.set_rules(None)
    return params, opt_state, losses


def _world_rank(mesh, argv):
    """One rank of ``--world``: :func:`main`'s run of ``argv`` on ``mesh``."""
    _run(_parser().parse_args(argv), mesh)


def _parser():
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
    ap.add_argument("--world", type=int, default=None,
                    help="train over a world of this many rank processes on this "
                         "host (they share the card where there is one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card pass --device cpu")
    return ap


def _run(args, mesh):
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
        fail_at=args.simulate_failure_at, device=args.device, mesh=mesh,
    )
    if mesh is not None and mesh.rank:
        return
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} last loss "
              f"{losses[-1]:.4f}", flush=True)
    else:
        print(f"[train] done: no step left before step {args.steps}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.world is None:
        _run(args, None)
        return
    resolve_device(args.device)
    try:
        run_local_world(_world_rank, args.world, (argv,), device=args.device, echo=True)
    except WorldError as e:
        if FAIL_EXIT in e.returncodes:        # --simulate-failure-at on every rank
            sys.exit(FAIL_EXIT)
        raise


if __name__ == "__main__":
    main()
