"""Rank functions of ``tests/test_torch_tp_train.py``: training under tensor
and sequence parallelism over a world of ranks (``make_train_step`` and
``loss_and_grads`` under ``sharding.PRODUCTION_RULES``, the vocab-parallel
loss, ``optim.apply_updates(mesh=, blocks=)``, ``launch/train.train(mesh=,
rules="production")`` with its world checkpoint).

Every rank runs the same cases on the same global NumPy batches, keeps its
blocks of the carried tree (``model.shard_params``) and runs every row;
what it holds is gathered and joined along each leaf's block
(``model.param_blocks``), so rank 0 returns the whole trees, with both
ranks' losses and norms beside them to hold the two bitwise. The rank
processes import this module, which imports no JAX;
``tests/test_torch_cuda.py`` runs :func:`port_cases` over a world on the
card against one on the CPU.
"""
import contextlib

import torch

import _torch_tp_world as TW
from repro_torch.core.carry import params_from_reference
from repro_torch.data.synth import lm_batch
from repro_torch.launch import dryrun
from repro_torch.launch.train import train
from repro_torch.models import lm, model as M, sharding as S
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

MOE_ARCH, DENSE_ARCH = TW.MOE_ARCH, TW.DENSE_ARCH
ARCHS = TW.ARCHS
STEPS, BATCH, SEED = 3, (2, 32), 5
# D = 2 does not divide 15 positions: "seq" is dropped, the norms see
# every position and their gradients are whole (no fold).
ODD_SEQ = TW.ODD_SEQ
OPT = dict(lr=1e-3, warmup=2)
# train(mesh=, rules="production") from the seed: saved at SAVE_AT,
# resumed to STEPS.
SAVE_AT, TRAIN_SEED = 2, 3
COMM_KINDS = TW.COMM_KINDS
PROD = S.PRODUCTION_RULES


def smoke_cfg(name):
    return TW.smoke_cfg(name)


def alone(name):
    return TW.alone(name)


def batches(arch, shape=BATCH, steps=STEPS, seed=SEED):
    """``steps`` global batches of ``shape`` (NumPy), from the port's
    ``lm_batch``."""
    cfg = smoke_cfg(arch)
    return [{k: v.numpy() for k, v in lm_batch(cfg, shape, step, seed=seed,
                                                device="cpu").items()}
            for step in range(steps)]


@contextlib.contextmanager
def rules(r, mesh):
    S.set_rules(r, mesh=mesh)
    try:
        yield
    finally:
        S.set_rules(None)


def whole(cfg, tree, mesh, r=PROD):
    """The leaves of ``tree`` in ``jax.tree.leaves`` order as float32 NumPy
    copies (the steps update the tensors in place), each cut leaf joined
    from the ranks' blocks in rank order."""
    out = []
    blocks = M.param_blocks(cfg, tree, mesh, rules=r) if mesh is not None else None
    for i, leaf in enumerate(lm.tree_leaves(tree)):
        t = leaf.detach().cpu().to(torch.float32, copy=True)
        if blocks is not None and blocks[i] is not None:
            t = torch.cat(list(mesh.gather(t).unbind(0)), dim=blocks[i][0])
        out.append(t.numpy())
    return out


def both(mesh, values):
    """Every rank's list of floats, stacked in rank order (NumPy)."""
    return mesh.gather(torch.tensor(values, dtype=torch.float64)).numpy()


def run_case(mesh, tree, arch, r, bs, keep=True):
    """``len(bs)`` train steps of ``arch`` from the carried weights under
    rules ``r`` over ``mesh`` (None: one process, no rules): losses and
    grad norms (both ranks'), step 1's gradients and the parameters after
    it, whole; the bytes this rank sent in step 2 by ``COMM_KINDS``, and
    what it held there. Step 1 is ``make_train_step``'s body spelled out to
    keep its gradients."""
    cfg, opt = smoke_cfg(arch), OptConfig(**OPT)
    dev = torch.device("cpu") if mesh is None else mesh.device
    params = params_from_reference(tree, cfg, dev)
    got = {"loss": [], "grad_norm": []}
    with rules(r if mesh is not None else None, mesh):
        if mesh is not None:
            params = M.shard_params(cfg, params, mesh)
        state = init_opt_state(params, opt)
        step = M.make_train_step(cfg, opt)
        for i, b in enumerate(bs):
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            if i:
                before = dict(mesh.comm_bytes) if mesh is not None else {}
                params, state, m = step(params, state, b)
                if i == 1 and mesh is not None:
                    got["comm_step"] = TW.comm_since(mesh, before)
                    got["held_step"] = dryrun.nbytes([params, state, b])
            else:
                loss, grads = M.loss_and_grads(params, cfg, b)
                if keep:
                    got["grads"] = whole(cfg, grads, mesh, r)
                blocks = None if mesh is None else M.param_blocks(cfg, params, mesh)
                params, state, m = apply_updates(params, grads, state, opt, mesh=mesh,
                                                 blocks=blocks)
                m["loss"] = loss
                if keep:
                    got["params1"] = whole(cfg, params, mesh, r)
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
    if mesh is not None:
        got["both"] = both(mesh, got["loss"] + got["grad_norm"])
    return got


def train_runs(mesh, arch, d_full, d_saved, d_one=None):
    """``train(mesh=, rules="production")`` of the smoke ``arch`` from the
    seed: STEPS steps saving at SAVE_AT into ``d_full``; SAVE_AT steps
    saving into ``d_saved``; then resumed from ``d_saved`` to STEPS; with
    ``d_one`` (a one-process run's checkpoint at SAVE_AT) resumed from it
    too. Each run's losses and final state, whole."""
    cfg = smoke_cfg(arch)
    kw = dict(seed=TRAIN_SEED, batch_shape=BATCH, log_every=0, device=mesh.device,
              mesh=mesh, rules="production")
    out = {}
    runs = [("full", STEPS, d_full, SAVE_AT), ("saved", SAVE_AT, d_saved, SAVE_AT),
            ("resumed", STEPS, d_saved, 0)] + ([("from_one", STEPS, d_one, 0)]
                                               if d_one else [])
    for name, steps, d, every in runs:
        params, state, losses = train(cfg, OptConfig(**OPT), steps, ckpt_dir=d,
                                      ckpt_every=every, **kw)
        with rules(PROD, mesh):
            out[name] = {"losses": losses,
                         "state": whole(cfg, {"params": params, "opt": state}, mesh)}
    return out


def world_cases(mesh, trees, dirs):
    """A rank of the test's world: every case."""
    out = {}
    for arch in ARCHS:
        out[arch] = run_case(mesh, trees[arch], arch, PROD, batches(arch))
        out[f"odd_{arch}"] = run_case(mesh, trees[arch], arch, PROD,
                                      batches(arch, (BATCH[0], ODD_SEQ), steps=1))
        for name in S.TP_NAMES:
            out[f"alone_{name}_{arch}"] = run_case(mesh, trees[arch], arch, alone(name),
                                                   batches(arch, steps=1))
    out["train"] = train_runs(mesh, DENSE_ARCH, dirs["full"], dirs["saved"], dirs["one"])
    return out


def one_process(trees):
    """The one-process port on the same weights and batches: each arch's
    first step (what each name bound alone is held against)."""
    return {arch: run_case(None, trees[arch], arch, None, batches(arch, steps=1))
            for arch in ARCHS}


def port_cases(mesh):
    """Each arch's steps once, TF32 off: a world on the card against a world
    on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = TW.smoke_trees(ARCHS)
    return {arch: run_case(mesh, trees[arch], arch, PROD, batches(arch)) for arch in ARCHS}


def reference_cases():
    """What the reference subprocesses run: each arch's batches, and the odd
    sequence's with the rules it runs under there (moonshot's MoE cannot
    shard 15 positions over "seq", so the reference runs its odd case
    under the batch binding, where each rank routes one row: the same
    token blocks as the port's replicated MoE path)."""
    return {arch: {"batches": batches(arch),
                   "odd": batches(arch, (BATCH[0], ODD_SEQ), steps=1),
                   "odd_rules": S.BATCH_RULES if arch == MOE_ARCH else None}
            for arch in ARCHS}
