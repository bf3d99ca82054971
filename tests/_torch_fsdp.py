"""Rank functions of ``tests/test_torch_fsdp.py``: FSDP over a world of ranks
(``sharding.FSDP_RULES`` and ``sharding.rules_for``: the reference's five
``fsdp_mode`` layouts on its (D, 1) mesh, and "fsdp_only", "dp_full" and
"zero1" on its (1, D) mesh under the production rules).

Every rank runs the same cases on the same global NumPy batches, stores
its blocks of the carried tree (``model.shard_params``; the moments
``model.init_opt``), runs its rows (every row on the (1, D) mesh) and
gathers each block's leaves at use. What a rank holds is gathered and
joined along each leaf's block (``model.param_blocks``), so rank 0
returns the whole trees, with both ranks' losses and norms beside them to
hold the two bitwise. The rank processes import this module, which
imports no JAX; ``tests/test_torch_cuda.py`` imports it on the card.
"""
import contextlib

import numpy as np
import torch

import _torch_tp_world as TW
from repro_torch.core.carry import params_from_reference
from repro_torch.data.synth import lm_batch
from repro_torch.launch.train import train
from repro_torch.models import lm, model as M, sharding as S
from repro_torch.optim import OptConfig, apply_updates

MOE_ARCH, DENSE_ARCH = TW.MOE_ARCH, TW.DENSE_ARCH
# Held against the reference's (2, 1) mesh in the MoE family's subprocess.
MOE_ARCHS = (MOE_ARCH, "deepseek-v2-236b", "jamba-v0.1-52b")
# Held against the one-process port: their FFNs are dense and drop nothing.
ONE_ARCHS = ("mamba2-370m", "seamless-m4t-medium")
ARCHS = MOE_ARCHS + (DENSE_ARCH,) + ONE_ARCHS
STEPS, BATCH, SEED = 3, (2, 32), 5
OPT = dict(lr=1e-3, warmup=2)
SAVE_AT, TRAIN_SEED = 2, 3
MODES = S.FSDP_MODES
# The (1, D) mesh's modes that change the layout or the rules.
PROD_MODES = ("fsdp_only", "dp_full", "zero1")
COMM_KINDS = TW.COMM_KINDS
# The forward: prefill of PREFILL tokens, then DECODE_STEPS into caches of
# CACHE_LEN, under "full".
PREFILL, DECODE_STEPS, CACHE_LEN = (2, 16), 4, 8


def smoke_cfg(arch, mode="full"):
    return TW.smoke_cfg(arch).replace(fsdp_mode=mode)


def train_cases():
    """(name, arch, mode, mesh, steps): every train case of the world, its
    mesh "dp" (the reference's (2, 1), ``--rules fsdp``) or "tp" ((1, 2),
    ``--rules production``)."""
    out = [(f"{MOE_ARCH}_full", MOE_ARCH, "full", "dp", STEPS),
           (f"{MOE_ARCH}_zero1", MOE_ARCH, "zero1", "dp", 1)]
    out += [(f"{a}_full", a, "full", "dp", 1) for a in MOE_ARCHS[1:] + ONE_ARCHS]
    # gemma's "full" runs 2 steps: its second is the dry-run's cell
    out += [(f"{DENSE_ARCH}_{m}", DENSE_ARCH, m, "dp", 2 if m == "full" else 1)
            for m in MODES]
    out += [(f"{DENSE_ARCH}_{m}_tp", DENSE_ARCH, m, "tp", 1) for m in PROD_MODES]
    return out


def rules_of(mesh_kind, mode):
    return S.rules_for("fsdp" if mesh_kind == "dp" else "production", mode)


def batches(arch, steps=STEPS, shape=BATCH, seed=SEED):
    cfg = smoke_cfg(arch)
    return [{k: v.numpy() for k, v in lm_batch(cfg, shape, step, seed=seed,
                                                device="cpu").items()}
            for step in range(steps)]


def inputs(seed=1):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, smoke_cfg(MOE_ARCH).vocab, PREFILL)}


@contextlib.contextmanager
def rules(r, mesh):
    S.set_rules(r, mesh=mesh)
    try:
        yield
    finally:
        S.set_rules(None)


def whole(cfg, tree, mesh, r):
    """The leaves of ``tree`` in ``jax.tree.leaves`` order as float32 NumPy
    copies, each cut leaf joined from the ranks' blocks in rank order."""
    out = []
    blocks = M.param_blocks(cfg, tree, mesh, rules=r) if mesh is not None else None
    for i, leaf in enumerate(lm.tree_leaves(tree)):
        t = leaf.detach().cpu().to(torch.float32, copy=True)
        if blocks is not None and blocks[i] is not None:
            t = torch.cat(list(mesh.gather(t).unbind(0)), dim=blocks[i][0])
        out.append(t.numpy())
    return out


def rows(mesh, t):
    """The ranks' rows of ``t`` joined in rank order (NumPy)."""
    return torch.cat(list(mesh.gather(t.detach().cpu()).unbind(0))).numpy()


def run_case(mesh, tree, arch, mode, r, bs, keep=True):
    """``len(bs)`` train steps of ``arch`` laid out by ``mode`` from the
    carried weights under rules ``r`` over ``mesh`` (None: one process, no
    rules): losses and grad norms (both ranks'), step 1's gradients and the
    parameters after it, whole; the bytes this rank sent in step 2 by
    ``COMM_KINDS``, and what it held there."""
    from repro_torch.launch import dryrun

    cfg, opt = smoke_cfg(arch, mode), OptConfig(**OPT)
    dev = torch.device("cpu") if mesh is None else mesh.device
    params = params_from_reference(tree, cfg, dev)
    got = {"loss": [], "grad_norm": []}
    with rules(r if mesh is not None else None, mesh):
        if mesh is not None:
            params = M.shard_params(cfg, params, mesh)
        state = M.init_opt(cfg, params, opt, mesh)
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
                mblocks = None if mesh is None else M.moment_blocks(cfg, params, mesh)
                params, state, m = apply_updates(params, grads, state, opt, mesh=mesh,
                                                 blocks=blocks, moment_blocks=mblocks)
                m["loss"] = loss
                if keep:
                    got["params1"] = whole(cfg, params, mesh, r)
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
    if mesh is not None:
        got["both"] = mesh.gather(torch.tensor(got["loss"] + got["grad_norm"],
                                               dtype=torch.float64)).numpy()
    return got


def forward_case(mesh, tree, arch, inp, r):
    """``arch``'s prefill of ``inp``'s tokens and DECODE_STEPS decode steps
    into caches of CACHE_LEN under rules ``r``: the logits of every row
    (the ranks' joined)."""
    cfg = smoke_cfg(arch)
    params = params_from_reference(tree, cfg, mesh.device)
    toks = torch.from_numpy(inp["tokens"])
    with rules(r, mesh), torch.no_grad():
        params = M.shard_params(cfg, params, mesh)
        pre = M.make_prefill_step(cfg)(params, {"tokens": toks})
        caches = M.init_cache(cfg, params, toks.shape[0], CACHE_LEN)
        step = M.make_decode_step(cfg)
        dec = []
        for t in range(DECODE_STEPS):
            lg, caches = step(params, caches, toks[:, t:t + 1], t)
            dec.append(rows(mesh, lg[:, 0]))
    return {"prefill": rows(mesh, pre), "decode": np.stack(dec)}


def train_runs(mesh, d_full, d_saved):
    """``train(mesh=, rules="fsdp")`` of smoke moonshot from the seed:
    STEPS steps saving at SAVE_AT into ``d_full``, SAVE_AT steps saving
    into ``d_saved`` (the run ends there, its state only on disk), then
    resumed from ``d_saved`` to STEPS. Each run's losses and final state,
    whole."""
    cfg = smoke_cfg(MOE_ARCH)
    kw = dict(seed=TRAIN_SEED, batch_shape=BATCH, log_every=0, device=mesh.device,
              mesh=mesh, rules="fsdp")
    out = {}
    for name, steps, d, every in [("full", STEPS, d_full, SAVE_AT),
                                  ("saved", SAVE_AT, d_saved, SAVE_AT),
                                  ("resumed", STEPS, d_saved, 0)]:
        params, state, losses = train(cfg, OptConfig(**OPT), steps, ckpt_dir=d,
                                      ckpt_every=every, **kw)
        with rules(S.FSDP_RULES, mesh):
            out[name] = {"losses": losses,
                         "state": whole(cfg, {"params": params, "opt": state}, mesh,
                                        S.FSDP_RULES)}
    return out


def world_cases(mesh, trees, inp, dirs):
    """A rank of the test's world: every case."""
    out = {}
    for name, arch, mode, kind, steps in train_cases():
        out[name] = run_case(mesh, trees[arch], arch, mode, rules_of(kind, mode),
                             batches(arch, steps))
    for arch in (MOE_ARCH, DENSE_ARCH):
        out[f"forward_{arch}"] = forward_case(mesh, trees[arch], arch, inp, S.FSDP_RULES)
    out["train"] = train_runs(mesh, dirs["full"], dirs["saved"])
    return out


def one_process(trees):
    """The one-process port on the same weights and batches: the first step
    of each arch that is held against it."""
    return {arch: run_case(None, trees[arch], arch, "full", None, batches(arch, 1))
            for arch in ONE_ARCHS}


def card_cases(mesh):
    """One step in each mode on the (2, 1) mesh, smoke moonshot, TF32 off:
    a world on the card against a world on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = TW.smoke_trees((MOE_ARCH,))
    return {mode: run_case(mesh, trees[MOE_ARCH], MOE_ARCH, mode, rules_of("dp", mode),
                           batches(MOE_ARCH, 1), keep=False)
            for mode in MODES}


def reference_cases():
    """What the reference subprocesses run, by family: each train case's
    arch, mode, mesh and batches, and the forward's tokens."""
    fam = {"moe": [], "dense": []}
    for name, arch, mode, kind, steps in train_cases():
        if arch in ONE_ARCHS:
            continue
        fam["dense" if arch == DENSE_ARCH else "moe"].append(
            {"name": name, "arch": arch, "mode": mode, "mesh": kind,
             "batches": batches(arch, steps)})
    return fam
