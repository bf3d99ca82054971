"""Rank functions of ``tests/test_torch_tp_mixers.py``: MLA, Mamba2, the
hybrid and the encoder-decoder under tensor and sequence parallelism over a
world of ranks (``sharding.PRODUCTION_RULES``): the prefill, decode steps
and one train step of deepseek-v2-236b, mamba2-370m, jamba-v0.1-52b (one
period) and seamless-m4t-medium at ``smoke()``.

Every rank runs the same cases on the same global NumPy inputs, keeps its
blocks of the carried tree (``model.shard_params``) and runs every row;
rank 0 returns the whole logits, losses and (joined) gradients, with rank
1's beside them to hold the two bitwise. The rank processes import this
module, which imports no JAX; ``tests/test_torch_cuda.py`` runs
:func:`port_cases` over a world on the card against one on the CPU.
"""
import numpy as np
import torch

import _torch_tp_train as TT
import _torch_tp_world as TW
from repro_torch.configs import registry
from repro_torch.core.carry import params_from_reference
from repro_torch.data.synth import lm_batch
from repro_torch.launch import dryrun
from repro_torch.models import lm, model as M, sharding as S
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

ARCHS = ("deepseek-v2-236b", "mamba2-370m", "jamba-v0.1-52b", "seamless-m4t-medium")
HYBRID = "jamba-v0.1-52b"
# B x S of the batch every case runs (seamless: 32 tokens and 32 frames,
# ``lm_batch``'s split); 64 positions are two of Mamba2's smoke chunks.
BATCH, SEED = (2, 64), 5
ENCDEC = "seamless-m4t-medium"
DECODE_STEPS = TW.DECODE_STEPS
OPT = TT.OPT
PROD = S.PRODUCTION_RULES
COMM_KINDS = TW.COMM_KINDS


# One train step at 15 positions, which D = 2 does not divide: "seq" is
# dropped and only the heads split, so a whole leaf's gradient is a partial
# by its split alone (Mamba2's ``in_proj`` and conv, MLA's ``wq_a`` and
# ``wkv_a``: ``model._whole_leaf_split``).
ODD = {"deepseek-v2-236b": (2, 15), "mamba2-370m": (2, 15)}


def cache_len(arch):
    """The decode caches' length: 8, so that deepseek's latent cache, split
    by position, takes steps 4 and 5 in rank 1's block, empty before;
    seamless's 64, the decode cell to which the dry-run gives the batch's
    32 frames (``model._frames_len``)."""
    return BATCH[1] if arch == ENCDEC else TW.CACHE_LEN


def smoke_cfg(name):
    """``smoke()``, jamba at one period (8 layers), as ``tests/test_torch_dryrun.py``
    cuts it."""
    cfg = registry.get(name).smoke()
    return cfg.replace(n_layers=len(cfg.pattern)) if name == HYBRID else cfg


def smoke_trees(archs=ARCHS):
    """Each arch's weights from the port's seeded init (seed 0), as NumPy
    trees: what the reference runs on and the ranks carry."""
    return {a: lm.tree_map(lambda t: t.numpy(), M.init(smoke_cfg(a),
                                                       torch.Generator().manual_seed(0),
                                                       device="cpu"))
            for a in archs}


def batches(arch, steps=2, shape=BATCH):
    """``steps`` global batches of ``shape`` (NumPy) from the port's
    ``lm_batch``."""
    return [{k: v.numpy() for k, v in lm_batch(smoke_cfg(arch), shape, step, seed=SEED,
                                                device="cpu").items()}
            for step in range(steps)]


def _on(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def run_steps(mesh, params, cfg, batch, r=PROD, comm=None):
    """Under rules ``r`` over ``mesh`` (None: one process, no rules): the
    prefill's logits (B, V) and DECODE_STEPS decode steps' (steps, B, V)
    from zero caches of :func:`cache_len` (an encoder-decoder's cross K/V from the
    batch's frames), as NumPy; ``comm`` receives the bytes this rank sent
    in the prefill and the first decode step and what it held for each."""
    comm = {} if comm is None else comm
    toks, frames = batch["tokens"], batch.get("frames")
    pre = {"tokens": toks} if frames is None else {"tokens": toks, "frames": frames}
    with TW.rules(r if mesh is not None else None, mesh), torch.no_grad():
        local = params if mesh is None else M.shard_params(cfg, params, mesh)
        before = dict(mesh.comm_bytes) if mesh is not None else {}
        prefill = M.make_prefill_step(cfg)(local, pre)
        if mesh is not None:
            comm["prefill"] = TW.comm_since(mesh, before)
            comm["held_prefill"] = dryrun.nbytes([local, pre])
        caches = M.init_cache(cfg, local, toks.shape[0], cache_len(cfg.name), frames=frames)
        step = M.make_decode_step(cfg)
        decode = []
        for t in range(DECODE_STEPS):
            before = dict(mesh.comm_bytes) if mesh is not None else {}
            decode.append(step(local, caches, toks[:, t:t + 1], t)[0][:, 0])
            if mesh is not None and not t:
                comm["decode"] = TW.comm_since(mesh, before)
                comm["held_decode"] = dryrun.nbytes([local, caches, toks[:, :1].clone()])
    return prefill.cpu().numpy(), torch.stack(decode).cpu().numpy()


def run_train(mesh, params, cfg, bs, r=PROD):
    """``len(bs)`` (1 or 2) train steps from ``params`` under rules ``r``
    over ``mesh`` (None: one process): step 1 spelled out (its loss, grad
    norm and gradients, and the parameters after ``apply_updates``,
    whole), step 2 through ``make_train_step`` with the bytes this rank
    sent by ``COMM_KINDS`` and what it held."""
    opt = OptConfig(**OPT)
    dev = torch.device("cpu") if mesh is None else mesh.device
    got = {"loss": [], "grad_norm": []}
    with TW.rules(r if mesh is not None else None, mesh):
        if mesh is not None:
            params = M.shard_params(cfg, params, mesh)
        state = init_opt_state(params, opt)
        loss, grads = M.loss_and_grads(params, cfg, _on(bs[0], dev))
        got["grads"] = TT.whole(cfg, grads, mesh, r)
        blocks = None if mesh is None else M.param_blocks(cfg, params, mesh)
        params, state, m = apply_updates(params, grads, state, opt, mesh=mesh, blocks=blocks)
        got["params1"] = TT.whole(cfg, params, mesh, r)
        got["loss"].append(float(loss))
        got["grad_norm"].append(float(m["grad_norm"]))
        for b in bs[1:]:
            before = dict(mesh.comm_bytes) if mesh is not None else {}
            b = _on(b, dev)
            params, state, m = M.make_train_step(cfg, opt)(params, state, b)
            if mesh is not None:
                got["comm_step"] = TW.comm_since(mesh, before)
                got["held_step"] = dryrun.nbytes([params, state, b])
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
    if mesh is not None:
        got["both"] = TT.both(mesh, got["loss"] + got["grad_norm"])
    return got


def arch_cases(mesh, trees, arch):
    """One arch's prefill, decode steps and train steps on this rank."""
    cfg = smoke_cfg(arch)
    bs = batches(arch)
    batch = _on(bs[0], mesh.device)
    params = params_from_reference(trees[arch], cfg, mesh.device)
    comm = {}
    pre, dec = run_steps(mesh, params, cfg, batch, comm=comm)
    out = {"prefill": TW.both_ranks(mesh, pre), "decode": TW.both_ranks(mesh, dec),
           "train": run_train(mesh, params_from_reference(trees[arch], cfg, mesh.device),
                              cfg, bs)}
    out.update({f"comm_{k}": v for k, v in comm.items()})
    if arch in ODD:
        out["odd"] = run_train(mesh, params_from_reference(trees[arch], cfg, mesh.device),
                               cfg, batches(arch, 1, ODD[arch]))
    return out


def world_cases(mesh, trees):
    """A rank of the test's world: every arch's cases, twice."""
    return [{arch: arch_cases(mesh, trees, arch) for arch in ARCHS} for _ in range(2)]


def port_cases(mesh):
    """Every arch's prefill, decode and train steps once, TF32 off: a world
    on the card against a world on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = smoke_trees()
    out = {}
    for arch in ARCHS:
        cfg, bs = smoke_cfg(arch), batches(arch)
        params = params_from_reference(trees[arch], cfg, mesh.device)
        pre, dec = run_steps(mesh, params, cfg, _on(bs[0], mesh.device))
        t = run_train(mesh, params_from_reference(trees[arch], cfg, mesh.device), cfg, bs)
        out[arch] = {"prefill": pre, "decode": dec, "loss": t["loss"],
                     "grad_norm": t["grad_norm"], "both": t.get("both")}
    return out


def one_process(trees):
    """The one-process port on the same weights and batches."""
    out = {}
    for arch in ARCHS:
        cfg, bs = smoke_cfg(arch), batches(arch)
        params = params_from_reference(trees[arch], cfg, torch.device("cpu"))
        pre, dec = run_steps(None, params, cfg, _on(bs[0], torch.device("cpu")))
        t = run_train(None, params_from_reference(trees[arch], cfg, torch.device("cpu")),
                      cfg, bs)
        out[arch] = {"prefill": pre, "decode": dec, "train": t}
    return out
