"""Rank functions of ``tests/test_torch_tp_world.py``: the prefill and decode
steps under tensor and sequence parallelism over a world of ranks
(``sharding.PRODUCTION_RULES``: heads, KV heads or the cache's positions,
FFN columns, vocab, the residual's sequence and the experts on the world).

Every rank runs the same cases on the same global NumPy inputs and keeps
its blocks of the whole trees (``model.shard_params``); the steps return
the whole logits on every rank, so rank 0 returns them as they are, with
rank 1's beside them to hold the two bitwise. The rank processes import
this module, which imports no JAX; ``tests/test_torch_cuda.py`` runs
:func:`port_cases` over a world on the card against one on the CPU.
"""
import contextlib

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.carry import params_from_reference
from repro_torch.launch import dryrun
from repro_torch.models import lm, model as M, moe, sharding as S

MOE_ARCH, DENSE_ARCH = "moonshot-v1-16b-a3b", "gemma-2b"
ARCHS = (MOE_ARCH, DENSE_ARCH)            # against the reference's (1, 2) mesh
OTHER_ARCHS = ("yi-34b", "qwen3-4b", "starcoder2-3b", "internvl2-26b")
PREFILL = (2, 16)                         # B x S tokens through the prefill
# 6 steps into caches of 8: over a world of 2 positions 4 and 5 land in
# rank 1's block of a cache split by positions ("kv_seq", gemma's one KV
# head), which holds no written position for the first four steps.
DECODE_STEPS, CACHE_LEN = 6, 8
# D = 2 does not divide 15 positions: "seq" is dropped (gemma: dense, so
# nothing but the split moves; the MoE router's world path differs from
# the one-process one at some token counts: it routes without the
# projection, PERF.md §6).
ODD_SEQ = 15
ALONE_STEPS = 2                           # decode steps of each name bound alone
COMM_KINDS = ("gather", "all_to_all", "reduce", "all_gather", "reduce_scatter")


def smoke_cfg(name):
    return registry.get(name).smoke()


def alone(name):
    """The production rules with ``name`` the only name of ``TP_NAMES`` on
    the world ("experts" stays)."""
    return dict(S.PRODUCTION_RULES, **{n: None for n in S.TP_NAMES if n != name})


def inputs(seed=0):
    g = np.random.default_rng(seed)
    cfg = smoke_cfg(MOE_ARCH)
    return {"tokens": g.integers(0, cfg.vocab, PREFILL),
            "odd": g.integers(0, cfg.vocab, (PREFILL[0], ODD_SEQ)),
            "patches": g.standard_normal((PREFILL[0], smoke_cfg("internvl2-26b").n_patches,
                                          cfg.d_model)).astype(np.float32),
            "moe_x": g.standard_normal((PREFILL[0], 1, cfg.d_model)).astype(np.float32)}


def smoke_trees(archs=ARCHS + OTHER_ARCHS):
    """Each arch's ``smoke()`` weights from the port's seeded init (seed 0),
    as NumPy trees: what the reference runs on and the ranks carry."""
    return {a: lm.tree_map(lambda t: t.numpy(), M.init(smoke_cfg(a),
                                                       torch.Generator().manual_seed(0),
                                                       device="cpu"))
            for a in archs}


@contextlib.contextmanager
def rules(r, mesh):
    S.set_rules(r, mesh=mesh)
    try:
        yield
    finally:
        S.set_rules(None)


def comm_since(mesh, before):
    return np.array([mesh.comm_bytes.get(k, 0) - before.get(k, 0) for k in COMM_KINDS])


def run_steps(mesh, params, cfg, toks, r, steps=DECODE_STEPS, patches=None, comm=None):
    """Under rules ``r`` over ``mesh`` (None: one process, no rules): the
    prefill's logits (B, V) and ``steps`` decode steps' (steps, B, V) from
    zero caches of CACHE_LEN, as NumPy; ``comm`` (a dict) receives the
    bytes this rank sent in the prefill and the first decode step and the
    bytes it held for each (the dry-run's ``memory.held``)."""
    comm = {} if comm is None else comm
    batch = {"tokens": toks} if patches is None else {"tokens": toks, "patches": patches}
    with rules(r if mesh is not None else None, mesh), torch.no_grad():
        local = params if mesh is None else M.shard_params(cfg, params, mesh)
        before = dict(mesh.comm_bytes) if mesh is not None else {}
        prefill = M.make_prefill_step(cfg)(local, batch)
        if mesh is not None:
            comm["prefill"] = comm_since(mesh, before)
            comm["held_prefill"] = dryrun.nbytes([local, batch])
        caches = M.init_cache(cfg, local, toks.shape[0], CACHE_LEN)
        step = M.make_decode_step(cfg)
        decode = []
        for t in range(steps):
            before = dict(mesh.comm_bytes) if mesh is not None else {}
            decode.append(step(local, caches, toks[:, t:t + 1], t)[0][:, 0])
            if mesh is not None and not t:
                comm["decode"] = comm_since(mesh, before)
                comm["held_decode"] = dryrun.nbytes([local, caches, toks[:, :1].clone()])
    return prefill.cpu().numpy(), torch.stack(decode).cpu().numpy()


def run_embed(mesh, params, cfg, toks):
    """The vocab-split embedding reduce-scattered to this rank's block of
    the sequence, and the one-process embedding's same block."""
    with torch.no_grad():
        want = lm._embedded(params, cfg, toks, None)
        with rules(S.PRODUCTION_RULES, mesh):
            got = lm._embedded(M.shard_params(cfg, params, mesh), cfg, toks, None)
            lo, hi = S.seq_range(toks.shape[1])
    return got.numpy(), want[:, lo:hi].numpy()


def run_moe_decode(mesh, params, cfg, x):
    """``moe_decode`` of layer 0 under the production rules (every rank the
    same rows, its experts), and the one-process ``moe_decode``."""
    p = lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"])
    with torch.no_grad():
        want = moe.moe_decode(p, cfg, x)
        with rules(S.PRODUCTION_RULES, mesh):
            got = moe.moe_decode(S.shard_experts(p, mesh), cfg, x)
    return got.numpy(), want.numpy()


def both_ranks(mesh, a):
    """Every rank's ``a`` (NumPy), stacked in rank order."""
    return mesh.gather(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def all_cases(mesh, trees, inp):
    """Every case on this rank, under the production rules unless named."""
    out = {}
    toks = torch.from_numpy(inp["tokens"])
    params = {a: params_from_reference(trees[a], smoke_cfg(a), mesh.device) for a in trees}
    for arch in ARCHS + OTHER_ARCHS:
        cfg = smoke_cfg(arch)
        patches = torch.from_numpy(inp["patches"]) if cfg.n_patches else None
        comm = {}
        pre, dec = run_steps(mesh, params[arch], cfg, toks, S.PRODUCTION_RULES,
                             patches=patches, comm=comm)
        out[f"prefill_{arch}"], out[f"decode_{arch}"] = both_ranks(mesh, pre), both_ranks(
            mesh, dec)
        for k, v in comm.items():
            out[f"comm_{k}_{arch}"] = v
    for arch in ARCHS:
        cfg = smoke_cfg(arch)
        for name in S.TP_NAMES:
            out[f"alone_{name}_{arch}"] = run_steps(mesh, params[arch], cfg, toks,
                                                    alone(name), steps=ALONE_STEPS)
    out["odd"] = run_steps(mesh, params[DENSE_ARCH], smoke_cfg(DENSE_ARCH),
                           torch.from_numpy(inp["odd"]), S.PRODUCTION_RULES, steps=1)
    out["embed"] = run_embed(mesh, params[DENSE_ARCH], smoke_cfg(DENSE_ARCH), toks)
    out["moe_decode"] = run_moe_decode(mesh, params[MOE_ARCH], smoke_cfg(MOE_ARCH),
                                       torch.from_numpy(inp["moe_x"]))
    return out


def one_process(trees, inp):
    """The one-process port on the same weights: the other archs' steps,
    each name's and the odd sequence's."""
    out = {}
    toks = torch.from_numpy(inp["tokens"])
    for arch in ARCHS + OTHER_ARCHS:
        cfg = smoke_cfg(arch)
        params = params_from_reference(trees[arch], cfg, torch.device("cpu"))
        patches = torch.from_numpy(inp["patches"]) if cfg.n_patches else None
        out[arch] = run_steps(None, params, cfg, toks, None, patches=patches)
        if arch == DENSE_ARCH:
            out["odd"] = run_steps(None, params, cfg, torch.from_numpy(inp["odd"]), None,
                                   steps=1)
    return out


def world_cases(mesh, trees, inp):
    """A rank of the test's world: every case, twice."""
    return [all_cases(mesh, trees, inp) for _ in range(2)]


def port_cases(mesh):
    """The two reference archs' steps once, TF32 off: a world on the card
    against a world on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = smoke_trees(ARCHS)
    inp = inputs()
    toks = torch.from_numpy(inp["tokens"]).to(mesh.device)
    out = {}
    for arch in ARCHS:
        params = params_from_reference(trees[arch], smoke_cfg(arch), mesh.device)
        out[arch] = run_steps(mesh, params, smoke_cfg(arch), toks, S.PRODUCTION_RULES)
    return out
