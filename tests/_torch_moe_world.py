"""Rank functions of ``tests/test_torch_moe_world.py``: the MoE forward over
a world of ranks (``models/sharding.py``, ``moe_train``'s a2a path,
``scd_route_shmap``, the prefill and decode steps under the batch binding).

Every rank runs the same cases on the same global NumPy inputs, cuts its
own share under the case's rules and its own experts out of the whole
tree, and gathers the outputs, so rank 0 returns the global view. The rank
processes import this module, which imports no JAX; the test process runs
the same functions over an in-process world of one, and
``tests/test_torch_cuda.py`` runs :func:`port_cases` over a world on the
card against one on the CPU.
"""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.carry import params_from_reference
from repro_torch.core.moe_router import scd_route_shmap, scd_route_shmap_probs
from repro_torch.models import lm, model as M, moe, sharding as S

MOE_ARCH = "moonshot-v1-16b-a3b"
ARCHS = (MOE_ARCH, "deepseek-v2-236b")
# Tokens cut by sequence (the reference's DEFAULT_RULES with batch on its
# "data" axis, of size 1 here) and by batch (everything else unbound).
SEQ_RULES = dict(S.DEFAULT_RULES, batch="data")
BATCH_RULES = dict(S.DEFAULT_RULES, batch="model", seq=None, kv_seq=None, heads=None,
                   kv_heads=None, ffn=None, vocab=None)
# name: (rules, capacity_factor); at 0.3 cap_send and cap_e drop pairs.
MOE_CASES = {"seq": (SEQ_RULES, 1.25), "batch": (BATCH_RULES, 1.25),
             "seq_drop": (SEQ_RULES, 0.3), "batch_drop": (BATCH_RULES, 0.3)}
# name: (tokens, experts, q) of the router's logits.
ROUTE_CASES = {"smoke": (256, 8, 2), "wide": (512, 64, 6)}
LAM_SHAPE = (4096, 64, 6)           # the world's lam against scd_route_probs
MOE_X = (4, 32)                     # B x S tokens through moe_train
PREFILL = (4, 64)                   # B x S tokens through the prefill
DECODE_STEPS, CACHE_LEN = 4, 16


def smoke_cfg(name, capacity_factor=None):
    cfg = registry.get(name).smoke()
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    return cfg


def inputs(seed=0):
    """The cases' global inputs (NumPy, float32 and int64)."""
    g = np.random.default_rng(seed)
    cfg = smoke_cfg(MOE_ARCH)
    out = {"moe_x": g.standard_normal(MOE_X + (cfg.d_model,)).astype(np.float32),
           "tokens": g.integers(0, cfg.vocab, PREFILL)}
    for name, (t, e, _) in ROUTE_CASES.items():
        out[f"route_{name}"] = (g.standard_normal((t, e)) * 2).astype(np.float32)
    t, e, _ = LAM_SHAPE
    logits = g.standard_normal((t, e)) * 2 + g.standard_normal(e)
    out["lam_probs"] = torch.softmax(torch.tensor(logits, dtype=torch.float32), -1).numpy()
    return out


@contextlib.contextmanager
def rules(r, mesh):
    S.set_rules(r, mesh=mesh)
    try:
        yield
    finally:
        S.set_rules(None)


def _cut(a, dim, mesh):
    """This rank's share of the NumPy array ``a`` along ``dim``, on its
    device."""
    lo, hi = S.rank_rows(a.shape[dim], mesh)
    return torch.from_numpy(a).narrow(dim, lo, hi - lo).to(mesh.device)


def _gather(t, mesh, dim=0):
    """The ranks' ``t`` joined along ``dim`` in rank order, as NumPy."""
    return torch.cat(list(mesh.gather(t).unbind(0)), dim=dim).numpy()


def moe_layer(params):
    """Layer 0's MoE tree (bare, unstacked) of a smoke tree."""
    return lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"])


def run_moe(mesh, p, inp, case):
    """moe_train over ``mesh`` under the case's rules: (output, drops)."""
    r, cf = MOE_CASES[case]
    cfg = smoke_cfg(MOE_ARCH, cf)
    dim = 1 if r["batch"] != "model" else 0
    x = _cut(inp["moe_x"], dim, mesh)
    moe.reset_dropped()
    with rules(r, mesh), torch.no_grad():
        y = moe.moe_train(S.shard_experts(p, mesh), cfg, x)
    drops = mesh.gather(torch.tensor([moe.DROPPED["cap_send"], moe.DROPPED["cap_e"]]))
    return _gather(y, mesh, dim), drops.sum(0).tolist()


def run_route(mesh, inp, case):
    _, _, q = ROUTE_CASES[case]
    logits = _cut(inp[f"route_{case}"], 0, mesh)
    combine, mask = scd_route_shmap(logits, q, 1.25, 4, mesh)
    return _gather(combine, mesh), _gather(mask.to(torch.uint8), mesh).astype(bool)


def run_lam(mesh, inp):
    _, _, q = LAM_SHAPE
    probs = _cut(inp["lam_probs"], 0, mesh)
    return scd_route_shmap_probs(probs, q, 1.25, 4, mesh).lam.cpu().numpy()


def run_steps(mesh, params, cfg, inp):
    """The prefill's logits (B, V) and DECODE_STEPS decode steps' (steps, B,
    V) under the batch binding."""
    toks = torch.from_numpy(inp["tokens"]).to(mesh.device)
    local = S.shard_experts(params, mesh)
    with rules(BATCH_RULES, mesh), torch.no_grad():
        prefill = M.make_prefill_step(cfg)(local, {"tokens": toks})
        caches = M.init_cache(cfg, local, toks.shape[0], CACHE_LEN)
        step = M.make_decode_step(cfg)
        decode = [step(local, caches, toks[:, t:t + 1], t)[0][:, 0]
                  for t in range(DECODE_STEPS)]
    return _gather(prefill, mesh), _gather(torch.stack(decode, 1), mesh).transpose(1, 0, 2)


def all_cases(mesh, trees, inp):
    """Every case on this rank; the gathered outputs by name."""
    out = {}
    moonshot = params_from_reference(trees[MOE_ARCH], smoke_cfg(MOE_ARCH), mesh.device)
    for case in MOE_CASES:
        out[f"moe_{case}"], out[f"drops_{case}"] = run_moe(mesh, moe_layer(moonshot), inp,
                                                           case)
    for case in ROUTE_CASES:
        out[f"route_{case}_combine"], out[f"route_{case}_mask"] = run_route(mesh, inp, case)
    out["lam"] = run_lam(mesh, inp)
    for arch in ARCHS:
        cfg = smoke_cfg(arch)
        params = moonshot if arch == MOE_ARCH else params_from_reference(trees[arch], cfg,
                                                                         mesh.device)
        out[f"prefill_{arch}"], out[f"decode_{arch}"] = run_steps(mesh, params, cfg, inp)
    return out


def smoke_trees():
    """Each arch's ``smoke()`` weights from the port's seeded init (seed 0),
    as NumPy trees: what the reference runs on and the ranks carry."""
    return {a: lm.tree_map(lambda t: t.numpy(), M.init(smoke_cfg(a),
                                                       torch.Generator().manual_seed(0),
                                                       device="cpu"))
            for a in ARCHS}


def world_cases(mesh, trees, inp):
    """A rank of the test's world: every case, twice."""
    return [all_cases(mesh, trees, inp) for _ in range(2)]


def port_cases(mesh):
    """Every case once, TF32 off: a world on the card against a world on
    the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return all_cases(mesh, smoke_trees(), inputs())
