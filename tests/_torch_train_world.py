"""Rank functions of ``tests/test_torch_train_world.py``: training over a
world of ranks (``models/model.loss_and_grads`` and ``make_train_step``
under the batch binding, ``optim.apply_updates(mesh=)``, the a2a MoE's
backward, ``launch/train.train(mesh=)`` with its world checkpoint).

Every rank runs the same cases on the same global NumPy inputs, keeps its
own experts of the carried tree and its rows of each batch, and gathers
what it holds, so rank 0 returns the whole trees. The rank processes
import this module, which imports no JAX; the test process runs the same
functions over an in-process world of one, and ``tests/test_torch_cuda.py``
runs :func:`port_cases` over a world on the card against one on the CPU.
"""
import torch

import _torch_moe_world as MW
from repro_torch.core.bucketing import ordered_fold
from repro_torch.core.carry import params_from_reference
from repro_torch.data.synth import lm_batch
from repro_torch.launch.train import train
from repro_torch.models import lm, model as M, moe, sharding as S
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

MOE_ARCH = MW.MOE_ARCH
# name: (arch, capacity factor or None for the config's, compress_grads).
# At 0.3 cap_send and cap_e drop pairs.
CASES = {"moonshot": (MOE_ARCH, None, False), "moonshot_drop": (MOE_ARCH, 0.3, False),
         "deepseek": ("deepseek-v2-236b", None, False),
         "moonshot_compress": (MOE_ARCH, None, True)}
ARCHS = tuple(dict.fromkeys(arch for arch, _, _ in CASES.values()))
STEPS, BATCH, SEED = 3, (4, 64), 2
OPT = dict(lr=1e-3, warmup=2)
# train(mesh=) on the seeded weights: saved at SAVE_AT, resumed to STEPS.
SAVE_AT, TRAIN_SEED = 2, 3


def case_cfg(case):
    arch, cf, _ = CASES[case]
    return MW.smoke_cfg(arch, cf)


def opt_cfg(case):
    return OptConfig(compress_grads=CASES[case][2], **OPT)


def batches(case):
    """The case's STEPS global batches (NumPy), from the port's ``lm_batch``."""
    cfg = case_cfg(case)
    return [{k: v.numpy() for k, v in lm_batch(cfg, BATCH, step, seed=SEED,
                                                device="cpu").items()}
            for step in range(STEPS)]


def blocks(cfg, tree, mesh):
    """``model.param_blocks`` of ``tree`` under the batch binding: the
    experts' blocks."""
    return M.param_blocks(cfg, tree, mesh, rules=S.BATCH_RULES)


def whole(cfg, tree, mesh):
    """The leaves of ``tree`` in ``jax.tree.leaves`` order as float32 NumPy
    copies (the steps update the tensors in place), each expert leaf joined
    from the ranks' blocks in rank order."""
    out = []
    for leaf, b in zip(lm.tree_leaves(tree), blocks(cfg, tree, mesh)):
        t = leaf.detach().cpu().to(torch.float32, copy=True)
        if b is not None:
            t = torch.cat(list(mesh.gather(t).unbind(0)), dim=b[0])
        out.append(t.numpy())
    return out


def run_case(mesh, trees, case):
    """STEPS train steps of ``case`` from the carried weights over ``mesh``
    under the batch binding: losses, grad norms, step 1's gradients and
    parameters after step 1, whole; the pairs that step 1's forward
    dropped; the bytes this rank sent in step 2 (``comm_step``, by
    ``_torch_moe_world.COMM_KINDS``). Step 1 is ``make_train_step``'s body spelled out
    (``loss_and_grads``, then ``apply_updates``) to keep its gradients."""
    arch = CASES[case][0]
    cfg, opt = case_cfg(case), opt_cfg(case)
    dev = mesh.device
    params = S.shard_experts(params_from_reference(trees[arch], cfg, dev), mesh)
    state = init_opt_state(params, opt)
    step = M.make_train_step(cfg, opt)
    got = {"loss": [], "grad_norm": []}
    with MW.rules(S.BATCH_RULES, mesh):
        for i, b in enumerate(batches(case)):
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            if i:
                before = dict(mesh.comm_bytes)
                params, state, m = step(params, state, b)
                if i == 1:
                    got["comm_step"] = MW.comm_since(mesh, before)
            else:
                moe.reset_dropped()
                loss, grads = M.loss_and_grads(params, cfg, b)
                got["grads"] = whole(cfg, grads, mesh)
                got["dropped"] = mesh.gather(torch.tensor(
                    [moe.DROPPED["cap_send"], moe.DROPPED["cap_e"]])).sum(0).tolist()
                params, state, m = apply_updates(params, grads, state, opt, mesh=mesh,
                                                 blocks=blocks(cfg, params, mesh))
                m["loss"] = loss
                got["params1"] = whole(cfg, params, mesh)
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
    return got


def moe_grads(mesh, p, inp, case, cotangent):
    """``moe_train`` over ``mesh`` under a case of ``_torch_moe_world``
    (tokens cut by sequence or batch, capacity 1.25 or 0.3) and the
    gradient of ``sum(y * cotangent)``: (y, dx, d router, d wi, d wo),
    whole, and the pairs dropped."""
    r, cf = MW.MOE_CASES[case]
    cfg = MW.smoke_cfg(MOE_ARCH, cf)
    dim = 1 if r["batch"] != "model" else 0
    x = MW._cut(inp["moe_x"], dim, mesh).requires_grad_(True)
    w = MW._cut(cotangent, dim, mesh)
    local = {k: v.detach().requires_grad_(True) for k, v in S.shard_experts(p, mesh).items()}
    moe.reset_dropped()
    with MW.rules(r, mesh):
        y = moe.moe_train(local, cfg, x)
        (y * w).sum().backward()
    join = lambda t, d: MW._gather(t.detach(), mesh, d)  # noqa: E731
    drops = mesh.gather(torch.tensor([moe.DROPPED["cap_send"], moe.DROPPED["cap_e"]]))
    router = ordered_fold(mesh.gather(local["router"].grad))     # the ranks' tokens
    return {"y": join(y, dim), "dx": join(x.grad, dim), "router": router.numpy(),
            "wi": join(local["wi"].grad, 0), "wo": join(local["wo"].grad, 0),
            "dropped": drops.sum(0).tolist()}


def train_runs(mesh, d_full, d_saved):
    """``train(mesh=)`` of smoke moonshot from the seed: STEPS steps saving
    at SAVE_AT into ``d_full``; SAVE_AT steps saving into ``d_saved``; then
    resumed from ``d_saved`` to STEPS. Each run's losses and final state,
    whole."""
    cfg = MW.smoke_cfg(MOE_ARCH)
    kw = dict(seed=TRAIN_SEED, batch_shape=BATCH, log_every=0, device=mesh.device,
              mesh=mesh)
    out = {}
    for name, steps, d, every in (("full", STEPS, d_full, SAVE_AT),
                                  ("saved", SAVE_AT, d_saved, SAVE_AT),
                                  ("resumed", STEPS, d_saved, 0)):
        params, state, losses = train(cfg, OptConfig(**OPT), steps, ckpt_dir=d,
                                      ckpt_every=every, **kw)
        out[name] = {"losses": losses,
                     "state": whole(cfg, {"params": params, "opt": state}, mesh)}
    return out


def world_cases(mesh, trees, inp, cotangent, d_full, d_saved):
    """A rank of the test's world: every train case, the MoE layer's
    gradients, and the train() runs."""
    out = {case: run_case(mesh, trees, case) for case in CASES}
    moonshot = MW.moe_layer(params_from_reference(trees[MOE_ARCH], MW.smoke_cfg(MOE_ARCH),
                                                  mesh.device))
    for case in MW.MOE_CASES:
        out[f"moe_{case}"] = moe_grads(mesh, moonshot, inp, case, cotangent)
    out["train"] = train_runs(mesh, d_full, d_saved)
    return out


def port_cases(mesh, d_full, d_saved):
    """Every train case once and the train() runs, TF32 off: a world on the
    card against a world on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = MW.smoke_trees()
    out = {case: run_case(mesh, trees, case) for case in CASES}
    out["train"] = train_runs(mesh, d_full, d_saved)
    return out


def reference_cases():
    """What the reference subprocess runs: the cases, their batches, the
    optimizer settings and the rules."""
    return {name: {"arch": arch, "capacity_factor": cf, "compress": compress,
                   "batches": batches(name)}
            for name, (arch, cf, compress) in CASES.items()}
