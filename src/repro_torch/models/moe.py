"""Mixture-of-Experts FFN (``src/repro/models/moe.py``).

Two routers: heuristic ``topk`` and the paper's ``scd`` (knapsack-priced,
exact capacity; ``core/moe_router.py``). On one process both paths run
dense over every expert with a combine mask, as the reference's
single-device path ``_moe_local`` and its decode path ``moe_decode`` do:
the expert products are one batched matrix product over the expert axis,
so a step reads every expert's weights once. Decode always routes with
top-k; only prefill and training reach the SCD router, whose two kernels
take up to 256 experts on the card (``core/moe_router.py``).

Over a world of ranks (the rules of ``models/sharding.py`` bind "experts"
to the world and carry this rank's ``Mesh``; each rank holds its E / D
experts, ``sharding.shard_experts``):

* ``moe_train`` takes the reference's expert-parallel path ``_moe_a2a``:
  the rank routes its own tokens (``scd_route_shmap``: global capacity and
  prices), sends each token-expert pair to the rank that owns the expert
  (``Mesh.all_to_all``, at most ``cap_send`` pairs to a rank), runs each
  local expert over at most ``cap_e`` of the rows it received, and takes
  the results back. Pairs past either capacity are dropped (their output
  is zero); ``DROPPED`` counts them.
* ``moe_decode`` gathers the step's tokens, routes them all (top-k, the
  same on every rank), runs the rank's experts over every token, gathers
  the ranks' partial outputs, folds them in rank order
  (``bucketing.ordered_fold``) and keeps the rank's own rows: the dense
  decode that the reference leaves to GSPMD over its expert-sharded axis.

Training runs through the a2a path as the reference's ``jax.grad`` runs
through its shard_map body: the all-to-alls of the token rows and of the
expert outputs are ``core.mesh.all_to_all`` (the backward is the same
exchange of the gradient; the int32 expert ids take none), the dispatch
writes are recorded by autograd, and the gradient reaches the router
through the values of the top-k sort (the combine weights) while the
prices and masks stay off it. A dropped pair's row is written to a dump
row that nothing reads, so its gradient is zero; no backward adds two
gradients into one row that is read (an indexed read of unique rows, a
broadcast in place of ``repeat_interleave``), so the bits stay run to
run on the card, where an indexed backward adds through atomics.

Shared experts (DeepSeek-style) are ordinary dense MLPs handled by the
caller; this module owns routed experts only.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..core.bucketing import ordered_fold
from ..core.moe_router import scd_route, scd_route_shmap, topk_route
from ..core.mesh import all_to_all
from . import sharding
from .layers import activation, truncnorm

# Token-expert pairs the a2a path dropped since the last reset: past
# ``cap_send`` on the way to an expert's rank, past ``cap_e`` at the expert
# (counted by the rank that received them). A forward pass counts them
# once: the remat recompute of a layer (``lm.remat``) routes the same pairs
# again under :func:`uncounted`.
DROPPED = {"cap_send": 0, "cap_e": 0}
_COUNTING = [True]


def reset_dropped():
    for key in DROPPED:
        DROPPED[key] = 0


@contextlib.contextmanager
def uncounted():
    """Add nothing to :data:`DROPPED` inside (a process-wide switch: the
    recompute runs on autograd's thread while the caller's waits)."""
    _COUNTING[0] = False
    try:
        yield
    finally:
        _COUNTING[0] = True


def init_moe(gen, cfg, device, periods=None):
    m, d = cfg.moe, cfg.d_model
    return {
        "router": truncnorm(gen, (d, m.n_experts), torch.float32, d ** -0.5,
                            device, periods),
        "wi": truncnorm(gen, (m.n_experts, d, 2, m.d_ff), cfg.param_dtype,
                        d ** -0.5, device, periods),
        "wo": truncnorm(gen, (m.n_experts, m.d_ff, d), cfg.param_dtype,
                        m.d_ff ** -0.5, device, periods),
    }


def _route(logits, cfg, decode=False):
    m = cfg.moe
    if m.router == "scd" and not decode:
        out = scd_route(logits, q=m.topk, capacity_factor=m.capacity_factor,
                        iters=m.scd_iters)
    else:
        # Decode always routes with plain top-k: a one-token step has no
        # batch-wide capacity to price.
        out = topk_route(logits, q=m.topk)
    # renormalise combine weights over the chosen experts
    denom = torch.clamp_min(out.combine.sum(-1, keepdim=True), 1e-9)
    return out.combine / denom, out.mask


def _dense_experts(p, t, combine, act):
    """sum_e combine[t, e] * expert_e(t), every expert on every token.

    t: (T, D); combine: (T, E). The reference's einsums
    ``td,edgf->tegf``, ``tef,efd->ted`` and ``ted,te->td``, as batched
    products over the expert axis.
    """
    e, d, _, f = p["wi"].shape
    h = torch.bmm(t.expand(e, *t.shape), p["wi"].reshape(e, d, 2 * f).to(t.dtype))
    g = activation(h[..., :f], act) * h[..., f:]          # (E, T, F)
    y = torch.bmm(g, p["wo"].to(t.dtype))                 # (E, T, D)
    return torch.bmm(combine.to(t.dtype).unsqueeze(1), y.transpose(0, 1))[:, 0]


def _moe(p, cfg, x, act, decode):
    b, s, d = x.shape
    t = x.reshape(b * s, d)
    logits = t.float() @ p["router"]
    combine, _ = _route(logits, cfg, decode=decode)
    return _dense_experts(p, t, combine, act).reshape(b, s, d)


def _expert_world(p, cfg):
    """The rules' ``Mesh`` where they bind "experts", else None; checks that
    ``p`` holds this rank's share of the experts."""
    if sharding.mesh_axis("experts") is None:
        return None
    mesh = sharding.get_mesh()
    if mesh is None:
        raise ValueError("the rules bind 'experts' but carry no Mesh: "
                         "sharding.set_rules(rules, mesh=) with this rank's "
                         "core.mesh.Mesh")
    if not sharding.on_world("experts"):
        raise ValueError(f"'experts' must be bound to the world "
                         f"({sharding.WORLD!r}), got "
                         f"{sharding.mesh_axis('experts')!r}")
    e = cfg.moe.n_experts
    if p["wi"].shape[0] * mesh.size != e:
        raise ValueError(f"this rank holds {p['wi'].shape[0]} of {e} experts; a "
                         f"world of {mesh.size} holds {e // mesh.size} a rank "
                         f"(sharding.shard_experts)")
    return mesh


def moe_decode(p, cfg, x, act="silu"):
    """One-token MoE, dense over the experts. x: (B, 1, D) -> (B, 1, D)."""
    mesh = _expert_world(p, cfg)
    if mesh is None:
        return _moe(p, cfg, x, act, decode=True)
    b, s, d = x.shape
    t = mesh.gather(x.reshape(b * s, d)).to(x.device).reshape(-1, d)
    combine, _ = _route(t.float() @ p["router"], cfg, decode=True)
    e_l = p["wi"].shape[0]
    part = _dense_experts(p, t, combine[:, mesh.rank * e_l:(mesh.rank + 1) * e_l],
                          act)
    y = ordered_fold(mesh.gather(part).to(x.device))
    return y[mesh.rank * b * s:(mesh.rank + 1) * b * s].reshape(b, s, d)


def moe_train(p, cfg, x, act="silu"):
    """Prefill (and training) MoE. x: (B, S, D) -> (B, S, D): the
    reference's one-device path ``_moe_local``, or over a world its a2a
    path, where x is this rank's tokens (cut by batch or by sequence)."""
    mesh = _expert_world(p, cfg)
    if mesh is None:
        return _moe(p, cfg, x, act, decode=False)
    return _moe_a2a(p, cfg, x, act, mesh)


def _exclusive_rank(onehot):
    """Each row's position among the earlier rows with the same one-hot
    column (0 for an all-zero row)."""
    return ((torch.cumsum(onehot, 0, dtype=torch.int32) - onehot) * onehot).sum(-1)


def _moe_a2a(p, cfg, x, act, mesh):
    """This rank's tokens -> a2a -> local expert products -> a2a back
    (the reference's shard_map body, step for step), differentiable."""
    m, n = cfg.moe, mesh.size
    b_l, s_l, d = x.shape
    t_l, k = b_l * s_l, m.topk
    xt = x.reshape(t_l, d)
    e_l = p["wi"].shape[0]

    # routing: global capacity and prices over the world
    logits = xt.float() @ p["router"]                       # (T_l, E)
    if m.router == "scd":
        combine, mask = scd_route_shmap(logits, m.topk, m.capacity_factor,
                                        m.scd_iters, mesh)
    else:
        combine, mask = _route(logits, cfg)
    # jax.lax.top_k's order: descending, ties to the lower index; the
    # gradient flows through the sorted values into ``combine``
    wsel, eid = torch.sort(torch.where(mask, combine, -1.0), dim=-1,
                           descending=True, stable=True)
    wsel, eid = wsel[:, :k], eid[:, :k]

    # per-target send buffers; dropped pairs go to one dump row, never read
    pairs = t_l * k
    eid_f, wsel_f = eid.reshape(pairs), wsel.reshape(pairs)
    with torch.no_grad():
        valid = wsel_f > 0
        target = eid_f // e_l
        onehot = F.one_hot(torch.where(valid, target, n), n + 1)[:, :n].to(torch.int32)
        pos = _exclusive_rank(onehot)
        cap_send = int(m.capacity_factor * pairs / n) + 1
        ok = valid & (pos < cap_send)
        slot = torch.where(ok, target * cap_send + pos, n * cap_send)
        send_le = torch.full((n * cap_send + 1,), e_l, dtype=torch.int32,
                             device=x.device)
        send_le[slot] = (eid_f % e_l).to(torch.int32)
    send_x = x.new_zeros((n * cap_send + 1, d))
    send_x[slot] = xt[:, None].expand(t_l, k, d).reshape(pairs, d)

    rt = n * cap_send
    rx = all_to_all(mesh, send_x[:-1].reshape(n, cap_send, d)).reshape(rt, d)
    rle = mesh.all_to_all(send_le[:-1].reshape(n, cap_send)).reshape(rt).long()

    # group by local expert (cap_e rows each), the expert products
    with torch.no_grad():
        r_onehot = F.one_hot(rle, e_l + 1)[:, :e_l].to(torch.int32)
        r_pos = _exclusive_rank(r_onehot)
        cap_e = int(m.capacity_factor * rt / e_l) + 1
        r_ok = (rle < e_l) & (r_pos < cap_e)
        r_slot = torch.where(r_ok, rle * cap_e + r_pos, e_l * cap_e)
    buf = x.new_zeros((e_l * cap_e + 1, d))
    buf[r_slot] = rx
    f = p["wo"].shape[1]
    h = torch.bmm(buf[:-1].reshape(e_l, cap_e, d),
                  p["wi"].reshape(e_l, d, 2 * f).to(x.dtype))
    g = activation(h[..., :f], act) * h[..., f:]
    y_buf = torch.bmm(g, p["wo"].to(x.dtype)).reshape(e_l * cap_e, d)

    # ungroup, a2a back, combine: a dropped row reads the zero row after
    # the last (the reference's clamped read under ``where``)
    y_r = torch.cat([y_buf, y_buf.new_zeros((1, d))])[r_slot]
    y_back = all_to_all(mesh, y_r.reshape(n, cap_send, d)).reshape(rt, d)
    y_pairs = torch.cat([y_back, y_back.new_zeros((1, d))])[slot]
    w_pairs = torch.where(ok, wsel_f, 0.0)
    if _COUNTING[0]:
        DROPPED["cap_send"] += int((valid & ~ok).sum())
        DROPPED["cap_e"] += int(((rle < e_l) & ~r_ok).sum())
    y = (y_pairs * w_pairs[:, None].to(x.dtype)).reshape(t_l, k, d).sum(1)
    return y.reshape(b_l, s_l, d)
