"""Mixture-of-Experts FFN on one process (``src/repro/models/moe.py``).

Two routers: heuristic ``topk`` and the paper's ``scd`` (knapsack-priced,
exact capacity; ``core/moe_router.py``). Both paths here run dense over
every expert with a combine mask, as the reference's single-device path
``_moe_local`` and its decode path ``moe_decode`` do: the expert products
are one batched matrix product over the expert axis, so a step reads
every expert's weights once. Decode always routes with top-k; only
prefill and training reach the SCD router, whose two kernels take up to
256 experts on the card (``core/moe_router.py``). The expert-parallel a2a path
(``_moe_a2a``) waits for the port's world slice (ROADMAP A10).

Shared experts (DeepSeek-style) are ordinary dense MLPs handled by the
caller; this module owns routed experts only.
"""
from __future__ import annotations

import torch

from ..core.moe_router import scd_route, topk_route
from .layers import activation, truncnorm


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


def moe_decode(p, cfg, x, act="silu"):
    """One-token MoE, dense over the experts. x: (B, 1, D) -> (B, 1, D)."""
    return _moe(p, cfg, x, act, decode=True)


def moe_train(p, cfg, x, act="silu"):
    """Prefill (and, in its slice, training) MoE: the reference's
    one-device path ``_moe_local``. x: (B, S, D) -> (B, S, D)."""
    return _moe(p, cfg, x, act, decode=False)
