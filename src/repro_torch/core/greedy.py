"""Algorithm 1: the greedy optimal solver of the per-user IP subproblem.

With laminar local constraints the per-user subproblem

    max_x  sum_j p~_ij x_ij   s.t.  sum_{j in S_l} x_ij <= C_l,  x in {0,1}

is solved optimally (Proposition 4.1) by keeping, for every set S_l in
topological (leaf -> root) order, only the top-C_l selected items ranked by
cost-adjusted profit p~. The whole shard is solved at once: ranks come from
two stable argsorts (ties to the lower item index).

The contractions are written out element by element, so that each row's
value depends neither on the batch shape nor on the device (the chunked
dense solve then equals the unchunked one bitwise on the card), and so
that they round as the reference's einsums do on the CPU: ``fma_dot`` is
a left-to-right chain of fused multiply-adds, and ``consumption`` (whose
products with a 0/1 mask are exact) a left-to-right sum.
"""
from __future__ import annotations

import torch

__all__ = ["adjusted_profit", "fma_dot", "greedy_solve", "consumption",
           "topc_mask"]


def fma_dot(a, w):
    """sum_k a[..., k] w[k] as a left-to-right chain of fused multiply-adds,
    float32 in and out. Each step ``acc + a_k * w_k`` runs in float64, where
    the product is exact, and is rounded back to float32: one rounding, as
    a float32 FMA, unless the float64 sum falls exactly halfway between two
    float32 values."""
    w64 = w.to(torch.float64)
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for k in range(w.shape[0]):
        acc = (acc.to(torch.float64) + a[..., k].to(torch.float64) * w64[k]
               ).to(torch.float32)
    return acc


def adjusted_profit(p, b, lam):
    """p~_ij = p_ij - sum_k lam_k b_ijk. p: (..., M), b: (..., M, K),
    lam: (K,) -> (..., M).

    At K = 1 the subtraction joins the product in one rounding, as the
    reference's einsum rounds there on the CPU (XLA turns the one-term dot
    into a multiply and contracts it with the subtraction into an FMA): an
    item whose ratio p / b equals lam is then decided by the exact sign of
    p - lam*b, as in the reference, not by a product rounded onto p."""
    if b.shape[-1] == 1:
        exact = p.to(torch.float64) - b[..., 0].to(torch.float64) * lam.to(torch.float64)
        return exact.to(torch.float32)
    return p - fma_dot(b, lam)


def topc_mask(score, c):
    """Mask of the top-``c`` entries of ``score`` along the last axis, ties
    to the lower index. ``c`` may be a 0-d tensor."""
    order = torch.argsort(-score, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < c


def greedy_solve(p_adj, sets, caps):
    """Algorithm 1, batched. p_adj: (..., M); sets: (L, M) bool topo-sorted;
    caps: (L,). Returns x (..., M) bool."""
    x = p_adj > 0
    neg_inf = torch.tensor(float("-inf"), dtype=p_adj.dtype, device=p_adj.device)
    for l in range(sets.shape[0]):
        mask = sets[l]
        score = torch.where(x & mask, p_adj, neg_inf)
        keep = topc_mask(score, caps[l])
        x = x & (keep | ~mask)
    return x


def consumption(b, x):
    """v_ik = sum_j b_ijk x_ij. b: (..., M, K), x: (..., M) -> (..., K)."""
    w = torch.where(x[..., None], b, 0.0)
    v = w[..., 0, :]
    for j in range(1, w.shape[-2]):
        v = v + w[..., j, :]
    return v
