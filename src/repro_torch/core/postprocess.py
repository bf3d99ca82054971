"""Section 5.4 feasibility projection.

Groups are ranked by their cost-adjusted group profit p~_i and removed in
ascending order until every global constraint holds. The resident solve
sorts the groups (:func:`feasibility_threshold_exact`). The streaming
finalize bins p~ against a fixed geometric ladder and accumulates a
removable consumption histogram and a removable raw-profit histogram;
removing every group at or below an edge removes exactly their prefix
sums, so tau and the post-projection (r, primal) need no further pass.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import row_sum
from .bucketing import ordered_cumsum
from .greedy import fma_dot

__all__ = ["group_profit", "feasibility_threshold_exact", "profit_edges_fixed",
           "threshold_and_removed"]


def group_profit(p, cons, lam, x):
    """p~_i = sum_j p_ij x_ij - sum_k lam_k cons_ik: the gain a left-to-right
    row sum, the price a chain of fused multiply-adds (``greedy.fma_dot``).
    p, x: (n, M); cons: (n, K); lam: (K,) -> (n,)."""
    return row_sum(torch.where(x, p, 0.0)) - fma_dot(cons, lam)


def feasibility_threshold_exact(ptilde, cons, budgets):
    """tau of the minimal ascending-p~ prefix whose removal restores every
    budget (-inf when nothing has to go); drop the groups with p~ <= tau.
    ptilde: (n,); cons: (n, K); budgets: (K,)."""
    order = torch.argsort(ptilde, stable=True)
    sorted_p = ptilde[order]
    csum = ordered_cumsum(cons[order], 0)                  # (n, K)
    excess = torch.clamp_min(csum[-1] - budgets, 0.0)
    ok = torch.all(csum >= excess[None, :], dim=-1)
    first_ok = torch.argmax(ok.to(torch.int32))
    inf = torch.tensor(float("-inf"), dtype=ptilde.dtype, device=ptilde.device)
    return torch.where(torch.any(excess > 0), sorted_p[first_ok], inf)


def profit_edges_fixed(n_edges=512, lo=1e-6, hi=1e6, dtype=torch.float32,
                       device="cpu"):
    """Fixed geometric group-profit ladder (E,), ascending.

    Built in float64 NumPy and then cast, so every caller and every device
    gets the same ladder bit for bit.
    """
    ladder = np.logspace(np.log10(lo), np.log10(hi), n_edges)
    return torch.from_numpy(ladder).to(dtype=dtype, device=device)


def threshold_and_removed(cons_hist, gain_hist, edges, r_total, budgets):
    """tau plus the removed (consumption (K,), profit ()) prefix masses.

    cons_hist: (K, E+1); gain_hist: (E+1,); edges: (E,). tau is -inf when
    nothing has to go, and +inf when no edge prefix covers the excess
    (every group is removed, which always fits).
    """
    n_edges = edges.shape[0]
    excess = torch.clamp_min(r_total - budgets, 0.0)
    ccum = torch.cumsum(cons_hist, dim=-1)
    gcum = torch.cumsum(gain_hist, dim=-1)
    feas_e = torch.all(ccum[:, :n_edges] >= excess[:, None], dim=0)
    need = bool(torch.any(excess > 0))
    covered = bool(torch.any(feas_e))
    inf = torch.tensor(float("inf"), dtype=edges.dtype, device=edges.device)
    if not need:
        return -inf, torch.zeros_like(r_total), torch.zeros_like(gcum[0])
    if not covered:
        return inf, ccum[:, n_edges], gcum[n_edges]
    e_star = int(torch.argmax(feas_e.to(torch.int32)))    # first feasible edge
    return edges[e_star], ccum[:, e_star], gcum[e_star]
