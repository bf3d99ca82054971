"""Section 5.4 feasibility projection.

Groups are ranked by their cost-adjusted group profit p~_i and removed in
ascending order until every global constraint holds. The resident solve
sorts the groups (:func:`feasibility_threshold_exact`). The streaming
finalize bins p~ against a fixed geometric ladder and accumulates a
removable consumption histogram and a removable raw-profit histogram;
removing every group at or below an edge removes exactly their prefix
sums, so tau and the post-projection (r, primal) need no further pass.

The legacy three-pass finalize (``stream_finalize="legacy"``) keeps the
reference's data-dependent ladder instead: :func:`profit_edges` between
the global (lo, hi) of a metrics pass, the consumption histogram
:func:`removable_hist` of a second pass, and
:func:`threshold_from_removable_hist`; a third pass applies tau.
:func:`feasibility_threshold_bucketed` composes the three for a resident
shard.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..kernels._wrap import MAX_SMEM
from ..kernels.ref import HIST_RUN, HIST_SUB, row_sum
from .bucketing import ordered_cumsum
from .greedy import fma_dot

__all__ = ["group_profit", "feasibility_threshold_exact",
           "feasibility_threshold_bucketed", "profit_edges", "profit_edges_fixed",
           "removable_hist", "threshold_from_removable_hist",
           "threshold_and_removed"]

_REMOVABLE_TILES = (512, 256, 128, 64, 32)


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


def profit_edges(lo, hi, n_edges=512):
    """Linear group-profit ladder (E,) between the global (lo, hi).

    Built in float64 NumPy from the float32 (lo, hi) and then cast, so
    every device gets the same edges; they differ from ``jnp.linspace``'s
    in the last bits (ROADMAP C).
    """
    lo = float(np.float32(lo))
    hi = float(np.float32(hi))
    with np.errstate(invalid="ignore"):
        ladder = np.linspace(lo, hi, n_edges)
    return torch.from_numpy(ladder.astype(np.float32))


def removable_tile(k, n_edges):
    """The ``bucket_hist`` tile of the removable histogram for K knapsacks
    and E edges: the largest of 512, 256, 128, 64 and 32 rows whose run
    histograms (K x (E+1) floats per 32-row run) fit a block's shared
    memory, the same on every device. Raises when none does (at E = 512,
    K above 53)."""
    for tile in _REMOVABLE_TILES:
        rows = min(tile, HIST_SUB)
        runs = -(-rows // HIST_RUN)
        floats = 2 * (-(-rows * k // 4) * 4) + runs * k * (n_edges + 1) + k * n_edges
        if 4 * floats <= MAX_SMEM:
            return tile
    raise ValueError(
        f"the removable histogram bins through bucket_hist, whose block holds "
        f"K x (E+1) run bins in {MAX_SMEM} bytes of shared memory: K={k} at "
        f"E={n_edges} does not fit even at a 32-row tile")


def removable_hist(ptilde, cons, edges, init=None):
    """(K, E+1) removable-consumption mass per group-profit bucket.

    ptilde: (n,); cons: (n, K); edges: (E,) ascending. Bucket j holds the
    consumption of the groups with edges[j-1] < p~ <= edges[j]
    (searchsorted-left). Binned by the ``bucket_hist`` kernel (its plain
    version on a CPU tensor) with v1 = p~ broadcast over the K columns:
    the additions follow its fixed tile order onto ``init``, so a chunked
    accumulation equals one pass over all rows whenever the chunk is a
    multiple of :func:`removable_tile`. Rows of zero consumption add 0.0.
    """
    n, k = cons.shape
    n_edges = edges.shape[0]
    v1 = ptilde[:, None].expand(n, k).contiguous()
    e2 = edges[None, :].expand(k, n_edges).contiguous()
    return ops.bucket_hist(v1, cons.contiguous(), e2,
                           tile_n=removable_tile(k, n_edges), hist_init=init)


def threshold_from_removable_hist(hist, edges, r_total, budgets):
    """Minimal edge tau whose prefix removal restores every budget (-inf
    when already feasible). hist: (K, E+1); edges: (E,); r_total,
    budgets: (K,)."""
    n_edges = edges.shape[0]
    excess = torch.clamp_min(r_total - budgets, 0.0)
    cum = ordered_cumsum(hist[:, :n_edges], -1)
    feas_e = torch.all(cum >= excess[:, None], dim=0)
    if not bool(torch.any(excess > 0)):
        return torch.tensor(float("-inf"), dtype=edges.dtype)
    return edges[int(torch.argmax(feas_e.to(torch.int32)))]


def feasibility_threshold_bucketed(ptilde, cons, r_total, budgets, n_edges=512):
    """tau of a resident shard by the legacy pieces: :func:`profit_edges`
    over the shard's (min, max) p~, :func:`removable_hist`, then
    :func:`threshold_from_removable_hist` (the reference's single-shard
    form; its ``axis`` collectives are ROADMAP A8)."""
    edges = profit_edges(torch.min(ptilde).item(), torch.max(ptilde).item(), n_edges)
    hist = removable_hist(ptilde, cons, edges.to(ptilde.device))
    return threshold_from_removable_hist(hist.cpu(), edges, r_total.cpu(),
                                         budgets.cpu())


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
