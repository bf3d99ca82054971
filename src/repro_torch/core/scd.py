"""Algorithms 3 + 4 (map side): SCD candidates of the general GKP.

For coordinate k, item j is the line z_j(lam_k) = a_j - lam_k * b_jk with
a_j = p_j - sum_{k' != k} lam_k' b_jk'. The greedy solution (Alg 1) only
changes where two lines cross or a line crosses zero (Alg 3), so the map
re-solves the greedy problem just left of every such candidate, sweeping
lam_k downward, and emits (v1 = candidate, v2 = consumption increase) as
Alg 4's map does. P = M(M-1)/2 + M candidates per user and coordinate.

The reference vmaps the greedy re-solve over the P candidates and the K
coordinates. Here the coordinates are a loop, and the candidates a batch
dimension cut into groups so that one group's (n, group, M) greedy
intermediates stay below ``_MAX_ELEMS`` elements.
"""
from __future__ import annotations

import torch

from .greedy import adjusted_profit, greedy_solve

__all__ = ["candidates_general", "num_candidates"]

_MAX_ELEMS = 1 << 26


def num_candidates(m: int) -> int:
    """P = M(M-1)/2 pairwise intersections + M zero crossings."""
    return m * (m - 1) // 2 + m


def _cons_left_of(pa, slope, lam_k, cand, sets, caps):
    """Consumption of coordinate k by the greedy solution just left of each
    candidate. pa, slope: (n, M); cand: (n, G) -> (n, G)."""
    c_eff = cand - 1e-5 * (1.0 + torch.abs(cand))
    padj = pa[:, None, :] + ((lam_k - c_eff)[:, :, None] * slope[:, None, :])
    x = greedy_solve(padj, sets, caps)                     # (n, G, M)
    w = torch.where(x, slope[:, None, :], 0.0)
    cons = w[..., 0]
    for j in range(1, w.shape[-1]):
        cons = cons + w[..., j]
    return cons


def candidates_general(p, b, lam, sets, caps):
    """Algorithm 3 + Alg 4 map. p: (n, M), b: (n, M, K), lam: (K,);
    sets (L, M) bool, caps (L,). Returns (v1, v2): (n, K, P); invalid
    candidates are v1 = -1, v2 = 0."""
    n, m = p.shape
    k = lam.shape[0]
    pa = adjusted_profit(p, b, lam)                        # (n, M)
    iu, ju = torch.triu_indices(m, m, offset=1, device=p.device)
    group = max(1, _MAX_ELEMS // max(1, n * m))
    v1s, v2s = [], []
    for kk in range(k):
        slope = b[:, :, kk]                                # (n, M)
        a = pa + lam[kk] * slope                           # intercepts
        # (1) pairwise intersections, (2) zero crossings.
        da = a[:, iu] - a[:, ju]
        db = slope[:, iu] - slope[:, ju]
        inter = torch.where(torch.abs(db) > 1e-12,
                            da / torch.where(db == 0, 1.0, db), -1.0)
        zero = torch.where(slope > 1e-12,
                           a / torch.where(slope <= 1e-12, 1.0, slope), -1.0)
        cand = torch.cat([inter, zero], dim=-1)            # (n, P)
        cand = torch.where(torch.isfinite(cand) & (cand >= 0.0), cand, -1.0)
        cand = torch.sort(cand, dim=-1, descending=True).values
        cons = torch.cat([
            _cons_left_of(pa, slope, lam[kk], cand[:, s:s + group], sets, caps)
            for s in range(0, cand.shape[1], group)], dim=-1)
        prev = torch.nn.functional.pad(cons[:, :-1], (1, 0))
        inc = cons - prev
        valid = (cand >= 0.0) & (inc > 0.0)
        v1s.append(torch.where(valid, cand, -1.0))
        v2s.append(torch.where(valid, inc, 0.0))
    return torch.stack(v1s, dim=1), torch.stack(v2s, dim=1)
