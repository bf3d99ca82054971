"""Section 5.2 bucketed reduce: the edge ladder and the threshold search.

Per knapsack k the SCD reduce needs the minimal v with
``sum_{candidates with v1 >= v} v2 <= B_k``. Candidates are histogrammed
into buckets whose widths grow geometrically away from the previous
iterate lam_t, and v is interpolated inside the crossing bucket.
"""
from __future__ import annotations

import torch

__all__ = ["make_edges", "hist_crossings", "threshold_from_hist"]


def make_edges(lam_t, delta, growth, half):
    """Bucket edges per knapsack, centred at the previous iterate.

    lam_t: (K,) -> (K, 2*half + 1), ascending per row. The offset ladder
    ``delta * growth**i`` is computed in float32 on the CPU, so every
    device gets the same offsets.
    """
    i = torch.arange(half, dtype=lam_t.dtype)
    offs = (delta * growth ** i).to(lam_t.device)       # (half,)
    pos = lam_t[:, None] + offs[None, :]
    neg = lam_t[:, None] - offs.flip(0)[None, :]
    return torch.cat([neg, lam_t[:, None], pos], dim=-1)


def hist_crossings(hist, budgets):
    """(rev, cum_above, in_bucket) of a (K, E+1) histogram.

    rev[:, j] is the mass in buckets >= j, cum_above the mass strictly
    above bucket j, and in_bucket marks the buckets where the budget line
    is crossed (feasible above, infeasible including).
    """
    rev = torch.flip(torch.cumsum(torch.flip(hist, [-1]), dim=-1), [-1])
    cum_above = rev - hist
    feasible = cum_above <= budgets[:, None]
    in_bucket = feasible & (rev > budgets[:, None])
    return rev, cum_above, in_bucket


def threshold_from_hist(hist, edges, budgets, top=None):
    """lam_k^{t+1} = minimal v with sum_{v1 >= v} v2 <= B_k, clamped >= 0.

    hist: (K, E+1); edges: (K, E); budgets: (K,); ``top`` (K,) is the max
    candidate, which closes the otherwise unbounded top bucket. Linear
    interpolation inside the crossing bucket.
    """
    k, nb = hist.shape
    if top is None:
        top = edges[:, -1]
    rev, cum_above, in_bucket = hist_crossings(hist, budgets)
    total = rev[:, 0]
    any_cross = torch.any(in_bucket, dim=-1)
    ar = torch.arange(nb, device=hist.device)[None, :]
    j = torch.argmax(torch.where(in_bucket, ar, torch.full_like(ar, -1)),
                     dim=-1)[:, None]                      # (K, 1)
    top_edge = torch.maximum(top, edges[:, -1]) * (1.0 + 1e-6) + 1e-12
    lo = torch.gather(torch.nn.functional.pad(edges, (1, 0)), 1, j)[:, 0]
    hi = torch.gather(torch.cat([edges, top_edge[:, None]], dim=-1), 1, j)[:, 0]
    mass = torch.gather(hist, 1, j)[:, 0]
    above = torch.gather(cum_above, 1, j)[:, 0]
    width = torch.clamp_min(hi - lo, 0.0)
    frac = torch.where(mass > 0, (budgets - above) / torch.clamp_min(mass, 1e-30),
                       torch.ones_like(mass))
    v = hi - width * frac
    zero = torch.zeros_like(v)
    v = torch.where(any_cross, v, zero)
    v = torch.where(total <= budgets, zero, v)
    return torch.clamp_min(v, 0.0)
