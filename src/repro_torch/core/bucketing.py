"""Section 5.2 bucketed reduce: the edge ladder and the threshold search.

Per knapsack k the SCD reduce needs the minimal v with
``sum_{candidates with v1 >= v} v2 <= B_k``. Candidates are histogrammed
into buckets whose widths grow geometrically away from the previous
iterate lam_t, and v is interpolated inside the crossing bucket. The
exact reduce (:func:`exact_threshold`) sorts every candidate instead.
"""
from __future__ import annotations

import torch

__all__ = ["make_edges", "bucket_histogram", "hist_crossings",
           "threshold_from_hist", "exact_threshold", "ordered_cumsum",
           "ordered_colsum"]

_SCAN_BLOCK = 2048


def ordered_cumsum(x, dim=-1):
    """Inclusive cumsum along ``dim`` with the same bits on every device and
    every run.

    PyTorch's float cumsum of a 1-D CUDA tensor is a look-back scan whose
    grouping depends on which blocks finish first, and its CPU cumsum adds
    in float64 where the CUDA one adds in float32. Here every sum runs in
    float64 in one fixed order: the axis is cut into blocks of 2048, each
    block is summed one element after another (one CUDA thread per block),
    then the block totals one after another, and each block adds its
    offset; the result is rounded to the input's type once.
    """
    x = x.movedim(dim, -1)
    lead, n = x.shape[:-1], x.shape[-1]
    blocks = max(2, -(-n // _SCAN_BLOCK))
    xp = torch.nn.functional.pad(x.reshape(-1, n).to(torch.float64),
                                 (0, blocks * _SCAN_BLOCK - n))
    r = xp.shape[0]
    # Scanning (L, R*B) along dim 0 walks each block's column in order.
    cols = xp.reshape(r * blocks, _SCAN_BLOCK).T.contiguous().cumsum(0)
    within = cols.T.reshape(r, blocks, _SCAN_BLOCK)
    tot = within[..., -1]                                     # (R, B)
    # The zero column keeps this scan off the 1-D path when R == 1.
    run = torch.cat([tot.T, torch.zeros_like(tot[:1].T)], dim=1).cumsum(0)
    off = torch.nn.functional.pad(run[:-1, :r].T, (1, 0))     # exclusive, (R, B)
    out = (within + off[..., None]).reshape(r, blocks * _SCAN_BLOCK)[:, :n]
    return out.to(x.dtype).reshape(lead + (n,)).movedim(-1, dim)


def ordered_colsum(x):
    """(n, K) -> (K,): the column sums, with the same bits on every device.

    ``torch.sum`` over the rows groups the additions one way on the CPU and
    another on the card. Here the rows are added pairwise by halving: row i
    of the top half plus row i of the bottom half, until one row is left
    (an odd row out is carried to the next level). Every step is an
    elementwise float32 add, which both devices round the same way.
    """
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        pair = x[:h] + x[h:2 * h]
        x = torch.cat([pair, x[2 * h:]]) if x.shape[0] % 2 else pair
    return x[0]


def bucket_histogram(v1, v2, edges, init=None):
    """Candidate mass per (knapsack, bucket), by the reference's rule.

    v1, v2: (n, K); edges: (K, E). Bucket j holds edges[j-1] < v1 <=
    edges[j] (searchsorted-left). The rows are added onto ``init`` (K, E+1)
    one after another in row order, as the reference's scatter-add does.
    CPU tensors only: this is the reference semantics for the tests. The
    solver bins through ``kernels.ops.bucket_hist``, whose CPU version has
    the card's tile order.
    """
    if v1.device.type != "cpu":
        raise ValueError("bucket_histogram adds in row order on the CPU; on "
                         "the card use kernels.ops.bucket_hist")
    n, k = v1.shape
    nb = edges.shape[-1] + 1
    idx = torch.searchsorted(edges.contiguous(), v1.T.contiguous())   # (K, n)
    seg = idx + (torch.arange(k) * nb)[:, None]
    acc = (torch.zeros((k * nb,), dtype=torch.float32) if init is None
           else init.to(torch.float32).reshape(-1).clone())
    acc.index_add_(0, seg.reshape(-1), v2.T.reshape(-1).to(torch.float32))
    return acc.view(k, nb)


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


def exact_threshold(v1, v2, budget, pad_rel=1e-6):
    """The Alg 4 reduce by sorting, batched over leading axes.

    v1, v2: (..., Z) candidates (invalid ones carry v2 == 0); budget (...).
    Returns the minimal candidate v with sum_{v1 >= v} v2 <= budget: 0 if
    every candidate fits, slightly above the largest if none does.
    """
    order = torch.argsort(-v1, dim=-1, stable=True)
    s1 = torch.gather(v1, -1, order)
    s2 = torch.gather(v2, -1, order)
    csum = ordered_cumsum(s2, -1)
    # The sum at s1[i] includes every candidate tied with it: the last
    # index j with s1[j] == s1[i].
    neg = -s1
    last = torch.searchsorted(neg, neg, right=True) - 1
    feas = torch.gather(csum, -1, last) <= budget[..., None]
    z = s1.shape[-1]
    ar = torch.arange(z, device=v1.device)
    idx_last_feas = torch.amax(torch.where(feas, ar, -1), dim=-1)
    v = torch.gather(s1, -1, torch.clamp_min(idx_last_feas, 0)[..., None])[..., 0]
    v = torch.where(~feas[..., 0], s1[..., 0] * (1.0 + pad_rel) + pad_rel, v)
    v = torch.where(feas[..., z - 1], torch.zeros_like(v), v)
    return torch.clamp_min(v, 0.0)
