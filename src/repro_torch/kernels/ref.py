"""Plain PyTorch versions of the kernels in ``csrc/``.

``candidates_block``, the per-row Alg-5 map, is the plain version of
``scd_candidates``, and ``adjusted_topc_plain`` (the greedy primal) that
of ``adjusted_topc``: both elementwise over rows, and so equal to their
kernels on any input. ``screen_bound_plain`` is a column max, exact in
any order. The three histogram kernels' plain versions reproduce the
kernels' float additions one for one. The rows are cut into tiles of
``tile_n`` (the ragged tail padded with inert rows, which the kernels get
from masked loads), each tile reduces into its own record, and the records
are folded onto the carried seed (``*_init``) in tile order,
``init + rec[0] + rec[1] + ...``; max and min fold exactly.

Inside a tile, the two histogram kernels ``scd_fused_hist`` and
``bucket_hist`` (``csrc/hist_tile.cuh``) add in this order, a function of
row position only:

* the tile is cut into sub-tiles of ``HIST_SUB`` rows from its start, and
  each sub-tile into runs of ``HIST_RUN`` rows (the last of each may be
  short);
* each (k, bin) of a run is the sum of the run's masses in row order, from
  0.0 (``_tile_bin_sums`` adds one row of every run at a time with
  ``index_add_``, whose indices never repeat within a call, so it is exact
  and deterministic on both devices);
* a sub-tile's record is its run sums added in run order from 0.0, and the
  tile's record its sub-tile records in order from 0.0.

The finalize (``scd_finalize_hist``) sums each bin and scalar of a tile
over the tile's rows in row order from 0.0. Inert rows have mass 0.0, and
adding +0.0 to a sum that starts at +0.0 changes no bit, so padding is
invisible. Per-row sums over the K items (``pt``, ``gain``) run left to
right. Together these make a chunked accumulation (chunk size a multiple of
the tile) bitwise equal to one call over all rows, on the CPU as on the
card.

``MAP_TILE`` is the histogram kernels' default tile: any size works, and
8,192 divides the host-fed chunk of 65,536 rows. Each function's records
and seeds share one packed float32 layout with its kernel;
``fused_layout`` and ``finalize_layout`` define it (the ``bucket_hist``
record is the bare (K*(E+1)) histogram).
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")
MAP_TILE = 8192      # default tile of scd_fused_hist and bucket_hist
HIST_SUB = 512       # rows per sub-tile (csrc/hist_tile.cuh)
HIST_RUN = 32        # rows per run


# --------------------------------------------------------------------------
# Packed layouts shared with the CUDA wrappers.
# --------------------------------------------------------------------------

def fused_layout(k, e):
    """(length, n_sum) of a packed scd_fused_hist record:
    [hist (K*(E+1)) | top (K)]. Slots below n_sum fold by +, the rest by max."""
    return k * (e + 1) + k, k * (e + 1)


def finalize_layout(k, e, with_hist):
    """(length, n_sum) of a packed scd_finalize_hist record:
    [cons_hist (K*(E+1)) | gain_hist (E+1) |] r (K) | primal | dual | hi | -lo."""
    hist = k * (e + 1) + (e + 1) if with_hist else 0
    return hist + k + 4, hist + k + 2


def pack_hist_init(k, e, hist_init, device):
    """Seed record of bucket_hist: the (K*(E+1)) histogram, zeros if none."""
    if hist_init is None:
        return torch.zeros((k * (e + 1),), dtype=torch.float32, device=device)
    return hist_init.reshape(-1).to(torch.float32).contiguous()


def unpack_fused(rec, k, e):
    """Packed record -> (hist (K, E+1), top (K,))."""
    nb = e + 1
    return rec[:k * nb].view(k, nb), rec[k * nb:k * nb + k]


def pack_finalize_init(k, e, with_hist, device, cons_hist_init=None,
                       gain_hist_init=None, r_init=None, sums_init=None,
                       maxs_init=None):
    """Seed record of the plain finalize (``scd_finalize_plain``);
    ``maxs_init`` is (hi, -lo). The card's wrapper passes the seeds to its
    fold as separate pointers instead."""
    def seed(x, n, fill):
        if x is None:
            return torch.full((n,), fill, dtype=torch.float32, device=device)
        return x.reshape(-1).to(torch.float32)

    parts = []
    if with_hist:
        parts += [seed(cons_hist_init, k * (e + 1), 0.0),
                  seed(gain_hist_init, e + 1, 0.0)]
    parts += [seed(r_init, k, 0.0), seed(sums_init, 2, 0.0),
              seed(maxs_init, 2, NEG_INF)]
    return torch.cat(parts)


def unpack_finalize(rec, k, e, with_hist, lo=None):
    """Packed record -> (cons_hist, gain_hist, r, primal, dual, lo, hi);
    the histograms are None without ``with_hist``. ``lo``, where given,
    stands for ``-rec[-1]`` (the card's fold writes it beside the record)."""
    nb = e + 1
    ch = gh = None
    o = 0
    if with_hist:
        ch = rec[:k * nb].view(k, nb)
        gh = rec[k * nb:k * nb + nb]
        o = k * nb + nb
    r = rec[o:o + k]
    if lo is None:
        lo = -rec[o + k + 3]
    return ch, gh, r, rec[o + k], rec[o + k + 1], lo, rec[o + k + 2]


def fold_partials(part, init, n_sum):
    """The ordered fold: ``init + part[0] + part[1] + ...`` on the slots
    below ``n_sum``, a running max on the rest. part: (T, L); init: (L,)."""
    acc = init.clone()
    for t in range(part.shape[0]):
        acc = torch.cat([acc[:n_sum] + part[t, :n_sum],
                         torch.maximum(acc[n_sum:], part[t, n_sum:])])
    return acc


# --------------------------------------------------------------------------
# Per-row semantics (Alg 5 candidates, the top-Q greedy mask).
# --------------------------------------------------------------------------

def _tiled(x, tile_n, fill=0.0):
    """(n, K) -> (T * tile_n, K) with inert ``fill`` rows appended."""
    pad = -x.shape[0] % tile_n
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


def _bin_of(v, edges):
    """Searchsorted-left bin per (row, k): the count of edges below v.
    v: (rows, K); edges: (K, E)."""
    return (v[:, :, None] > edges[None, :, :]).sum(-1)


def _tile_bin_sums(idx, v2, nb):
    """(T, K, nb) tile records of (T, tile_n, K) bins and masses, in the
    histogram kernels' order (module doc): runs, then sub-tiles, then the
    tile."""
    t, tile_n, k = idx.shape
    sub = min(tile_n, HIST_SUB)
    subs = -(-tile_n // sub)
    sub_pad = -(-sub // HIST_RUN) * HIST_RUN
    runs = sub_pad // HIST_RUN
    pad = subs * sub_pad - tile_n             # inert rows: bin 0, mass 0.0
    if pad:
        idx = torch.cat([idx, idx.new_zeros((t, pad, k))], dim=1)
        v2 = torch.cat([v2, v2.new_zeros((t, pad, k))], dim=1)
    m = t * subs * runs
    idx = idx.reshape(m, HIST_RUN, k)
    v2 = v2.reshape(m, HIST_RUN, k)
    base = (torch.arange(m, device=idx.device)[:, None] * k
            + torch.arange(k, device=idx.device)[None, :]) * nb
    run_hist = torch.zeros((m * k * nb,), dtype=torch.float32, device=idx.device)
    for r in range(HIST_RUN):
        run_hist.index_add_(0, (base + idx[:, r, :]).reshape(-1),
                            v2[:, r, :].reshape(-1))
    run_hist = run_hist.view(t * subs, runs, k * nb)
    sub_rec = torch.zeros((t * subs, k * nb), dtype=torch.float32, device=idx.device)
    for r in range(runs):
        sub_rec = sub_rec + run_hist[:, r]
    sub_rec = sub_rec.view(t, subs, k * nb)
    tile_rec = torch.zeros((t, k * nb), dtype=torch.float32, device=idx.device)
    for s in range(subs):
        tile_rec = tile_rec + sub_rec[:, s]
    return tile_rec.view(t, k, nb)


def _fold_hist(part, init):
    """The ordered fold of (T, L) histogram records onto ``init`` (L,)."""
    acc = init.clone()
    for t in range(part.shape[0]):
        acc = acc + part[t]
    return acc


def _order_stats(ap, q):
    """Q-th and (Q+1)-th largest per row, by Q+1 masked-max passes that
    knock out the lowest index among the maxima (the kernel's loop)."""
    n, k = ap.shape
    idx = torch.arange(k, device=ap.device)[None, :]
    inf = torch.full((n,), float("inf"), dtype=ap.dtype, device=ap.device)
    q_th, q1_th = inf, inf
    work = ap
    for i in range(q + 1):
        m = work.amax(dim=1)
        if i == q - 1:
            q_th = m
        if i == q:
            q1_th = m
        pick = torch.where(work == m[:, None], idx, k).amin(dim=1)
        work = torch.where(idx == pick[:, None], NEG_INF, work)
    return q_th, q1_th


def candidates_block(p, b, lam, q):
    """Alg 5 candidates (v1, v2) of (n, K) rows; invalid -> (-1, 0). The
    plain version of ``scd_candidates``, and the map of the fused one."""
    ap = torch.clamp_min(p - lam[None, :] * b, 0.0)
    k = p.shape[1]
    if q >= k:
        pbar = torch.zeros_like(ap)
    else:
        q_th, q1_th = _order_stats(ap, q)
        pbar = torch.where(ap >= q_th[:, None], q1_th[:, None], q_th[:, None])
    valid = (p > pbar) & (b > 0)
    safe_b = torch.where(b > 0, b, torch.ones_like(b))
    v1 = torch.where(valid, (p - pbar) / safe_b, -1.0)
    v2 = torch.where(valid, b, 0.0)
    return v1, v2


def topq_mask(ap, q):
    """Top-q strictly positive entries per row, ties to the lower index."""
    n, k = ap.shape
    idx = torch.arange(k, device=ap.device)[None, :]
    x = torch.zeros_like(ap, dtype=torch.bool)
    work = ap
    for _ in range(q):
        m = work.amax(dim=1, keepdim=True)
        is_max = (work == m) & (m > 0)
        pick = torch.where(is_max, idx, k).amin(dim=1, keepdim=True)
        hit = idx == pick
        x = x | hit
        work = torch.where(hit, NEG_INF, work)
    return x


def row_sum(w):
    """Left-to-right sum over the last axis, from 0.0 (the kernel's loop)."""
    s = torch.zeros_like(w[:, 0])
    for j in range(w.shape[1]):
        s = s + w[:, j]
    return s


# --------------------------------------------------------------------------
# The plain versions.
# --------------------------------------------------------------------------

def screen_bound_plain(p, b):
    """Plain version of ``screen_bound``: the (K,) column max of ``p / b``
    over rows with ``b > 0`` (select, then divide, then select: a row with
    b <= 0 gives -inf and never divides by zero)."""
    ok = b > 0
    safe = torch.where(ok, b, torch.ones_like(b))
    return torch.where(ok, p / safe, NEG_INF).amax(dim=0)


def adjusted_topc_plain(p, b, lam, q):
    """Plain version of ``adjusted_topc``: the top-Q strictly positive
    ``p - lam*b`` (a multiply, then a subtract) per row, ties to the lower
    index, as (x (n, K) bool, v = where(x, b, 0))."""
    x = topq_mask(p - lam[None, :] * b, q)
    return x, torch.where(x, b, 0.0)


def bucket_hist_plain(v1, v2, edges, tile_n=MAP_TILE, hist_init=None):
    """Plain version of ``bucket_hist``: (K, E+1) f32, the v2 mass of the
    rows with edges[k, j-1] < v1 <= edges[k, j], folded onto ``hist_init``.
    Pad rows are v1 = -1, v2 = 0."""
    n, k = v1.shape
    e = edges.shape[-1]
    tile_n = min(tile_n, n)
    vv1, vv2 = _tiled(v1, tile_n, -1.0), _tiled(v2, tile_n)
    t = vv1.shape[0] // tile_n
    idx = _bin_of(vv1, edges).view(t, tile_n, k)
    part = _tile_bin_sums(idx, vv2.view(t, tile_n, k), e + 1).reshape(t, -1)
    rec = _fold_hist(part, pack_hist_init(k, e, hist_init, v1.device))
    return rec.view(k, e + 1)


def scd_fused_hist_plain(p, b, lam, edges, q, tile_n=MAP_TILE, hist_init=None,
                         top_init=None):
    """Plain version of ``scd_fused_hist``: (hist (K, E+1) f32, top (K,)).

    hist[k, j] is the v2 mass of the candidates with
    edges[k, j-1] < v1 <= edges[k, j] (searchsorted-left), top the
    running max of v1; both seeded by ``hist_init`` / ``top_init``.
    """
    n, k = p.shape
    e = edges.shape[-1]
    tile_n = min(tile_n, n)
    v1, v2 = candidates_block(_tiled(p, tile_n), _tiled(b, tile_n), lam, q)
    t = v1.shape[0] // tile_n
    idx = _bin_of(v1, edges).view(t, tile_n, k)
    part = _tile_bin_sums(idx, v2.view(t, tile_n, k), e + 1).reshape(t, -1)
    hist = _fold_hist(part, pack_hist_init(k, e, hist_init, p.device))
    top = v1.amax(dim=0)
    if top_init is not None:
        top = torch.maximum(top_init.reshape(-1).to(torch.float32), top)
    return hist.view(k, e + 1), top


def scd_finalize_plain(p, b, lam, pedges, q, tile_n=512, with_hist=True,
                       cons_hist_init=None, gain_hist_init=None, r_init=None,
                       sums_init=None, maxs_init=None):
    """Plain version of ``scd_finalize_hist``.

    Greedy top-Q selection at lam, then r (K,), primal, dual sum and the
    (lo, hi) range of the per-row group profit pt over rows that selected
    anything; with ``with_hist`` also the consumption (K, E+1) and raw
    profit (E+1,) histograms of pt binned against ``pedges`` (E,).
    Returns (cons_hist, gain_hist, r, primal, dual, lo, hi).
    """
    n, k = p.shape
    e = pedges.shape[-1] if with_hist else 0
    tile_n = min(tile_n, n)
    pp, bb = _tiled(p, tile_n), _tiled(b, tile_n)
    t = pp.shape[0] // tile_n
    ap = pp - lam[None, :] * bb
    x = topq_mask(ap, q)
    cons = torch.where(x, bb, 0.0)
    gain = row_sum(torch.where(x, pp, 0.0))
    pt = row_sum(torch.where(x, ap, 0.0))
    sel = x.any(dim=1)
    cons3, gain2, pt2 = cons.view(t, tile_n, k), gain.view(t, tile_n), pt.view(t, tile_n)
    zeros = dict(dtype=torch.float32, device=p.device)
    r_part, s_part = torch.zeros((t, k), **zeros), torch.zeros((t, 2), **zeros)
    if with_hist:
        pidx = (pt[:, None] > pedges[None, :]).sum(-1).view(t, tile_n)
        bins = torch.arange(e + 1, device=p.device)
        ch = torch.zeros((t, k, e + 1), **zeros)
        gh = torch.zeros((t, e + 1), **zeros)
    for r in range(tile_n):
        r_part += cons3[:, r]
        s_part += torch.stack([gain2[:, r], pt2[:, r]], dim=1)
        if with_hist:
            hit = pidx[:, r, None] == bins
            ch += torch.where(hit[:, None, :], cons3[:, r, :, None], 0.0)
            gh += torch.where(hit, gain2[:, r, None], 0.0)
    sel2 = sel.view(t, tile_n)
    hi = torch.where(sel2, pt2, NEG_INF).amax(dim=1)
    nlo = torch.where(sel2, -pt2, NEG_INF).amax(dim=1)
    parts = [ch.reshape(t, -1), gh] if with_hist else []
    part = torch.cat(parts + [r_part, s_part, hi[:, None], nlo[:, None]], dim=1)
    _, n_sum = finalize_layout(k, e, with_hist)
    init = pack_finalize_init(k, e, with_hist, p.device, cons_hist_init,
                              gain_hist_init, r_init, sums_init, maxs_init)
    return unpack_finalize(fold_partials(part, init, n_sum), k, e, with_hist)
