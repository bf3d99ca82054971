"""Wrappers of the two CUDA kernels in ``csrc/scd_fused.cu``.

``scd_fused_hist`` replaces the reference's Pallas ``scd_fused_hist``
(src/repro/kernels/scd_fused.py, ``_kernel``) and ``scd_finalize_hist``
its ``_finalize_kernel``, with the same signatures and ``*_init`` seeds.
Each wrapper checks its inputs, allocates its scratch and output with
``torch.empty``, launches on the current stream without synchronising
(``scd_fused_hist`` one kernel that folds its records itself; the finalize
a tile kernel and the ordered fold onto its seeds, which it passes as
separate pointers and never packs), and raises if a launch returned a
CUDA error. They take CUDA tensors only; ``kernels.ops``
sends CPU tensors to the plain versions in ``kernels/ref.py``.

``kernels._wrap.LAUNCHES`` counts the launches, one per wrapper call.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._wrap import (check, check_p_b_lam, check_smem, flat_seed, hist_buffers, launched,
                    ptr, stream_of)

__all__ = ["scd_fused_hist", "scd_finalize_hist"]


def scd_fused_hist(p, b, lam, edges, q, tile_n=ref.MAP_TILE, hist_init=None,
                   top_init=None):
    """Fused Alg-5 map + §5.2 histogram on the card, in one launch.

    p, b: (n, K) f32 CUDA; lam: (K,); edges: (K, E) ascending per row;
    tile_n: any size >= 1 (the unit of the addition order, ``ref`` module
    doc). Returns (hist (K, E+1), top (K,)): the v2 mass per
    searchsorted-left bucket of v1 and the max of v1, folded onto
    ``hist_init`` (zeros) and ``top_init`` (-inf) in tile order.
    """
    tile_n = min(tile_n, p.shape[0])
    n, k = check_p_b_lam("scd_fused_hist", p, b, lam, tile_n, max_tile=None)
    e = edges.shape[-1]
    check("edges", edges, (k, e), p.device)
    hist_init = flat_seed("hist_init", hist_init, k * (e + 1), p.device)
    top_init = flat_seed("top_init", top_init, k, p.device)
    lib = _build.load()
    scratch, tickets, out = hist_buffers(lib, p, e, tile_n, True)
    err = lib.scd_fused_hist_launch(
        p.data_ptr(), b.data_ptr(), lam.data_ptr(), edges.data_ptr(),
        ptr(hist_init), ptr(top_init), scratch.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), n, k, e, q, tile_n, stream_of(p))
    launched("scd_fused_hist", err, lib)
    return ref.unpack_fused(out, k, e)


def scd_finalize_hist(p, b, lam, pedges, q, tile_n=512, with_hist=True,
                      cons_hist_init=None, gain_hist_init=None, r_init=None,
                      sums_init=None, maxs_init=None):
    """Fused streaming-finalize pass on the card.

    Greedy top-Q at lam; r (K,), primal, dual sum and the (lo, hi) range
    of the per-row group profit over rows that selected anything; with
    ``with_hist`` the removable consumption (K, E+1) and raw-profit (E+1,)
    histograms of that profit against ``pedges`` (E,), ascending. Seeds:
    ``r_init``, ``sums_init`` (primal, dual), ``maxs_init`` (hi, -lo) and
    the histogram inits, each passed to the fold as its own pointer (None:
    zeros, or -inf for ``maxs_init``). ``tile_n`` <= 1,024. Returns
    (cons_hist, gain_hist, r, primal, dual, lo, hi).
    """
    tile_n = min(tile_n, p.shape[0])
    n, k = check_p_b_lam("scd_finalize_hist", p, b, lam, tile_n)
    e = 0
    seeds = [None, None]
    if with_hist:
        e = pedges.shape[-1]
        check("pedges", pedges, (e,), p.device)
        seeds = [flat_seed("cons_hist_init", cons_hist_init, k * (e + 1), p.device),
                 flat_seed("gain_hist_init", gain_hist_init, e + 1, p.device)]
    seeds += [flat_seed("r_init", r_init, k, p.device),
              flat_seed("sums_init", sums_init, 2, p.device),
              flat_seed("maxs_init", maxs_init, 2, p.device)]
    lib = _build.load()
    check_smem(lib.scd_finalize_smem_bytes(k, e, tile_n), tile_n, k, e)
    rec, _ = ref.finalize_layout(k, e, with_hist)
    part = torch.empty((-(-n // tile_n), lib.scd_finalize_part_stride(k, e)),
                       dtype=torch.float32, device=p.device)
    out = torch.empty((rec + 1,), dtype=torch.float32, device=p.device)  # + lo
    err = lib.scd_finalize_hist_launch(
        p.data_ptr(), b.data_ptr(), lam.data_ptr(),
        pedges.data_ptr() if with_hist else None, *map(ptr, seeds),
        part.data_ptr(), out.data_ptr(), n, k, e, q, tile_n, int(with_hist),
        stream_of(p))
    launched("scd_finalize_hist", err, lib)
    # lo from out[rec], where the fold wrote -(-lo): no negation kernel.
    return ref.unpack_finalize(out, k, e, with_hist, lo=out[rec])
