"""Wrappers of the two CUDA kernels in ``csrc/scd_fused.cu``.

``scd_fused_hist`` replaces the reference's Pallas ``scd_fused_hist``
(src/repro/kernels/scd_fused.py, ``_kernel``) and ``scd_finalize_hist``
its ``_finalize_kernel``, with the same signatures and ``*_init`` seeds.
Each wrapper checks its inputs, allocates its scratch and output with
``torch.empty``, launches on the current stream without synchronising
(``scd_fused_hist`` one kernel that folds its records itself; the finalize
a tile kernel and the ordered fold), and raises if a launch returned a
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
    histograms of that profit against ``pedges`` (E,). Seeds: ``r_init``,
    ``sums_init`` (primal, dual), ``maxs_init`` (hi, -lo) and the
    histogram inits. Returns (cons_hist, gain_hist, r, primal, dual, lo, hi).
    """
    tile_n = min(tile_n, p.shape[0])
    n, k = check_p_b_lam("scd_finalize_hist", p, b, lam, tile_n)
    e = 0
    if with_hist:
        e = pedges.shape[-1]
        check("pedges", pedges, (e,), p.device)
    lib = _build.load()
    smem = lib.scd_finalize_smem_bytes(k, e, tile_n)
    check_smem(smem, tile_n, k, e)
    init = ref.pack_finalize_init(k, e, with_hist, p.device, cons_hist_init,
                                  gain_hist_init, r_init, sums_init, maxs_init)
    rec, _ = ref.finalize_layout(k, e, with_hist)
    n_tiles = -(-n // tile_n)
    part = torch.empty((n_tiles, rec), dtype=torch.float32, device=p.device)
    out = torch.empty((rec,), dtype=torch.float32, device=p.device)
    err = lib.scd_finalize_hist_launch(
        p.data_ptr(), b.data_ptr(), lam.data_ptr(),
        pedges.data_ptr() if with_hist else None,
        init.data_ptr(), part.data_ptr(), out.data_ptr(), n, k, e, q, tile_n,
        int(with_hist), stream_of(p))
    launched("scd_finalize_hist", err, lib)
    return ref.unpack_finalize(out, k, e, with_hist)
