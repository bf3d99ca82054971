"""Kernel entry points: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``scd_fused``), which
launches or raises. A CPU tensor goes to the plain PyTorch version
(``ref``), which has the kernel's tile structure and addition order.
There is no fallback from one to the other and no switch between them.
"""
from __future__ import annotations

from . import ref
from . import scd_fused as _kernels

_TILE_LADDER = (512, 256, 128)


def pick_tile(n, max_tile=512):
    """User-axis tile for n rows: the largest ladder tile dividing n, else
    one tile of n rows (n <= max_tile) or max_tile with a ragged tail."""
    for t in _TILE_LADDER:
        if t <= max_tile and n % t == 0:
            return t
    return min(max_tile, max(n, 1))


def scd_fused_hist(p, b, lam, edges, q, tile_n=512, hist_init=None,
                   top_init=None):
    """Fused Alg-5 map + §5.2 histogram: (hist (K, E+1), top (K,))."""
    if p.device.type == "cpu":
        return ref.scd_fused_hist_plain(p, b, lam, edges, q, tile_n=tile_n,
                                        hist_init=hist_init, top_init=top_init)
    return _kernels.scd_fused_hist(p, b, lam, edges, q, tile_n=tile_n,
                                   hist_init=hist_init, top_init=top_init)


def scd_finalize_hist(p, b, lam, pedges, q, tile_n=512, with_hist=True, **inits):
    """Fused streaming finalize: (cons_hist, gain_hist, r, primal, dual, lo, hi)."""
    if p.device.type == "cpu":
        return ref.scd_finalize_plain(p, b, lam, pedges, q, tile_n=tile_n,
                                      with_hist=with_hist, **inits)
    return _kernels.scd_finalize_hist(p, b, lam, pedges, q, tile_n=tile_n,
                                      with_hist=with_hist, **inits)
