"""Kernel entry points: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``scd_fused``,
``scd_candidates``, ``bucket_hist``, ``screen_bound``, ``adjusted_topc``),
which launches or raises. A CPU
tensor goes to the plain PyTorch version (``ref``), which has the
kernel's tile structure and addition order. A ``meta`` tensor (the
dry-run, ``launch/dryrun.py``) goes to the kernel's shape path
(``cost.on_meta``): empty outputs, the card's scratch allocated on
``meta`` and the launch recorded, nothing computed. There is no fallback
from one to another and no switch between them.
"""
from __future__ import annotations

from . import adjusted_topc as _adjusted_topc
from . import bucket_hist as _bucket_hist
from . import cost, ref
from . import scd_candidates as _scd_candidates
from . import scd_fused as _fused
from . import screen_bound as _screen_bound
from ._wrap import LAUNCHES, reset_launches  # noqa: F401

MAP_TILE = ref.MAP_TILE
_TILE_LADDER = (512, 256, 128)


def pick_tile(n, max_tile=512):
    """The finalize's user-axis tile for n rows (its kernel takes at most
    1,024): the largest ladder tile dividing n, else one tile of n rows
    (n <= max_tile) or max_tile with a ragged tail. The histogram kernels
    take any tile and default to ``MAP_TILE``."""
    for t in _TILE_LADDER:
        if t <= max_tile and n % t == 0:
            return t
    return min(max_tile, max(n, 1))


def scd_fused_hist(p, b, lam, edges, q, tile_n=MAP_TILE, hist_init=None,
                   top_init=None):
    """Fused Alg-5 map + §5.2 histogram: (hist (K, E+1), top (K,))."""
    if p.device.type == "meta":
        n, k = p.shape
        e = edges.shape[-1]
        tile = min(tile_n, n)
        out, = cost.on_meta("scd_fused_hist", p, cost.scd_fused_hist(n, k, e, q, tile),
                            e, q, tile)
        return ref.unpack_fused(out, k, e)
    if p.device.type == "cpu":
        return ref.scd_fused_hist_plain(p, b, lam, edges, q, tile_n=tile_n,
                                        hist_init=hist_init, top_init=top_init)
    return _fused.scd_fused_hist(p, b, lam, edges, q, tile_n=tile_n,
                                 hist_init=hist_init, top_init=top_init)


def scd_finalize_hist(p, b, lam, pedges, q, tile_n=512, with_hist=True, **inits):
    """Fused streaming finalize: (cons_hist, gain_hist, r, primal, dual, lo, hi)."""
    if p.device.type == "meta":
        n, k = p.shape
        e = pedges.shape[-1] if with_hist else 0
        tile = min(tile_n, n)
        out, = cost.on_meta("scd_finalize_hist", p,
                            cost.scd_finalize_hist(n, k, e, q, tile, with_hist), e, q, tile)
        return ref.unpack_finalize(out, k, e, with_hist, lo=out[-1])
    if p.device.type == "cpu":
        return ref.scd_finalize_plain(p, b, lam, pedges, q, tile_n=tile_n,
                                      with_hist=with_hist, **inits)
    return _fused.scd_finalize_hist(p, b, lam, pedges, q, tile_n=tile_n,
                                    with_hist=with_hist, **inits)


def scd_candidates(p, b, lam, q):
    """Alg-5 map: the (n, K) candidate pairs (v1, v2)."""
    if p.device.type == "meta":
        n, k = p.shape
        return tuple(cost.on_meta("scd_candidates", p, cost.scd_candidates(n, k, q), q=q))
    if p.device.type == "cpu":
        return ref.candidates_block(p, b, lam, q)
    return _scd_candidates.scd_candidates(p, b, lam, q)


def bucket_hist(v1, v2, edges, tile_n=MAP_TILE, hist_init=None):
    """§5.2 histogram (K, E+1) of (n, K) candidates, seeded by ``hist_init``."""
    if v1.device.type == "meta":
        n, k = v1.shape
        e = edges.shape[-1]
        tile = min(tile_n, n)
        out, = cost.on_meta("bucket_hist", v1, cost.bucket_hist(n, k, e, tile), e, tile=tile)
        return out.view(k, e + 1)
    if v1.device.type == "cpu":
        return ref.bucket_hist_plain(v1, v2, edges, tile_n=tile_n,
                                     hist_init=hist_init)
    return _bucket_hist.bucket_hist(v1, v2, edges, tile_n=tile_n,
                                    hist_init=hist_init)


def screen_bound(p, b, out=None):
    """Screening certificate (K,): the column max of p / b over b > 0 rows,
    written into ``out`` when given (on the CPU, the plain result copied in)."""
    if p.device.type == "meta":
        n, k = p.shape
        res = cost.on_meta("screen_bound", p, cost.screen_bound(n, k, out is not None))
        return out if out is not None else res[0]
    if p.device.type == "cpu":
        res = ref.screen_bound_plain(p, b)
        return res if out is None else out.copy_(res)
    return _screen_bound.screen_bound(p, b, out=out)


def adjusted_topc(p, b, lam, q):
    """Greedy primal at lam: (x (n, K) bool, v = where(x, b, 0))."""
    if p.device.type == "meta":
        n, k = p.shape
        return tuple(cost.on_meta("adjusted_topc", p, cost.adjusted_topc(n, k, q), q=q))
    if p.device.type == "cpu":
        return ref.adjusted_topc_plain(p, b, lam, q)
    return _adjusted_topc.adjusted_topc(p, b, lam, q)
