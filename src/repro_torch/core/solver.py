"""The per-chunk SCD accumulate and the damped multiplier step.

The resident ``solve`` of the reference is not ported yet (ROADMAP A2);
the host-fed driver in ``core/prefetch.py`` uses these pieces.
"""
from __future__ import annotations

import torch

from ..kernels import ops

__all__ = ["damped_multiplier_step", "scd_chunk_accumulate"]


def _kernel_tile(cfg, n):
    """User-axis tile of the kernels: the cfg override or the ladder."""
    return cfg.kernel_tile if cfg.kernel_tile else ops.pick_tile(n)


def scd_chunk_accumulate(p_c, b_c, lam, edges, q, cfg, hist, top):
    """Fold one (c, K) chunk into the running (hist (K, E+1), top (K,)).

    The carry seeds the chunk's tile fold, so a chunked pass performs the
    same additions as one pass over all rows (chunk a multiple of the tile).
    """
    return ops.scd_fused_hist(p_c, b_c, lam, edges, q,
                              tile_n=_kernel_tile(cfg, p_c.shape[0]),
                              hist_init=hist, top_init=top)


def damped_multiplier_step(lam, dprev, prop, cfg):
    """Proposed lam -> (lam_new, delta, moved).

    A coordinate whose step reverses sign against the previous step is
    scaled by ``cfg.cd_damping``; ``moved`` (a 0-d bool tensor) says the
    largest move still exceeds ``tol * (1 + max(lam))``.
    """
    delta = prop - lam
    if cfg.cd_damping < 1.0 and cfg.algo == "scd":
        delta = delta * torch.where(delta * dprev < 0.0,
                                    torch.full_like(delta, cfg.cd_damping),
                                    torch.ones_like(delta))
    lam_new = lam + delta
    moved = torch.max(torch.abs(lam_new - lam)) > cfg.tol * (1.0 + torch.max(lam))
    return lam_new, delta, moved
