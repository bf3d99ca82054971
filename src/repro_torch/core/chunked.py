"""Streaming-finalize pieces and per-chunk decisions.

The fused finalize (one pass over the chunks after convergence)
accumulates the metrics partials and the §5.4 removable histograms chunk
by chunk through :func:`finalize_chunk_accumulate`; the projection lands
on actual rows only when decisions are read back with
:func:`decisions_rows` at the solved ``(lam, tau)``.

Pinned rounding: ``p - lam*b`` is a multiply and then a subtract (never a
fused multiply-add), and the per-row group profit ``pt`` is a left-to-right
sum over the items, the same additions the finalize kernel performs, so a
row on the removal threshold resolves the same way in the finalize and in
the lookup.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.ref import row_sum
from .solver import _finalize_tile
from .sparse_scd import select_sparse

__all__ = ["StreamResult", "adjusted_profit_chunk", "finalize_chunk_accumulate",
           "decisions_rows", "ordered_fold"]


class StreamResult(NamedTuple):
    """Streaming solve output: no O(n) fields.

    ``tau`` is the §5.4 removal threshold (-inf: nothing removed; +inf:
    the ladder's overflow fallback removed everything). ``fin_hist`` holds
    the finalize's (cons_hist (K, E+1), gain_hist (E+1,)) when
    ``cfg.postprocess``. ``screen`` is the host-fed driver's
    ``HostScreen.stats()`` with ``cfg.screening``, else None.
    """

    lam: torch.Tensor      # (K,) final multipliers
    iters: int             # multiplier iterations run
    r: torch.Tensor        # (K,) post-projection consumption
    primal: torch.Tensor   # () post-projection primal objective
    dual: torch.Tensor     # () dual objective at lam
    tau: torch.Tensor      # () group-profit removal threshold
    fin_hist: Optional[tuple] = None
    screen: Optional[dict] = None


def _num_chunks(n, chunk):
    return -(-n // chunk)


def adjusted_profit_chunk(p_c, b_c, lam):
    """``p - lam*b`` as a multiply and then a subtract (two roundings)."""
    prod = lam[None, :] * b_c
    return p_c - prod


def finalize_chunk_accumulate(p_c, b_c, lam, q, cfg, carry, pedges=None):
    """Fold one chunk into the running finalize accumulators.

    ``carry`` is ``(r (K,), primal (), dual_sum (), lo (), hi ())``, with
    the removable ``(cons_hist (K, E+1), gain_hist (E+1,))`` appended when
    ``pedges`` (the fixed §5.4 ladder) is given. Every accumulator seeds
    the kernel's tile fold, so a chunked finalize is bitwise the one-pass
    finalize (chunk a multiple of the tile).
    """
    tile = _finalize_tile(cfg, p_c.shape[0])
    if pedges is None:
        r, primal, dual_sum, lo, hi = carry
        out = ops.scd_finalize_hist(
            p_c, b_c, lam, None, q, tile_n=tile, with_hist=False, r_init=r,
            sums_init=torch.stack([primal, dual_sum]),
            maxs_init=torch.stack([hi, -lo]))
        return out[2:]
    r, primal, dual_sum, lo, hi, ch, gh = carry
    ch, gh, r, primal, dual_sum, lo, hi = ops.scd_finalize_hist(
        p_c, b_c, lam, pedges, q, tile_n=tile, cons_hist_init=ch,
        gain_hist_init=gh, r_init=r, sums_init=torch.stack([primal, dual_sum]),
        maxs_init=torch.stack([hi, -lo]))
    return r, primal, dual_sum, lo, hi, ch, gh


def ordered_fold(x, dim=0):
    """Sum ``x`` over ``dim`` in strict index order: the float32 left fold
    ``x[0] + x[1] + ... + x[S-1]``, one elementwise add at a time.

    The host-fed driver combines its per-slot partials with it on the
    host, so the combined sums depend only on the slot count, never on how
    a reduction kernel would group the additions.
    """
    acc = x.select(dim, 0).clone()
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _pinned_dot(a, b):
    """lam . budgets as an elementwise multiply and then a sum."""
    return torch.sum(a * b)


def _validate_stream_cfg(cfg):
    """The checks only the streaming drivers make (the resident solve takes
    every one of these configurations)."""
    if cfg.algo == "scd" and cfg.reduce != "bucketed":
        raise ValueError("solve_streaming requires reduce='bucketed' "
                         "(the exact reduce must sort all candidates)")
    if cfg.stream_finalize != "fused":
        raise ValueError(
            f"stream_finalize must be 'fused', got {cfg.stream_finalize!r}")
    if cfg.record_history and cfg.metrics_every < 1:
        raise ValueError(
            "record_history=True would re-scan the whole chunk source on "
            "every iteration when streaming; solve resident "
            "(repro_torch.core.solver.solve), where per-iteration history is "
            "free (the sampled streaming history, metrics_every, is ROADMAP A3)")
    if cfg.screening and (cfg.algo != "scd" or cfg.cd_mode != "sync"
                          or cfg.reduce != "bucketed"):
        raise ValueError(
            "cfg.screening requires the synchronous-SCD bucketed streaming "
            "path (algo='scd', cd_mode='sync', reduce='bucketed'): the "
            "certificates are statements about the bucket ladder "
            "(core/screening.py), and DD and cyclic CD have no bucketed "
            "skip contract.")


def decisions_rows(p_c, b_c, lam, q: int, valid, tau=None):
    """Decision rows (c, K) bool of one chunk at a solved ``(lam, tau)``.

    The greedy top-Q selection at lam; with ``tau``, rows whose group
    profit is at or below tau are removed (the §5.4 projection). ``valid``
    (c,) masks rows past the instance's n.
    """
    x = select_sparse(p_c, b_c, lam, q)
    if tau is not None:
        ap = adjusted_profit_chunk(p_c, b_c, lam)
        pt = row_sum(torch.where(x, ap, 0.0))
        x = x & (pt > tau)[:, None]
    return x & valid[:, None]
