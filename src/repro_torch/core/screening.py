"""Safe lambda-interval active-set screening for the host-fed SCD solve.

The reference's ``core/screening.py`` under the same names. Whole chunks
whose items can no longer move the bucketed reduce are retired from the
iteration epochs, and the multiplier trajectory stays bitwise the
unscreened solve's. The argument, in short (the reference's module
docstring and its DESIGN.md §11 give it in full):

1. ``v1 = (p - pbar) / b <= p / b`` at every lam (``pbar >= 0``, rounding
   is monotone), so a chunk's certificate, the column max of ``p / b``
   over ``b > 0`` rows (:func:`chunk_bound`), bounds its candidates for
   good.
2. With a floor ``lam_lo <= lam`` checked every epoch, a certificate at or
   below the lowest edge of the ladder at the floor (:func:`lowest_edges`)
   proves every item of the chunk bins into bucket 0 from then on. The
   port's fused kernel folds per-tile partials onto the running histogram
   in order, and a skipped chunk only adds 0.0 to every bucket >= 1, so
   those buckets keep their bits. An escape below the floor reactivates
   every chunk.
3. Bucket 0 reaches the threshold only through the ``total <= budgets``
   early-out and a crossing inside bucket 0; :func:`crossing_trusted`
   checks on the screened histogram, with ``hist_crossings``, that every
   knapsack crosses in a bucket >= 1. When it does not, the epoch runs
   again over every chunk.
4. ``top`` enters only through ``max(top, edges[:, -1])``, and a retired
   candidate sits below ``edges[:, 0]``.

The finalize always streams every chunk. The port computes the
certificates on the card, on the device buffer the chunk's accumulate
reads (``core/prefetch.py``), and hands the rows to :class:`HostScreen`
with :meth:`HostScreen.note_bounds`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from .bucketing import hist_crossings, make_edges

__all__ = ["chunk_bound", "crossing_trusted", "lowest_edges", "HostScreen"]


def chunk_bound(p_c, b_c, out=None):
    """(chunk, K) profits and costs -> (K,) f32: the column max of ``p / b``
    over rows with ``b > 0`` (-inf where there is none), through the
    ``screen_bound`` kernel on a CUDA tensor and its plain version on a
    CPU one; written into ``out`` (a (K,) view) when given."""
    return ops.screen_bound(p_c, b_c, out=out)


def crossing_trusted(hist, budgets):
    """() bool tensor: every knapsack's budget crossing lies in a bucket
    >= 1 of the (K, E+1) histogram, by the floats ``threshold_from_hist``
    uses (``hist_crossings``)."""
    _, _, in_bucket = hist_crossings(hist, budgets)
    return torch.all(torch.any(in_bucket[:, 1:], dim=-1))


def lowest_edges(lam_lo, cfg):
    """(K,) float32 numpy: the lowest bucket edge at the floor, from
    ``make_edges`` itself, so the comparison with a certificate is the one
    the ladder makes."""
    edges = make_edges(torch.as_tensor(np.asarray(lam_lo, np.float32)),
                       cfg.bucket_delta, cfg.bucket_growth, cfg.bucket_half)
    return edges[:, 0].numpy().astype(np.float32)


class HostScreen:
    """Active-set state of the host-fed driver, per global chunk index.

    ``active`` says whether a chunk is still streamed, ``bmax`` (C, K) its
    certificate (+inf until noted) and ``lam_lo`` the floor the
    certificates are checked against. The driver calls :meth:`begin_iter`
    before each iteration epoch, :meth:`note_bounds` with the certificates
    computed in the epoch, and :meth:`retire` after the step. ``seed=``
    warm-starts from a previous solve's :meth:`stats` (the delta refresh):
    chunks inherit their certificates and activity, chunks flagged in
    ``seed["changed"]`` start active with an unknown bound, and the floor
    never starts below the seed's. Screening never steers the trajectory.
    """

    def __init__(self, c: int, k: int, cfg, lam0, seed: Optional[dict] = None):
        self.cfg = cfg
        self.active = np.ones((c,), bool)
        self.bmax = np.full((c, k), np.inf, np.float32)
        lam0 = np.asarray(lam0, np.float32)
        self.lam_lo = (lam0 * np.float32(cfg.screening_floor)).astype(np.float32)
        if seed is not None:
            m = min(c, int(np.asarray(seed["active"]).shape[0]))
            self.active[:m] = np.asarray(seed["active"], bool)[:m]
            self.bmax[:m] = np.asarray(seed["bmax"], np.float32)[:m]
            changed = seed.get("changed")
            if changed is not None:
                ch = np.asarray(changed, bool)
                mm = min(c, ch.shape[0])
                self.active[:mm] |= ch[:mm]
                self.bmax[:mm][ch[:mm]] = np.inf
            # A seeded retired chunk was certified down to the seed's floor
            # only; a warm start below it escapes in begin_iter.
            self.lam_lo = np.maximum(self.lam_lo,
                                     np.asarray(seed["lam_lo"], np.float32))
        self.resets = 0
        self.fallbacks = 0
        self.streamed = []          # chunks streamed per iteration epoch
        self.seeded_active = int(self.active.sum())

    def begin_iter(self, lam) -> bool:
        """Floor check before an epoch; False means lam escaped below the
        floor and every chunk was reactivated (the floor re-anchors)."""
        lam = np.asarray(lam, np.float32)
        ok = bool(np.all(lam >= self.lam_lo))
        floor = (lam * np.float32(self.cfg.screening_floor)).astype(np.float32)
        if ok:
            self.lam_lo = np.maximum(self.lam_lo, floor)
        else:
            self.active[:] = True
            self.resets += 1
            self.lam_lo = floor
        return ok

    def needs_bound(self, i: int) -> bool:
        """Chunk i has no certificate yet."""
        return not bool(np.isfinite(self.bmax[i]).all())

    def note_bounds(self, indices, rows) -> None:
        """Store the (len(indices), K) certificates of those chunks."""
        self.bmax[np.asarray(indices, np.int64)] = np.asarray(rows, np.float32)

    def active_indices(self):
        return np.flatnonzero(self.active)

    def any_retired(self) -> bool:
        return not bool(self.active.all())

    def record_streamed(self, n: int, fallback: bool = False) -> None:
        """Count an epoch's streamed chunks; a fallback pass adds to the
        epoch it repeats."""
        if fallback:
            self.fallbacks += 1
            self.streamed[-1] += n
        else:
            self.streamed.append(int(n))

    def retire(self) -> None:
        """Retire every active chunk whose certificate is at or below the
        floor's lowest edge in every knapsack."""
        e0 = lowest_edges(self.lam_lo, self.cfg)
        can = np.all(self.bmax <= e0[None, :], axis=-1)
        self.active &= ~can

    def stats(self) -> dict:
        return {
            "active": self.active.copy(),
            "bmax": self.bmax.copy(),
            "lam_lo": self.lam_lo.copy(),
            "resets": self.resets,
            "fallbacks": self.fallbacks,
            "streamed_chunks": np.asarray(self.streamed, np.int64),
            "seeded_active": self.seeded_active,
        }
