"""The device-streamed solve and the streaming-finalize pieces.

A :class:`ChunkSource` delivers the instance as on-demand (chunk, K)
tensors already on the solve's device: :func:`array_source` slices
arrays held there, and ``data.synth.sparse_chunk_source`` generates each
chunk on the card from ``(seed, i)``. :func:`solve_streaming` runs the
multiplier iteration as a Python loop over the chunk indices. Its passes
are :class:`PassRunner`'s, which the host-fed driver
(``core/prefetch.py``) shares and feeds differently: the same per-chunk
steps (``solver.scd_chunk_accumulate`` for SCD, ``ops.adjusted_topc``
with ``bucketing.ordered_colsum`` for DD, :func:`finalize_chunk_accumulate`
for the finalize) and the same constant-size tail of every pass on the
host CPU in float32. So the device holds O(chunk x K + K x E) state
whatever n is, no chunk crosses the host link, and the result is bitwise
the host-fed solve's over the same bytes.

Pass accounting (the reference's DESIGN.md §5c): a converged solve reads
the source ``iters + 1`` times with the fused finalize (the default) and
``iters + 3`` times with ``stream_finalize="legacy"`` (metrics, the
removable histogram against the data-dependent ladder, the projection
apply). The fused finalize accumulates the metrics partials and the §5.4
removable histograms chunk by chunk (:func:`finalize_chunk_accumulate`);
the projection lands on actual rows only when decisions are read back
with :func:`decisions_chunk` or :func:`decisions_rows` at the solved
``(lam, tau)``.

Pinned rounding: ``p - lam*b`` is a multiply and then a subtract (never a
fused multiply-add), and the per-row group profit ``pt`` is a left-to-right
sum over the items, the same additions the finalize kernel performs, so a
row on the removal threshold resolves the same way in the finalize and in
the lookup.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops
from ..obs import NULL_TRACER
from ..kernels.ref import row_sum
from .bucketing import make_edges, ordered_colsum, ordered_fold, threshold_from_hist
from .postprocess import (
    profit_edges,
    profit_edges_fixed,
    removable_hist,
    threshold_and_removed,
    threshold_from_removable_hist,
)
from .mesh import check_mesh
from .screening import HostScreen, chunk_bound, crossing_trusted
from .solver import (
    _finalize_tile,
    damped_multiplier_step,
    dd_proposal,
    hist_scale,
    resolve_device,
    scd_chunk_accumulate,
    solve,
    solve_shard,
    straggler_mask,
)
from .sparse_scd import select_sparse
from .types import SolverConfig, SparseKP

__all__ = ["ChunkSource", "StreamResult", "array_source", "solve_streaming",
           "stream_solve_fn",
           "decisions_chunk", "decisions_rows", "adjusted_profit_chunk",
           "finalize_chunk_accumulate", "removable_chunk_accumulate",
           "apply_chunk_accumulate", "metrics_row", "ordered_fold"]


class ChunkSource(NamedTuple):
    """A sparse GKP instance delivered as on-demand chunks on the device.

    ``fn(i)`` maps a chunk index to ``(p, b)`` float32 tensors of shape
    (chunk, K) on the solve's device, holding rows [i*chunk, (i+1)*chunk)
    of the virtual (n, K) instance. Rows at index >= n (the ragged tail and
    any index past the last chunk) come back as p = b = 0: inert in every
    pass. ``budgets`` is a (K,) float32 CPU tensor (the tail runs on the
    host). For chunks that live on the host use ``core.prefetch``.
    """

    n: int
    k: int
    chunk: int
    budgets: torch.Tensor
    fn: Callable


class StreamResult(NamedTuple):
    """Streaming solve output: no O(n) fields.

    ``tau`` is the §5.4 removal threshold (-inf: nothing removed; +inf:
    the fused ladder's overflow fallback removed everything). ``history``
    holds the sampled per-iteration records (``cfg.record_history`` with
    ``cfg.metrics_every``), else None. ``fin_hist`` holds the fused
    finalize's (cons_hist (K, E+1), gain_hist (E+1,)) when
    ``cfg.postprocess``. ``screen`` is the host-fed driver's
    ``HostScreen.stats()``, or the device-streamed driver's
    ``{"active_chunks" (max_iters,) with -1 past convergence, "resets",
    "fallbacks"}``, with ``cfg.screening``, else None.
    """

    lam: torch.Tensor      # (K,) final multipliers
    iters: int             # multiplier iterations run
    r: torch.Tensor        # (K,) post-projection consumption
    primal: torch.Tensor   # () post-projection primal objective
    dual: torch.Tensor     # () dual objective at lam
    tau: torch.Tensor      # () group-profit removal threshold
    history: Optional[dict] = None
    fin_hist: Optional[tuple] = None
    screen: Optional[dict] = None


def _num_chunks(n, chunk):
    return -(-n // chunk)


def array_source(kp: SparseKP, chunk: int, device="cuda") -> ChunkSource:
    """A resident ``SparseKP`` served as a :class:`ChunkSource` on ``device``
    (the parity source of the tests): the arrays are moved there and padded
    to a chunk multiple with inert rows once, and ``fn(i)`` returns views;
    an index past the last chunk gets zeros."""
    dev = resolve_device(device)
    p = torch.as_tensor(kp.p).to(dev, torch.float32)
    b = torch.as_tensor(kp.b).to(dev, torch.float32)
    n, k = p.shape
    c = _num_chunks(n, chunk)
    pad = c * chunk - n
    if pad:
        p = torch.cat([p, p.new_zeros((pad, k))])
        b = torch.cat([b, b.new_zeros((pad, k))])
    p3 = p.contiguous().view(c, chunk, k)
    b3 = b.contiguous().view(c, chunk, k)
    zero = torch.zeros((chunk, k), dtype=torch.float32, device=dev)

    def fn(i):
        i = int(i)
        return (p3[i], b3[i]) if 0 <= i < c else (zero, zero)

    budgets = torch.as_tensor(kp.budgets).detach().to("cpu", torch.float32)
    return ChunkSource(n=n, k=k, chunk=chunk, budgets=budgets, fn=fn)


def _chunk(source, i, dev):
    """Chunk i of the source, checked to be on the solve's device."""
    p_c, b_c = source.fn(i)
    if p_c.device != dev or b_c.device != dev:
        raise ValueError(f"chunk {i} of the source is on {p_c.device}; the "
                         f"solve runs on {dev} (build the source there)")
    return p_c, b_c


# --------------------------------------------------------------------------
# Per-chunk steps, shared with the host-fed driver (core/prefetch.py).
# --------------------------------------------------------------------------

def adjusted_profit_chunk(p_c, b_c, lam):
    """``p - lam*b`` as a multiply and then a subtract (two roundings)."""
    prod = lam[None, :] * b_c
    return p_c - prod


def _chunk_primal(p_c, b_c, lam, q):
    """The greedy primal of one chunk at lam: (x, cons, pt), ``pt`` the
    selected adjusted profits summed left to right (the finalize kernel's
    group profit, and :func:`decisions_rows`')."""
    x, cons = ops.adjusted_topc(p_c, b_c, lam, q)
    pt = row_sum(torch.where(x, adjusted_profit_chunk(p_c, b_c, lam), 0.0))
    return x, cons, pt


def finalize_chunk_accumulate(p_c, b_c, lam, q, cfg, carry, pedges=None):
    """Fold one chunk into the running finalize accumulators.

    ``carry`` is ``(r (K,), primal (), dual_sum (), lo (), hi ())``, with
    the removable ``(cons_hist (K, E+1), gain_hist (E+1,))`` appended when
    ``pedges`` (the fixed §5.4 ladder) is given. The scalar sums group by
    chunk, as on the reference's default path: the kernel folds the
    chunk's tiles onto 0.0, and the chunk's r, primal and dual sum are
    then added onto the carry, one float32 add each. (Seeding the kernel
    with the running sums would add every tile record onto a float32
    carry, which drifts at 10^9 rows.) lo/hi and the histograms seed the
    kernel: a max is exact in any order, and both reference paths seed the
    histograms, so those stay bitwise the one-pass finalize's (chunk a
    multiple of the tile).
    """
    tile = _finalize_tile(cfg, p_c.shape[0])
    if pedges is None:
        r, primal, dual_sum, lo, hi = carry
        _, _, r_c, primal_c, dual_c, lo, hi = ops.scd_finalize_hist(
            p_c, b_c, lam, None, q, tile_n=tile, with_hist=False,
            maxs_init=torch.stack([hi, -lo]))
        return r + r_c, primal + primal_c, dual_sum + dual_c, lo, hi
    r, primal, dual_sum, lo, hi, ch, gh = carry
    ch, gh, r_c, primal_c, dual_c, lo, hi = ops.scd_finalize_hist(
        p_c, b_c, lam, pedges, q, tile_n=tile, cons_hist_init=ch,
        gain_hist_init=gh, maxs_init=torch.stack([hi, -lo]))
    return r + r_c, primal + primal_c, dual_sum + dual_c, lo, hi, ch, gh


def removable_chunk_accumulate(p_c, b_c, lam, q, edges, hist):
    """Legacy finalize, pass 2: one chunk's consumption binned by its group
    profit against the data-dependent ladder ``edges`` (E,), onto ``hist``
    (K, E+1) (``postprocess.removable_hist``)."""
    _, cons, pt = _chunk_primal(p_c, b_c, lam, q)
    return removable_hist(pt, cons, edges, init=hist)


def apply_chunk_accumulate(p_c, b_c, lam, q, tau, carry):
    """Legacy finalize, pass 3: the chunk's (r (K,), primal ()) after the
    projection (rows with pt <= tau dropped), added onto ``carry``. The
    sums have a fixed order on every device: ``ordered_colsum`` over the
    rows, the row's gain a left-to-right sum."""
    r2, primal2 = carry
    x, cons, pt = _chunk_primal(p_c, b_c, lam, q)
    keep = (pt > tau)[:, None]
    gain = row_sum(torch.where(x & keep, p_c, 0.0))
    return (r2 + ordered_colsum(torch.where(keep, cons, 0.0)),
            primal2 + ordered_colsum(gain[:, None])[0])


def _pinned_dot(a, b):
    """lam . budgets as an elementwise multiply and then a sum."""
    return torch.sum(a * b)


def metrics_row(r, primal, dual, lam, budgets):
    """One sampled history record from the folded metrics (CPU tensors)."""
    viol = torch.amax(torch.clamp_min(r - budgets, 0.0) / budgets)
    return {"lam": lam, "primal": primal, "dual": dual, "gap": dual - primal,
            "max_violation": viol}


def nan_row(lam):
    """The record of an iteration the history does not sample."""
    nan = torch.tensor(float("nan"), dtype=lam.dtype)
    return {"lam": lam, "primal": nan, "dual": nan, "gap": nan,
            "max_violation": nan}


def fin_zeros(k, nb, postprocess, device):
    """Fresh finalize carries on ``device``: zeros, lo = +inf, hi = -inf,
    and with ``postprocess`` the (K, nb) and (nb,) removable histograms."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    carry = (full((k,), 0.0), full((), 0.0), full((), 0.0),
             full((), float("inf")), full((), float("-inf")))
    if postprocess:
        carry = carry + (full((k, nb), 0.0), full((nb,), 0.0))
    return carry


def _validate_stream_cfg(cfg):
    """The checks only the streaming drivers make (the resident solve takes
    every one of these configurations)."""
    if cfg.algo == "scd" and cfg.reduce != "bucketed":
        raise ValueError("solve_streaming requires reduce='bucketed' "
                         "(the exact reduce must sort all candidates)")
    if cfg.stream_finalize not in ("fused", "legacy"):
        raise ValueError(
            f"stream_finalize must be 'fused' or 'legacy', "
            f"got {cfg.stream_finalize!r}")
    if cfg.record_history and cfg.metrics_every < 1:
        raise ValueError(
            "record_history=True would re-scan the whole chunk source on "
            "every iteration when streaming. Either set cfg.metrics_every=m "
            "to sample the streamed metrics every m-th iteration (one extra "
            "source pass per sample), or solve resident "
            "(repro_torch.core.solver.solve), where per-iteration history "
            "is free.")
    if cfg.screening and (cfg.algo != "scd" or cfg.cd_mode != "sync"
                          or cfg.reduce != "bucketed"):
        raise ValueError(
            "cfg.screening requires the synchronous-SCD bucketed streaming "
            "path (algo='scd', cd_mode='sync', reduce='bucketed'): the "
            "certificates are statements about the bucket ladder "
            "(core/screening.py), and DD and cyclic CD have no bucketed "
            "skip contract.")


# --------------------------------------------------------------------------
# The passes, written once for both streamed drivers.
# --------------------------------------------------------------------------

class PassRunner:
    """The iteration, metrics and finalize passes over S virtual slots.

    Each pass is a list of items ``(s, j)`` (slot ``s``'s chunk ``j``,
    global chunk ``s * cps + j``) fed column by column to a step that
    advances slot s's own device carry, so slot s accumulates its chunks in
    order; S = 1 is the plain pass over the chunks. The constant-size tail
    of each pass (the slot fold, threshold recovery or the DD step, the
    damped step, the screening guard, the §5.4 thresholds) runs on the host
    CPU in float32, so ``lam``, ``dprev`` and the results are CPU tensors.

    Over a mesh (``core.mesh.Mesh`` of D ranks, D dividing S) rank r runs
    only its slots [r*S/D, (r+1)*S/D); every fold gathers all S partials
    and folds them in slot order on every rank, so the bits depend on S and
    never on D, and every rank takes the same host decisions. With a mesh
    or S > 1 (the reference's sharded runtime), ``cfg.partial_fraction <
    1`` drops the slots past that fraction: each
    slot's SCD histogram is scaled by ``keep * scale`` before the fold
    (linear in v2, as the reference's kernel path), DD's r by ``keep``
    before it and by ``scale`` after; top stays unmasked.

    A driver provides how chunks arrive: :meth:`_chunk_of` (one slot's
    chunk), ``zero`` (the inert chunk fed to a retired slot) and
    :meth:`_run_epoch` (``state = step(state, p_c, b_c, item)`` over the
    items, ``on_step(item, state)`` after each). :class:`_DeviceRunner`
    loops over a :class:`ChunkSource` on the device;
    ``prefetch._SlotRuntime`` uploads host chunks through its double
    buffer. Everything else is shared, so the two drivers perform the same
    arithmetic on the same bytes.

    With a :class:`HostScreen` installed (over the S * cps chunk slots, on
    every rank) the SCD passes are screened: a column whose chunk slots are
    all retired is skipped and a retired slot of a streamed column is fed a
    zero chunk. The certificates are computed on the device, by
    ``screen_bound`` on the chunk the step reads, into row g of ``bound_d``
    (S * cps, K); the rows noted in a pass reach the host once (gathered
    from their ranks), before ``retire``.
    """

    tracer = NULL_TRACER

    def __init__(self, source, cfg, q, slots, device, mesh=None):
        self.source, self.cfg, self.q = source, cfg, q
        self.slots = slots
        self.device = device
        self.mesh = mesh
        self.spd = slots // (mesh.size if mesh is not None else 1)
        self.s0 = self.spd * (mesh.rank if mesh is not None else 0)
        self.c = _num_chunks(source.n, source.chunk)
        self.cps = -(-self.c // slots)
        self.budgets = torch.as_tensor(np.asarray(source.budgets), dtype=cfg.dtype)
        self.pedges = profit_edges_fixed(cfg.profit_buckets, cfg.profit_ladder_lo,
                                         cfg.profit_ladder_hi, cfg.dtype)
        self.mask = None
        if (mesh is not None or slots > 1) and cfg.partial_fraction < 1.0:
            self.mask = [straggler_mask(cfg.partial_fraction, s, slots)
                         for s in self._slots()]
        self.scr = None
        self.bound_d = None
        self.active_counts = []

    # -- how chunks arrive (the drivers override these) --------------------

    def _chunk_of(self, s, j):
        raise NotImplementedError

    def _run_epoch(self, step, state, kind, items, fetch=None, on_step=None):
        raise NotImplementedError

    def _note_wall(self, t0):
        """Close the current pass's wall clock; returns the time now."""
        return time.perf_counter()

    def _sync(self):
        """Wait for the queued steps (the host-fed feeder's compute stream)."""

    # -- this rank's slots and the collectives -------------------------------

    def _slots(self):
        return range(self.s0, self.s0 + self.spd)

    def _gather(self, local):
        """This rank's (spd, ...) slot partials -> all S, (S, ...) on the host."""
        local = torch.stack([x.cpu() for x in local])
        if self.mesh is None:
            return local
        out = self.mesh.gather(local)
        return out.reshape((self.slots,) + tuple(local.shape[1:]))

    def _max(self, local):
        out = torch.amax(torch.stack([x.cpu() for x in local]), dim=0)
        return out if self.mesh is None else self.mesh.amax(out)

    def _min(self, local):
        out = torch.amin(torch.stack([x.cpu() for x in local]), dim=0)
        return out if self.mesh is None else self.mesh.amin(out)

    def _fold(self, parts):
        """One field's slot partials (this rank's), folded over all S slots
        in slot order on the host."""
        return ordered_fold(self._gather(parts))

    def _fold_hist(self, parts):
        """The SCD histograms' fold, each slot's scaled by the straggler
        mask first."""
        if self.mask is not None:
            parts = [h.cpu() * hist_scale(*m) for h, m in zip(parts, self.mask)]
        return self._fold(parts)

    # -- the passes --------------------------------------------------------

    def install_screen(self, scr):
        self.scr = scr
        self.bound_d = torch.full((self.slots * self.cps, self.source.k),
                                  float("inf"), dtype=torch.float32,
                                  device=self.device)

    def _items(self, cols):
        return [(s, int(j)) for j in cols for s in self._slots()]

    def _fetch(self, item):
        return self._chunk_of(*item)

    def _fetch_screened(self, item):
        s, j = item
        if not self.scr.active[s * self.cps + j]:
            return self.zero, self.zero
        return self._chunk_of(s, j)

    def iter_epoch(self, lam, dprev):
        """One sync-SCD, cyclic-CD or DD iteration: (lam_new, delta, moved).
        Cyclic CD runs K SCD passes, the k-th moving coordinate k."""
        t0 = time.perf_counter()
        cfg, dev, s0 = self.cfg, self.device, self.s0
        lam_d = lam.to(dev)
        if cfg.algo == "dd":
            def step(rs, p_c, b_c, item):
                i = item[0] - s0
                rs[i] = rs[i] + ordered_colsum(
                    ops.adjusted_topc(p_c, b_c, lam_d, self.q)[1])
                return rs

            rs = self._run_epoch(step, [torch.zeros_like(lam_d)
                                        for _ in range(self.spd)],
                                 "iterate", self._items(range(self.cps)))
            if self.mask is None:
                r = self._fold(rs)
            else:
                r = self._fold([x.cpu() * m[0] for x, m in zip(rs, self.mask)])
                r = r * self.mask[0][1]
            prop = dd_proposal(lam, r, self.budgets, cfg)
        elif cfg.cd_mode == "cyclic":
            prop = lam.clone()
            for kk in range(self.source.k):
                edges = make_edges(prop, cfg.bucket_delta, cfg.bucket_growth,
                                   cfg.bucket_half)
                hist, top = self._scd_pass(prop.to(dev), edges.to(dev), "iterate")
                prop[kk] = threshold_from_hist(hist, edges, self.budgets, top)[kk]
        else:
            edges = make_edges(lam, cfg.bucket_delta, cfg.bucket_growth,
                               cfg.bucket_half)
            edges_d = edges.to(dev)
            if self.scr is None:
                hist, top = self._scd_pass(lam_d, edges_d, "iterate")
            else:
                hist, top, t0 = self._scd_pass_screened(lam, lam_d, edges_d, t0)
            prop = threshold_from_hist(hist, edges, self.budgets, top)
        lam_new, delta, moved = damped_multiplier_step(lam, dprev, prop, cfg)
        self._note_wall(t0)
        return lam_new, delta, bool(moved)

    def _scd_pass(self, lam_d, edges_d, kind, items=None, noted=(), fetch=None):
        """(hist, top) on the host from one pass over ``items`` (default
        every column); the chunk slots in ``noted`` also get their
        certificate."""
        k, cps, s0 = self.source.k, self.cps, self.s0
        noted = set(noted)
        carry = [(torch.zeros((k, edges_d.shape[-1] + 1), dtype=torch.float32,
                              device=self.device),
                  torch.full((k,), float("-inf"), dtype=torch.float32,
                             device=self.device))
                 for _ in range(self.spd)]

        def step(carry, p_c, b_c, item):
            s, j = item
            if s * cps + j in noted:
                chunk_bound(p_c, b_c, out=self.bound_d[s * cps + j])
            carry[s - s0] = scd_chunk_accumulate(p_c, b_c, lam_d, edges_d, self.q,
                                                 self.cfg, *carry[s - s0])
            return carry

        if items is None:
            items = self._items(range(cps))
        carry = self._run_epoch(step, carry, kind, items, fetch)
        return self._fold_hist([h for h, _ in carry]), self._max([t for _, t in carry])

    def _noted_rows(self, noted):
        """The certificate rows ``noted`` (chunk slots of every rank), each
        from the rank that computed it: (len(noted), K) on the host."""
        rows = self.bound_d[noted].cpu()
        if self.mesh is None:
            return rows
        every = self.mesh.gather(rows)                      # (D, L, K)
        owner = torch.tensor([g // self.cps // self.spd for g in noted])
        return every[owner, torch.arange(len(noted))]

    def _scd_pass_screened(self, lam, lam_d, edges_d, t0):
        """The reference's screened iteration: the floor protocol
        (``HostScreen.begin_iter``), a pass over the columns with an active
        chunk slot, the retired slots fed zeros; when the crossing guard
        cannot certify its histogram, one full pass (which notes nothing,
        and whose epoch starts the wall clock anew: the returned t0). Then
        the certificates and the retirement."""
        scr, cps = self.scr, self.cps
        scr.begin_iter(lam.numpy())
        cols = np.flatnonzero(scr.active.reshape(self.slots, cps).any(axis=0))
        noted = [s * cps + j for j in cols for s in range(self.slots)
                 if scr.active[s * cps + j] and scr.needs_bound(s * cps + j)]
        streamed = int(np.count_nonzero(scr.active[:self.c]))
        hist, top = self._scd_pass(lam_d, edges_d, "iterate", self._items(cols),
                                   noted, self._fetch_screened)
        scr.record_streamed(streamed)
        self.active_counts.append(streamed)
        self.tracer.event("screen.skip", streamed=streamed,
                          skipped=self.c - streamed)
        if scr.any_retired() and not bool(crossing_trusted(hist, self.budgets)):
            t0 = self._note_wall(t0)
            hist, top = self._scd_pass(lam_d, edges_d, "fallback")
            scr.record_streamed(self.c, fallback=True)
        if noted:
            scr.note_bounds(noted, self._noted_rows(noted).numpy())
        scr.retire()
        return hist, top, t0

    def metrics(self, lam, kind="metrics"):
        """One metrics pass at lam, the slot partials folded in slot order:
        (r, primal, dual, lo, hi) on the host. Legacy finalize pass 1, and
        the sampled-history pass."""
        lam_d, s0 = lam.to(self.device), self.s0

        def step(carry, p_c, b_c, item):
            i = item[0] - s0
            carry[i] = finalize_chunk_accumulate(p_c, b_c, lam_d, self.q, self.cfg,
                                                 carry[i])
            return carry

        carry = self._run_epoch(
            step, [fin_zeros(self.source.k, 0, False, self.device)
                   for _ in range(self.spd)], kind, self._items(range(self.cps)))
        r, primal, dual_sum = (self._fold([c[f] for c in carry]) for f in range(3))
        lo = self._min([c[3] for c in carry])
        hi = self._max([c[4] for c in carry])
        return r, primal, dual_sum + _pinned_dot(lam, self.budgets), lo, hi

    def metrics_record(self, lam):
        """One sampled history record at lam."""
        t0 = time.perf_counter()
        r, primal, dual, _, _ = self.metrics(lam)
        self._note_wall(t0)
        return metrics_row(r, primal, dual, lam, self.budgets)

    def legacy_result(self, lam, iters):
        """The legacy three-pass finalize (one slot a rank): the metrics
        pass, the removable histogram against the (lo, hi) ladder, and the
        pass that applies tau to (r, primal). Over a mesh every pass ends
        in the slot fold across the ranks, as the reference's ``psum``
        (lo by min and hi by max), so every rank builds the same ladder
        and takes the same tau."""
        cfg, dev, q = self.cfg, self.device, self.q
        items = self._items(range(self.cps))
        r, primal, dual, lo, hi = self.metrics(lam)
        if not cfg.postprocess:
            return StreamResult(lam, iters, r, primal, dual,
                                torch.tensor(float("-inf"), dtype=lam.dtype))
        edges = profit_edges(lo, hi, cfg.profit_buckets)
        lam_d, edges_d = lam.to(dev), edges.to(dev)
        hist = torch.zeros((self.source.k, edges.shape[0] + 1), dtype=torch.float32,
                           device=dev)
        hist = self._run_epoch(
            lambda h, p_c, b_c, item: removable_chunk_accumulate(
                p_c, b_c, lam_d, q, edges_d, h), hist, "hist", items)
        tau = threshold_from_removable_hist(self._fold([hist]), edges, r,
                                            self.budgets)
        tau_d = tau.to(dev)
        r2, primal2 = self._run_epoch(
            lambda c, p_c, b_c, item: apply_chunk_accumulate(
                p_c, b_c, lam_d, q, tau_d, c),
            fin_zeros(self.source.k, 0, False, dev)[:2], "apply", items)
        return StreamResult(lam, iters, self._fold([r2]), self._fold([primal2]),
                            dual, tau)

    def fin_init(self):
        """This rank's per-slot fused-finalize carries, from zeros (lo = +inf,
        hi = -inf)."""
        return [fin_zeros(self.source.k, self.pedges.shape[0] + 1,
                          self.cfg.postprocess, self.device)
                for _ in range(self.spd)]

    def fin_run(self, carry, lam, start=0, on_col=None):
        """The fused finalize over columns [start, cps); ``on_col(j, carry)``
        after each column's last slot (on every rank)."""
        t0 = time.perf_counter()
        pedges = self.pedges.to(self.device) if self.cfg.postprocess else None
        lam_d, s0 = lam.to(self.device), self.s0
        last = s0 + self.spd - 1

        def step(carry, p_c, b_c, item):
            i = item[0] - s0
            carry[i] = finalize_chunk_accumulate(p_c, b_c, lam_d, self.q,
                                                 self.cfg, carry[i], pedges)
            return carry

        on_step = None
        if on_col is not None:
            def on_step(item, carry):
                if item[0] == last:
                    on_col(item[1], carry)

        out = self._run_epoch(step, carry, "finalize",
                              self._items(range(start, self.cps)),
                              on_step=on_step)
        self._sync()
        self._note_wall(t0)
        return out

    def fin_result(self, carry, lam, iters):
        """(r, primal) after the §5.4 projection, read off the fused
        finalize's removable histograms; dual and tau."""
        r, primal, dual_sum = (self._fold([c[f] for c in carry]) for f in range(3))
        dual = dual_sum + _pinned_dot(lam, self.budgets)
        fin_hist = None
        if self.cfg.postprocess:
            ch, gh = (self._fold([c[f] for c in carry]) for f in (5, 6))
            tau, removed_cons, removed_gain = threshold_and_removed(
                ch, gh, self.pedges, r, self.budgets)
            r = r - removed_cons
            primal = primal - removed_gain
            fin_hist = (ch, gh)
        else:
            tau = torch.tensor(float("-inf"), dtype=lam.dtype)
        return StreamResult(lam, iters, r, primal, dual, tau, fin_hist=fin_hist)


def run_iterations(rt, lam, dprev, iters, on_iter=None):
    """The multiplier loop over ``rt.iter_epoch`` from iteration ``iters``
    until lam stops moving or ``cfg.max_iters``; ``on_iter(iters, lam,
    dprev)`` after each iteration that moved. With ``cfg.record_history``
    every ``cfg.metrics_every``-th iteration pays one metrics pass and the
    others record NaN scalars (``lam`` every row); the rows are padded to
    ``max_iters`` with the last one, as frozen iterations after convergence
    would repeat it. Returns (lam, dprev, iters, history or None)."""
    cfg = rt.cfg
    rows = [] if cfg.record_history else None
    every = max(cfg.metrics_every, 1)
    while iters < cfg.max_iters:
        with rt.tracer.span("solve.iterate", iter=iters):
            lam, dprev, moved = rt.iter_epoch(lam, dprev)
        iters += 1
        if rows is not None:
            rows.append(rt.metrics_record(lam) if (iters - 1) % every == 0
                        else nan_row(lam))
        if not moved:
            break
        if on_iter is not None:
            on_iter(iters, lam, dprev)
    history = None
    if rows:
        rows += [rows[-1]] * (cfg.max_iters - len(rows))
        history = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return lam, dprev, iters, history


# --------------------------------------------------------------------------
# The device-streamed driver.
# --------------------------------------------------------------------------

class _DeviceRunner(PassRunner):
    """The passes over a :class:`ChunkSource` on the device: a Python loop
    over the chunk indices, one slot per rank (over a mesh of D ranks, D
    slots: rank s takes chunks [s*cps, (s+1)*cps))."""

    def __init__(self, source, cfg, q, device, mesh=None):
        slots = mesh.size if mesh is not None else 1
        super().__init__(source, cfg, q, slots, device, mesh)
        # One slot: a column holds one chunk, so a retired chunk's column is
        # skipped whole and no zero chunk is ever fed (nor held). Over a
        # mesh a retired slot of a streamed column is fed zeros, as the
        # host-fed driver feeds them.
        self.zero = (torch.zeros((source.chunk, source.k), dtype=torch.float32,
                                 device=device) if slots > 1 else None)

    def _chunk_of(self, s, j):
        return _chunk(self.source, s * self.cps + j, self.device)

    def _run_epoch(self, step, state, kind, items, fetch=None, on_step=None):
        fetch = fetch or self._fetch
        for item in items:
            p_c, b_c = fetch(item)
            state = step(state, p_c, b_c, item)
            if on_step is not None:
                on_step(item, state)
        return state


def _presolve_stream(rt, lam0):
    """§5.3 warm start: the first ``presolve_samples`` rows of the shard's
    leading chunks, solved resident on the device with the budgets scaled
    by their fraction; over a mesh the shards' samples solve together
    (``solver.solve_shard``), as in the reference."""
    source, cfg = rt.source, rt.cfg
    if cfg.presolve_samples <= 0:
        return lam0
    s = min(cfg.presolve_samples, rt.cps * source.chunk, source.n)
    i0 = rt.s0 * rt.cps
    parts = [_chunk(source, i0 + i, rt.device) for i in range(-(-s // source.chunk))]
    small = SparseKP(p=torch.cat([pp for pp, _ in parts])[:s],
                     b=torch.cat([bb for _, bb in parts])[:s],
                     budgets=source.budgets * (s * rt.slots / source.n))
    sub = cfg.replace(presolve_samples=0, record_history=False,
                      postprocess=False, chunk_size=None)
    if rt.mesh is None:
        return solve(small, sub, q=rt.q, lam0=lam0, device=rt.device).lam
    return solve_shard(small, rt.mesh, sub, q=rt.q, lam0=lam0).lam


def stream_solve_fn(source: ChunkSource, cfg: SolverConfig, q: int = 1, mesh=None,
                    axes=None, device="cuda"):
    """The device-streamed solve as :func:`solve_streaming` builds it:
    ``(rt, run)``, ``rt`` the configured :class:`PassRunner` (its chunk
    count ``c``, the chunks a rank streams ``cps``, the slots) and
    ``run(budgets, lam0) -> StreamResult`` the solve itself (once a
    runner: it keeps its passes' state). The arguments are
    :func:`solve_streaming`'s; ``device="meta"`` makes the runner on the
    ``meta`` device for the dry-run (``launch/dryrun.py``), which runs the
    chunk steps of each pass on it through the runner's loop and scales
    them by ``rt.cps``: the program users run."""
    check_mesh(mesh)
    if axes is not None:
        raise ValueError("axes: the port's mesh is one flat world of ranks")
    _validate_stream_cfg(cfg)
    if mesh is not None:
        dev = mesh.device
    else:
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    rt = _DeviceRunner(source, cfg, q, dev, mesh)

    def run(budgets, lam0=None):
        rt.budgets = torch.as_tensor(np.asarray(budgets), dtype=cfg.dtype)
        lam0 = (torch.ones((source.k,), dtype=cfg.dtype) if lam0 is None
                else torch.as_tensor(lam0, dtype=cfg.dtype).cpu())
        lam = _presolve_stream(rt, lam0)
        if cfg.screening:
            rt.install_screen(HostScreen(rt.slots * rt.cps, source.k, cfg, lam.numpy()))
        lam, _, iters, history = run_iterations(rt, lam, torch.zeros_like(lam), 0)
        if cfg.stream_finalize == "legacy":
            res = rt.legacy_result(lam, iters)
        else:
            res = rt.fin_result(rt.fin_run(rt.fin_init(), lam), lam, iters)
        screen = None
        if cfg.screening:
            active = np.full((cfg.max_iters,), -1, np.int32)
            active[:len(rt.active_counts)] = rt.active_counts
            screen = {"active_chunks": torch.from_numpy(active),
                      "resets": rt.scr.resets, "fallbacks": rt.scr.fallbacks}
        return res._replace(history=history, screen=screen)
    return rt, run


def solve_streaming(source: ChunkSource, cfg: SolverConfig = SolverConfig(),
                    q: int = 1, lam0=None, mesh=None, axes=None,
                    device="cuda") -> StreamResult:
    """Solve a ChunkSource-backed sparse GKP with O(chunk) device state.

    The multiplier loop runs on the host (early exit at convergence); each
    map pass is a loop over ``source.fn(i)`` on ``device`` (the card unless
    ``device="cpu"``; the chunks must come on it). A converged solve reads
    the source ``iters + 1`` times (fused finalize) or ``iters + 3`` times
    (``cfg.stream_finalize="legacy"``); with ``cfg.record_history`` and
    ``cfg.metrics_every = m`` every m-th iteration adds one metrics pass.
    Sync SCD, cyclic CD and DD; with ``cfg.screening`` the SCD passes skip
    the retired chunks (``core/screening.py``) and the result is bitwise
    the unscreened one. ``cfg.presolve_samples`` warm-starts lam from the
    leading chunks. ``cfg.chunk_size`` is ignored: the source's chunk is
    the chunk. The program is :func:`stream_solve_fn`'s, run on the
    source's budgets.

    ``mesh`` (a ``core.mesh.Mesh`` of D ranks; every rank calls this with
    a source of the same instance on its own device, ``mesh.device``, which
    replaces ``device``): shard s scans chunks [s*cps, (s+1)*cps), cps =
    ceil(c / D), and every pass ends in the slot fold across the ranks; the
    presolve samples each shard's leading chunks and ``cfg.partial_fraction``
    drops the shards past that fraction (the finalize's sums stay
    unmasked, as in the reference); ``axes`` raises ``ValueError``.

    Bitwise equal to ``prefetch.solve_streaming_host`` over a host source
    of the same bytes and chunk, with as many slots as shards (lam, iters,
    r, primal, dual, tau, fin_hist, history); (lam, iters) equal the
    resident ``solve`` with ``chunk_size=source.chunk`` on the SCD bucketed
    path when the map tile divides the chunk. SCD needs the bucketed reduce
    and ``record_history`` needs ``metrics_every`` (``ValueError``).
    """
    _, run = stream_solve_fn(source, cfg, q, mesh=mesh, axes=axes, device=device)
    return run(source.budgets, lam0)


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


def decisions_chunk(source: ChunkSource, lam, q: int, i, tau=None):
    """The primal decisions of chunk ``i`` of a solved source:
    (x (chunk, K) bool, valid (chunk,) bool) on the source's device, the
    greedy selection at ``lam`` with the §5.4 projection at ``tau`` when
    given. Stream it over every chunk to export a whole solution; for
    point lookups use ``serve.decisions.DecisionService``."""
    p_c, b_c = source.fn(int(i))
    dev = p_c.device
    rows = int(i) * source.chunk + torch.arange(source.chunk, device=dev)
    valid = rows < source.n
    lam = torch.as_tensor(lam, dtype=torch.float32).to(dev)
    if tau is not None:
        tau = torch.as_tensor(tau, dtype=torch.float32).to(dev)
    return decisions_rows(p_c, b_c, lam, q, valid, tau), valid
