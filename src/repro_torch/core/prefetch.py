"""Host-fed streaming solve: NumPy chunks uploaded as they are consumed.

A :class:`HostChunkSource` produces the instance as NumPy chunks (arrays
in memory, memory maps, any callable). :func:`solve_streaming_host` runs
the sync-SCD (or DD) multiplier iteration as one *epoch* over the chunks
per iteration, then one fused finalize epoch: ``iters + 1`` passes. With
``cfg.screening`` an SCD epoch streams only the chunks that
``core/screening.py`` has not retired, and its results stay bitwise the
unscreened solve's.

On the card every chunk is staged through one of two pinned host buffers
and copied to one of two device buffers on a side CUDA stream; the compute
stream waits on the copy's event, and the next copy into a device buffer
waits on the event of the step that last read it. With ``double_buffer``
the next chunk is fetched and its copy issued right after the current
chunk's step is queued, so the host fetch and the H2D copy run under the
kernel. ``double_buffer=False`` blocks on every copy and every step: the
synchronous baseline. Both give the same bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops
from .bucketing import make_edges, threshold_from_hist
from .chunked import (
    StreamResult,
    _metrics_init,
    _num_chunks,
    _pinned_dot,
    _validate_stream_cfg,
    finalize_chunk_accumulate,
)
from .postprocess import profit_edges_fixed, threshold_and_removed
from .screening import HostScreen, chunk_bound, crossing_trusted
from .solver import (
    damped_multiplier_step,
    dd_proposal,
    resolve_device,
    scd_chunk_accumulate,
)
from .types import SolverConfig

__all__ = ["HostChunkSource", "host_array_source", "callable_source",
           "solve_streaming_host", "FeedStats"]


class HostChunkSource(NamedTuple):
    """A sparse GKP instance delivered as on-demand NumPy chunks.

    ``fn(i)`` returns ``(p, b)`` NumPy arrays of shape exactly (chunk, K)
    holding rows [i*chunk, (i+1)*chunk); rows at index >= n come back as
    p = b = 0 (inert: no candidate, never selected).
    """

    n: int
    k: int
    chunk: int
    budgets: np.ndarray
    fn: Callable


def _pad_chunk(a, chunk, dtype):
    a = np.asarray(a, dtype=dtype)
    if a.shape[0] < chunk:
        a = np.concatenate(
            [a, np.zeros((chunk - a.shape[0],) + a.shape[1:], dtype)])
    return a


def host_array_source(p, b, budgets, chunk: int) -> HostChunkSource:
    """Host-resident (n, K) arrays (``np.memmap`` too) served as chunks;
    the ragged tail is zero-padded."""
    p = np.asarray(p) if not isinstance(p, np.memmap) else p
    b = np.asarray(b) if not isinstance(b, np.memmap) else b
    n, k = p.shape
    dtype = np.float32

    def fn(i):
        lo = i * chunk
        hi = min(lo + chunk, n)
        return (_pad_chunk(p[lo:hi], chunk, dtype),
                _pad_chunk(b[lo:hi], chunk, dtype))

    return HostChunkSource(n=n, k=k, chunk=chunk,
                           budgets=np.asarray(budgets, dtype), fn=fn)


def callable_source(fn, n: int, k: int, budgets, chunk: int) -> HostChunkSource:
    """HostChunkSource from any chunk-producing callable (padded defensively)."""
    def wrapped(i):
        p, b = fn(i)
        return (_pad_chunk(p, chunk, np.float32),
                _pad_chunk(b, chunk, np.float32))

    return HostChunkSource(n=n, k=k, chunk=chunk,
                           budgets=np.asarray(budgets, np.float32), fn=wrapped)


@dataclasses.dataclass
class FeedStats:
    """Per-epoch timings of a host-fed solve, when the caller passes one.

    One record per pass over chunks, of kind ``iterate``, ``fallback`` (the
    full pass a screened epoch repeats when its guard fails) or
    ``finalize``, with the count of chunks it streamed. Host clock:
    ``fetch_s`` (``source.fn``), ``stage_s`` (copy into the pinned buffer)
    and ``wall_s`` (the epoch, up to its host sync). On a
    CUDA device, CUDA events give ``h2d_ms`` (copies on the side stream)
    and ``step_ms`` (the per-chunk steps, kernels included, on the compute
    stream). :meth:`resolve` turns the recorded events into these sums.
    """

    epochs: list = dataclasses.field(default_factory=list)

    def begin(self, kind):
        self.epochs.append({"kind": kind, "chunks": 0, "fetch_s": 0.0,
                            "stage_s": 0.0, "wall_s": 0.0, "h2d_ms": 0.0,
                            "step_ms": 0.0, "_h2d": [], "_step": []})
        return self.epochs[-1]

    def resolve(self):
        """Synchronise and turn the event pairs into ``h2d_ms``/``step_ms``."""
        if any(ep["_h2d"] or ep["_step"] for ep in self.epochs):
            torch.cuda.synchronize()
        for ep in self.epochs:
            for key in ("h2d", "step"):
                ep[f"{key}_ms"] += sum(a.elapsed_time(b) for a, b in ep[f"_{key}"])
                ep[f"_{key}"] = []
        return self


class _Feeder:
    """Moves host chunks to the device and runs a step on each."""

    def __init__(self, chunk, k, device, stats: Optional[FeedStats]):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stats = stats
        self.ep = None
        self.slot = 0
        if self.cuda:
            shape = (2, chunk, k)
            self.host = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                         for _ in range(2)]
            self.host_np = [h.numpy() for h in self.host]
            self.dev = [torch.empty(shape, dtype=torch.float32, device=device)
                        for _ in range(2)]
            self.copy_stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.consumed = [torch.cuda.Event() for _ in range(2)]

    def _timing(self, kind, stream):
        if self.stats is None or not self.cuda:
            return None
        a = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        self.ep[f"_{kind}"].append((a, torch.cuda.Event(enable_timing=True)))
        return self.ep[f"_{kind}"][-1][1]

    def put(self, source, i):
        """Fetch chunk i and start its upload; returns a handle for ``run``."""
        t0 = time.perf_counter()
        p, b = source.fn(i)
        t1 = time.perf_counter()
        if not self.cuda:
            cur = (torch.tensor(np.asarray(p, np.float32)),
                   torch.tensor(np.asarray(b, np.float32)), None)
        else:
            s = self.slot
            self.slot ^= 1
            self.copied[s].synchronize()      # the last upload out of host[s]
            np.copyto(self.host_np[s][0], p, casting="same_kind")
            np.copyto(self.host_np[s][1], b, casting="same_kind")
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(self.consumed[s])
                end = self._timing("h2d", self.copy_stream)
                self.dev[s].copy_(self.host[s], non_blocking=True)
                if end is not None:
                    end.record(self.copy_stream)
                self.copied[s].record(self.copy_stream)
            cur = (self.dev[s][0], self.dev[s][1], s)
        if self.ep is not None:
            self.ep["fetch_s"] += t1 - t0
            self.ep["stage_s"] += time.perf_counter() - t1
            self.ep["chunks"] += 1
        return cur

    def wait_upload(self, cur):
        if self.cuda:
            self.copied[cur[2]].synchronize()

    def run(self, step, state, cur, i):
        """Queue ``step(state, p, b, i)`` for chunk i on the compute stream
        after its upload; the buffer is marked free only after everything
        the step queued."""
        p_c, b_c, s = cur
        if not self.cuda:
            return step(state, p_c, b_c, i)
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.copied[s])
        end = self._timing("step", stream)
        state = step(state, p_c, b_c, i)
        if end is not None:
            end.record(stream)
        self.consumed[s].record(stream)
        return state

    def sync(self):
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()


def _epoch(source, feeder, step, state, double_buffer, kind="iterate",
           indices=None):
    """One pass over the chunks: ``state = step(state, p_c, b_c, i)``.

    ``indices`` (ascending) restricts the pass to those chunks: the
    screened epoch streams only the active set through this loop."""
    if feeder.stats is not None:
        feeder.ep = feeder.stats.begin(kind)
    idxs = (list(range(_num_chunks(source.n, source.chunk))) if indices is None
            else [int(i) for i in indices])
    if not double_buffer:
        for i in idxs:
            cur = feeder.put(source, i)
            feeder.wait_upload(cur)
            state = feeder.run(step, state, cur, i)
            feeder.sync()
        return state
    if not idxs:
        return state
    nxt = feeder.put(source, idxs[0])
    for t, i in enumerate(idxs):
        cur, nxt = nxt, None
        state = feeder.run(step, state, cur, i)
        if t + 1 < len(idxs):
            nxt = feeder.put(source, idxs[t + 1])
    return state


class _SingleRuntime:
    """One device, one slot: the iteration epochs and the fused finalize.

    The per-chunk steps run on ``device``. The constant-size tail of each
    epoch (threshold recovery or the DD step, the damped step, the
    screening guard, the §5.4 threshold) runs on the host CPU in float32:
    it is a few (K, E+1) operations, the host needs ``moved`` anyway, and
    one implementation of its scans and sums makes the solve on the card
    bitwise the solve on the CPU (the kernels already match their plain
    versions bit for bit). So ``lam``, ``dprev`` and the returned fields
    are CPU tensors.

    With a :class:`HostScreen` in ``scr`` the SCD epochs are screened. The
    certificates are computed on the device, by ``screen_bound`` on the
    buffer the chunk's accumulate reads, inside the chunk's step (so before
    the buffer is marked free for the next upload), into row i of
    ``bound_d`` (C, K); the rows noted in an epoch reach the host once,
    before ``retire``.
    """

    def __init__(self, source, cfg, q, double_buffer, device, stats):
        self.source, self.cfg, self.q = source, cfg, q
        self.double_buffer = double_buffer
        self.device = device
        self.c = _num_chunks(source.n, source.chunk)
        self.budgets = torch.as_tensor(np.asarray(source.budgets), dtype=cfg.dtype)
        self.pedges = profit_edges_fixed(cfg.profit_buckets, cfg.profit_ladder_lo,
                                         cfg.profit_ladder_hi, cfg.dtype)
        self.feeder = _Feeder(source.chunk, source.k, device, stats)
        self.scr = None
        self.bound_d = None

    def install_screen(self, scr):
        self.scr = scr
        self.bound_d = torch.full((self.c, self.source.k), float("inf"),
                                  dtype=torch.float32, device=self.device)

    def _run_epoch(self, step, state, kind, indices=None):
        return _epoch(self.source, self.feeder, step, state, self.double_buffer,
                      kind, indices)

    def _note_wall(self, t0):
        """Set the current epoch's wall from ``t0``; returns the time now."""
        now = time.perf_counter()
        if self.feeder.ep is not None:
            self.feeder.ep["wall_s"] = now - t0
        return now

    def iter_epoch(self, lam, dprev):
        """One SCD or DD iteration: (lam_new, delta, moved)."""
        t0 = time.perf_counter()
        cfg, dev = self.cfg, self.device
        lam_d = lam.to(dev)
        if cfg.algo == "dd":
            def step(r, p_c, b_c, _i):
                return r + torch.sum(ops.adjusted_topc(p_c, b_c, lam_d, self.q)[1],
                                     dim=0)

            r = self._run_epoch(step, torch.zeros_like(lam_d), "iterate")
            prop = dd_proposal(lam, r.cpu(), self.budgets, cfg)
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

    def _scd_pass(self, lam_d, edges_d, kind, indices=None, noted=()):
        """(hist, top) on the host from one pass over ``indices`` (default
        all chunks); the chunks in ``noted`` also get their certificate."""
        k = self.source.k
        noted = set(noted)
        hist0 = torch.zeros((k, edges_d.shape[-1] + 1), dtype=torch.float32,
                            device=self.device)
        top0 = torch.full((k,), float("-inf"), dtype=torch.float32,
                          device=self.device)

        def step(carry, p_c, b_c, i):
            if i in noted:
                chunk_bound(p_c, b_c, out=self.bound_d[i])
            return scd_chunk_accumulate(p_c, b_c, lam_d, edges_d, self.q,
                                        self.cfg, *carry)

        hist, top = self._run_epoch(step, (hist0, top0), kind, indices)
        return hist.cpu(), top.cpu()

    def _scd_pass_screened(self, lam, lam_d, edges_d, t0):
        """The reference's ``_iter_epoch_screened``: a pass over the active
        chunks; when the crossing guard cannot certify its histogram, one
        full pass (which notes nothing, and whose ``FeedStats`` epoch starts
        the wall clock anew: the returned t0). Then the certificates and
        the retirement."""
        scr = self.scr
        scr.begin_iter(lam.numpy())
        idx = scr.active_indices()
        noted = [int(i) for i in idx if scr.needs_bound(i)]
        hist, top = self._scd_pass(lam_d, edges_d, "iterate", idx, noted)
        scr.record_streamed(len(idx))
        if scr.any_retired() and not bool(crossing_trusted(hist, self.budgets)):
            t0 = self._note_wall(t0)
            hist, top = self._scd_pass(lam_d, edges_d, "fallback")
            scr.record_streamed(self.c, fallback=True)
        if noted:
            scr.note_bounds(noted, self.bound_d[noted].cpu().numpy())
        scr.retire()
        return hist, top, t0

    def fin_init(self):
        init = _metrics_init(self.source.k, self.cfg.dtype, self.device)
        if self.cfg.postprocess:
            nb = self.pedges.shape[0] + 1
            z = dict(dtype=self.cfg.dtype, device=self.device)
            init = init + (torch.zeros((self.source.k, nb), **z),
                           torch.zeros((nb,), **z))
        return init

    def fin_run(self, carry, lam):
        t0 = time.perf_counter()
        pedges = self.pedges.to(self.device) if self.cfg.postprocess else None
        lam_d = lam.to(self.device)

        def step(carry, p_c, b_c, _i):
            return finalize_chunk_accumulate(p_c, b_c, lam_d, self.q, self.cfg,
                                             carry, pedges)

        out = self._run_epoch(step, carry, "finalize")
        self.feeder.sync()
        self._note_wall(t0)
        return out

    def fin_result(self, out, lam, iters):
        out = tuple(a.cpu() for a in out)
        r, primal, dual_sum = out[0], out[1], out[2]
        dual = dual_sum + _pinned_dot(lam, self.budgets)
        fin_hist = None
        if self.cfg.postprocess:
            tau, removed_cons, removed_gain = threshold_and_removed(
                out[5], out[6], self.pedges, r, self.budgets)
            r = r - removed_cons
            primal = primal - removed_gain
            fin_hist = (out[5], out[6])
        else:
            tau = torch.tensor(float("-inf"), dtype=lam.dtype)
        return StreamResult(lam, iters, r, primal, dual, tau, fin_hist)


def solve_streaming_host(source: HostChunkSource,
                         cfg: SolverConfig = SolverConfig(), q: int = 1,
                         lam0=None, double_buffer: bool = True,
                         device="cuda", mesh=None, slots=None,
                         checkpoint_dir=None, resume_from=None, tracer=None,
                         screen_init: Optional[dict] = None,
                         stats: Optional[FeedStats] = None) -> StreamResult:
    """Solve a host-fed sparse GKP by sync SCD with the §5.2 bucketed
    reduce, or by DD (``cfg.algo="dd"``).

    Iterates one epoch over the chunks per iteration until the multipliers
    stop moving (or ``cfg.max_iters``), then runs the fused finalize epoch
    and the §5.4 projection: ``iters + 1`` passes. A DD epoch sums the
    consumption of the greedy primal (``adjusted_topc``) and steps lam by
    ``dd_lr``, as the resident chunked DD does, bit for bit at the same
    chunk. With ``cfg.screening`` (SCD only) each SCD epoch skips the
    retired chunks (``core/screening.py``); the result is bitwise the
    unscreened one and ``result.screen`` holds ``HostScreen.stats()``.
    ``screen_init`` seeds the screening state from such stats (the delta
    refresh's warm start). Runs on the card unless ``device="cpu"``;
    without CUDA and without ``device="cpu"`` it raises. ``lam0`` (K,)
    warm-starts the multipliers (default ones). The per-chunk kernels run
    on the device, the constant-size tail on the host, and the result's
    tensors are on the CPU (see ``_SingleRuntime``). ``stats`` (a
    :class:`FeedStats`) records per-epoch fetch, staging, H2D and step
    times.

    Sharding (``mesh``, ``slots``), checkpoint and resume
    (``checkpoint_dir``, ``resume_from``), the phase tracer, and the
    reference host-fed driver's cyclic CD and presolve are not ported yet
    and raise ``NotImplementedError``; ``record_history`` needs the
    unported ``metrics_every`` and raises ``ValueError``.
    """
    for name, value, item in (("mesh", mesh, "A4 and A8"),
                              ("slots", slots, "A4"),
                              ("checkpoint_dir", checkpoint_dir, "A4"),
                              ("resume_from", resume_from, "A4"),
                              ("tracer", tracer, "A4")):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet: ROADMAP {item}")
    _validate_stream_cfg(cfg)
    for bad, what in ((cfg.algo == "scd" and cfg.cd_mode == "cyclic",
                       "cd_mode='cyclic'"),
                      (cfg.presolve_samples > 0, "presolve_samples > 0")):
        if bad:
            raise NotImplementedError(
                f"the host-fed solve does not port {what} yet: ROADMAP A4 "
                "(the resident solver.solve takes it)")
    dev = resolve_device(device)
    lam = (torch.ones((source.k,), dtype=cfg.dtype) if lam0 is None
           else torch.as_tensor(lam0, dtype=cfg.dtype).cpu())
    rt = _SingleRuntime(source, cfg, q, double_buffer, dev, stats)
    if cfg.screening:
        rt.install_screen(HostScreen(rt.c, source.k, cfg, lam.numpy(),
                                     seed=screen_init))
    dprev = torch.zeros_like(lam)
    iters = 0
    while iters < cfg.max_iters:
        lam, dprev, moved = rt.iter_epoch(lam, dprev)
        iters += 1
        if not moved:
            break
    carry = rt.fin_run(rt.fin_init(), lam)
    res = rt.fin_result(carry, lam, iters)
    if rt.scr is not None:
        res = res._replace(screen=rt.scr.stats())
    if stats is not None:
        stats.resolve()
    return res
