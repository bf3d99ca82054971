"""Host-fed streaming solve: NumPy chunks uploaded as they are consumed.

A :class:`HostChunkSource` produces the instance as NumPy chunks (arrays
in memory, memory maps, any callable). :func:`solve_streaming_host` runs
the sync-SCD (or DD) multiplier iteration as one *epoch* over the chunks
per iteration, then one fused finalize epoch: ``iters + 1`` passes (the
legacy three-pass finalize, single slot only: ``iters + 3``). With
``cfg.screening`` an SCD epoch streams only the chunks that
``core/screening.py`` has not retired, and its results stay bitwise the
unscreened solve's.

* **Feeding.** On the card every chunk is staged through one of two pinned
  host buffers and copied to one of two device buffers on a side CUDA
  stream; the compute stream waits on the copy's event, and the next copy
  into a device buffer waits on the event of the step that last read it.
  With ``double_buffer`` the next chunk is fetched and its copy issued
  right after the current chunk's step is queued, so the host fetch and
  the H2D copy run under the kernel. ``double_buffer=False`` blocks on
  every copy and every step: the synchronous baseline. Both give the same
  bits.
* **Virtual slots.** ``slots=S`` splits the chunk range into S contiguous
  ranges of ``cps = ceil(c / S)`` chunks (:func:`sharded_source`), each an
  independent carry-seeded accumulator on the one device. Each column
  advances every slot by one chunk, in slot order, through the same
  double buffer; chunk slots past the last real chunk are fed inert zero
  chunks and run, as the reference runs them. The (K, E+1)-size slot
  partials are combined on the host by :func:`chunked.ordered_fold`, so
  the result depends on S and not on the device. ``slots=1`` (the
  default without a mesh) is the plain single-slot solve.
* **A world of ranks.** ``mesh=`` (``launch.mesh``) spreads the S slots
  over D processes, S / D each, every rank with its own device, feeder and
  fetching thread; each pass's slot partials are gathered across the ranks
  and folded in slot order on every rank, so the bits depend on S and
  never on D, and a checkpoint resumes on any world whose size divides S.
* **Fault layer.** With ``cfg.fetch_retries`` (or ``fetch_timeout``,
  ``verify_refetch``) the source is wrapped once, at entry, in
  :func:`faults.resilient_source`: every fetch (the epochs, the presolve's
  head, the fingerprint's probe) retries transient failures. Retries re-run
  only the fetch, never the staging, the copy or the step, so a solve that
  survives faults is bitwise the fault-free one.
* **Preemption safety.** With ``cfg.checkpoint_every = N`` and a
  checkpoint directory, a constant-size resume state (lam, the damping
  carry, the per-slot finalize partials, a phase and column cursor and a
  fingerprint of the solve) is written atomically (``checkpoint/ckpt.py``)
  every N iterations, at finalize entry, and every N columns of the
  finalize. ``resume_from=`` restores the latest state and continues to
  the uninterrupted solve's bits, at the slot count it was written with.
* **Tracing.** ``tracer=`` (an ``obs.Tracer``) records the spans
  ``solve.iterate``, ``solve.finalize`` and ``screen.skip``, and per epoch
  one ``ingest.fetch`` and one ``ingest.h2d`` record from the feeder's host
  clocks. Spans bracket host Python only, so a traced solve keeps its bits.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint import ckpt
from ..obs import NULL_TRACER
from .chunked import (
    PassRunner,
    StreamResult,
    _num_chunks,
    _validate_stream_cfg,
    run_iterations,
)
from .faults import policy_from_cfg, resilient_source
from .mesh import check_mesh
from .screening import HostScreen
from .solver import resolve_device, solve
from .types import SolverConfig, SparseKP

__all__ = ["HostChunkSource", "host_array_source", "memmap_source",
           "callable_source", "sharded_source", "chunk_hashes",
           "solve_streaming_host", "source_fingerprint", "FeedStats"]

# Resume-state phases (the "epoch cursor" of the checkpoint): the solve is
# either still iterating multipliers or inside the finalize pass.
_PHASE_ITER = 0
_PHASE_FIN = 1


class HostChunkSource(NamedTuple):
    """A sparse GKP instance delivered as on-demand NumPy chunks.

    ``fn(i)`` returns ``(p, b)`` NumPy arrays of shape exactly (chunk, K)
    holding rows [i*chunk, (i+1)*chunk); rows at index >= n come back as
    p = b = 0 (inert: no candidate, never selected). Checkpoint and resume
    also need ``fn`` to be restart-deterministic (the same bytes for the
    same index across processes).
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


def memmap_source(p_path, b_path, n: int, k: int, budgets,
                  chunk: int, dtype=np.float32) -> HostChunkSource:
    """Memory-mapped on-disk instance: raw row-major (n, K) p and b files,
    opened with ``np.memmap(mode="r")`` and served by
    :func:`host_array_source`, so only the chunks streamed are read."""
    p = np.memmap(p_path, dtype=dtype, mode="r", shape=(n, k))
    b = np.memmap(b_path, dtype=dtype, mode="r", shape=(n, k))
    return host_array_source(p, b, budgets, chunk)


def chunk_hashes(source: HostChunkSource, chunks=None) -> np.ndarray:
    """Per-chunk sha256 digests of a host source, as (c, 32) uint8.

    Hashes the float32 bytes of ``p`` then ``b`` that each chunk index
    serves, the bytes the solver consumes, so two sources whose digests
    match for a chunk are byte-identical there (the content identity a
    file-backed source brings to the serving layer's delta refresh).
    ``chunks`` restricts the scan to those indices, in that order.
    """
    if chunks is None:
        chunks = range(-(-source.n // source.chunk))
    out = np.zeros((len(chunks), 32), np.uint8)
    for j, i in enumerate(chunks):
        p, b = source.fn(int(i))
        h = hashlib.sha256(np.asarray(p, np.float32).tobytes())
        h.update(np.asarray(b, np.float32).tobytes())
        out[j] = np.frombuffer(h.digest(), np.uint8)
    return out


def callable_source(fn, n: int, k: int, budgets, chunk: int) -> HostChunkSource:
    """HostChunkSource from any chunk-producing callable (padded defensively)."""
    def wrapped(i):
        p, b = fn(i)
        return (_pad_chunk(p, chunk, np.float32),
                _pad_chunk(b, chunk, np.float32))

    return HostChunkSource(n=n, k=k, chunk=chunk,
                           budgets=np.asarray(budgets, np.float32), fn=wrapped)


def sharded_source(source: HostChunkSource, slots: int):
    """Split a host source into ``slots`` disjoint chunk-range sub-sources.

    Slot ``s`` owns global chunks [s*cps, (s+1)*cps), cps = ceil(c/slots).
    Sub-source ``fn(j)`` serves global chunk ``s*cps + j``, or an all-zero
    (inert) chunk past the last real one: those padded chunks are run like
    any other (their invalid candidates still raise a slot's running top
    from -inf), as in the reference.
    """
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    c = _num_chunks(source.n, source.chunk)
    cps = -(-c // slots)
    subs = []
    for s in range(slots):
        def fn(j, _s=s):
            i = _s * cps + j
            if i >= c:
                z = np.zeros((source.chunk, source.k), np.float32)
                return z, z.copy()
            return source.fn(i)

        lo = min(s * cps * source.chunk, source.n)
        hi = min((s + 1) * cps * source.chunk, source.n)
        subs.append(HostChunkSource(n=hi - lo, k=source.k,
                                    chunk=source.chunk,
                                    budgets=source.budgets, fn=fn))
    return subs


@dataclasses.dataclass
class FeedStats:
    """Per-epoch timings of a host-fed solve, when the caller passes one.

    One record per pass over chunks, of kind ``iterate``, ``fallback`` (the
    full pass a screened epoch repeats when its guard fails) or
    ``finalize``, with the count of chunks it fed (with slots, every chunk
    slot, inert and zero-fed ones included; over a mesh, this rank's).
    Host clock: ``fetch_s`` (``source.fn``), ``stage_s`` (copy into the
    pinned buffer), ``wall_s`` (the epoch, up to its host sync) and
    ``comm_s`` (the share of that wall spent in collectives across a
    mesh's ranks). On a CUDA device, CUDA events give ``h2d_ms`` (copies
    on the side stream) and ``step_ms`` (the per-chunk steps, kernels
    included, on the compute stream). :meth:`resolve` turns the recorded
    events into these sums.
    """

    epochs: list = dataclasses.field(default_factory=list)

    def begin(self, kind):
        self.epochs.append({"kind": kind, "chunks": 0, "fetch_s": 0.0,
                            "stage_s": 0.0, "wall_s": 0.0, "comm_s": 0.0,
                            "h2d_ms": 0.0, "step_ms": 0.0, "_h2d": [],
                            "_step": []})
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

    def begin(self, kind, timed):
        """Start an epoch's accumulators: the ``FeedStats`` record when the
        caller passed one, else a bare one when ``timed`` (tracing)."""
        if self.stats is not None:
            self.ep = self.stats.begin(kind)
        elif timed:
            self.ep = {"kind": kind, "chunks": 0, "fetch_s": 0.0, "stage_s": 0.0,
                       "comm_s": 0.0}
        else:
            self.ep = None
        return self.ep

    def _timing(self, kind, stream):
        if self.stats is None or not self.cuda:
            return None
        a = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        self.ep[f"_{kind}"].append((a, torch.cuda.Event(enable_timing=True)))
        return self.ep[f"_{kind}"][-1][1]

    def put(self, fetch, item):
        """Fetch ``item``'s chunk and start its upload; returns a handle for
        ``run``."""
        t0 = time.perf_counter()
        p, b = fetch(item)
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

    def run(self, step, state, cur, item):
        """Queue ``step(state, p, b, item)`` on the compute stream after the
        chunk's upload; the buffer is marked free only after everything the
        step queued."""
        p_c, b_c, s = cur
        if not self.cuda:
            return step(state, p_c, b_c, item)
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.copied[s])
        end = self._timing("step", stream)
        state = step(state, p_c, b_c, item)
        if end is not None:
            end.record(stream)
        self.consumed[s].record(stream)
        return state

    def sync(self):
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()


def _epoch(fetch, feeder, step, state, double_buffer, items, kind="iterate",
           on_step=None, tracer=NULL_TRACER):
    """One pass over ``items``: ``state = step(state, p_c, b_c, item)`` on
    the chunk ``fetch(item)``.

    ``on_step(item, state)`` observes the state after each item's step is
    queued (and, double-buffered, after the next item's upload is issued):
    the checkpoint hook, whose host read of the carry waits for the queued
    steps on the compute stream. With a tracer, the feeder's host clocks of
    the epoch become one ``ingest.fetch`` and one ``ingest.h2d`` record.
    """
    ep = feeder.begin(kind, tracer.enabled)
    t_epoch = time.time()
    if not double_buffer:
        for item in items:
            cur = feeder.put(fetch, item)
            feeder.wait_upload(cur)
            state = feeder.run(step, state, cur, item)
            feeder.sync()
            if on_step is not None:
                on_step(item, state)
    elif items:
        nxt = feeder.put(fetch, items[0])
        for t, item in enumerate(items):
            cur, nxt = nxt, None
            state = feeder.run(step, state, cur, item)
            if t + 1 < len(items):
                nxt = feeder.put(fetch, items[t + 1])
            if on_step is not None:
                on_step(item, state)
    if tracer.enabled and ep["chunks"]:
        tracer.record("ingest.fetch", t_epoch, ep["fetch_s"], chunks=ep["chunks"])
        tracer.record("ingest.h2d", t_epoch, ep["stage_s"], chunks=ep["chunks"])
    return state


# --------------------------------------------------------------------------
# Checkpoint state (constant size): save / restore / fingerprint.
# --------------------------------------------------------------------------

_FIN_KEYS = ["fin_r", "fin_primal", "fin_dual", "fin_lo", "fin_hi",
             "fin_ch", "fin_gh"]

# The SolverConfig fields whose values steer the multiplier trajectory or
# the finalize arithmetic: hashed, in this order, into the resume-state
# fingerprint, with ``str(cfg.dtype)``. The reference's list without its
# ``use_kernels``, which the port has not.
_FINGERPRINT_CFG_FIELDS = (
    "algo", "cd_mode", "reduce", "tol", "cd_damping", "dd_lr",
    "bucket_half", "bucket_delta", "bucket_growth", "presolve_samples",
    "partial_fraction", "stream_finalize", "profit_buckets",
    "profit_ladder_lo", "profit_ladder_hi", "kernel_tile", "postprocess",
)

# Fields deliberately EXCLUDED from the fingerprint: changing any of them
# across a restart is legitimate because none alters the accepted
# multiplier trajectory or the finalize results (iteration budget, save
# cadence and retention, history sampling, the fault policy, the resident
# solver's chunking, screening, which never steers the trajectory and is
# rebuilt on resume). Every SolverConfig field is in exactly one of the two
# sets (tests/test_torch_resume.py checks it).
FINGERPRINT_EXEMPT_FIELDS = frozenset({
    "max_iters", "metrics_every", "record_history",
    "checkpoint_every", "checkpoint_keep",
    "fetch_retries", "fetch_backoff", "fetch_backoff_growth",
    "fetch_backoff_cap", "fetch_jitter", "fetch_timeout",
    "verify_refetch",
    "chunk_size",
    "screening", "screening_floor",
})


def _fingerprint(source, cfg, q, lam_init):
    """Identity hash of (instance, solver arithmetic): the workload shape,
    the budgets, the warm-start multipliers, the bytes of chunk 0 and every
    field of ``_FINGERPRINT_CFG_FIELDS``, as (8,) uint8. A resume whose
    fingerprint differs belongs to another solve and is refused."""
    h = hashlib.sha256()
    h.update(repr(
        (source.n, source.k, source.chunk, int(q))
        + tuple(getattr(cfg, f) for f in _FINGERPRINT_CFG_FIELDS)
        + (str(cfg.dtype),)).encode())
    h.update(np.asarray(source.budgets, np.float32).tobytes())
    h.update(np.asarray(lam_init, np.float32).tobytes())
    p0, b0 = source.fn(0)
    h.update(np.asarray(p0, np.float32).tobytes())
    h.update(np.asarray(b0, np.float32).tobytes())
    return np.frombuffer(h.digest()[:8], np.uint8).copy()


def source_fingerprint(source: HostChunkSource, cfg: SolverConfig, q: int,
                       lam0=None) -> np.ndarray:
    """Public identity hash of one (source, cfg, q, lam0) solve, (8,) uint8:
    the fingerprint ``solve_streaming_host`` stores in its resume state,
    for higher layers to stamp published results with. ``lam0`` defaults
    to the all-ones cold start. The chunk-0 probe fetches under the cfg's
    fault policy."""
    lam0 = (np.ones((source.k,), np.float32) if lam0 is None
            else np.asarray(lam0, np.float32))
    policy = policy_from_cfg(cfg)
    if policy is not None:
        source = resilient_source(source, policy, verify=cfg.verify_refetch)
    return _fingerprint(source, cfg, q, lam0)


def _save_state(directory, step, phase, iters, cursor, slots, fp, lam,
                dprev, fin, keep=3):
    """Write one resume state atomically; keep the newest ``keep``.

    ``fin`` is the per-slot finalize partial tuple (leading axis = slots; 5
    or 7 leaves), zeros while still iterating. Everything is host NumPy,
    constant size in n.
    """
    state = {
        "phase": np.int32(phase),
        "iters": np.int32(iters),
        "cursor": np.int32(cursor),
        "slots": np.int32(slots),
        "fingerprint": np.asarray(fp, np.uint8),
        "lam": np.asarray(lam),
        "dprev": np.asarray(dprev),
    }
    for name, arr in zip(_FIN_KEYS, fin):
        state[name] = np.asarray(arr)
    ckpt.save(directory, step, state)
    ckpt.prune(directory, keep=keep)


def _load_state(resume_from):
    """Latest resume state as host NumPy, or None when the directory has
    none (a fresh start)."""
    step = ckpt.latest_step(resume_from)
    if step is None:
        return None
    try:
        state = ckpt.restore_auto(resume_from, step)
    except ValueError as e:
        raise ValueError(
            f"could not restore checkpoint {resume_from!r} step {step}: "
            f"{e}") from e
    return {k: v.numpy() for k, v in state.items()}


def _fin_zeros_np(slots, k, nb, postprocess, dtype=np.float32):
    """ITER-phase placeholder for the finalize partials (constant shape)."""
    dtype = np.dtype(dtype)
    fin = (np.zeros((slots, k), dtype), np.zeros((slots,), dtype),
           np.zeros((slots,), dtype),
           np.full((slots,), np.inf, dtype),
           np.full((slots,), -np.inf, dtype))
    if postprocess:
        fin = fin + (np.zeros((slots, k, nb), dtype),
                     np.zeros((slots, nb), dtype))
    return fin


def _presolve_host(source, lam0, q, cfg, device):
    """§5.3 warm start: the first ``presolve_samples`` rows of the stream,
    solved resident on ``device`` with the budgets scaled by their
    fraction."""
    if cfg.presolve_samples <= 0:
        return lam0
    s = min(cfg.presolve_samples, source.n)
    parts = [source.fn(i) for i in range(-(-s // source.chunk))]
    p = np.concatenate([pp for pp, _ in parts])[:s]
    b = np.concatenate([bb for _, bb in parts])[:s]
    small = SparseKP(p=torch.from_numpy(np.asarray(p, np.float32)),
                     b=torch.from_numpy(np.asarray(b, np.float32)),
                     budgets=torch.as_tensor(source.budgets) * (s / source.n))
    sub = cfg.replace(presolve_samples=0, record_history=False,
                      postprocess=False, chunk_size=None)
    return solve(small, sub, q=q, lam0=lam0, device=device).lam


# --------------------------------------------------------------------------
# The runtime: S virtual slots on one device, fed from the host.
# --------------------------------------------------------------------------

class _SlotRuntime(PassRunner):
    """The passes of ``chunked.PassRunner`` over S virtual slots (this
    rank's S / D over a mesh) on one device, each chunk uploaded from the
    host through the one double buffer (:class:`_Feeder`); a retired chunk
    slot is fed a host zero chunk. The feeder times every epoch
    (``FeedStats``) and the tracer records the phase spans."""

    def __init__(self, source, cfg, q, slots, double_buffer, device, stats,
                 tracer, mesh=None):
        super().__init__(source, cfg, q, slots, device, mesh)
        self.double_buffer = double_buffer
        self.tracer = tracer
        self.subs = sharded_source(source, slots)
        self.zero = np.zeros((source.chunk, source.k), np.float32)
        self.feeder = _Feeder(source.chunk, source.k, device, stats)
        self.comm0 = 0.0

    def _chunk_of(self, s, j):
        return self.subs[s].fn(j)

    def _comm_s(self):
        return 0.0 if self.mesh is None else self.mesh.comm_s

    def _run_epoch(self, step, state, kind, items, fetch=None, on_step=None):
        self.comm0 = self._comm_s()
        return _epoch(fetch or self._fetch, self.feeder, step, state,
                      self.double_buffer, items, kind, on_step, self.tracer)

    def _note_wall(self, t0):
        """Set the current epoch's wall from ``t0`` and its collectives'
        seconds since the epoch began; returns the time now."""
        now = time.perf_counter()
        if self.feeder.ep is not None:
            self.feeder.ep["wall_s"] = now - t0
            self.feeder.ep["comm_s"] = self._comm_s() - self.comm0
        return now

    def _sync(self):
        self.feeder.sync()

    def fin_to_np(self, carry):
        """This rank's per-slot carries -> a tuple of (S, ...) host arrays of
        every slot (gathered across a mesh)."""
        return tuple(self._gather([c[f] for c in carry]).numpy()
                     for f in range(len(carry[0])))

    def fin_from_np(self, fin):
        """A tuple of (S, ...) host arrays -> this rank's per-slot device
        carries."""
        return [tuple(torch.from_numpy(np.array(a[s], np.float32)).to(self.device)
                      for a in fin)
                for s in self._slots()]


# --------------------------------------------------------------------------
# The driver: presolve -> iterate -> finalize, with checkpoint and resume.
# --------------------------------------------------------------------------

def solve_streaming_host(source: HostChunkSource,
                         cfg: SolverConfig = SolverConfig(), q: int = 1,
                         lam0=None, double_buffer: bool = True,
                         device="cuda", mesh=None, slots: Optional[int] = None,
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
    refresh's warm start). ``cfg.presolve_samples`` warm-starts lam by a
    resident solve of the stream's first rows. Runs on the card unless
    ``device="cpu"``; without CUDA and without ``device="cpu"`` it raises.
    ``lam0`` (K,) warm-starts the multipliers (default ones). The per-chunk
    kernels run on the device, the constant-size tail on the host, and the
    result's tensors are on the CPU. ``stats`` (a :class:`FeedStats`)
    records per-epoch fetch, staging, H2D and step times.

    ``slots`` (default 1) is the virtual slot count (see the module
    docstring); different slot counts group the additions differently, so
    give different bits. Checkpoint and resume: with
    ``cfg.checkpoint_every = N`` and ``checkpoint_dir`` (or
    ``resume_from``, which doubles as the directory) the resume state is
    written every N iterations, at finalize entry and every N finalize
    columns, keeping ``cfg.checkpoint_keep`` states; ``resume_from=<dir>``
    restores the latest one (fingerprint-checked against this source, cfg,
    q and lam0; torn writes ignored; an empty or missing directory starts
    fresh) and returns bitwise the uninterrupted ``lam/iters/r/primal/
    dual/tau`` and ``fin_hist``. The slot count is fixed at first launch.
    ``tracer`` (an ``obs.Tracer``) journals the phase spans; it is not a
    config field and never enters the fingerprint.

    ``cfg.stream_finalize="legacy"`` runs the three-pass finalize
    (``iters + 3`` passes; one slot only). ``cfg.record_history`` with
    ``cfg.metrics_every = m`` records the sampled history (one metrics
    epoch every m-th iteration, the rows padded to ``max_iters`` with the
    last one), bitwise the device-streamed driver's on the same bytes.

    ``mesh`` (a ``core.mesh.Mesh`` of D ranks; every rank calls this with
    the same source, cfg and lam0, and runs on ``mesh.device``, which
    replaces ``device``) spreads the slots over the ranks: ``slots``
    (default D) must be a positive multiple of D, and rank r feeds slots
    [r*S/D, (r+1)*S/D) through its own feeder. The slot partials of every
    pass are gathered and folded in slot order on every rank, so the result
    is bitwise the one-process solve at the same ``slots`` whatever D is.
    With a mesh or ``slots > 1`` the straggler mask applies per slot
    (``cfg.partial_fraction``). Rank 0 writes the checkpoints (every rank
    meets a barrier after each save), and a state resumes on any world
    whose size divides its slot count, each rank taking its slots' rows.

    Restrictions (``ValueError``, as in the reference): ``cd_mode="cyclic"``;
    ``record_history`` without ``metrics_every``, or with checkpoint or
    resume; the legacy finalize with ``slots > 1`` or a mesh; ``slots`` not
    a multiple of the world size. A ``mesh`` that is not a ``Mesh`` raises
    ``TypeError``.
    """
    check_mesh(mesh)
    _validate_stream_cfg(cfg)
    if cfg.algo == "scd" and cfg.cd_mode != "sync":
        raise ValueError(
            "solve_streaming_host supports cd_mode='sync' (cyclic CD "
            "re-feeds the whole source K times per iteration)")
    # Wrap the source once, here, so every fetch below (epochs, presolve,
    # fingerprint) retries under cfg's policy; only the fetch is re-run.
    fault_policy = policy_from_cfg(cfg)
    if fault_policy is not None:
        source = resilient_source(source, fault_policy,
                                  verify=cfg.verify_refetch)
    # The directory enables checkpointing; a cadence without one runs
    # unprotected (so a reference run can share a checkpointed job's cfg).
    ckpt_every = cfg.checkpoint_every
    if checkpoint_dir is None:
        checkpoint_dir = resume_from
    checkpointing = ckpt_every > 0 and checkpoint_dir is not None
    if checkpointing and cfg.checkpoint_keep < 1:
        raise ValueError(
            f"checkpoint_keep must be >= 1 (got {cfg.checkpoint_keep}): "
            "retaining zero resume states would leave nothing to resume "
            "from")
    if (checkpointing or resume_from is not None) and cfg.record_history:
        raise ValueError(
            "record_history is an analysis mode and cannot be combined "
            "with checkpoint/resume (the sampled rows are not part of "
            "the constant-size resume state)")

    restored = _load_state(resume_from) if resume_from is not None else None
    if restored is not None:
        S = int(restored["slots"])
        if slots is not None and slots != S:
            raise ValueError(
                f"checkpoint was written with slots={S}; asked for "
                f"slots={slots} (the slot count is fixed at first launch)")
    else:
        S = slots if slots is not None else (mesh.size if mesh is not None else 1)
    if S < 1:
        raise ValueError(f"slots must be >= 1, got {S}")
    if mesh is not None and S % mesh.size:
        raise ValueError(
            f"slots={S} must be a positive multiple of the mesh device count "
            f"{mesh.size} (elastic resume divides slots over devices)")
    if (S > 1 or mesh is not None) and cfg.stream_finalize == "legacy":
        raise ValueError(
            "sharded host feeding supports stream_finalize='fused' only "
            "(the legacy three-pass finalize remains on the single-device "
            "driver as the oracle/benchmark baseline)")

    dev = mesh.device if mesh is not None else resolve_device(device)
    lam = (torch.ones((source.k,), dtype=cfg.dtype) if lam0 is None
           else torch.as_tensor(lam0, dtype=cfg.dtype).cpu())
    fp = (_fingerprint(source, cfg, q, lam.numpy())
          if (checkpointing or restored is not None) else None)
    if restored is not None and not np.array_equal(restored["fingerprint"], fp):
        raise ValueError(
            "resume state fingerprint mismatch: the checkpoint in "
            f"{resume_from!r} was written for a different "
            "(source, cfg, q, lam0) — refusing to resume")

    tracer = NULL_TRACER if tracer is None else tracer
    rt = _SlotRuntime(source, cfg, q, S, double_buffer, dev, stats, tracer, mesh)
    dprev = torch.zeros_like(lam)
    iters, phase, cursor, fin_carry = 0, _PHASE_ITER, 0, None
    if restored is not None:
        lam = torch.from_numpy(restored["lam"]).to(cfg.dtype)
        dprev = torch.from_numpy(restored["dprev"]).to(cfg.dtype)
        iters = int(restored["iters"])
        phase = int(restored["phase"])
        cursor = int(restored["cursor"])
        if phase == _PHASE_FIN and cursor > 0:
            fin_carry = rt.fin_from_np(tuple(
                restored[k] for k in _FIN_KEYS if k in restored))
    else:
        lam = _presolve_host(source, lam, q, cfg, dev)
        if mesh is not None:
            lam = mesh.gather(lam)[0]         # every rank starts from rank 0's bits

    if cfg.screening:
        # Rebuilt on every (re)start: screening never steers the trajectory.
        rt.install_screen(HostScreen(S * rt.cps, source.k, cfg, lam.numpy(),
                                     seed=screen_init))
    fin_zeros = functools.partial(_fin_zeros_np, S, source.k,
                                  cfg.profit_buckets + 1, cfg.postprocess)

    def save(step, phase, iters, cursor, lam, dprev, fin):
        # Rank 0 writes; every rank waits for the write.
        if mesh is None or mesh.rank == 0:
            _save_state(checkpoint_dir, step, phase, iters, cursor, S, fp, lam,
                        dprev, fin, keep=cfg.checkpoint_keep)
        if mesh is not None:
            mesh.barrier()

    history = None
    if phase == _PHASE_ITER:
        on_iter = None
        if checkpointing:
            def on_iter(iters, lam, dprev):
                if iters % ckpt_every == 0 and iters < cfg.max_iters:
                    save(iters, _PHASE_ITER, iters, 0, lam, dprev, fin_zeros())

        lam, dprev, iters, history = run_iterations(rt, lam, dprev, iters, on_iter)
        phase, cursor = _PHASE_FIN, 0
        if checkpointing:
            # Finalize entry: a kill in the finalize replays no iteration.
            save(cfg.max_iters + 1, _PHASE_FIN, iters, 0, lam, dprev, fin_zeros())
    scr_stats = rt.scr.stats() if rt.scr is not None else None

    if cfg.stream_finalize == "legacy":
        with tracer.span("solve.finalize", mode="legacy", iters=iters):
            res = rt.legacy_result(lam, iters)
        if stats is not None:
            stats.resolve()
        return res._replace(history=history, screen=scr_stats)

    on_col = None
    if checkpointing:
        def on_col(j, carry):
            done = j + 1
            if done % ckpt_every == 0 and done < rt.cps:
                save(cfg.max_iters + 1 + done, _PHASE_FIN, iters, done, lam,
                     dprev, rt.fin_to_np(carry))

    carry = rt.fin_init() if fin_carry is None else fin_carry
    with tracer.span("solve.finalize", mode="fused", iters=iters):
        carry = rt.fin_run(carry, lam, cursor, on_col)
        res = rt.fin_result(carry, lam, iters)
    if stats is not None:
        stats.resolve()
    return res._replace(history=history, screen=scr_stats)
