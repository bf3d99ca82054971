"""Fault domain for host-fed chunk ingest: retries, timeouts, injection.

The paper's system is "deployed to production and called on a daily
basis" (§6) — which means chunk fetches that fail transiently, fetches
that hang, payloads that arrive damaged, and the occasional chunk whose
storage shard is having a bad day. This module is the repo's single
fault-tolerance layer for the host-fed ingest path
(:mod:`repro_torch.core.prefetch`) and the serving lookups built on it.
The reference's ``core/faults.py`` (NumPy and stdlib), copied:

* :class:`FaultPolicy` — max retries, capped exponential backoff with
  **deterministic** jitter keyed on ``(chunk_index, attempt)`` (no
  ``random`` or wall-clock anywhere in the schedule, so a test replays
  the exact delays a production run would have slept), and an optional
  per-fetch timeout enforced by a worker thread.
* :func:`fetch_with_retries` — runs one chunk fetch under the policy.
  Retries re-run *only the pure fetch*: the caller's accumulate never
  observes a failed attempt, which is the whole bitwise story — a solve
  that survives injected transient faults is byte-identical to the
  fault-free solve. Exhaustion raises :class:`ChunkFetchError` naming
  the chunk index and the full attempt history.
* :func:`resilient_source` — wraps any ``HostChunkSource``-shaped
  object (anything with an ``fn`` field and ``_replace``) so every
  downstream consumer — the epoch loops, the sharded sub-sources, the
  presolve head read, the fingerprint's chunk-0 read — fetches through
  the policy without knowing it exists.
* :class:`FaultPlan` / :func:`faulty_source` — deterministic fault
  *injection* for tests and the chaos CLI: transient ``IOError`` drops,
  slow fetches, corrupt payloads (different bytes on every occurrence,
  so a verified double-read always catches them), and repeat-offender
  chunks that fail a fixed number of times before recovering.

Verification (``verify=True`` / ``cfg.verify_refetch``) is the paranoid
fetch-is-pure check: the chunk is read twice and the two payloads must
be byte-equal; a mismatch means one of the reads was corrupt (or the
source is not restart-deterministic, which breaks checkpoint/resume
anyway) and is retried like any transient fault. This is what turns
silent payload corruption — the one fault a retry loop cannot see —
into a retryable, *detected* fault.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..obs import MetricsRegistry

__all__ = ["FaultPolicy", "FaultPlan", "ChunkFetchError",
           "ChunkFetchTimeout", "ChunkIntegrityError", "FetchCapacityError",
           "fetch_with_retries", "resilient_source", "faulty_source",
           "policy_from_cfg", "abandoned_workers", "ABANDONED_WORKER_CAP",
           "process_registry"]

# Exceptions a retry may recover from. Anything else (a programming
# error, an injected kill) propagates immediately: retrying it would
# only mask the bug.
RETRYABLE = (IOError, OSError, TimeoutError)


class ChunkFetchTimeout(IOError):
    """A fetch exceeded the policy's per-fetch timeout (retryable)."""


class FetchCapacityError(IOError):
    """Too many abandoned fetch workers are still running (retryable).

    Each timed-out fetch abandons a daemon worker thread; a source that
    hangs *persistently* would otherwise accumulate them without bound
    (every retry of every chunk parks another thread on the same dead
    backend). The cap makes that failure mode loud and finite: once
    :data:`ABANDONED_WORKER_CAP` abandoned workers are still alive, new
    timed fetches fail fast with this retryable error — the backoff
    schedule gives stragglers time to drain, and true exhaustion
    surfaces as the usual :class:`ChunkFetchError` naming this cause.
    """


class ChunkIntegrityError(IOError):
    """The verified double-read of a chunk disagreed with itself
    (retryable): one of the two payloads was corrupt, or the source
    violates the fetch-is-pure contract."""


class ChunkFetchError(RuntimeError):
    """A chunk fetch exhausted its retry budget (terminal).

    ``chunk`` is the failing chunk index; ``history`` the full attempt
    record as ``(attempt, error_repr, backoff_slept)`` tuples — the
    message names both, so the operator knows exactly which chunk of
    which source to look at and what each attempt died of.
    """

    def __init__(self, chunk: int, history):
        self.chunk = int(chunk)
        self.history = list(history)
        attempts = "; ".join(
            f"attempt {a}: {err} (slept {slept:.3g}s before retry)"
            if slept is not None else f"attempt {a}: {err}"
            for a, err, slept in self.history)
        super().__init__(
            f"chunk {self.chunk}: fetch failed after "
            f"{len(self.history)} attempt(s) — {attempts}. The retry "
            "budget (FaultPolicy.max_retries) is exhausted; the chunk's "
            "storage is persistently unavailable or persistently corrupt.")


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Retry/backoff/timeout policy for one chunk-fetch site (hashable).

    ``max_retries`` bounds the *re*-attempts: a fetch runs at most
    ``max_retries + 1`` times. Backoff before retry ``a`` (1-based) is
    ``min(cap, base * growth**(a-1) * (1 + jitter * u(chunk, a)))``
    where ``u`` is a deterministic hash of ``(chunk, a)`` in [0, 1) —
    no RNG state, no wall-clock, so the schedule replays exactly and
    two workers retrying different chunks still decorrelate. The
    constructor enforces ``growth >= 1 + jitter``, which makes the
    schedule monotone non-decreasing until the cap (property-tested).

    ``timeout`` (seconds, 0 disables) bounds each individual fetch via
    a daemon worker thread; an overrun raises the retryable
    :class:`ChunkFetchTimeout`. The abandoned worker may still complete
    in the background — harmless under the fetch-is-pure contract, the
    late payload is simply dropped — but it is *tracked*: live
    abandoned workers are capped at :data:`ABANDONED_WORKER_CAP`
    (:class:`FetchCapacityError` past it) and counted in
    :func:`abandoned_workers`.
    """

    max_retries: int = 4
    backoff_base: float = 0.05
    backoff_growth: float = 2.0
    backoff_cap: float = 2.0
    jitter: float = 0.25
    timeout: float = 0.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_base < 0 or self.backoff_cap < 0 or self.timeout < 0:
            raise ValueError("backoff_base/backoff_cap/timeout must be >= 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.backoff_growth < 1.0 + self.jitter:
            raise ValueError(
                f"backoff_growth ({self.backoff_growth}) must be >= "
                f"1 + jitter ({1.0 + self.jitter}): the deterministic "
                "jitter band must not undo the exponential growth, or "
                "the schedule loses its monotone-until-cap guarantee")

    @staticmethod
    def _unit(chunk: int, attempt: int) -> float:
        """Deterministic u in [0, 1) keyed on (chunk, attempt) only."""
        h = hashlib.sha256(f"backoff:{int(chunk)}:{int(attempt)}".encode())
        return int.from_bytes(h.digest()[:8], "big") / float(2 ** 64)

    def backoff(self, chunk: int, attempt: int) -> float:
        """Seconds to sleep before retry ``attempt`` (1-based) of ``chunk``."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        raw = self.backoff_base * self.backoff_growth ** (attempt - 1)
        return min(self.backoff_cap,
                   raw * (1.0 + self.jitter * self._unit(chunk, attempt)))

    def schedule(self, chunk: int) -> tuple:
        """The full replayable delay schedule for one chunk's retries."""
        return tuple(self.backoff(chunk, a)
                     for a in range(1, self.max_retries + 1))


# Abandoned-worker accounting (process-wide). A timed-out fetch parks
# its daemon worker here; dead threads are reaped before every timed
# fetch and on every read, so "live" is the number still actually
# holding a thread. ``ABANDONED_WORKER_CAP`` bounds them — tests may
# monkeypatch it (it is read at call time, never cached).
ABANDONED_WORKER_CAP = 64
_abandoned_lock = threading.Lock()
_abandoned: list = []      # threads abandoned by a timeout, maybe live
_abandoned_total = 0       # monotone count of every abandonment

# Process-wide fault metrics. Always a real registry —
# these counters are the source of truth the serving layers' health
# fields read through, so there is no null path here; the instruments
# are plain locked integers, cheap on failure paths by definition.
_REGISTRY = MetricsRegistry()
_RETRIES = _REGISTRY.counter("faults_retries_total")
_ABANDONED_CTR = _REGISTRY.counter("faults_abandoned_total")


def _abandoned_live() -> int:
    with _abandoned_lock:
        _reap_abandoned_locked()
        return len(_abandoned)


_REGISTRY.gauge("faults_abandoned_live", fn=_abandoned_live)


def process_registry() -> MetricsRegistry:
    """The process-wide fault-domain metrics registry.

    Exported by every ``/metrics`` endpoint alongside the per-service
    registries, so retry pressure and leaked fetch workers are visible
    without a serving layer in play.
    """
    return _REGISTRY


def _reap_abandoned_locked() -> None:
    _abandoned[:] = [t for t in _abandoned if t.is_alive()]


def abandoned_workers() -> dict:
    """Leaked-fetch-worker counters: ``{"live", "total", "cap"}``.

    ``live`` is the number of abandoned daemon threads still running
    right now (hung fetches that never returned); ``total`` counts every
    abandonment since process start. The serving layer's health report
    surfaces them, so a backend that hangs rather than fails shows up
    there before the cap trips.
    """
    with _abandoned_lock:
        _reap_abandoned_locked()
        return {"live": len(_abandoned), "total": _abandoned_total,
                "cap": ABANDONED_WORKER_CAP}


def _call_with_timeout(fn: Callable, i: int, timeout: float):
    """Run ``fn(i)`` bounded by ``timeout`` seconds (0 = unbounded).

    The fetch runs on a daemon worker thread; an overrun raises
    :class:`ChunkFetchTimeout` and abandons the worker (the fetch is
    pure, so its late result is simply never read). Abandoned workers
    are tracked and capped — see :class:`FetchCapacityError` — so
    repeated timeouts leak a bounded number of threads, not one per
    retry forever.
    """
    if timeout <= 0:
        return fn(i)
    global _abandoned_total
    with _abandoned_lock:
        _reap_abandoned_locked()
        if len(_abandoned) >= ABANDONED_WORKER_CAP:
            raise FetchCapacityError(
                f"chunk {i}: {len(_abandoned)} abandoned fetch workers "
                f"are still running (cap {ABANDONED_WORKER_CAP}) — the "
                "source is hanging persistently; refusing to park "
                "another thread on it")
    box = {}

    def run():
        try:
            box["val"] = fn(i)
        except BaseException as e:        # delivered to the caller below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        with _abandoned_lock:
            _abandoned.append(t)
            _abandoned_total += 1
        _ABANDONED_CTR.inc()
        raise ChunkFetchTimeout(
            f"chunk {i}: fetch exceeded the {timeout:g}s per-fetch "
            "timeout (the worker thread was abandoned)")
    if "err" in box:
        raise box["err"]
    return box["val"]


def _payload_equal(a, b) -> bool:
    """Byte-equality of two (p, b) chunk payloads (NaN-safe)."""
    return all(np.asarray(x, np.float32).tobytes()
               == np.asarray(y, np.float32).tobytes()
               for x, y in zip(a, b))


def fetch_with_retries(fn: Callable, i: int, policy: FaultPolicy,
                       verify: bool = False, sleep: Callable = time.sleep,
                       on_retry: Optional[Callable] = None):
    """Fetch chunk ``i`` through ``fn`` under ``policy``.

    Retries only the pure fetch on :data:`RETRYABLE` errors, sleeping
    the policy's deterministic backoff between attempts (``sleep`` is
    injectable so tests record the schedule instead of waiting it out).
    ``verify`` double-reads the chunk and requires byte-equality
    (corruption detection; the matching payload is returned).
    ``on_retry(chunk, attempt, error, delay)`` observes every retryable
    failure — the hook serving health counters hang off.

    Exhaustion raises :class:`ChunkFetchError` with the chunk index and
    the complete attempt history; the final cause is chained.
    """
    history = []
    for attempt in range(policy.max_retries + 1):
        try:
            out = _call_with_timeout(fn, i, policy.timeout)
            if verify:
                again = _call_with_timeout(fn, i, policy.timeout)
                if not _payload_equal(out, again):
                    raise ChunkIntegrityError(
                        f"chunk {i}: verified re-read returned different "
                        "bytes — one payload was corrupt (or the source "
                        "is not restart-deterministic)")
                out = again
            return out
        except RETRYABLE as e:
            last = attempt == policy.max_retries
            delay = None if last else policy.backoff(i, attempt + 1)
            history.append((attempt, repr(e), delay))
            if last:
                raise ChunkFetchError(i, history) from e
            _RETRIES.inc()
            if on_retry is not None:
                on_retry(i, attempt, e, delay)
            sleep(delay)


def resilient_source(source, policy: FaultPolicy, verify: bool = False,
                     sleep: Callable = time.sleep,
                     on_retry: Optional[Callable] = None):
    """Wrap a chunk source so every ``fn(i)`` goes through the policy.

    Returns ``source._replace(fn=...)`` — duck-typed over
    :class:`repro_torch.core.prefetch.HostChunkSource` (or anything
    NamedTuple-shaped with an ``fn``), so this module stays free of
    import cycles. Wrapping composes: a :func:`faulty_source` *under* a
    resilient source is the chaos-test sandwich (faults injected below,
    retries absorbing them above).
    """
    inner = source.fn

    def fn(i):
        return fetch_with_retries(inner, i, policy, verify=verify,
                                  sleep=sleep, on_retry=on_retry)

    return source._replace(fn=fn)


def policy_from_cfg(cfg) -> Optional[FaultPolicy]:
    """The :class:`FaultPolicy` a SolverConfig's fetch knobs describe.

    None when the config requests no fault handling at all
    (``fetch_retries == 0``, no timeout, no verification) — the caller
    then skips wrapping entirely and the ingest path is byte-for-byte
    the pre-fault-layer one.
    """
    if cfg.fetch_retries == 0 and cfg.fetch_timeout == 0 \
            and not cfg.verify_refetch:
        return None
    return FaultPolicy(max_retries=cfg.fetch_retries,
                       backoff_base=cfg.fetch_backoff,
                       backoff_growth=cfg.fetch_backoff_growth,
                       backoff_cap=cfg.fetch_backoff_cap,
                       jitter=cfg.fetch_jitter,
                       timeout=cfg.fetch_timeout)


# ---------------------------------------------------------------------------
# Deterministic fault injection: the chaos side of the layer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic injection plan for :func:`faulty_source`.

    Every injection decision is a pure hash of ``(seed, chunk,
    occurrence)`` where *occurrence* counts the calls made for that
    chunk so far — so a plan replays identically across runs, and a
    retried fetch sees a fresh (independent) decision rather than the
    same fault forever. Rates are probabilities per fetch:

    * ``drop`` — raise a transient ``IOError``;
    * ``slow`` — sleep ``slow_s`` seconds, then return the clean chunk
      (pair with a ``FaultPolicy.timeout < slow_s`` to exercise the
      timeout-and-retry path);
    * ``corrupt`` — return a perturbed payload whose perturbation is
      keyed on the occurrence (two corrupt reads of the same chunk
      never match, so a verified double-read always detects them).

    ``offenders`` are chunk indices whose first ``offender_failures``
    fetches raise unconditionally — the repeat-offender shard. Set
    ``offender_failures > max_retries`` to force retry exhaustion.
    """

    seed: int = 0
    drop: float = 0.0
    slow: float = 0.0
    slow_s: float = 0.02
    corrupt: float = 0.0
    offenders: tuple = ()
    offender_failures: int = 0

    def __post_init__(self):
        if min(self.drop, self.slow, self.corrupt) < 0 \
                or self.drop + self.slow + self.corrupt > 1.0:
            raise ValueError(
                "drop/slow/corrupt must be non-negative rates summing "
                f"to <= 1, got {(self.drop, self.slow, self.corrupt)}")

    def _unit(self, chunk: int, occurrence: int) -> float:
        h = hashlib.sha256(
            f"fault:{self.seed}:{int(chunk)}:{int(occurrence)}".encode())
        return int.from_bytes(h.digest()[:8], "big") / float(2 ** 64)


def faulty_source(source, plan: FaultPlan):
    """Inject the plan's faults under any chunk source (tests + chaos CLI).

    The wrapper keeps a per-chunk occurrence counter (thread-safe: a
    timed-out fetch's abandoned worker may still be counting) and
    decides each fetch's fate from the plan's hash. Clean fetches pass
    the inner payload through untouched, so a solve whose faults are all
    absorbed by the retry layer above consumes exactly the fault-free
    bytes.
    """
    inner = source.fn
    lock = threading.Lock()
    counts: dict = {}

    def fn(i):
        i = int(i)
        with lock:
            occ = counts.get(i, 0)
            counts[i] = occ + 1
        if i in plan.offenders and occ < plan.offender_failures:
            raise IOError(
                f"injected repeat-offender fault: chunk {i} "
                f"occurrence {occ} (< {plan.offender_failures})")
        u = plan._unit(i, occ)
        if u < plan.drop:
            raise IOError(f"injected transient fault: chunk {i} "
                          f"occurrence {occ}")
        if u < plan.drop + plan.slow:
            time.sleep(plan.slow_s)
            return inner(i)
        if u < plan.drop + plan.slow + plan.corrupt:
            p, b = inner(i)
            p = np.array(p, np.float32, copy=True)
            # Occurrence-keyed perturbation: two corrupt reads of the
            # same chunk can never return identical bytes, so the
            # verified double-read detects every corruption.
            p.flat[:: max(1, p.size // 8)] += np.float32(occ + 1)
            return p, b
        return inner(i)

    return source._replace(fn=fn)
