"""On-demand decision lookups: "what is x for user i?" in O(chunk).

The reference's ``serve/decisions.py`` under the same names. A fill
uploads the owning chunk to the service's device (the card unless
``device="cpu"``) and runs the port's ``chunked.decisions_rows`` there;
the cache holds the rows as NumPy.

Production (§6) does not consume the solve as an O(n) decision matrix —
it asks for single users' allocations as traffic arrives. The solver
already never materialises x (``chunked.decisions_chunk`` streams it);
this module adds the random-access path: a :class:`DecisionService`
bound to one published :class:`~repro_torch.serve.engine.Generation`
regenerates ONLY the chunk owning the queried user from the chunk
source and computes that chunk's decisions with
:func:`repro_torch.core.chunked.decisions_rows` — the exact per-row
arithmetic of full materialisation, so a lookup is **bitwise-equal** to
the corresponding row of ``decisions_chunk`` streamed over the whole
source (pinned by tests).

Why the parity holds: the decision for a row is ``select_sparse`` at
``lam`` intersected with the §5.4 projection ``pt > tau``, and both the
selection and the group-profit row sum ``pt`` are computed with the
same pinned arithmetic in every caller (``adjusted_profit_chunk``, a
multiply then a subtract; the left-to-right row sum), so the comparison
against ``tau`` — where a half-ulp would flip a row sitting exactly on
the removal threshold — resolves identically whether the chunk is one of
many in an export scan or a lone cache fill here.

Chunks are cached under a small LRU (``cache_chunks``) **keyed by the
generation's solver fingerprint plus the chunk index** — never the
chunk index alone. A service that follows a pointer flip
(:meth:`DecisionService.rebind`) therefore can never serve a chunk
computed under the previous generation's multipliers: the old entries
simply stop matching (and stay useful as the degraded-mode fallback's
cache).

Fault domain: chunk regenerations run through the same retry layer as
the solver's ingest (:mod:`repro_torch.core.faults`) when a ``fault_policy``
is given. A lookup whose regeneration exhausts its retries *degrades*
instead of failing when the service is armed with a ``fallback``
generation (the previously published one): the answer comes from the
fallback's decisions with an explicit ``stale=True`` flag, and
:meth:`health` accounts retries, fetch failures and stale serves so the
degradation is observable, never silent.

Thread safety: the service is safe to hammer from concurrent request
threads (the HTTP/RPC front's replicas, ``serve/front.py``, do exactly
that) while :meth:`rebind` follows pointer flips underneath. Every
lookup snapshots the ``(current, fallback)`` binding pair **once**
under the service lock and answers entirely from that snapshot — a
concurrent rebind can never mix two generations inside one call (bounds
validated against one generation, rows filled from another) or leave
the degraded path reading a fallback that a rebind just replaced. The
lock also serialises the LRU mutations and the ``stats`` counters;
the chunk fill itself runs *outside* the lock, so concurrent misses on
different chunks still overlap.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from ..core.chunked import decisions_rows
from ..core.faults import (ChunkFetchError, abandoned_workers,
                           fetch_with_retries)
from ..core.prefetch import HostChunkSource
from ..core.solver import resolve_device
from ..obs import MetricsRegistry, NULL_TRACER

__all__ = ["DecisionService", "LookupResult"]


class LookupResult(NamedTuple):
    """One answered lookup: the decision row, and where it came from.

    ``stale`` is True only on the degraded path — the current
    generation's chunk could not be regenerated and the answer is the
    ``fallback`` generation's decision for the same user. ``gen`` names
    the generation that actually answered.
    """

    x: np.ndarray          # (K,) bool decision row
    stale: bool
    gen: int


class _Bound(NamedTuple):
    """One generation binding: source + record + the cache key prefix."""

    source: object         # HostChunkSource or device ChunkSource
    generation: object     # serve.engine.Generation
    lam: torch.Tensor      # (K,) on the service's device
    tau: torch.Tensor      # () on the service's device
    q: int
    key: bytes             # generation fingerprint — the LRU key prefix


class DecisionService:
    """Point and batched decision queries against one generation.

    ``source`` is the generation's workload as either source family —
    a device :class:`~repro_torch.core.chunked.ChunkSource` (its chunks on
    ``device``) or a host-side
    :class:`~repro_torch.core.prefetch.HostChunkSource`; the engine's
    :meth:`~repro_torch.serve.engine.RefreshEngine.decision_service` builds it
    from the generation's spec. ``generation`` supplies ``(lam, tau,
    spec.q)``. The service holds O(cache_chunks · chunk · K) host state
    and nothing else.

    ``fault_policy`` (a :class:`repro_torch.core.faults.FaultPolicy`) makes
    every host-source chunk regeneration retry transient failures;
    ``verify`` double-reads each chunk (fetch-is-pure corruption
    check). ``fallback`` — a ``(source, generation)`` pair, normally
    the previously published generation — arms degraded mode: a lookup
    whose regeneration exhausts its retries is answered from the
    fallback with ``stale=True`` instead of raising. ``device`` (the card
    unless ``"cpu"``) runs the fills.
    """

    _STAT_KEYS = ("queries", "hits", "fills", "evictions",
                  "retries", "fetch_failures", "stale_serves")

    def __init__(self, source, generation, cache_chunks: int = 16,
                 fault_policy=None, verify: bool = False,
                 fallback: Optional[tuple] = None, supervisor_root=None,
                 registry=None, tracer=None, device="cuda"):
        self.device = resolve_device(device)
        if cache_chunks < 1:
            raise ValueError(f"cache_chunks must be >= 1, "
                             f"got {cache_chunks}")
        self.cache_chunks = cache_chunks
        self.fault_policy = fault_policy
        self.verify = verify
        # Optional supervision surface: a directory whose SUPERVISOR.json
        # (written by ``launch/supervisor.py``) is merged into health() —
        # restarts, takeovers and lease ages next to the serving counters.
        self.supervisor_root = supervisor_root
        # One LRU across generations: entries are keyed by (generation
        # fingerprint, chunk index), so a rebind keeps the old entries
        # harmless (they can only answer for their own generation) and
        # the fallback path still hits them.
        self._cache: OrderedDict = OrderedDict()
        # Per-service metrics registry: the serving
        # counters live here and ``stats`` / ``health()`` are read-only
        # views over it, preserving every pre-registry field name. The
        # registry is per *service* (not process-wide) on purpose — the
        # replica ``diff`` op baselines per-generation services against
        # each other by their own fill counts.
        self.registry = MetricsRegistry() if registry is None else registry
        self._counters = {k: self.registry.counter(f"serve_{k}")
                          for k in self._STAT_KEYS}
        self.registry.gauge("serve_cached_chunks",
                            fn=lambda: len(self._cache))
        self.registry.gauge("serve_cache_chunks").set(cache_chunks)
        self._g_degraded = self.registry.gauge("serve_degraded")
        self._h_fill = self.registry.histogram("serve_fill_seconds")
        self._tracer = NULL_TRACER if tracer is None else tracer
        # Degraded reflects the *current* binding state, not history: a
        # stale serve raises it, a rebind onto a fresh generation
        # clears it (the recovery-transition test pins this).
        self._degraded = False
        # The service lock: held around cache/stats mutation and the
        # binding swap — never around a fetch or the fill.
        self._lock = threading.Lock()
        self._current = self._bind(source, generation)
        self._fallback = (self._bind(*fallback)
                          if fallback is not None else None)

    @property
    def stats(self) -> dict:
        """The serving counters as a plain dict (pre-registry shape)."""
        return {k: c.value for k, c in self._counters.items()}

    def _bind(self, source, generation) -> _Bound:
        if source.k != generation.spec.k or source.n != generation.spec.n \
                or source.chunk != generation.spec.chunk:
            raise ValueError(
                f"source shape (n={source.n}, k={source.k}, "
                f"chunk={source.chunk}) does not match the generation's "
                f"spec {generation.spec} — lookups would silently answer "
                "for a different workload")
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        return _Bound(
            source=source, generation=generation,
            lam=put(generation.lam),
            # tau = -inf (nothing removed) still goes through the
            # projection compare so the arithmetic matches the
            # materialisation path.
            tau=put(generation.tau),
            q=generation.spec.q,
            key=np.asarray(generation.fingerprint, np.uint8).tobytes())

    def _snapshot(self):
        """The ``(current, fallback)`` binding pair, read atomically.

        Every public query snapshots once and answers from the
        snapshot: a concurrent :meth:`rebind` swaps both references
        under the same lock, so a call either sees the pre-flip pair or
        the post-flip pair — never the current of one generation with
        the fallback of another.
        """
        with self._lock:
            return self._current, self._fallback

    # -- binding surface (kept for callers that predate degraded mode) ---

    @property
    def source(self):
        return self._current.source

    @property
    def generation(self):
        return self._current.generation

    @property
    def lam(self):
        return self._current.lam

    @property
    def tau(self):
        return self._current.tau

    @property
    def q(self):
        return self._current.q

    def rebind(self, source, generation):
        """Follow a pointer flip: bind the new generation, demote the old.

        The previous binding becomes the degraded-mode fallback; both
        references swap under the service lock in one step, so an
        in-flight lookup observes either the old pair or the new pair
        (its own snapshot — see :meth:`_snapshot`). The chunk cache is
        *not* cleared — its entries are keyed by generation
        fingerprint, so the new generation can never hit the old
        generation's chunks (the cross-generation regression test pins
        this), while the demoted generation's warm entries keep serving
        the fallback path for free.
        """
        new = self._bind(source, generation)   # uploads outside the lock
        with self._lock:
            old = self._current
            self._current = new
            self._fallback = old
            # A fresh binding starts healthy: ``degraded`` states "the
            # *current* binding has served stale", not "some binding
            # ever did" (the recovery-transition regression pins this).
            # ``stale_serves`` stays monotone across rebinds.
            self._degraded = False
        self._g_degraded.set(0)

    # -- the chunk pipeline ------------------------------------------------

    def _on_retry(self, chunk, attempt, err, delay):
        self._counters["retries"].inc()

    def _fetch(self, bound: _Bound, ci: int):
        if isinstance(bound.source, HostChunkSource):
            if self.fault_policy is not None:
                p, b = fetch_with_retries(
                    bound.source.fn, int(ci), self.fault_policy,
                    verify=self.verify, on_retry=self._on_retry)
            else:
                p, b = bound.source.fn(int(ci))
            return (torch.from_numpy(np.asarray(p, np.float32)).to(self.device),
                    torch.from_numpy(np.asarray(b, np.float32)).to(self.device))
        return bound.source.fn(int(ci))

    def _fill(self, bound: _Bound, ci: int) -> np.ndarray:
        """Chunk ``ci``'s decision rows on the device, as NumPy."""
        p, b = self._fetch(bound, ci)
        rows = ci * bound.source.chunk + torch.arange(bound.source.chunk,
                                                     device=p.device)
        x = decisions_rows(p, b, bound.lam.to(p.device), bound.q,
                           rows < bound.source.n, bound.tau.to(p.device))
        return x.cpu().numpy()

    def _chunk_decisions(self, bound: _Bound, ci: int) -> np.ndarray:
        """(chunk, K) bool decisions for chunk ``ci``, through the LRU.

        The cache probe and the insert each hold the service lock; the
        fetch + fill between them run unlocked, so concurrent
        misses overlap. Two threads racing a miss on the same chunk
        both fill (deterministically identical bytes — the second
        insert is a no-op overwrite) and each counts exactly one of
        hits/fills, keeping ``hits + fills == chunk requests`` exact
        under any interleaving.
        """
        key = (bound.key, ci)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._counters["hits"].inc()
                self._cache.move_to_end(key)
                return hit
        t0 = time.perf_counter()
        tracer = self._tracer
        if tracer.enabled:
            # The fill span carries the request id installed by the
            # replica RPC layer (obs.trace.request), correlating a
            # front HTTP request with the fill that served it.
            with tracer.span("serve.fill", chunk=int(ci),
                             gen=bound.generation.gen):
                x = self._fill(bound, ci)
        else:
            x = self._fill(bound, ci)
        self._h_fill.observe(time.perf_counter() - t0)
        with self._lock:
            self._counters["fills"].inc()
            self._cache[key] = x
            while len(self._cache) > self.cache_chunks:
                self._cache.popitem(last=False)
                self._counters["evictions"].inc()
        return x

    # -- lookups -----------------------------------------------------------

    def _lookup(self, cur: _Bound, fb: Optional[_Bound],
                user: int) -> LookupResult:
        """One lookup against an explicit binding snapshot."""
        n, chunk = cur.source.n, cur.source.chunk
        user = int(user)
        if not 0 <= user < n:
            raise IndexError(f"user {user} outside [0, {n})")
        self._counters["queries"].inc()
        try:
            row = self._chunk_decisions(cur, user // chunk)[user % chunk]
            return LookupResult(row, False, cur.generation.gen)
        except ChunkFetchError:
            self._counters["fetch_failures"].inc()
            if fb is None or user >= fb.source.n:
                raise
            row = self._chunk_decisions(
                fb, user // fb.source.chunk)[user % fb.source.chunk]
            self._counters["stale_serves"].inc()
            with self._lock:
                self._degraded = True
            self._g_degraded.set(1)
            return LookupResult(row, True, fb.generation.gen)

    def lookup(self, user: int) -> LookupResult:
        """The decision row for one user, with staleness provenance.

        The degraded path: when the current generation's owning chunk
        cannot be regenerated (retries exhausted — a
        ``ChunkFetchError``) and a fallback generation is armed that
        covers the user, the fallback's decision is returned with
        ``stale=True``. With no fallback (or one the user outgrew) the
        fetch error propagates: an explicit failure beats a silently
        wrong answer. The ``(current, fallback)`` pair is snapshotted
        once — a rebind mid-call cannot redirect the degraded path to
        a different generation than the one that failed.
        """
        cur, fb = self._snapshot()
        return self._lookup(cur, fb, user)

    def decide(self, user: int) -> np.ndarray:
        """The (K,) bool decision row for one user of the generation."""
        return self.lookup(user).x

    def lookup_batch(self, users: Iterable[int]):
        """Batched lookups with per-row provenance.

        Returns ``(x (m, K) bool, stale (m,) bool, gens (m,) int64)`` —
        the rows in input order plus, per row, whether it was served
        degraded and by which generation. The whole batch answers from
        **one** binding snapshot: bounds are validated against the same
        generation that fills the rows, whatever ``rebind`` does
        concurrently (the injected-rebind regression test pins this).
        Owning chunks are regenerated at most once per call (grouped
        fills), so a batch over m users touches min(m, chunks-spanned)
        chunks per generation that answers.
        """
        cur, fb = self._snapshot()
        users = np.asarray(list(users), np.int64)
        n, chunk = cur.source.n, cur.source.chunk
        if users.size and (users.min() < 0 or users.max() >= n):
            bad = users[(users < 0) | (users >= n)][0]
            raise IndexError(f"user {int(bad)} outside [0, {n})")
        x = np.zeros((users.size, cur.source.k), bool)
        stale = np.zeros(users.size, bool)
        gens = np.full(users.size, cur.generation.gen, np.int64)
        order = np.argsort(users // chunk, kind="stable")
        for j in order:
            res = self._lookup(cur, fb, int(users[j]))
            x[j], stale[j], gens[j] = res.x, res.stale, res.gen
        return x, stale, gens

    def decide_batch(self, users: Iterable[int]) -> np.ndarray:
        """(len(users), K) bool decisions, chunk-grouped source access.

        Queries are answered in input order but the owning chunks are
        each regenerated at most once per call (grouped fills), so a
        batch over m users touches min(m, chunks-spanned) chunks.
        Degraded lookups fall back per user (see :meth:`lookup`); use
        :meth:`lookup_batch` when the per-row provenance matters.
        """
        return self.lookup_batch(users)[0]

    # -- observability -----------------------------------------------------

    def health(self) -> dict:
        """Serving health: retry/degradation counters + cache stats.

        ``stale_serves`` counting up means the current generation's
        source is failing past its retry budget and queries are being
        answered by the fallback generation — degraded but alive;
        ``fetch_failures`` without matching ``stale_serves`` means
        queries are *failing* (no fallback covered them). ``degraded``
        is the *current* binding's state — True once this binding has
        served stale, reset when :meth:`rebind` installs a fresh
        generation — so a service that rebinds onto a healed source
        reports healthy again even though ``stale_serves`` (a monotone
        counter) stays nonzero.
        ``abandoned_fetch_workers`` / ``abandoned_fetch_total`` surface
        the process-wide leaked-worker counters of the timeout layer
        (:func:`repro_torch.core.faults.abandoned_workers`) — a backend that
        hangs instead of erroring shows up here. When the service was
        built with a ``supervisor_root``, the supervisor's status
        document (restarts, hang takeovers, lease ages) is merged in
        under ``"supervisor"`` — with an explicit ``{"status":
        "absent"}`` when no SUPERVISOR.json has been written yet (a
        configured-but-not-yet-started supervisor is not the same
        observation as a dead one) and ``{"status": "unreadable"}``
        when the document exists but cannot be parsed (externally
        damaged): one bad supervisor file must degrade that field, not
        take down the health endpoint.
        """
        leaked = abandoned_workers()
        with self._lock:
            cur, fb = self._current, self._fallback
            cached = len(self._cache)
            degraded = self._degraded
        out = {
            **self.stats,
            "generation": cur.generation.gen,
            "fallback_generation": (None if fb is None
                                    else fb.generation.gen),
            "cached_chunks": cached,
            "cache_chunks": self.cache_chunks,
            "degraded": degraded,
            "abandoned_fetch_workers": leaked["live"],
            "abandoned_fetch_total": leaked["total"],
        }
        if self.supervisor_root is not None:
            from ..checkpoint import ckpt

            try:
                doc = ckpt.read_json(self.supervisor_root,
                                     "SUPERVISOR.json")
            except ValueError as e:
                out["supervisor"] = {"status": "unreadable",
                                     "error": str(e)}
            else:
                out["supervisor"] = ({"status": "absent"} if doc is None
                                     else doc)
        return out
