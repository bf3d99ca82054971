"""Phase-span tracing to an fsync-safe JSONL journal per process.

Spans are *host-side only*: a span brackets host Python work (an epoch
of chunk feeding, a finalize pass, a replica fill) and never reaches
inside a kernel or its arguments, which is what keeps a solve with
tracing enabled bitwise identical to one without. The reference's
``obs/trace.py``, copied.

Journal format: one JSON object per line —

    {"phase": "solve.iterate", "t": <epoch s>, "dur_s": <float>,
     "pid": <int>, "rid": <request id, if any>, ...attrs}

Durability: spans buffer in memory and are JSON-encoded, written in
one batch, flushed and fsynced every ``fsync_every`` spans and on
``flush``/``close``.  A SIGKILL therefore loses at most the last
``fsync_every`` unflushed spans and can tear at most the final line on
disk — ``read_trace`` tolerates a torn tail (it never raises on one)
while still refusing mid-file corruption.  Keeping the hot path to a
locked list append is what keeps the enabled path cheap.

Request correlation: the front mints a request id per HTTP request and
sends it over the replica RPC wire; ``ReplicaServer`` installs it in a
``contextvars.ContextVar`` around dispatch so every span emitted while
serving that request (e.g. ``serve.fill``) carries the same ``rid``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "read_trace",
           "current_rid", "request", "trace_path"]

import contextvars

_RID: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_rid", default=None)


def current_rid():
    """The request id installed for this context, or None."""
    return _RID.get()


@contextlib.contextmanager
def request(rid):
    """Install ``rid`` as the current request id for the duration."""
    tok = _RID.set(rid)
    try:
        yield
    finally:
        _RID.reset(tok)


def trace_path(root, role: str):
    """Canonical journal path for ``role`` under ``<root>/obs/``."""
    return os.path.join(os.fspath(root), "obs",
                        f"{role}-{os.getpid()}.jsonl")


class _Span:
    __slots__ = ("_tracer", "_phase", "_attrs", "_t0", "_p0")

    def __init__(self, tracer, phase, attrs):
        self._tracer = tracer
        self._phase = phase
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.time()
        self._p0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._p0
        self._tracer._emit(self._phase, self._t0, dur, self._attrs)
        return False


class Tracer:
    """Appends phase spans to one JSONL journal file.

    The file is opened lazily on the first span so constructing a
    Tracer never touches the filesystem; parent directories are created
    on open.  Thread-safe: one lock serialises writes.
    """

    enabled = True

    def __init__(self, path, fsync_every: int = 512):
        self.path = os.fspath(path)
        self.fsync_every = max(1, int(fsync_every))
        self._fh = None
        self._buf: list = []
        self._lock = threading.Lock()

    def span(self, phase: str, **attrs):
        """Context manager timing a host-side phase."""
        return _Span(self, phase, attrs)

    def event(self, phase: str, **attrs) -> None:
        """Zero-duration mark (e.g. ``screen.skip``)."""
        self._emit(phase, time.time(), 0.0, attrs)

    def record(self, phase: str, t0: float, dur_s: float,
               **attrs) -> None:
        """Emit a pre-measured span (host-side aggregated timing).

        The ingest instrumentation uses this to time every chunk fetch
        / upload with bare ``perf_counter`` pairs and emit *one* record
        per phase per epoch — per-chunk span objects on the streaming
        critical path would dominate the cost they measure.
        """
        self._emit(phase, t0, float(dur_s), attrs)

    def _emit(self, phase, t0, dur, attrs):
        # The hot path does no serialisation and no I/O: records buffer
        # in memory and are JSON-encoded + written in one batch every
        # ``fsync_every`` spans (and on flush/close). That batching is
        # what keeps the per-span cost near a list append.
        rec = {"phase": phase, "t": t0, "dur_s": dur, "pid": os.getpid()}
        rid = _RID.get()
        if rid is not None:
            rec["rid"] = rid
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) >= self.fsync_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write("".join(
            json.dumps(rec, separators=(",", ":")) + "\n"
            for rec in self._buf))
        self._buf.clear()
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def flush(self) -> None:
        """Durably write every buffered span (one line batch + fsync)."""
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        """Flush, fsync and close the journal (idempotent)."""
        with self._lock:
            self._flush_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: the default everywhere tracing isn't requested."""

    enabled = False

    def span(self, phase: str, **attrs):
        """Shared no-op context manager."""
        return _NULL_SPAN

    def event(self, phase: str, **attrs) -> None:
        """No-op."""

    def record(self, phase: str, t0: float, dur_s: float,
               **attrs) -> None:
        """No-op."""

    def flush(self) -> None:
        """No-op."""

    def close(self) -> None:
        """No-op."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_TRACER = NullTracer()


def read_trace(path) -> list:
    """Read a span journal, tolerating a torn tail.

    Returns the list of decoded span dicts.  A final line torn by a
    crash (no trailing newline / truncated JSON) is silently dropped;
    an undecodable line *before* the tail raises, because that means
    real corruption rather than a crash mid-append.
    """
    spans = []
    try:
        with open(os.fspath(path), "r", encoding="utf-8") as fh:
            raw = fh.read()
    except FileNotFoundError:
        return spans
    lines = raw.splitlines()
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            spans.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                continue            # torn tail (crash mid-append)
            raise ValueError(
                f"{path}: corrupt trace line {i + 1}") from None
    return spans
