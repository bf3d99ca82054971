"""Heartbeat leases: durable liveness records for supervised workers.

The checkpoint protocol (DESIGN.md §7) makes a killed solve *resumable*;
this module makes a dead or wedged solve *detectable*. A supervised
worker process renews a small on-disk lease — the heartbeat file — on a
fixed cadence, and a coordinator decides from that file alone whether
the worker is alive, hung, or gone:

* :class:`LeaseRecord` / :func:`write_lease` / :func:`read_lease` — one
  JSON payload (worker id, takeover ``term``, per-process ``seq``
  counter, a ``progress`` counter bumped per unit of real work, clocks,
  ``ttl``) plus a sha256 checksum line, written with the checkpoint
  layer's atomic-and-durable discipline (tmp file, fsync, ``os.replace``,
  directory fsync). The checksum is what makes *externally* torn or
  non-atomic writes detectable: a record that does not verify is treated
  as expired (:class:`TornLease`), never trusted.
* :class:`HeartbeatWriter` — the worker side: a daemon thread renews the
  lease every ``interval`` seconds (default ``ttl / 4``) with a strictly
  increasing ``seq``; the worker's fetch path calls :meth:`bump` so the
  lease also carries a work-progress counter.
* :class:`LeaseMonitor` — the coordinator side. Staleness is judged by
  observing ``seq`` **advancement against the observer's own monotonic
  clock**, never by comparing clocks across processes: a lease is fresh
  while its ``seq`` keeps moving, expired once it has not moved for
  ``ttl`` seconds of the observer's time. A SIGSTOPped worker freezes
  every thread including the renewer, so its lease stops advancing and
  expires within one ttl — the hang-detection signal the supervisor
  acts on. ``progress_ttl`` adds the second level: beats that continue
  while ``progress`` stagnates (a stuck fetch inside a live process).
* :func:`claim_takeover` — exclusive adoption of an expired worker:
  ``O_CREAT | O_EXCL`` on a per-term claim file means exactly one of any
  number of racing coordinators wins the right to kill and respawn
  (property-tested in tests/test_torch_heartbeat.py).

The module is deliberately tiny and dependency-light (stdlib + the
checkpoint fsync helper); it is the substrate `launch/supervisor.py`
drives and the one every future multi-host PR supervises its hosts
with.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import threading
import time
from typing import Callable, Optional

from ..checkpoint.ckpt import fsync_dir

__all__ = ["LeaseRecord", "TornLease", "write_lease", "read_lease",
           "lease_status", "HeartbeatWriter", "LeaseMonitor",
           "claim_takeover"]


class TornLease(ValueError):
    """A heartbeat file failed its checksum or did not parse.

    The atomic write protocol cannot produce this state, so it means the
    file was damaged externally (or written by something that is not
    this module). A torn lease carries **no liveness evidence** and is
    treated as expired by every consumer — restarting a live worker is
    recoverable, trusting a damaged record is not.
    """


@dataclasses.dataclass(frozen=True)
class LeaseRecord:
    """One heartbeat: who is alive, how alive, and until when.

    ``term`` is the takeover epoch (incremented per adoption, raft
    style) — records from a previous term are a dead incarnation's
    ghost, not evidence about the current worker. ``seq`` increases
    strictly within one writer's life; ``progress`` counts units of real
    work (chunk fetches) so a coordinator can distinguish "alive and
    working" from "alive and stuck". ``mono``/``wall`` are the writer's
    ``time.monotonic()``/``time.time()`` at write; ``ttl`` is the
    renewal deadline the writer promises to beat.
    """

    worker: str
    pid: int
    term: int
    seq: int
    progress: int
    ttl: float
    mono: float
    wall: float

    def to_json(self) -> dict:
        """Plain-dict form, the JSON payload of the lease file."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "LeaseRecord":
        """Rebuild a record from its ``to_json`` dict."""
        return cls(**d)


def _encode(record: LeaseRecord) -> bytes:
    payload = json.dumps(record.to_json(), sort_keys=True).encode()
    digest = hashlib.sha256(payload).hexdigest().encode()
    return payload + b"\n" + digest + b"\n"


def write_lease(path, record: LeaseRecord) -> str:
    """Atomically and durably publish ``record`` at ``path``.

    Same discipline as the checkpoint layer's ``write_json``: the
    payload (plus its checksum line) is written to ``<path>.tmp``,
    fsynced, renamed into place, and the parent directory fsynced — a
    reader sees the previous complete record or the new one, and a
    published beat survives power loss. Returns the final path.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_encode(record))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return str(path)


def read_lease(path) -> Optional[LeaseRecord]:
    """The record at ``path``; None when absent; :class:`TornLease` when
    the file exists but fails its checksum or does not parse.

    Raising (rather than returning None) keeps "never started" and
    "damaged" distinguishable; both classify as expired — see
    :func:`lease_status`.
    """
    path = pathlib.Path(path)
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return None
    lines = raw.split(b"\n")
    if len(lines) < 2:
        raise TornLease(f"heartbeat file {path} is truncated "
                        "(no checksum line); treating the lease as expired")
    payload, digest = lines[0], lines[1]
    if hashlib.sha256(payload).hexdigest().encode() != digest:
        raise TornLease(f"heartbeat file {path} fails its checksum — the "
                        "record was torn or damaged mid-write; treating "
                        "the lease as expired")
    try:
        return LeaseRecord.from_json(json.loads(payload.decode()))
    except (ValueError, TypeError) as e:
        raise TornLease(f"heartbeat file {path} checksummed but does not "
                        f"parse as a lease record ({e})") from e


def lease_status(path, ttl: Optional[float] = None,
                 now: Optional[float] = None) -> dict:
    """Same-host classification of the lease at ``path``.

    Returns ``{"state", "expired", "age", "lease"}`` with state one of
    ``absent`` / ``torn`` / ``fresh`` / ``expired``; ``expired`` is True
    for every state except ``fresh`` (no record, a damaged record, and a
    stale record all carry no liveness evidence). Age is measured
    against the *caller's* ``time.monotonic()``, which on Linux is the
    system-wide CLOCK_MONOTONIC and therefore comparable with the
    writer's — cross-host coordinators must use :class:`LeaseMonitor`,
    which never compares clocks across processes.
    """
    now = time.monotonic() if now is None else now
    try:
        lease = read_lease(path)
    except TornLease:
        return {"state": "torn", "expired": True, "age": None, "lease": None}
    if lease is None:
        return {"state": "absent", "expired": True, "age": None,
                "lease": None}
    age = now - lease.mono
    deadline = lease.ttl if ttl is None else ttl
    state = "fresh" if age <= deadline else "expired"
    return {"state": state, "expired": state != "fresh", "age": age,
            "lease": lease}


class HeartbeatWriter:
    """The worker side: renew one lease on a cadence, forever.

    ``start()`` writes an immediate first beat (so the coordinator's
    startup grace is about process launch, not thread scheduling) and
    then renews every ``interval`` seconds from a daemon thread until
    ``stop()``. ``bump(k)`` advances the progress counter from any
    thread; the next beat publishes it. ``seq`` increases strictly per
    write — the monotonicity the coordinator's advancement check and the
    property tests rely on. Usable as a context manager.
    """

    def __init__(self, path, worker: str, term: int, ttl: float,
                 interval: Optional[float] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        if ttl <= 0:
            raise ValueError(f"ttl must be > 0 (got {ttl}): a lease that "
                             "never needs renewal cannot expire")
        self.path = pathlib.Path(path)
        self.worker = str(worker)
        self.term = int(term)
        self.ttl = float(ttl)
        self.interval = float(interval) if interval is not None \
            else self.ttl / 4.0
        self._now = now_fn
        self._seq = 0
        self._progress = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bump(self, k: int = 1) -> int:
        """Advance the work-progress counter; returns the new value."""
        with self._lock:
            self._progress += int(k)
            return self._progress

    def beat(self) -> LeaseRecord:
        """Write one renewal now (also called by the background thread)."""
        with self._lock:
            self._seq += 1
            record = LeaseRecord(
                worker=self.worker, pid=os.getpid(), term=self.term,
                seq=self._seq, progress=self._progress, ttl=self.ttl,
                mono=self._now(), wall=time.time())
        write_lease(self.path, record)
        return record

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:
                # A failed renewal must not kill the worker: the solve
                # is still making progress, and the coordinator treating
                # the stale lease as a hang (restart from checkpoint) is
                # the designed, bitwise-safe response.
                pass

    def start(self) -> "HeartbeatWriter":
        """First beat synchronously, then renew from a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("HeartbeatWriter already started")
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-{self.worker}")
        self._thread.start()
        return self

    def stop(self):
        """Stop renewing (the last record is left in place)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.interval))
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class LeaseMonitor:
    """The coordinator side: staleness by observed advancement only.

    The monitor remembers the last ``(term, seq)`` it saw and *when it
    saw it on its own clock*; the lease is ``fresh`` while seq keeps
    advancing, ``expired`` once it has not advanced for ``ttl`` seconds,
    ``absent`` until a record of ``expect_term`` (or newer) first
    appears — records from older terms are a previous incarnation's
    ghost and count as absent — and ``expired`` immediately when the
    file is torn. ``grace`` bounds the absent state: a worker that never
    writes its first beat within ``grace`` seconds of monitor creation
    classifies as expired (covers a worker that dies before its first
    beat AND one that never starts).

    ``progress_ttl`` (optional) adds stuck-fetch detection: state
    ``stalled`` (also ``expired=True``) when beats keep arriving but
    ``progress`` has not advanced for that long.
    """

    def __init__(self, path, ttl: float, grace: float,
                 expect_term: int = 0,
                 progress_ttl: Optional[float] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.path = pathlib.Path(path)
        self.ttl = float(ttl)
        self.grace = float(grace)
        self.expect_term = int(expect_term)
        self.progress_ttl = progress_ttl
        self._now = now_fn
        t = self._now()
        self._born = t
        self._last_seq: Optional[tuple] = None     # (term, seq)
        self._last_advance = t
        self._last_progress: Optional[int] = None
        self._last_progress_advance = t

    def poll(self) -> dict:
        """One observation: ``{"state", "expired", "age", "progress",
        "lease"}``.

        ``age`` is seconds since the last observed seq advancement (or
        since monitor creation while absent) on the monitor's own clock.
        """
        now = self._now()
        try:
            lease = read_lease(self.path)
        except TornLease:
            return {"state": "torn", "expired": True,
                    "age": now - self._last_advance, "progress": None,
                    "lease": None}
        if lease is None or lease.term < self.expect_term:
            age = now - self._born
            return {"state": "absent" if age <= self.grace else "expired",
                    "expired": age > self.grace, "age": age,
                    "progress": None, "lease": lease}
        key = (lease.term, lease.seq)
        if self._last_seq is None or key > self._last_seq:
            self._last_seq = key
            self._last_advance = now
        if self._last_progress is None or lease.progress > self._last_progress:
            self._last_progress = lease.progress
            self._last_progress_advance = now
        age = now - self._last_advance
        if age > self.ttl:
            return {"state": "expired", "expired": True, "age": age,
                    "progress": lease.progress, "lease": lease}
        if self.progress_ttl is not None \
                and now - self._last_progress_advance > self.progress_ttl:
            return {"state": "stalled", "expired": True, "age": age,
                    "progress": lease.progress, "lease": lease}
        return {"state": "fresh", "expired": False, "age": age,
                "progress": lease.progress, "lease": lease}


def claim_takeover(path, term: int) -> bool:
    """Exclusively claim the right to adopt (kill + respawn) a worker.

    The claim for ``term`` is ``<path>.claim_<term>`` created with
    ``O_CREAT | O_EXCL`` — the filesystem's atomic create-if-absent, so
    of any number of coordinators racing to adopt the same expired
    worker exactly one returns True (and proceeds to SIGKILL + respawn
    at ``term``); every other racer returns False and must stand down.
    The claim file records the winner's pid for the post-mortem.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    claim = path.with_name(f"{path.name}.claim_{int(term):08d}")
    try:
        fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    try:
        os.write(fd, f"{os.getpid()}\n".encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    fsync_dir(path.parent)
    return True
