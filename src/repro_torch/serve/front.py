"""Serving front: an HTTP surface over DecisionService replica processes.

The paper's §6 deployment is a *service*: the solve runs daily, but the
decisions are consumed as per-user request traffic. This module is that
request path, built from the stdlib (``http.server`` + raw sockets):

* :class:`ReplicaServer` — runs in each replica *process*: one
  :class:`~repro_torch.serve.decisions.DecisionService` over the shared
  generation root, served over a tiny length-prefixed JSON RPC (thread
  per connection — the concurrency that makes the service lock in
  :mod:`repro_torch.serve.decisions` load-bearing), plus a **pointer
  watcher** thread that polls ``LIVE.json`` and ``rebind()``s the
  service on every flip, demoting the previous generation to the
  degraded-mode fallback.
* :class:`ReplicaClient` — a connection-pooled RPC client for one
  replica.
* :class:`Front` — a ``ThreadingHTTPServer`` that round-robins lookup
  traffic over N replicas, aggregates every replica's ``health()`` at
  ``/health``, and exposes the cross-generation decision **diff** at
  ``/diff``.
* :func:`decision_diff` — "which of these users changed since
  generation g?", answered as **one grouped chunk pass per
  generation**: both generations' rows come from
  :meth:`~repro_torch.serve.decisions.DecisionService.lookup_batch`, whose
  chunk grouping regenerates each spanned chunk at most once (the
  parity test counts fetches at the source to prove it). Replicas keep
  a small LRU of per-generation services, so repeated diffs against
  the same baseline hit warm chunk caches.

Bitwise contract: a front answer IS a DecisionService answer — the
replica calls the same ``lookup``/``lookup_batch`` the in-process path
uses and the wire encodes the exact bytes (base64 of the bool row
payload), so single, batched, degraded-``stale`` and diff responses
are all bitwise-equal to direct in-process lookups against the same
generations (pinned end-to-end by ``tests/test_torch_front.py``).

The module is numpy and the stdlib over the port's ``DecisionService``,
whose fills run on the engine's device (the card unless ``"cpu"``); the
wire frames are the reference's byte for byte, so a frame written by
either package reads in the other.
"""
from __future__ import annotations

import base64
import itertools
import json
import os
import socket
import struct
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..core.faults import process_registry
from ..obs import (MetricsRegistry, NULL_TRACER, label_snapshot,
                   merge_snapshots, render_prometheus, request)

__all__ = ["ReplicaServer", "ReplicaClient", "Front", "FrontRPCError",
           "decision_diff", "pack_array", "unpack_array",
           "send_msg", "recv_msg", "poisoned_factory"]


# ---------------------------------------------------------------------------
# Wire format: 4-byte big-endian length + JSON; arrays as base64 payloads.
# ---------------------------------------------------------------------------

def pack_array(a) -> dict:
    """A JSON-safe encoding of an ndarray preserving its exact bytes."""
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def unpack_array(d: dict) -> np.ndarray:
    """Invert :func:`pack_array` (bitwise: same bytes, dtype, shape)."""
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])) \
        .reshape(d["shape"]).copy()


def send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed mid-message")
        buf.extend(part)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """One framed message; None on a clean close between messages."""
    try:
        head = _recv_exact(sock, 4)
    except ConnectionError:
        return None
    (length,) = struct.unpack(">I", head)
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


class FrontRPCError(RuntimeError):
    """A replica answered an RPC with an error payload."""

    def __init__(self, message: str, kind: str = "RuntimeError"):
        super().__init__(message)
        self.kind = kind


# ---------------------------------------------------------------------------
# The cross-generation decision diff.
# ---------------------------------------------------------------------------

def decision_diff(new_svc, old_svc, users) -> dict:
    """Which of ``users`` have a different decision row in ``new_svc``'s
    generation than in ``old_svc``'s?

    One grouped chunk pass per generation: each service answers through
    :meth:`~repro_torch.serve.decisions.DecisionService.lookup_batch`, which
    regenerates every spanned chunk at most once (and not at all when
    the service's LRU already holds it — the "two cached generations"
    of the front's diff endpoint). Returns::

        changed   (m,) bool — True where the rows differ, where the old
                  generation never covered the user (traffic growth),
                  or — when K changed — everywhere (no row is
                  comparable across a knapsack-count change)
        compared  users answered by both generations
        new_users users past the old generation's n
        stale     True when either side served any row degraded — the
                  diff is then against fallback data, flagged exactly
                  like a single lookup would be

    plus ``from_gen``/``to_gen`` provenance. Equal to the brute-force
    comparison of both generations' full ``decisions_chunk``
    materialisations (pinned, fetch-counted, in ``tests/test_torch_front.py``).
    """
    users = np.asarray(list(users), np.int64)
    out = {"from_gen": int(old_svc.generation.gen),
           "to_gen": int(new_svc.generation.gen)}
    if new_svc.generation.spec.k != old_svc.generation.spec.k:
        out.update(changed=np.ones(users.size, bool), compared=0,
                   new_users=0, stale=False, k_changed=True)
        return out
    x_new, stale_new, _ = new_svc.lookup_batch(users)
    covered = users < old_svc.source.n
    changed = np.ones(users.size, bool)
    stale = bool(stale_new.any())
    if covered.any():
        x_old, stale_old, _ = old_svc.lookup_batch(users[covered])
        changed[covered] = (x_new[covered] != x_old).any(axis=1)
        stale = stale or bool(stale_old.any())
    out.update(changed=changed, compared=int(covered.sum()),
               new_users=int((~covered).sum()), stale=stale,
               k_changed=False)
    return out


def poisoned_factory(make_source, budget_scale: float, chunk: int):
    """A ``make_source`` whose spec at ``budget_scale`` fails on one chunk.

    Test/chaos instrumentation for the degraded path: sources built for
    a spec whose ``budget_scale`` matches raise ``IOError`` on every
    fetch of ``chunk`` — with a retry policy armed this exhausts into a
    ``ChunkFetchError`` and the service answers those users from its
    fallback generation with ``stale=True``. Keying the poison on the
    spec (not the chunk index alone) leaves the *fallback* generation's
    fetches healthy, which is what makes the degradation observable
    end to end through a replica.
    """
    def factory(spec):
        src = make_source(spec)
        if spec.budget_scale != budget_scale:
            return src
        inner = src.fn

        def fn(i):
            if int(i) == chunk:
                raise IOError(
                    f"poisoned chunk {chunk} (budget_scale "
                    f"{budget_scale}) — injected permanent fault")
            return inner(i)

        return src._replace(fn=fn)

    return factory


# ---------------------------------------------------------------------------
# Replica process: DecisionService + pointer watcher behind a socket RPC.
# ---------------------------------------------------------------------------

class ReplicaServer:
    """One replica: a DecisionService served over socket RPC.

    Binds ``host:port`` (port 0 picks a free one — :attr:`port` after
    :meth:`start`), answers each connection on its own thread, and runs
    a pointer-watcher thread that follows ``LIVE.json`` flips with
    :meth:`~repro_torch.serve.decisions.DecisionService.rebind` — so every
    replica converges on a freshly published generation within
    ``poll_s`` without any coordination with the refresh writer.

    ``engine`` is a :class:`~repro_torch.serve.engine.RefreshEngine` over the
    shared root (usually :meth:`RefreshEngine.attach`-ed). Ops:
    ``lookup``, ``decide_batch`` (rows + per-row stale/gen provenance),
    ``diff`` (see :func:`decision_diff`; per-generation services cached
    under a ``gen_cache``-entry LRU), ``health``, ``metrics`` (merged
    registry snapshot + Prometheus text), ``ping``, ``shutdown``.

    Requests carrying a front-minted ``rid`` have it installed as the
    tracing request id for the duration of the dispatch, so a
    ``serve.fill`` span on this replica correlates with the
    ``front.decide`` span that caused it.
    """

    def __init__(self, engine, index: int = 0, cache_chunks: int = 16,
                 poll_s: float = 0.05, host: str = "127.0.0.1",
                 port: int = 0, gen_cache: int = 2):
        self.engine = engine
        self.index = int(index)
        self.cache_chunks = int(cache_chunks)
        self.poll_s = float(poll_s)
        self.host, self._port_req = host, int(port)
        self.svc = engine.decision_service(cache_chunks=cache_chunks)
        # Replica-level metrics live on their own (always-real) registry
        # so rebind counts survive even when the engine runs without obs;
        # the tracer comes from the engine so replica spans land in the
        # same journal as the fills they trigger.
        self.registry = MetricsRegistry()
        self._c_rebinds = self.registry.counter("replica_rebinds")
        self._tracer = engine.obs.tracer
        self._gen_cache_cap = int(gen_cache)
        self._gen_services: OrderedDict = OrderedDict()
        self._gen_lock = threading.Lock()
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._threads: list = []

    @property
    def rebinds(self) -> int:
        """Pointer flips this replica has followed (monotone)."""
        return int(self._c_rebinds.value)

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("replica not started")
        return self._sock.getsockname()[1]

    def start(self) -> int:
        """Bind, launch the watcher + accept loop threads; returns port."""
        self._sock = socket.create_server((self.host, self._port_req))
        self._sock.settimeout(0.2)
        for fn in (self._watch, self._accept):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()

    def serve_forever(self) -> None:
        """Block until :meth:`stop` (the ``--replica`` CLI entry)."""
        if self._sock is None:
            self.start()
        self._stop.wait()

    # -- pointer watcher ----------------------------------------------------

    def _watch(self) -> None:
        while not self._stop.is_set():
            try:
                live = self.engine.live_gen_id()
                if live is not None and live != self.svc.generation.gen:
                    gen = self.engine.generation(live)
                    if self._tracer.enabled:
                        with self._tracer.span("replica.rebind",
                                               replica=self.index,
                                               gen=int(live)):
                            self.svc.rebind(
                                self.engine.make_source(gen.spec), gen)
                    else:
                        self.svc.rebind(
                            self.engine.make_source(gen.spec), gen)
                    self._c_rebinds.inc()
            except (ValueError, OSError):
                # The GC raced this read (vanished generation under a
                # moving pointer — the documented contract): the next
                # poll re-resolves the pointer.
                pass
            self._stop.wait(self.poll_s)

    # -- per-generation services for the diff endpoint ----------------------

    def _gen_service(self, gen_id: int):
        """The diff baseline service for ``gen_id``, LRU-cached.

        The *current* generation always answers through ``self.svc``
        (whose cache is already warm from lookup traffic); baselines
        get their own fallback-less service so a damaged baseline fails
        the diff loudly instead of silently comparing stale rows.
        """
        gen_id = int(gen_id)
        if gen_id == self.svc.generation.gen:
            return self.svc
        with self._gen_lock:
            svc = self._gen_services.get(gen_id)
            if svc is not None:
                self._gen_services.move_to_end(gen_id)
                return svc
        gen = self.engine.generation(gen_id)     # raises on pruned/absent
        svc = self.engine.decision_service(
            generation=gen, cache_chunks=self.cache_chunks, fallback=False)
        with self._gen_lock:
            self._gen_services.setdefault(gen_id, svc)
            self._gen_services.move_to_end(gen_id)
            while len(self._gen_services) > self._gen_cache_cap:
                self._gen_services.popitem(last=False)
            return self._gen_services[gen_id]

    # -- RPC dispatch -------------------------------------------------------

    def metrics_snapshot(self) -> list:
        """Merged metric snapshot for this replica process.

        Combines the service registry (serve_* series), the replica's
        own registry (replica_rebinds) and the process-wide fault
        registry, summed by :func:`~repro_torch.obs.merge_snapshots`.
        """
        return merge_snapshots([self.svc.registry.snapshot(),
                                self.registry.snapshot(),
                                process_registry().snapshot()])

    def _handle(self, req: dict) -> dict:
        rid = req.get("rid")
        if rid is not None:
            # Install the front-minted request id so every span emitted
            # while answering this request (serve.fill in particular)
            # carries it — the wire-level correlation contract.
            with request(str(rid)):
                return self._dispatch(req)
        return self._dispatch(req)

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "gen": int(self.svc.generation.gen),
                    "replica": self.index}
        if op == "lookup":
            r = self.svc.lookup(int(req["user"]))
            return {"x": pack_array(r.x), "stale": bool(r.stale),
                    "gen": int(r.gen)}
        if op == "decide_batch":
            x, stale, gens = self.svc.lookup_batch(req["users"])
            return {"x": pack_array(x), "stale": pack_array(stale),
                    "gens": pack_array(gens)}
        if op == "diff":
            new_svc = self.svc
            old_svc = self._gen_service(req["gen"])
            fills0 = (new_svc.stats["fills"], old_svc.stats["fills"])
            out = decision_diff(new_svc, old_svc, req["users"])
            out["changed"] = pack_array(out["changed"])
            # Chunk-fill deltas for the pass accounting (exact when the
            # replica is otherwise idle, e.g. the bench's diff phase).
            out["fills"] = {"new": new_svc.stats["fills"] - fills0[0],
                            "old": old_svc.stats["fills"] - fills0[1]}
            return out
        if op == "health":
            h = self.svc.health()
            h["replica"] = {"index": self.index, "pid": os.getpid(),
                            "rebinds": self.rebinds,
                            "gen_cache": sorted(self._gen_services)}
            return h
        if op == "metrics":
            snap = self.metrics_snapshot()
            return {"replica": self.index, "snapshot": snap,
                    "text": render_prometheus(snap)}
        if op == "shutdown":
            self._stop.set()
            return {"ok": True}
        raise ValueError(f"unknown RPC op {op!r}")

    # -- socket plumbing ----------------------------------------------------

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                     # stop() closed the socket
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(60.0)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    req = recv_msg(conn)
                except (OSError, ValueError):
                    return
                if req is None:
                    return
                try:
                    resp = self._handle(req)
                except Exception as e:      # noqa: BLE001 — RPC boundary
                    resp = {"error": str(e), "type": type(e).__name__}
                try:
                    send_msg(conn, resp)
                except OSError:
                    return


# ---------------------------------------------------------------------------
# Front: HTTP over N replicas.
# ---------------------------------------------------------------------------

class ReplicaClient:
    """Connection-pooled RPC client for one replica."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.addr = (host, int(port))
        self.timeout = timeout
        self._pool: list = []
        self._lock = threading.Lock()

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, obj: dict) -> dict:
        """One request/response; raises FrontRPCError on replica errors,
        OSError when the replica is unreachable."""
        sock = self._checkout()
        try:
            send_msg(sock, obj)
            resp = recv_msg(sock)
        except OSError:
            sock.close()
            raise
        if resp is None:
            sock.close()
            raise ConnectionError(f"replica {self.addr} closed mid-call")
        with self._lock:
            self._pool.append(sock)
        if "error" in resp:
            raise FrontRPCError(resp["error"], resp.get("type", ""))
        return resp

    def close(self) -> None:
        with self._lock:
            for s in self._pool:
                s.close()
            self._pool.clear()


class _FrontHandler(BaseHTTPRequestHandler):
    """Request handler; the Front instance hangs off the server."""

    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True          # small JSON frames: no 40ms stalls

    def log_message(self, fmt, *args):      # quiet: the front keeps counters
        pass

    @property
    def front(self) -> "Front":
        return self.server.front

    def _reply(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_text(self, code: int, text: str) -> None:
        data = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            return {}
        return json.loads(self.rfile.read(length).decode("utf-8"))

    def do_GET(self) -> None:               # noqa: N802 (stdlib casing)
        url = urlparse(self.path)
        try:
            if url.path == "/health":
                self._reply(200, self.front.health())
            elif url.path == "/metrics":
                self._reply_text(200, self.front.metrics_text())
            elif url.path == "/decide":
                user = int(parse_qs(url.query)["user"][0])
                self._reply(200, self.front.decide(user))
            else:
                self._reply(404, {"error": f"no route {url.path}"})
        except FrontRPCError as e:
            self._reply(400 if e.kind == "IndexError" else 502,
                        {"error": str(e), "type": e.kind})
        except (KeyError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
        except OSError as e:
            self._reply(502, {"error": f"no replica reachable: {e}"})

    def do_POST(self) -> None:              # noqa: N802
        url = urlparse(self.path)
        try:
            body = self._body()
            if url.path == "/decide_batch":
                self._reply(200, self.front.decide_batch(body["users"]))
            elif url.path == "/diff":
                self._reply(200, self.front.diff(body["gen"],
                                                 body["users"]))
            else:
                self._reply(404, {"error": f"no route {url.path}"})
        except FrontRPCError as e:
            self._reply(400 if e.kind == "IndexError" else 502,
                        {"error": str(e), "type": e.kind})
        except (KeyError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
        except OSError as e:
            self._reply(502, {"error": f"no replica reachable: {e}"})


class Front:
    """The HTTP front: round-robin lookups, aggregated health, diffs.

    ``replicas`` is a list of :class:`ReplicaClient`. Lookup traffic
    (``/decide``, ``/decide_batch``) and diffs round-robin over them,
    failing over to the next replica (counted in ``rpc_errors``) when
    one is unreachable; ``/health`` fans out to every replica and
    reports per-replica documents plus an ``agreement`` bit — False
    while a pointer flip is still propagating through the watchers
    (replicas momentarily serve different generations, each one still
    bitwise-correct for the generation it names). ``/metrics`` exports
    Prometheus text: front counters, per-replica series labeled
    ``replica="i"``, and an unlabeled fleet aggregate.
    """

    def __init__(self, replicas: list, host: str = "127.0.0.1",
                 port: int = 0, tracer=None):
        if not replicas:
            raise ValueError("a front needs at least one replica")
        self.replicas = list(replicas)
        self._rr = 0
        self._lock = threading.Lock()
        self.registry = MetricsRegistry()
        self._c_requests = self.registry.counter("front_requests")
        self._c_rpc_errors = self.registry.counter("front_rpc_errors")
        self._c_failovers = self.registry.counter("front_failovers")
        self._h_route = self.registry.histogram("front_route_seconds")
        self._tracer = NULL_TRACER if tracer is None else tracer
        self._rids = itertools.count()
        self._httpd = ThreadingHTTPServer((host, port), _FrontHandler)
        self._httpd.front = self
        self._thread: Optional[threading.Thread] = None

    @property
    def stats(self) -> dict:
        """Routing counters (same keys as the pre-registry dict)."""
        return {"requests": int(self._c_requests.value),
                "rpc_errors": int(self._c_rpc_errors.value),
                "failovers": int(self._c_failovers.value)}

    def _rid(self) -> str:
        """Mint a request id unique across fronts (pid + monotone seq)."""
        return f"{os.getpid():x}-{next(self._rids):x}"

    # -- replica routing ----------------------------------------------------

    def _route(self, req: dict) -> tuple:
        """Round-robin with failover; returns (response, replica index)."""
        self._c_requests.inc()
        with self._lock:
            start = self._rr
            self._rr = (self._rr + 1) % len(self.replicas)
        t0 = time.perf_counter()
        last: Optional[Exception] = None
        for k in range(len(self.replicas)):
            i = (start + k) % len(self.replicas)
            try:
                resp = self.replicas[i].call(req)
            except FrontRPCError:
                raise                        # the op itself failed: surface
            except OSError as e:
                self._c_rpc_errors.inc()
                last = e
                continue
            if k:                            # answered by a later choice
                self._c_failovers.inc()
            self._h_route.observe(time.perf_counter() - t0)
            return resp, i
        raise last

    # -- the endpoints (also the in-process client surface) -----------------

    def decide(self, user: int) -> dict:
        req = {"op": "lookup", "user": int(user), "rid": self._rid()}
        if self._tracer.enabled:
            with self._tracer.span("front.decide", op="lookup",
                                   rid=req["rid"], users=1):
                resp, i = self._route(req)
        else:
            resp, i = self._route(req)
        x = unpack_array(resp["x"])
        return {"user": int(user), "x": [int(v) for v in x],
                "stale": resp["stale"], "gen": resp["gen"], "replica": i}

    def decide_batch(self, users) -> dict:
        users = [int(u) for u in users]
        req = {"op": "decide_batch", "users": users, "rid": self._rid()}
        if self._tracer.enabled:
            with self._tracer.span("front.decide", op="decide_batch",
                                   rid=req["rid"], users=len(users)):
                resp, i = self._route(req)
        else:
            resp, i = self._route(req)
        return {"users": len(users), "x": resp["x"],
                "stale": resp["stale"], "gens": resp["gens"], "replica": i}

    def diff(self, gen: int, users) -> dict:
        resp, i = self._route({"op": "diff", "gen": int(gen),
                               "users": [int(u) for u in users],
                               "rid": self._rid()})
        resp["replica"] = i
        return resp

    def health(self) -> dict:
        docs = []
        for i, rc in enumerate(self.replicas):
            try:
                docs.append(rc.call({"op": "health"}))
            except (OSError, FrontRPCError) as e:
                self._c_rpc_errors.inc()
                docs.append({"error": str(e), "replica": {"index": i}})
        gens = sorted({d["generation"] for d in docs if "generation" in d})
        front = dict(self.stats)
        front["replicas"] = len(self.replicas)
        return {"replicas": docs, "generations": gens,
                "agreement": len(gens) == 1,
                "ok": all("error" not in d for d in docs),
                "front": front}

    def metrics_text(self) -> str:
        """Prometheus text for the fleet: the front's own series, each
        replica's series stamped ``replica="i"``, and an unlabeled
        aggregate summed across the replicas that answered (the same
        fan-out-and-tolerate shape as :meth:`health` — unreachable
        replicas count an rpc_error and drop out of the aggregate).
        """
        series = list(self.registry.snapshot())
        per_replica = []
        for i, rc in enumerate(self.replicas):
            try:
                snap = rc.call({"op": "metrics"})["snapshot"]
            except (OSError, FrontRPCError):
                self._c_rpc_errors.inc()
                continue
            per_replica.append(snap)
            series.extend(label_snapshot(snap, replica=str(i)))
        if per_replica:
            series.extend(merge_snapshots(per_replica))
        return render_prometheus(series)

    # -- lifecycle ----------------------------------------------------------

    @property
    def address(self) -> tuple:
        return self._httpd.server_address

    def start(self) -> tuple:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.address

    def shutdown(self) -> None:
        # Only stop the serve loop if one is running: socketserver's
        # shutdown() waits on a flag that serve_forever sets on exit,
        # so calling it on a never-started front would block forever.
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()
        for rc in self.replicas:
            rc.close()
