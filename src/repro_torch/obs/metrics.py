"""Typed metrics registry: counters, gauges, histograms.

This is the process-wide observability substrate, the reference's
``obs/metrics.py`` copied: ``core/faults.py`` keeps its fault counters
on it, and the serving layers keep their ``health()`` fields as
read-only views assembled from instrument values.

Design rules:

* **Host-side only.**  Nothing here is ever called from inside a
  kernel or a device step; instruments mutate plain Python state under
  a lock.
* **Null fast path.**  ``NULL_REGISTRY`` hands out shared no-op
  instruments so un-instrumented call sites cost one attribute lookup
  and a no-op call — the bitwise story of a solve is identical with
  observability on or off either way, because instruments never feed
  back into numerics.
* **JSON-safe snapshots.**  ``MetricsRegistry.snapshot()`` returns a
  list of plain dicts that travels the replica RPC wire unchanged;
  ``merge_snapshots`` aggregates replica registries the way the front's
  ``/health`` already aggregates status; ``render_prometheus`` /
  ``parse_prometheus`` are the text exposition used by ``/metrics``.
"""
from __future__ import annotations

import json
import math
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_REGISTRY", "NullRegistry",
    "merge_snapshots", "label_snapshot",
    "render_prometheus", "parse_prometheus",
    "LATENCY_BUCKETS",
]

# Fixed latency ladder (seconds).  Fixed — not configurable per call
# site — so replica snapshots always merge elementwise.
LATENCY_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter.  ``inc`` only; never decremented or set."""

    kind = "counter"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (default 1) to the counter."""
        with self._lock:
            self._value += n

    @property
    def value(self):
        """Current count."""
        return self._value

    def _snap(self) -> dict:
        return {"kind": "counter", "name": self.name,
                "labels": dict(self.labels), "value": self._value}


class Gauge:
    """Point-in-time value: ``set``/``set_max``, or a pull callback.

    With ``fn`` the gauge is *computed* — ``value`` calls ``fn()`` at
    snapshot time (used e.g. for live cache sizes).
    """

    kind = "gauge"

    def __init__(self, name: str, labels: dict, fn=None):
        self.name = name
        self.labels = dict(labels)
        self._fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self._value = v

    def set_max(self, v) -> None:
        """Raise the gauge to ``v`` if ``v`` exceeds the current value."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        """Current value (calls the pull callback if one was given)."""
        if self._fn is not None:
            return self._fn()
        return self._value

    def _snap(self) -> dict:
        return {"kind": "gauge", "name": self.name,
                "labels": dict(self.labels), "value": self.value}


class Histogram:
    """Cumulative histogram over a fixed, shared bucket ladder."""

    kind = "histogram"

    def __init__(self, name: str, labels: dict, buckets=LATENCY_BUCKETS):
        self.name = name
        self.labels = dict(labels)
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # +1: +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        """Record one observation ``v``."""
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        """Total number of observations."""
        return self._count

    @property
    def sum(self):
        """Sum of all observed values."""
        return self._sum

    def _snap(self) -> dict:
        with self._lock:
            return {"kind": "histogram", "name": self.name,
                    "labels": dict(self.labels),
                    "buckets": list(self.buckets),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}


class MetricsRegistry:
    """Get-or-create instrument registry keyed by (name, labels)."""

    null = False

    def __init__(self):
        self._instruments: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        """Get or create the counter ``name`` with ``labels``."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, fn=None, **labels) -> Gauge:
        """Get or create the gauge ``name``; ``fn`` makes it computed."""
        g = self._get(Gauge, name, labels, fn=fn)
        if fn is not None and g._fn is None:
            g._fn = fn
        return g

    def histogram(self, name: str, buckets=LATENCY_BUCKETS,
                  **labels) -> Histogram:
        """Get or create the histogram ``name`` over ``buckets``."""
        return self._get(Histogram, name, labels, buckets=buckets)

    def snapshot(self) -> list:
        """JSON-safe list of instrument states, deterministically sorted."""
        with self._lock:
            insts = list(self._instruments.values())
        snaps = [i._snap() for i in insts]
        snaps.sort(key=lambda s: (s["name"], _label_key(s["labels"])))
        return snaps


class _NullInstrument:
    """Shared no-op instrument: every mutator is a cheap no-op."""

    def inc(self, n: int = 1) -> None:  # noqa: D102 - no-op
        pass

    def set(self, v) -> None:
        pass

    def set_max(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    value = 0
    count = 0
    sum = 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """No-op registry: hands out one shared no-op instrument."""

    null = True

    def counter(self, name: str, **labels):
        """Return the shared no-op instrument."""
        return _NULL_INSTRUMENT

    def gauge(self, name: str, fn=None, **labels):
        """Return the shared no-op instrument."""
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=LATENCY_BUCKETS, **labels):
        """Return the shared no-op instrument."""
        return _NULL_INSTRUMENT

    def snapshot(self) -> list:
        """Always empty."""
        return []


NULL_REGISTRY = NullRegistry()


def label_snapshot(snapshot: list, **labels) -> list:
    """Return a copy of ``snapshot`` with ``labels`` merged into every
    entry; the caller's labels win on collision (the front uses this to
    stamp ``replica="i"`` onto replica snapshots before merging)."""
    out = []
    for s in snapshot:
        s2 = dict(s)
        merged = dict(s2.get("labels", {}))
        merged.update({str(k): str(v) for k, v in labels.items()})
        s2["labels"] = merged
        out.append(s2)
    return out


def merge_snapshots(snapshots) -> list:
    """Merge an iterable of snapshot lists by (kind, name, labels).

    Counters and gauges sum; histograms add counts elementwise (the
    fixed shared ladders make this well defined) and add sum/count.
    """
    merged: dict = {}
    order: list = []
    for snap in snapshots:
        for s in snap:
            key = (s["kind"], s["name"], _label_key(s.get("labels", {})))
            cur = merged.get(key)
            if cur is None:
                cur = json.loads(json.dumps(s))   # deep, JSON-safe copy
                merged[key] = cur
                order.append(key)
                continue
            if s["kind"] == "histogram":
                if list(s["buckets"]) != list(cur["buckets"]):
                    raise ValueError(
                        f"histogram {s['name']!r}: bucket ladders differ")
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], s["counts"])]
                cur["sum"] += s["sum"]
                cur["count"] += s["count"]
            else:
                cur["value"] += s["value"]
    out = [merged[k] for k in order]
    out.sort(key=lambda s: (s["name"], _label_key(s.get("labels", {}))))
    return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(str(k))}="{v}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: list) -> str:
    """Render a snapshot (or merged snapshot) as Prometheus text format."""
    lines = []
    seen_type: set = set()
    for s in snapshot:
        name = _prom_name(s["name"])
        labels = s.get("labels", {})
        if name not in seen_type:
            lines.append(f"# TYPE {name} {s['kind']}")
            seen_type.add(name)
        if s["kind"] == "histogram":
            edges = list(s["buckets"]) + [math.inf]
            cum = 0
            for edge, c in zip(edges, s["counts"]):
                cum += c
                ls = dict(labels)
                ls["le"] = _prom_num(edge)
                lines.append(f"{name}_bucket{_prom_labels(ls)} {cum}")
            lines.append(
                f"{name}_sum{_prom_labels(labels)} {_prom_num(s['sum'])}")
            lines.append(
                f"{name}_count{_prom_labels(labels)} {s['count']}")
        else:
            lines.append(
                f"{name}{_prom_labels(labels)} {_prom_num(s['value'])}")
    return "\n".join(lines) + "\n"


_SERIES_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)="([^"]*)"')


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text format into ``{(name, labels): value}``.

    ``labels`` is a sorted tuple of (key, value) pairs.  Used by the CI
    gates to check ``/metrics`` against ``/health`` counters.
    """
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labelstr, value = m.groups()
        labels = ()
        if labelstr:
            labels = tuple(sorted(_LABEL_RE.findall(labelstr)))
        v = float("inf") if value == "+Inf" else float(value)
        out[(name, labels)] = v
    return out
