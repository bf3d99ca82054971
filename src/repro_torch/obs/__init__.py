"""Unified observability layer: metrics registry + phase-span tracing.

The reference's ``obs`` package (stdlib only), copied so the port imports
nothing of it. Everything is host-side only; the null fast path
(``null_obs()``) makes un-instrumented runs cost ~zero and keeps solves
bitwise identical with observability on or off
(``tests/test_torch_obs.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry,
    NULL_REGISTRY, NullRegistry,
    merge_snapshots, label_snapshot,
    render_prometheus, parse_prometheus, LATENCY_BUCKETS,
)
from .trace import (
    Tracer, NullTracer, NULL_TRACER, read_trace,
    current_rid, request, trace_path,
)

__all__ = [
    "Obs", "null_obs", "make_obs",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_REGISTRY", "NullRegistry",
    "merge_snapshots", "label_snapshot",
    "render_prometheus", "parse_prometheus", "LATENCY_BUCKETS",
    "Tracer", "NullTracer", "NULL_TRACER", "read_trace",
    "current_rid", "request", "trace_path",
]


@dataclass
class Obs:
    """Bundle of one metrics registry and one trace journal writer."""

    registry: object = field(default_factory=MetricsRegistry)
    tracer: object = NULL_TRACER

    def close(self) -> None:
        """Flush and close the trace journal."""
        self.tracer.close()


_NULL_OBS = Obs(registry=NULL_REGISTRY, tracer=NULL_TRACER)


def null_obs() -> Obs:
    """The shared no-op bundle (null registry + null tracer)."""
    return _NULL_OBS


def make_obs(root=None, role: str = "proc",
             fsync_every: int = 512) -> Obs:
    """Real registry, plus a journal under ``<root>/obs/`` if ``root``
    is given (otherwise tracing stays null)."""
    tracer = (Tracer(trace_path(root, role), fsync_every=fsync_every)
              if root is not None else NULL_TRACER)
    return Obs(registry=MetricsRegistry(), tracer=tracer)
