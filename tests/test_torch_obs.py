"""The port's observability layer (``repro_torch.obs``) on the CPU: the
registry, tracer and torn-journal tests of ``tests/test_obs.py``, the
Prometheus text and the traced solve's spans against the reference's, and
a traced host-fed solve bitwise the untraced one.

The traced solve records the reference's span names with the reference's
attributes: ``solve.iterate`` (iter), ``solve.finalize`` (mode, iters),
``screen.skip`` (streamed, skipped) and, per epoch, ``ingest.fetch`` and
``ingest.h2d`` (chunks). At one slot the journals are equal span for span;
with slots the reference's mesh runtime records the ingest per column
(``col``) where the port records it per epoch, so there the solve and
screening spans are compared.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import prefetch as jpf  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.core.prefetch import solve_streaming_host  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.data.synth import banded_host_chunk_source, sparse_host_chunk_source  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    LATENCY_BUCKETS,
    NULL_REGISTRY,
    MetricsRegistry,
    Tracer,
    current_rid,
    label_snapshot,
    merge_snapshots,
    null_obs,
    parse_prometheus,
    read_trace,
    render_prometheus,
    request,
    trace_path,
)

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_FIELDS = ("lam", "iters", "r", "primal", "dual", "tau")


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("hits", route="a")
    c.inc()
    c.inc(4)
    assert c.value == 5 and not hasattr(c, "set")
    g = reg.gauge("lease_age")
    g.set(2.0)
    g.set_max(1.0)
    g.set_max(7.5)
    assert g.value == 7.5
    backing = [1, 2, 3]
    live = reg.gauge("cache_size", fn=lambda: len(backing))
    backing.append(4)
    assert live.value == 4
    h = reg.histogram("lat")
    assert h.buckets == LATENCY_BUCKETS
    for v in (2e-5, 2e-5, 0.3, 99.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(99.30004)
    snap = {s["name"]: s for s in reg.snapshot()}
    assert snap["hits"] == {"kind": "counter", "name": "hits",
                            "labels": {"route": "a"}, "value": 5}
    assert snap["lat"]["counts"][-1] == 1 and snap["lat"]["counts"][1] == 2
    assert reg.counter("hits", route="a") is c
    assert reg.counter("hits", route="b") is not c
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("hits", route="a")


def test_null_registry_is_inert():
    inst = NULL_REGISTRY.counter("anything")
    inst.inc()
    inst.set(9)
    inst.observe(1.0)
    assert inst.value == 0
    assert NULL_REGISTRY.snapshot() == []
    assert NULL_REGISTRY.gauge("g") is inst
    assert null_obs() is null_obs()


def _drive(reg):
    reg.counter("req", route="decide").inc(3)
    reg.counter("req", route="refresh").inc()
    reg.gauge("up").set(1)
    reg.gauge("age").set_max(4.25)
    for v in (3e-5, 0.02, 7.0, 500.0):
        reg.histogram("lat").observe(v)
    reg.histogram("size", buckets=(1.0, 10.0)).observe(5.0)


def test_prometheus_render_equals_reference():
    ours, theirs = MetricsRegistry(), jobs.MetricsRegistry()
    _drive(ours)
    _drive(theirs)
    text = render_prometheus(ours.snapshot())
    assert text == jobs.render_prometheus(theirs.snapshot())
    series = parse_prometheus(text)
    assert series == jobs.parse_prometheus(text)
    assert series[("req", (("route", "decide"),))] == 3
    assert series[("lat_bucket", (("le", "+Inf"),))] == 4
    m = merge_snapshots([ours.snapshot(), label_snapshot(ours.snapshot(), r="1")])
    assert m == jobs.merge_snapshots([theirs.snapshot(),
                                      jobs.label_snapshot(theirs.snapshot(), r="1")])


# ---------------------------------------------------------------------------
# The tracer and its journal.
# ---------------------------------------------------------------------------

def test_tracer_spans_events_records_and_rid(tmp_path):
    path = trace_path(tmp_path, "t")
    with Tracer(path) as tr:
        with tr.span("solve.iterate", iter=3):
            pass
        tr.event("screen.skip", chunk=7)
        tr.record("ingest.fetch", 123.0, 0.25, chunks=8)
        with request("abc-1"):
            assert current_rid() == "abc-1"
            tr.event("serve.fill", chunk=0)
        assert current_rid() is None
    by_phase = {s["phase"]: s for s in read_trace(path)}
    assert by_phase["solve.iterate"]["iter"] == 3
    assert by_phase["solve.iterate"]["dur_s"] >= 0
    assert by_phase["screen.skip"]["dur_s"] == 0.0
    assert by_phase["ingest.fetch"]["t"] == 123.0
    assert by_phase["ingest.fetch"]["dur_s"] == 0.25
    assert by_phase["serve.fill"]["rid"] == "abc-1"
    assert "rid" not in by_phase["screen.skip"]


def test_tracer_batches_fsyncs_and_torn_tail(tmp_path):
    path = trace_path(tmp_path, "b")
    tr = Tracer(path, fsync_every=4)
    for i in range(3):
        tr.event("e", i=i)
    assert read_trace(path) == []
    tr.event("e", i=3)
    assert len(read_trace(path)) == 4
    tr.close()
    p = tmp_path / "j.jsonl"
    rec = json.dumps({"phase": "x", "t": 0, "dur_s": 0, "pid": 1})
    p.write_text(rec + "\n" + rec + "\n" + rec[: len(rec) // 2])
    assert len(read_trace(p)) == 2
    p.write_text(rec + "\n{bad}\n" + rec + "\n")
    with pytest.raises(ValueError, match="corrupt trace line 2"):
        read_trace(p)
    assert read_trace(tmp_path / "missing.jsonl") == []


def test_trace_journal_survives_sigkill(tmp_path):
    prog = (
        "import sys; sys.path.insert(0, {src!r})\n"
        "from repro_torch.obs import Tracer, trace_path\n"
        "tr = Tracer(trace_path({root!r}, 'victim'), fsync_every=1)\n"
        "tr.event('warmup')\n"
        "tr.flush()\n"
        "print('ready', flush=True)\n"
        "import time\n"
        "i = 0\n"
        "while True:\n"
        "    tr.event('tick', i=i); i += 1; time.sleep(0.001)\n"
    ).format(src=os.path.join(ROOT, "src"), root=str(tmp_path))
    proc = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        path = os.path.join(tmp_path, "obs", f"victim-{proc.pid}.jsonl")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if os.path.exists(path) and \
                    len(open(path, "rb").read().splitlines()) > 20:
                break
            time.sleep(0.01)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    ticks = [s for s in read_trace(path) if s["phase"] == "tick"]
    assert len(ticks) >= 10
    assert [s["i"] for s in ticks] == list(range(len(ticks)))


# ---------------------------------------------------------------------------
# Traced solves: bitwise the untraced ones, with the reference's spans.
# ---------------------------------------------------------------------------

def _shape(spans, phases=None):
    """(phase, attributes) of each span, without its clocks and pid."""
    return [(s["phase"], {k: v for k, v in s.items()
                          if k not in ("t", "dur_s", "pid")})
            for s in spans if phases is None or s["phase"] in phases]


def _traced(tmp_path, name, solve):
    with Tracer(trace_path(tmp_path, name)) as tr:
        res = solve(tr)
    return res, read_trace(tr.path)


CASES = {
    "uniform": (lambda m: m.sparse_host_chunk_source(3, 1024, 6, 128, q=2,
                                                     tightness=0.3),
                dict(max_iters=20), 2),
    "banded": (lambda m: m.banded_host_chunk_source(7, 8 * 256 - 50, 6, 256, q=2,
                                                    tightness=0.08, band=0.05),
               dict(max_iters=30, bucket_half=12, screening=True), 2),
}


class _Port:
    sparse_host_chunk_source = staticmethod(sparse_host_chunk_source)
    banded_host_chunk_source = staticmethod(banded_host_chunk_source)


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_solve_bitwise_with_reference_spans(tmp_path, case, slots):
    make, cfg, q = CASES[case]
    base = solve_streaming_host(make(_Port), SolverConfig(**cfg), q=q,
                                device="cpu", slots=slots)
    traced, spans = _traced(tmp_path, "port", lambda tr: solve_streaming_host(
        make(_Port), SolverConfig(**cfg), q=q, device="cpu", slots=slots,
        tracer=tr))
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(base, f)),
                                      np.asarray(getattr(traced, f)), err_msg=f)
    for x, y in zip(base.fin_hist, traced.fin_hist):
        assert torch.equal(x, y)
    theirs, jspans = _traced(tmp_path, "ref", lambda tr: jpf.solve_streaming_host(
        make(jsynth), JCfg(**cfg), q=q, slots=slots, tracer=tr))
    assert traced.iters == int(theirs.iters)
    phases = {s["phase"] for s in spans}
    assert {"solve.iterate", "solve.finalize", "ingest.fetch", "ingest.h2d"} <= phases
    if slots == 1:
        assert _shape(spans) == _shape(jspans)
    else:
        keep = {"solve.iterate", "solve.finalize", "screen.skip"}
        assert _shape(spans, keep) == _shape(jspans, keep)
        passes = traced.iters + 1 + (traced.screen["fallbacks"] if traced.screen else 0)
        for phase in ("ingest.fetch", "ingest.h2d"):
            assert sum(s["phase"] == phase for s in spans) == passes
    if case == "banded":
        assert any(s["phase"] == "screen.skip" and s["skipped"] > 0 for s in spans)
