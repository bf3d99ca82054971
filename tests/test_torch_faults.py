"""The port's fault layer (``repro_torch.core.faults``) on the CPU: the
port's mirror of the fetch and chaos half of ``tests/test_faults.py``.

* the backoff schedule is deterministic, replayable and actually slept,
  and equal to the reference's for the same (chunk, attempt); a
  ``FaultPlan`` decides each (seed, chunk, occurrence) as the reference's
  does; exhaustion raises an error naming the chunk and every attempt;
* chaos parity: a host-fed solve whose source drops, slows, corrupts and
  repeat-offends, absorbed by the retry layer, is bitwise the fault-free
  solve, at slots 1 and 4; a fetch that hangs past the timeout is
  abandoned and retried, bitwise too;
* checkpoint writes fsync the data before the rename and the directory
  after it.
"""
import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.carry import config_from_reference  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    ChunkFetchError,
    ChunkFetchTimeout,
    FaultPlan,
    FaultPolicy,
    faulty_source,
    fetch_with_retries,
    policy_from_cfg,
    resilient_source,
)
from repro_torch.core.prefetch import solve_streaming_host  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.data.synth import sparse_host_chunk_source  # noqa: E402

CFG = SolverConfig(max_iters=40)
CHAOS_CFG = CFG.replace(fetch_retries=8, fetch_backoff=1e-4,
                        fetch_backoff_cap=1e-3, verify_refetch=True)
CHAOS_PLAN = FaultPlan(seed=0, drop=0.08, slow=0.05, slow_s=0.002,
                       corrupt=0.04, offenders=(1,), offender_failures=2)
RESULT_FIELDS = ["lam", "tau", "iters", "r", "primal", "dual"]


def _source():
    return sparse_host_chunk_source(3, 2048, 8, 256, q=2, tightness=0.4)


def _solve(src, cfg, **kw):
    return solve_streaming_host(src, cfg, q=2, device="cpu", **kw)


def _assert_bitwise(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for x, y in zip(a.fin_hist, b.fin_hist):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _flaky(fail_occurrences, payload=("p", "b")):
    """A fetch fn failing on the listed occurrence numbers (0-based)."""
    calls = {"n": 0}

    def fn(i):
        occ = calls["n"]
        calls["n"] += 1
        if occ in fail_occurrences:
            raise IOError(f"transient occurrence {occ}")
        return payload

    return fn, calls


# ---------------------------------------------------------------------------
# The retry loop, and its schedule against the reference's.
# ---------------------------------------------------------------------------

def test_retries_sleep_exactly_the_schedule():
    policy = FaultPolicy(max_retries=4, backoff_base=0.05)
    fn, calls = _flaky({0, 1, 2})
    slept = []
    out = fetch_with_retries(fn, 7, policy, sleep=slept.append)
    assert out == ("p", "b") and calls["n"] == 4
    assert slept == list(policy.schedule(7))[:3]


@pytest.mark.parametrize("kw", [{}, {"max_retries": 6, "backoff_base": 0.01,
                                     "backoff_growth": 3.0, "jitter": 0.5,
                                     "backoff_cap": 0.7}])
def test_schedule_equals_reference(kw):
    ours, theirs = FaultPolicy(**kw), jfaults.FaultPolicy(**kw)
    for chunk in (0, 1, 7, 152, 10 ** 6):
        assert ours.schedule(chunk) == theirs.schedule(chunk)


def test_fault_plan_decisions_equal_reference():
    """Per (seed, chunk, occurrence) the port's injection takes the
    reference's decision: the same raise, the same bytes."""
    src = _source()
    for plan_kw in ({"seed": 0, "drop": 0.2, "corrupt": 0.2, "slow": 0.1,
                     "slow_s": 0.0, "offenders": (2,), "offender_failures": 1},
                    {"seed": 5, "drop": 0.3, "corrupt": 0.3}):
        ours = faulty_source(src, FaultPlan(**plan_kw))
        theirs = jfaults.faulty_source(src, jfaults.FaultPlan(**plan_kw))
        for i in range(8):
            for _ in range(6):
                got, want = [], []
                for f, out in ((ours.fn, got), (theirs.fn, want)):
                    try:
                        out.append(f(i))
                    except IOError as e:
                        out.append(str(e))
                if isinstance(want[0], str):
                    assert got == want
                else:
                    for x, y in zip(got[0], want[0]):
                        np.testing.assert_array_equal(x, y)


def test_exhaustion_names_chunk_and_history():
    policy = FaultPolicy(max_retries=2, backoff_base=1e-5)
    fn, calls = _flaky(set(range(10)))
    slept = []
    with pytest.raises(ChunkFetchError) as ei:
        fetch_with_retries(fn, 3, policy, sleep=slept.append)
    e = ei.value
    assert e.chunk == 3 and len(e.history) == 3 and calls["n"] == 3
    assert "chunk 3" in str(e) and "3 attempt(s)" in str(e)
    assert "transient occurrence 0" in str(e)
    assert e.history[-1][2] is None and len(slept) == 2


def test_non_retryable_errors_propagate_and_hook_sees_retries():
    def bug(i):
        raise ValueError("a bug, not a fault")

    with pytest.raises(ValueError, match="a bug"):
        fetch_with_retries(bug, 0, FaultPolicy(max_retries=5), sleep=lambda s: None)
    fn, _ = _flaky({0, 1})
    seen = []
    fetch_with_retries(fn, 5, FaultPolicy(max_retries=3, backoff_base=1e-5),
                       sleep=lambda s: None, on_retry=lambda *a: seen.append(a))
    assert len(seen) == 2
    for chunk, _attempt, err, delay in seen:
        assert chunk == 5 and isinstance(err, IOError) and delay > 0


def test_timeout_is_retryable():
    calls = {"n": 0}

    def fn(i):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.5)
        return ("p", "b")

    policy = FaultPolicy(max_retries=2, backoff_base=1e-5, timeout=0.05)
    seen = []
    out = fetch_with_retries(fn, 0, policy, sleep=lambda s: None,
                             on_retry=lambda c, a, e, d: seen.append(e))
    assert out == ("p", "b")
    assert len(seen) == 1 and isinstance(seen[0], ChunkFetchTimeout)


def test_verify_detects_corruption_and_retries_past_it():
    clean = _source().fn(0)
    calls = {"n": 0}

    def fn(i):
        occ = calls["n"]
        calls["n"] += 1
        if occ < 2:
            p = np.array(clean[0], copy=True)
            p.flat[0] += np.float32(occ + 1)     # different bytes each time
            return p, clean[1]
        return clean

    out = fetch_with_retries(fn, 0, FaultPolicy(max_retries=3, backoff_base=1e-5),
                             verify=True, sleep=lambda s: None)
    np.testing.assert_array_equal(out[0], clean[0])
    calls["n"] = 0
    with pytest.raises(ChunkFetchError, match="re-read"):
        fetch_with_retries(fn, 0, FaultPolicy(max_retries=0), verify=True,
                           sleep=lambda s: None)


def test_policy_validation_and_cfg():
    with pytest.raises(ValueError, match="max_retries"):
        FaultPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="jitter"):
        FaultPolicy(jitter=1.0)
    with pytest.raises(ValueError, match="monotone"):
        FaultPolicy(backoff_growth=1.1, jitter=0.25)
    with pytest.raises(ValueError, match="attempt is 1-based"):
        FaultPolicy().backoff(0, 0)
    with pytest.raises(ValueError, match="summing"):
        FaultPlan(drop=0.7, corrupt=0.4)
    assert policy_from_cfg(CFG) is None
    pol = policy_from_cfg(CHAOS_CFG)
    assert pol.max_retries == 8 and pol.timeout == 0.0
    assert policy_from_cfg(CFG.replace(verify_refetch=True)) is not None
    assert policy_from_cfg(CFG.replace(fetch_timeout=0.1)) is not None
    # The reference's fault fields cross into the port's config.
    kw = dict(fetch_retries=8, fetch_backoff=1e-4, fetch_backoff_growth=3.0,
              fetch_backoff_cap=1e-3, fetch_jitter=0.5, fetch_timeout=0.2,
              verify_refetch=True, checkpoint_every=3, checkpoint_keep=2)
    got = config_from_reference(dataclasses.asdict(JCfg(**kw)))
    assert got == SolverConfig(**kw)
    assert policy_from_cfg(got) == FaultPolicy(
        max_retries=8, backoff_base=1e-4, backoff_growth=3.0,
        backoff_cap=1e-3, jitter=0.5, timeout=0.2)


def test_resilient_source_composes_over_faulty():
    clean = _source()
    wrapped = resilient_source(faulty_source(clean, CHAOS_PLAN),
                               policy_from_cfg(CHAOS_CFG), verify=True,
                               sleep=lambda s: None)
    for i in range(-(-clean.n // clean.chunk)):
        want, got = clean.fn(i), wrapped.fn(i)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Chaos parity: faults absorbed -> bitwise the clean solve.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 4])
def test_chaos_solve_bitwise_equals_clean_solve(slots):
    clean = _solve(_source(), CFG, slots=slots)
    chaotic = _solve(faulty_source(_source(), CHAOS_PLAN), CHAOS_CFG, slots=slots)
    _assert_bitwise(chaotic, clean)


def test_timeout_retry_path_bitwise():
    src = _source()
    inner = src.fn
    calls = {"n": 0}

    def hang_once(i):
        if int(i) == 2:
            calls["n"] += 1
            if calls["n"] == 1:
                time.sleep(0.5)
        return inner(i)

    cfg = CFG.replace(fetch_retries=3, fetch_backoff=1e-4,
                      fetch_backoff_cap=1e-3, fetch_timeout=0.1)
    clean = _solve(_source(), CFG)
    got = _solve(src._replace(fn=hang_once), cfg)
    assert calls["n"] >= 2           # the timeout really fired and retried
    _assert_bitwise(got, clean)


def test_exhaustion_in_solve_names_the_chunk():
    plan = FaultPlan(seed=0, offenders=(3,), offender_failures=10 ** 6)
    cfg = CFG.replace(fetch_retries=2, fetch_backoff=1e-5, fetch_backoff_cap=1e-4)
    with pytest.raises(ChunkFetchError, match="chunk 3") as ei:
        _solve(faulty_source(_source(), plan), cfg, slots=4)
    assert ei.value.chunk == 3 and len(ei.value.history) == 3


# ---------------------------------------------------------------------------
# Checkpoint durability: fsync before the rename, the directory after it.
# ---------------------------------------------------------------------------

def _events(monkeypatch):
    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    return events


def test_save_and_write_json_fsync_around_the_rename(tmp_path, monkeypatch):
    events = _events(monkeypatch)
    ckpt.save(tmp_path, 0, {"a": np.arange(4, dtype=np.float32),
                            "b": torch.ones((2, 2))})
    ri = events.index("replace")
    assert events[:ri].count("fsync") >= 4   # 2 leaves, manifest, tmp dir
    assert "fsync" in events[ri + 1:]
    events.clear()
    ckpt.write_json(tmp_path, "LIVE.json", {"gen": 1})
    ri = events.index("replace")
    assert "fsync" in events[:ri] and "fsync" in events[ri + 1:]
