"""Property tests for the port's heartbeat leases (repro_torch/core/heartbeat.py),
case for case the reference's ``tests/test_heartbeat_props.py``, plus the
lease file read across packages (written by either, read by the other,
byte for byte).

The properties the supervisor's correctness stands on:

* **renewal monotonicity** — a writer's ``seq`` strictly increases per
  beat and ``progress`` is non-decreasing under ``bump``; the monitor's
  freshness judgement depends only on observing ``(term, seq)`` advance
  against its *own* clock, so with beats arriving within ``ttl`` the
  lease stays fresh and once they cease it expires after exactly
  ``ttl`` of monitor time — never earlier, regardless of the schedule;
* **takeover exclusivity** — for one term, of any number of racing
  coordinators exactly one ``claim_takeover`` wins (O_CREAT|O_EXCL),
  whether raced sequentially or from threads;
* **torn writes carry no liveness** — any truncation or byte corruption
  of a valid lease file classifies as expired (``TornLease`` /
  ``state == "torn"``), never fresh: a damaged record must not keep a
  dead worker looking alive.

Each property has a deterministic twin (always run) and a hypothesis
sweep (skipped without hypothesis unless REQUIRE_HYPOTHESIS is set —
see tests/_hypothesis_compat.py).
"""
import os
import threading

import pytest

pytest.importorskip("torch")

from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402

from repro.core import heartbeat as jheartbeat  # noqa: E402
from repro_torch.core.heartbeat import (  # noqa: E402
    HeartbeatWriter,
    LeaseMonitor,
    LeaseRecord,
    TornLease,
    claim_takeover,
    lease_status,
    read_lease,
    write_lease,
)


class _Clock:
    """Injectable monotonic clock."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _writer(tmp_path, clock, ttl=3.0, term=1):
    return HeartbeatWriter(tmp_path / "hb.json", worker="w", term=term,
                           ttl=ttl, now_fn=clock)


# ---------------------------------------------------------------------------
# Renewal monotonicity.
# ---------------------------------------------------------------------------

def test_seq_strictly_increases_and_progress_monotone(tmp_path):
    clock = _Clock()
    hb = _writer(tmp_path, clock)
    seqs, progs = [], []
    for i in range(10):
        hb.bump(i % 3)
        rec = hb.beat()
        seqs.append(rec.seq)
        progs.append(rec.progress)
    assert seqs == sorted(set(seqs)), "seq must strictly increase"
    assert progs == sorted(progs), "progress must be non-decreasing"
    on_disk = read_lease(tmp_path / "hb.json")
    assert on_disk.seq == seqs[-1] and on_disk.progress == progs[-1]


def test_monitor_fresh_while_beating_expired_after_ttl(tmp_path):
    clock = _Clock()
    hb = _writer(tmp_path, clock, ttl=2.0)
    mon = LeaseMonitor(tmp_path / "hb.json", ttl=2.0, grace=5.0,
                       expect_term=1, now_fn=clock)
    for _ in range(8):                    # renewals within ttl: fresh
        hb.beat()
        clock.advance(0.5)
        st_ = mon.poll()
        assert st_["state"] == "fresh" and not st_["expired"]
    clock.advance(1.9)                    # beats cease; inside ttl still
    assert not mon.poll()["expired"]
    clock.advance(0.2)                    # now past ttl since last advance
    st_ = mon.poll()
    assert st_["state"] == "expired" and st_["expired"]


def test_monitor_never_compares_cross_process_clocks(tmp_path):
    # A lease whose *writer* clock is absurdly far in the past/future
    # must not matter: only observed advancement on the monitor's clock.
    clock = _Clock(1000.0)
    mon = LeaseMonitor(tmp_path / "hb.json", ttl=1.0, grace=10.0,
                       expect_term=1, now_fn=clock)
    rec = LeaseRecord(worker="w", pid=1, term=1, seq=1, progress=0,
                      ttl=1.0, mono=-9e9, wall=9e12)
    write_lease(tmp_path / "hb.json", rec)
    assert mon.poll()["state"] == "fresh"
    clock.advance(0.5)
    write_lease(tmp_path / "hb.json",
                LeaseRecord(worker="w", pid=1, term=1, seq=2, progress=0,
                            ttl=1.0, mono=9e9, wall=0.0))
    assert mon.poll()["state"] == "fresh"
    clock.advance(1.1)                    # no further advancement
    assert mon.poll()["state"] == "expired"


def test_monitor_grace_bounds_absent_and_old_terms_are_ghosts(tmp_path):
    clock = _Clock()
    mon = LeaseMonitor(tmp_path / "hb.json", ttl=1.0, grace=3.0,
                       expect_term=2, now_fn=clock)
    assert mon.poll()["state"] == "absent"
    # A dead incarnation's record (term 1 < expect_term 2) is a ghost.
    write_lease(tmp_path / "hb.json",
                LeaseRecord(worker="w", pid=1, term=1, seq=99, progress=9,
                            ttl=1.0, mono=0.0, wall=0.0))
    st_ = mon.poll()
    assert st_["state"] == "absent" and st_["expired"] is False
    clock.advance(3.1)                    # grace elapsed, still no term-2
    assert mon.poll()["expired"]


def test_progress_ttl_detects_stall_with_live_beats(tmp_path):
    clock = _Clock()
    hb = _writer(tmp_path, clock, ttl=2.0)
    mon = LeaseMonitor(tmp_path / "hb.json", ttl=2.0, grace=5.0,
                       expect_term=1, progress_ttl=3.0, now_fn=clock)
    hb.bump()
    hb.beat()
    assert mon.poll()["state"] == "fresh"
    for _ in range(4):                    # beats keep coming, progress frozen
        clock.advance(1.0)
        hb.beat()
        mon.poll()
    st_ = mon.poll()
    assert st_["state"] == "stalled" and st_["expired"]
    hb.bump()                             # progress resumes -> fresh again
    hb.beat()
    assert mon.poll()["state"] == "fresh"


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=60, deadline=None)
@given(steps=st.lists(
    st.tuples(st.booleans(), st.floats(0.01, 1.0)), min_size=1,
    max_size=40))
def test_prop_expiry_iff_no_advancement_for_ttl(tmp_path_factory, steps):
    """expired <=> monitor time since last observed advance > ttl."""
    tmp_path = tmp_path_factory.mktemp("hb")
    clock = _Clock()
    ttl = 1.0
    hb = _writer(tmp_path, clock, ttl=ttl)
    mon = LeaseMonitor(tmp_path / "hb.json", ttl=ttl, grace=100.0,
                       expect_term=1, now_fn=clock)
    hb.beat()
    mon.poll()
    since_advance = 0.0
    for beat, dt in steps:
        if beat:
            hb.beat()
        clock.advance(dt)
        st_ = mon.poll()
        # The monitor observes the beat at this poll, so advancement
        # resets *now* when one happened since the last poll.
        since_advance = 0.0 if beat else since_advance + dt
        if abs(since_advance - ttl) > 1e-9:   # off the float boundary
            assert st_["expired"] == (since_advance > ttl), \
                (steps, since_advance, st_)


# ---------------------------------------------------------------------------
# Takeover exclusivity.
# ---------------------------------------------------------------------------

def test_takeover_exclusive_sequential(tmp_path):
    path = tmp_path / "hb.json"
    assert claim_takeover(path, 2) is True
    assert claim_takeover(path, 2) is False      # second claimant loses
    assert claim_takeover(path, 3) is True       # next term is fresh


def test_takeover_exclusive_racing_threads(tmp_path):
    path = tmp_path / "hb.json"
    wins = []
    barrier = threading.Barrier(8)

    def race():
        barrier.wait()
        wins.append(claim_takeover(path, 7))

    threads = [threading.Thread(target=race) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(wins) == 1, f"exactly one of 8 racers may win, got {wins}"


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=30, deadline=None)
@given(terms=st.lists(st.integers(1, 6), min_size=1, max_size=24))
def test_prop_one_winner_per_term(tmp_path_factory, terms):
    tmp_path = tmp_path_factory.mktemp("claims")
    path = tmp_path / "hb.json"
    winners = {}
    for i, term in enumerate(terms):
        if claim_takeover(path, term):
            assert term not in winners, "a term was claimed twice"
            winners[term] = i
    assert set(winners) == set(terms), "first claim per term must win"


# ---------------------------------------------------------------------------
# Torn writes carry no liveness evidence.
# ---------------------------------------------------------------------------

def _valid_lease_bytes(tmp_path) -> bytes:
    path = tmp_path / "hb.json"
    write_lease(path, LeaseRecord(worker="w", pid=1, term=1, seq=5,
                                  progress=3, ttl=2.0, mono=0.0, wall=0.0))
    return path.read_bytes()


def test_truncated_lease_is_torn_and_expired(tmp_path):
    raw = _valid_lease_bytes(tmp_path)
    path = tmp_path / "hb.json"
    for cut in (0, 1, len(raw) // 2, len(raw) - 2):
        path.write_bytes(raw[:cut])   # 0 = empty-but-existing file
        with pytest.raises(TornLease):
            read_lease(path)
        st_ = lease_status(path, now=0.0)
        assert st_["state"] == "torn" and st_["expired"]


def test_corrupted_lease_byte_is_torn_never_fresh(tmp_path):
    raw = _valid_lease_bytes(tmp_path)
    path = tmp_path / "hb.json"
    clock = _Clock()
    mon = LeaseMonitor(path, ttl=100.0, grace=100.0, expect_term=1,
                       now_fn=clock)
    flipped = bytearray(raw)
    flipped[3] ^= 0xFF                    # damage inside the payload
    path.write_bytes(bytes(flipped))
    st_ = mon.poll()
    assert st_["state"] == "torn" and st_["expired"]


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=80, deadline=None)
@given(data=st.data())
def test_prop_damaged_lease_never_classifies_fresh(tmp_path_factory, data):
    tmp_path = tmp_path_factory.mktemp("torn")
    raw = _valid_lease_bytes(tmp_path)
    path = tmp_path / "hb.json"
    mode = data.draw(st.sampled_from(["truncate", "flip"]))
    if mode == "truncate":
        # Up to len-2: dropping only the trailing newline leaves a
        # complete payload+digest, which is legitimately not torn.
        cut = data.draw(st.integers(0, len(raw) - 2))
        damaged = raw[:cut]
    else:
        pos = data.draw(st.integers(0, len(raw) - 1))
        bit = data.draw(st.integers(0, 7))
        b = bytearray(raw)
        b[pos] ^= 1 << bit
        damaged = bytes(b)
    if damaged == raw:                    # flip landed on trailing newline?
        return                            # (impossible for sha256 hex, but
                                          # keep the property total)
    path.write_bytes(damaged)
    st_ = lease_status(path, now=0.0)
    assert st_["state"] in ("torn", "expired"), st_
    assert st_["expired"], "damaged lease files must never look alive"


def test_writer_context_manager_beats_and_stops(tmp_path):
    path = tmp_path / "hb.json"
    with HeartbeatWriter(path, worker="w", term=1, ttl=0.2) as hb:
        first = read_lease(path)
        assert first is not None and first.seq >= 1
        hb.bump(4)
    rec = read_lease(path)
    assert rec.term == 1
    # Stopped: no renewal thread left running.
    assert hb._thread is None


# ---------------------------------------------------------------------------
# The lease file is the reference's, byte for byte.
# ---------------------------------------------------------------------------

def test_lease_interchange_with_reference(tmp_path):
    fields = dict(worker="w", pid=7, term=3, seq=11, progress=5, ttl=2.5,
                  mono=12.25, wall=1.5e9)
    write_lease(tmp_path / "port.json", LeaseRecord(**fields))
    jheartbeat.write_lease(tmp_path / "ref.json",
                           jheartbeat.LeaseRecord(**fields))
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "ref.json").read_bytes()
    assert jheartbeat.read_lease(tmp_path / "port.json").to_json() == fields
    assert read_lease(tmp_path / "ref.json").to_json() == fields
    # A live reference writer is followed by the port's monitor, and a
    # damaged port lease is torn for the reference's reader.
    mon = LeaseMonitor(tmp_path / "ref.json", ttl=1.0, grace=1.0,
                       expect_term=3)
    assert mon.poll()["state"] == "fresh"
    raw = bytearray((tmp_path / "port.json").read_bytes())
    raw[2] ^= 0x01
    (tmp_path / "port.json").write_bytes(bytes(raw))
    with pytest.raises(jheartbeat.TornLease):
        jheartbeat.read_lease(tmp_path / "port.json")
