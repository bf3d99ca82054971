"""The port's serving front (repro_torch/serve/front.py and
launch/front.py), case for case the reference's ``tests/test_front.py``,
with every service, engine and replica process on the CPU
(``device="cpu"``), plus the wire frames held byte for byte against the
reference's and the launcher's refusal to run without a card.

The contract under test (DESIGN.md §13): a front answer IS a
DecisionService answer. Single lookups, batches, degraded-``stale``
rows and the cross-generation ``/diff`` must all be **bitwise-equal**
to direct in-process lookups against the same generations — the wire
(base64 of the exact row bytes), the round-robin, the replica RPC and
the pointer watcher may add latency but never change a bit.

The diff endpoint's cost model is pinned by counting fetches at the
source: "which of these users changed since generation g?" is one
grouped chunk pass per generation (lookup_batch's chunk grouping), and
a repeat against cached generations is zero passes.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.serve import front as jfront  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.launch.front import (  # noqa: E402
    _HTTPClient,
    _materialise,
    spawn_replicas,
    stop_replicas,
)
from repro_torch.serve import (  # noqa: E402
    DecisionService,
    Front,
    FrontRPCError,
    RefreshEngine,
    ReplicaClient,
    ReplicaServer,
    WorkloadSpec,
    synthetic_source,
)
from repro_torch.serve.front import (  # noqa: E402
    decision_diff,
    pack_array,
    poisoned_factory,
    recv_msg,
    send_msg,
    unpack_array,
)

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parent.parent

SPEC = WorkloadSpec(seed=5, n=1024, k=4, chunk=128, q=1, tightness=0.4)
CFG = SolverConfig(reduce="bucketed", max_iters=25, checkpoint_every=0)
SCALES = [1.0, 0.9]
CHUNKS = SPEC.n // SPEC.chunk


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A generation root with two published generations + references."""
    path = tmp_path_factory.mktemp("front_root")
    eng = RefreshEngine(path, SPEC, cfg=CFG, device="cpu")
    gens, refs = [], []
    for s in SCALES:
        g = eng.refresh(budget_scale=s)
        svc = eng.decision_service(generation=g, fallback=False)
        gens.append(g)
        refs.append(svc.decide_batch(np.arange(SPEC.n)))
        # The scenario's reference (every chunk through decisions_rows)
        # is the service's materialisation.
        assert _materialise(eng, g).tobytes() == refs[-1].tobytes()
    return SimpleNamespace(path=path, engine=eng, gens=gens, refs=refs)


def _counting_source(spec):
    """A synthetic source whose per-chunk fetches are counted."""
    src = synthetic_source(spec)
    calls = []
    inner = src.fn

    def fn(i):
        calls.append(int(i))
        return inner(i)

    return src._replace(fn=fn), calls


# ---------------------------------------------------------------------------
# Wire format: exact bytes across the encoding and the framing.
# ---------------------------------------------------------------------------

def test_pack_array_roundtrip_is_bitwise():
    rng = np.random.default_rng(0)
    arrays = [rng.random(17).astype(np.float32),
              rng.integers(0, 2, (5, 3)).astype(bool),
              np.arange(12, dtype=np.int64)[::2],      # non-contiguous
              np.zeros((0, 4), bool)]                  # empty
    for a in arrays:
        b = unpack_array(json.loads(json.dumps(pack_array(a))))
        assert b.dtype == a.dtype and b.shape == a.shape
        assert b.tobytes() == np.ascontiguousarray(a).tobytes()


def test_framing_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    with a, b:
        msgs = [{"op": "ping"}, {"x": pack_array(np.arange(9) % 2 == 0)}]
        for m in msgs:
            send_msg(a, m)
        assert [recv_msg(b) for _ in msgs] == msgs
        a.close()
        assert recv_msg(b) is None           # clean close between messages


def test_wire_frames_are_the_reference_s_byte_for_byte():
    """pack_array and send_msg frames equal the reference's for the same
    arrays, and each package unpacks the other's."""
    rng = np.random.default_rng(1)
    arrays = [rng.random(7).astype(np.float32),
              rng.integers(0, 2, (4, 3)).astype(bool),
              np.arange(10, dtype=np.int64)[::3], np.zeros((0, 2), bool)]
    for a in arrays:
        assert pack_array(a) == jfront.pack_array(a)
        assert unpack_array(jfront.pack_array(a)).tobytes() \
            == jfront.unpack_array(pack_array(a)).tobytes()
    msg = {"op": "decide_batch", "x": pack_array(arrays[1]), "users": [3, 1]}
    frames = []
    for send in (send_msg, jfront.send_msg):
        a, b = socket.socketpair()
        with a, b:
            send(a, msg)
            a.close()
            frames.append(b.recv(1 << 16))
    assert frames[0] == frames[1]


# ---------------------------------------------------------------------------
# decision_diff: brute-force parity, fetch-counted grouped passes.
# ---------------------------------------------------------------------------

def test_decision_diff_matches_brute_force_in_one_pass_per_gen(root):
    g0, g1 = root.gens
    src_new, calls_new = _counting_source(g1.spec)
    src_old, calls_old = _counting_source(g0.spec)
    new_svc = DecisionService(src_new, g1, cache_chunks=CHUNKS, device="cpu")
    old_svc = DecisionService(src_old, g0, cache_chunks=CHUNKS, device="cpu")

    users = np.concatenate([np.arange(0, SPEC.n, 13), [0, 0, 511]])
    spanned = len(np.unique(users // SPEC.chunk))
    d = decision_diff(new_svc, old_svc, users)

    brute = (root.refs[1][users] != root.refs[0][users]).any(axis=1)
    assert d["changed"].tobytes() == brute.tobytes()
    assert d["from_gen"] == g0.gen and d["to_gen"] == g1.gen
    assert d["compared"] == users.size and d["new_users"] == 0
    assert not d["stale"] and not d["k_changed"]
    # The cost claim, counted at the source: each generation regenerated
    # every spanned chunk exactly once — ONE grouped pass, not one fetch
    # per user (users.size >> spanned here).
    assert sorted(calls_new) == sorted(set(calls_new))
    assert len(calls_new) == spanned == len(calls_old)
    # Repeat against the (now cached) generations: zero further fetches.
    d2 = decision_diff(new_svc, old_svc, users)
    assert d2["changed"].tobytes() == brute.tobytes()
    assert len(calls_new) == spanned == len(calls_old)


def test_decision_diff_full_range_costs_exactly_all_chunks(root):
    g0, g1 = root.gens
    src_new, calls_new = _counting_source(g1.spec)
    src_old, calls_old = _counting_source(g0.spec)
    new_svc = DecisionService(src_new, g1, cache_chunks=CHUNKS, device="cpu")
    old_svc = DecisionService(src_old, g0, cache_chunks=CHUNKS, device="cpu")
    d = decision_diff(new_svc, old_svc, range(SPEC.n))
    brute = (root.refs[1] != root.refs[0]).any(axis=1)
    assert d["changed"].tobytes() == brute.tobytes()
    assert len(calls_new) == CHUNKS == len(calls_old)


def test_decision_diff_users_past_old_generation_are_changed(root, tmp_path):
    """Traffic growth: users the old generation never covered diff as
    changed (there is nothing to compare them against)."""
    eng = RefreshEngine(tmp_path / "grow", SPEC.replace(n=SPEC.n // 2),
                        cfg=CFG, device="cpu")
    small = eng.refresh(budget_scale=1.0)            # n = 512
    big = eng.refresh(budget_scale=1.0, n=SPEC.n)    # n = 1024
    new_svc = eng.decision_service(generation=big, fallback=False)
    old_svc = eng.decision_service(generation=small, fallback=False)
    users = np.array([0, 300, 511, 512, 1023])       # last two are new
    d = decision_diff(new_svc, old_svc, users)
    assert d["compared"] == 3 and d["new_users"] == 2
    assert d["changed"][3:].all()
    ref_new = new_svc.decide_batch(users[:3])
    ref_old = old_svc.decide_batch(users[:3])
    assert (d["changed"][:3] == (ref_new != ref_old).any(axis=1)).all()


def test_decision_diff_k_change_marks_everything_changed():
    """No row is comparable across a knapsack-count change — the diff
    short-circuits before any lookup."""
    mk = lambda k, gen: SimpleNamespace(  # noqa: E731
        generation=SimpleNamespace(spec=SimpleNamespace(k=k), gen=gen),
        source=SimpleNamespace(n=100))
    d = decision_diff(mk(8, 1), mk(4, 0), [1, 2, 3])
    assert d["k_changed"] and d["changed"].all()
    assert d["compared"] == 0 and d["new_users"] == 0


# ---------------------------------------------------------------------------
# Replica RPC + degraded-stale provenance over the wire.
# ---------------------------------------------------------------------------

def _start_replica(root_path, make_source=None, retries=0, index=0):
    cfg = SolverConfig(reduce="bucketed", fetch_retries=retries,
                       fetch_backoff=1e-5, fetch_backoff_cap=1e-4)
    kw = {} if make_source is None else {"make_source": make_source}
    eng = RefreshEngine.attach(root_path, cfg=cfg, device="cpu", **kw)
    rep = ReplicaServer(eng, index=index, cache_chunks=CHUNKS,
                        poll_s=0.02)
    port = rep.start()
    return rep, ReplicaClient("127.0.0.1", port)


def test_replica_rpc_lookup_and_batch_are_bitwise(root):
    rep, rc = _start_replica(root.path)
    try:
        live = root.gens[-1]
        r = rc.call({"op": "lookup", "user": 700})
        assert unpack_array(r["x"]).tobytes() == root.refs[-1][700].tobytes()
        assert not r["stale"] and r["gen"] == live.gen
        users = [5, 900, 5, 130, 1023]
        b = rc.call({"op": "decide_batch", "users": users})
        assert unpack_array(b["x"]).tobytes() == \
            root.refs[-1][np.asarray(users)].tobytes()
        assert not unpack_array(b["stale"]).any()
        assert (unpack_array(b["gens"]) == live.gen).all()
        # Out-of-range surfaces as a typed error payload, not a hangup.
        with pytest.raises(FrontRPCError) as ei:
            rc.call({"op": "lookup", "user": SPEC.n})
        assert ei.value.kind == "IndexError"
    finally:
        rc.close()
        rep.stop()


def test_replica_degraded_stale_answers_match_in_process(root):
    """The degraded path over the wire: the live generation's poisoned
    chunk exhausts its retries and the replica answers those users from
    the fallback generation, stale-flagged — bitwise what a direct
    in-process DecisionService with the same poisoned source serves."""
    poison_chunk = 3
    live_scale = SCALES[-1]
    make_source = poisoned_factory(synthetic_source, live_scale,
                                   poison_chunk)
    rep, rc = _start_replica(root.path, make_source=make_source, retries=1)
    try:
        # The in-process reference: same poisoned factory, same policy.
        ref_svc = rep.engine.decision_service(cache_chunks=CHUNKS)
        poisoned = poison_chunk * SPEC.chunk + 7
        healthy = 10
        ref_p, ref_h = ref_svc.lookup(poisoned), ref_svc.lookup(healthy)
        assert ref_p.stale and ref_p.gen == root.gens[0].gen   # sanity
        for user, ref in ((poisoned, ref_p), (healthy, ref_h)):
            r = rc.call({"op": "lookup", "user": user})
            assert unpack_array(r["x"]).tobytes() == ref.x.tobytes()
            assert r["stale"] == ref.stale and r["gen"] == ref.gen
        # Batched: per-row provenance flags exactly the poisoned chunk.
        users = np.array([healthy, poisoned, poisoned + 1, 999])
        b = rc.call({"op": "decide_batch", "users": users.tolist()})
        stale = unpack_array(b["stale"])
        gens = unpack_array(b["gens"])
        assert stale.tolist() == [False, True, True, False]
        assert gens.tolist() == [root.gens[1].gen, root.gens[0].gen,
                                 root.gens[0].gen, root.gens[1].gen]
        x = unpack_array(b["x"])
        expect = np.where(stale[:, None], root.refs[0][users],
                          root.refs[1][users])
        assert x.tobytes() == expect.tobytes()
        h = rc.call({"op": "health"})
        assert h["degraded"] and h["stale_serves"] >= 3
    finally:
        rc.close()
        rep.stop()


# ---------------------------------------------------------------------------
# Front: routing, aggregated health, failover.
# ---------------------------------------------------------------------------

def test_front_aggregated_health_and_failover(root):
    rep0, rc0 = _start_replica(root.path, index=0)
    rep1, rc1 = _start_replica(root.path, index=1)
    front = Front([rc0, rc1])
    host, port = front.start()
    cli = _HTTPClient(host, port)
    try:
        h = cli.get("/health")
        assert h["ok"] and h["agreement"]
        assert h["generations"] == [root.gens[-1].gen]
        assert [d["replica"]["index"] for d in h["replicas"]] == [0, 1]
        assert all(d["supervisor"] == {"status": "absent"}
                   for d in h["replicas"])
        # Kill replica 0; the round-robin must fail over, health must
        # report the dead replica without taking the endpoint down.
        rep0.stop()
        rc0.close()                     # drop pooled conns to the corpse
        time.sleep(0.05)
        for u in (1, 2, 3, 4):
            r = cli.get(f"/decide?user={u}")
            assert r["x"] == [int(v) for v in root.refs[-1][u]]
        h = cli.get("/health")
        assert not h["ok"]
        assert "error" in h["replicas"][0] and "error" not in h["replicas"][1]
        assert h["front"]["failovers"] >= 1
    finally:
        cli.close()
        front.shutdown()
        rep1.stop()
        rep0.stop()


# ---------------------------------------------------------------------------
# End to end: replica processes, HTTP front, live refresh, diff.
# ---------------------------------------------------------------------------

def test_front_over_replica_processes_tracks_refresh(root, tmp_path):
    """The full request path: spawned replica *processes* attach to a
    copied root, the front serves bitwise answers, a refresh published
    underneath flips every watcher, and /diff answers the
    cross-generation question against brute force."""
    import shutil

    work = tmp_path / "serve_root"
    shutil.copytree(root.path, work)
    eng = RefreshEngine(work, SPEC, cfg=CFG, device="cpu")
    procs, clients = spawn_replicas(work, 2, cache_chunks=CHUNKS, device="cpu")
    front = Front(clients)
    host, port = front.start()
    cli = _HTTPClient(host, port)
    try:
        live = root.gens[-1]
        users = list(range(0, SPEC.n, 7))
        b = cli.post("/decide_batch", {"users": users})
        assert unpack_array(b["x"]).tobytes() == \
            root.refs[-1][np.asarray(users)].tobytes()
        assert not unpack_array(b["stale"]).any()
        assert (unpack_array(b["gens"]) == live.gen).all()
        r = cli.get("/decide?user=321")
        assert r["x"] == [int(v) for v in root.refs[-1][321]]
        assert r["gen"] == live.gen and not r["stale"]

        # Publish a new generation; every replica's watcher must rebind.
        g2 = eng.refresh(budget_scale=0.8)
        ref2 = eng.decision_service(
            generation=g2, fallback=False).decide_batch(np.arange(SPEC.n))
        deadline = time.monotonic() + 30
        while True:
            h = cli.get("/health")
            if h["ok"] and h["generations"] == [g2.gen]:
                break
            assert time.monotonic() < deadline, f"never converged: {h}"
            time.sleep(0.05)
        assert all(d["replica"]["rebinds"] >= 1 for d in h["replicas"])
        b = cli.post("/decide_batch", {"users": users})
        assert unpack_array(b["x"]).tobytes() == \
            ref2[np.asarray(users)].tobytes()
        assert (unpack_array(b["gens"]) == g2.gen).all()

        # /diff against the previous generation, brute-force-checked,
        # on BOTH replicas (round-robin covers each).
        brute = (ref2 != root.refs[-1]).any(axis=1)
        for _ in range(2):
            d = cli.post("/diff", {"gen": live.gen,
                                   "users": list(range(SPEC.n))})
            assert unpack_array(d["changed"]).tobytes() == brute.tobytes()
            assert d["from_gen"] == live.gen and d["to_gen"] == g2.gen
            assert not d["stale"]
            assert d["fills"]["old"] == CHUNKS     # one grouped pass
        errs = cli.post("/diff", {"gen": live.gen,
                                  "users": list(range(SPEC.n))})
        assert errs["fills"] == {"new": 0, "old": 0}   # both cached now
    finally:
        cli.close()
        front.shutdown()
        stop_replicas(procs, clients)


def test_attach_requires_a_published_generation(tmp_path):
    with pytest.raises(ValueError, match="no live generation"):
        RefreshEngine.attach(tmp_path / "empty", device="cpu")


def test_cli_without_a_card_raises_resolve_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda scenario would run")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra in ([], ["--replica", "--index", "0"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.front", "--smoke",
             "--device", "cuda", "--root", str(tmp_path), *extra],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
    assert not any(tmp_path.iterdir())
