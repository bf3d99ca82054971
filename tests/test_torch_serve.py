"""The port's serving layer against the JAX reference's, same workloads.

Both packages' ``synthetic_source`` serve the same NumPy chunks. Against
the reference engine: cold and warm refreshes (iterations within one,
lam within the stopping rule's ``tol * (1 + max lam)``), and the change
masks of ``synthetic_chunk_diff``/``content_chunk_diff`` exactly. Within
the port: a published generation is the host-fed solve's bits; lookups
equal ``decisions_chunk`` over the owning chunk bitwise (batched, single,
cache hit or fill, device-source or host-source); the LRU, the degraded
fallback with ``stale=True``, ``rebind``, threaded lookups; a refresh
killed in process, killed by SIGKILL in a fresh interpreter, or crashed
between the record and the pointer flip publishes the uninterrupted
record bitwise; ``prune``, ``discard_pending``, ``failed``; and the
``--smoke`` and ``--chaos`` CLIs.
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import chunked as tchunked  # noqa: E402
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core.faults import ChunkFetchError, FaultPolicy  # noqa: E402
from repro_torch.core.types import SolverConfig, SparseKP  # noqa: E402
from repro_torch.launch import refresh as trefresh  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DecisionService,
    RefreshEngine,
    WorkloadSpec,
    content_chunk_diff,
    synthetic_chunk_diff,
    synthetic_source,
)
from repro_torch.serve import engine as tengine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parent.parent
SPEC = WorkloadSpec(seed=3, n=4000, k=8, chunk=256, q=2, tightness=0.4)
CFG = SolverConfig(max_iters=60, checkpoint_every=4)
FIELDS = ["lam", "tau", "iters", "r", "primal", "dual", "fingerprint"]


def _engine(root, **kw):
    return RefreshEngine(root, kw.pop("spec", SPEC), cfg=kw.pop("cfg", CFG),
                         device="cpu", **kw)


def _assert_gen_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert (a.fin_hist is None) == (b.fin_hist is None)
    for x, y in zip(a.fin_hist or (), b.fin_hist or ()):
        np.testing.assert_array_equal(x, y)


def _materialise(gen):
    """Every row's decisions through ``decisions_chunk`` (the oracle)."""
    src = synthetic_source(gen.spec)
    c = -(-src.n // src.chunk)
    p = np.concatenate([src.fn(i)[0] for i in range(c)])[:src.n]
    b = np.concatenate([src.fn(i)[1] for i in range(c)])[:src.n]
    kp = SparseKP(torch.from_numpy(p), torch.from_numpy(b),
                  torch.from_numpy(src.budgets))
    asrc = tchunked.array_source(kp, src.chunk, device="cpu")
    rows = [tchunked.decisions_chunk(asrc, gen.lam, gen.spec.q, i,
                                     tau=gen.tau)[0][:src.n - i * src.chunk]
            for i in range(c)]
    return torch.cat(rows).numpy(), asrc


@pytest.fixture(scope="module")
def gens(tmp_path_factory):
    """Three published generations (budget scales 1.0, 0.9, 0.8) and each
    one's materialised decisions."""
    eng = _engine(tmp_path_factory.mktemp("gens"))
    out = [eng.refresh(budget_scale=s) for s in (1.0, 0.9, 0.8)]
    return {"eng": eng, "gen": out, "ref": [_materialise(g)[0] for g in out]}


class _Kill(Exception):
    """In-process stand-in for preemption, raised from the source fn."""


def _killing_factory(after):
    calls = {"n": 0}

    def make(spec):
        src = synthetic_source(spec)
        inner = src.fn

        def fn(i):
            calls["n"] += 1
            if calls["n"] > after:
                raise _Kill()
            return inner(i)

        return src._replace(fn=fn)

    return make, calls


# --------------------------------------------------------------------------
# Refresh against the reference engine.
# --------------------------------------------------------------------------

def test_cold_and_warm_refresh_match_reference(tmp_path):
    """Cold gen 0 and warm gen 1 (budgets x 0.9) of the port's engine and
    the reference's on the same chunks: iterations within one, lam within
    the stopping rule's tolerance, the same warm flags; warm beats a cold
    solve of the same workload."""
    jspec = jengine.WorkloadSpec(**SPEC.to_json())
    jeng = jengine.RefreshEngine(tmp_path / "ref", jspec,
                                 cfg=JCfg(reduce="bucketed", max_iters=60,
                                          checkpoint_every=4))
    eng = _engine(tmp_path / "port")
    for scale in (1.0, 0.9):
        want, got = jeng.refresh(budget_scale=scale), eng.refresh(budget_scale=scale)
        assert got.warm == want.warm and got.gen == want.gen
        assert abs(got.iters - int(want.iters)) <= 1
        tol = CFG.tol * (1.0 + float(np.max(want.lam)))
        np.testing.assert_allclose(got.lam, np.asarray(want.lam), rtol=0, atol=tol)
        # The rows repeat with a period of one Philox counter step across
        # chunks (K = 8: one row), so a lam inside the stopping tolerance
        # can flip every copy of a marginal row together: the primal is
        # held to the reference's own warm-against-cold bar.
        np.testing.assert_allclose(got.primal, np.asarray(want.primal), rtol=2e-2)
        assert got.spec.to_json() == want.spec.to_json()
    cold = _engine(tmp_path / "cold", spec=SPEC.replace(budget_scale=0.9)).refresh()
    assert not cold.warm and got.iters < cold.iters


def test_refresh_is_the_host_fed_solve(gens):
    """The engine adds durability, not arithmetic: a warm generation is
    bitwise ``solve_streaming_host`` from the parent's lam, and its
    fingerprint is ``source_fingerprint`` of that solve."""
    g0, g1 = gens["gen"][0], gens["gen"][1]
    src = synthetic_source(g1.spec)
    lam0 = torch.from_numpy(g0.lam)
    res = tpf.solve_streaming_host(src, CFG.replace(checkpoint_every=0), q=2,
                                   lam0=lam0, device="cpu")
    assert res.iters == g1.iters and g1.warm
    for f in ("lam", "tau", "r", "primal", "dual"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), getattr(g1, f))
    np.testing.assert_array_equal(
        g1.fingerprint, tpf.source_fingerprint(src, CFG, 2, g0.lam))


def test_chunk_diffs_match_reference(tmp_path):
    pairs = [(SPEC, SPEC.replace(budget_scale=0.8)),
             (SPEC, SPEC.replace(n=SPEC.n + 300)),
             (SPEC, SPEC.replace(seed=4)),
             (SPEC.replace(band=0.05), SPEC.replace(band=0.05, n=3000))]
    for old, new in pairs:
        want = jengine.synthetic_chunk_diff(jengine.WorkloadSpec(**old.to_json()),
                                            jengine.WorkloadSpec(**new.to_json()))
        got = synthetic_chunk_diff(old, new)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    diff = content_chunk_diff(synthetic_source)
    got = diff(SPEC, SPEC.replace(n=SPEC.n + 300))
    np.testing.assert_array_equal(got, synthetic_chunk_diff(SPEC, SPEC.replace(n=SPEC.n + 300)))
    assert diff(SPEC, SPEC.replace(chunk=128)) is None


def test_screened_delta_refresh_bitwise_unscreened(tmp_path):
    """Screened generations on the banded workload publish the unscreened
    records' bits; the child inherits the parent's certificates (fewer
    chunks streamed in its first epoch than there are chunks)."""
    spec = SPEC.replace(k=6, tightness=0.08, band=0.05, n=4096)
    cfg = SolverConfig(max_iters=30, bucket_half=12, checkpoint_every=0)
    plain = _engine(tmp_path / "plain", spec=spec, cfg=cfg)
    scr = _engine(tmp_path / "scr", spec=spec, cfg=cfg.replace(screening=True))
    for scale in (1.0, 0.95):
        a, b = plain.refresh(budget_scale=scale), scr.refresh(budget_scale=scale)
        for f in ("lam", "tau", "iters", "r", "primal", "dual"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), err_msg=f)
    rec = ckpt.restore_auto(Path(b.path) / "record", 0)
    assert "screen_active" in rec and int(np.asarray(rec["screen_streamed"])[0]) < 16


# --------------------------------------------------------------------------
# Preemption: in process, crash before the flip, and one real SIGKILL.
# --------------------------------------------------------------------------

def test_kill_in_process_and_crash_before_flip(tmp_path, gens):
    """A refresh killed mid-solve leaves gen 0 live and a pending gen 1 (a
    different intent is refused); re-driven it publishes the
    uninterrupted record. A crash between the record and the pointer flip
    is recovered without re-solving."""
    root = tmp_path / "killed"
    eng = _engine(root)
    eng.refresh()
    make, _ = _killing_factory(40)
    with pytest.raises(_Kill):
        _engine(root, make_source=make).refresh(budget_scale=0.9)
    assert eng.live().gen == 0 and eng._pending() is not None
    with pytest.raises(ValueError, match="pending"):
        eng.refresh(budget_scale=1.1)
    _assert_gen_equal(eng.refresh(budget_scale=0.9), gens["gen"][1])

    real = ckpt.write_json
    state = {"fail": True}

    def failing(d, name, payload):
        if name == "LIVE.json" and state["fail"]:
            state["fail"] = False
            raise OSError("simulated crash before pointer flip")
        return real(d, name, payload)

    tengine.ckpt.write_json = failing
    try:
        with pytest.raises(OSError, match="pointer flip"):
            eng.refresh(budget_scale=0.8)
    finally:
        tengine.ckpt.write_json = real
    assert eng.live().gen == 1
    make, calls = _killing_factory(10 ** 9)
    rec = _engine(root, make_source=make).recover()
    assert rec.gen == 2 and calls["n"] == 0 and eng.live().gen == 2
    _assert_gen_equal(rec, gens["gen"][2])
    assert eng.recover() is None


_SIGKILL_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, sys.argv[1])
    from repro_torch.core.types import SolverConfig
    from repro_torch.serve import RefreshEngine, WorkloadSpec, synthetic_source

    root, kill_after = sys.argv[2], int(sys.argv[3])
    spec = WorkloadSpec(seed=3, n=4000, k=8, chunk=256, q=2, tightness=0.4)
    cfg = SolverConfig(max_iters=60, checkpoint_every=4)
    calls = {"n": 0}

    def make(s):
        src = synthetic_source(s)
        inner = src.fn

        def fn(i):
            calls["n"] += 1
            if calls["n"] > kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
            return inner(i)

        return src._replace(fn=fn)

    RefreshEngine(root, spec, make_source=make, cfg=cfg, device="cpu",
                  slots=2).refresh(budget_scale=0.9)
""")


def test_sigkill_refresh_recover_publishes_bitwise(tmp_path):
    """A 2-slot warm refresh SIGKILLed in a fresh interpreter mid-solve:
    gen 0 stays live, gen 1 pends with resume states, and ``recover()``
    here publishes bitwise the uninterrupted record."""
    ref = _engine(tmp_path / "ref", slots=2)
    ref.refresh()
    want = ref.refresh(budget_scale=0.9)
    root = tmp_path / "killed"
    _engine(root, slots=2).refresh()
    out = subprocess.run([sys.executable, "-c", _SIGKILL_SCRIPT, str(ROOT / "src"),
                          str(root), "120"], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == -signal.SIGKILL, (out.returncode, out.stderr[-2000:])
    eng = _engine(root, slots=2)
    assert eng.live().gen == 0
    assert ckpt.latest_step(root / "gen_000001" / "ckpt") is not None
    _assert_gen_equal(eng.recover(), want)
    assert eng.live().gen == 1


def test_prune_discard_and_failed(tmp_path):
    """``prune`` keeps the newest generations and never the live or the
    pending one; a refresh whose fetches exhaust their retries stamps
    FAILED.json and leaves the pointer; ``discard_pending`` drops it."""
    root = tmp_path / "root"
    eng = _engine(root, cfg=CFG.replace(checkpoint_every=0))
    for s in (1.0, 0.95, 0.9):
        eng.refresh(budget_scale=s)
    assert eng.prune(keep=1) == [0, 1] and eng.generation_ids() == [2]

    def broken(spec):
        src = synthetic_source(spec)

        def fn(i):
            raise IOError("source gone")

        return src._replace(fn=fn)

    bad = _engine(root, make_source=broken,
                  cfg=CFG.replace(checkpoint_every=0, fetch_retries=1,
                                  fetch_backoff=1e-5, fetch_backoff_cap=1e-5))
    with pytest.raises(ChunkFetchError):
        bad.refresh(budget_scale=0.8)
    assert eng.live().gen == 2 and eng.failed()["gen"] == 3
    assert eng.prune(keep=1) == [] and eng.generation_ids() == [2, 3]
    assert eng.discard_pending() == 3 and eng.failed() is None
    assert eng.generation_ids() == [2] and eng.discard_pending() is None
    with pytest.raises(ValueError, match="keep"):
        _engine(root, keep=0)
    with pytest.raises(TypeError, match="Mesh"):
        RefreshEngine(root, SPEC, device="cpu", mesh=object())


# --------------------------------------------------------------------------
# DecisionService.
# --------------------------------------------------------------------------

def test_lookups_equal_decisions_chunk(gens):
    """Batched and single lookups, fills and hits, host and device
    sources: every row equals ``decisions_chunk`` over the owning chunk,
    ragged tail included; the LRU evicts and counts exactly."""
    gen, full = gens["gen"][1], gens["ref"][1]
    assert full.any()
    svc = gens["eng"].decision_service(gen, cache_chunks=4)
    users = np.random.default_rng(0).integers(0, SPEC.n, 600)
    users[:3] = [0, SPEC.n - 1, 15 * SPEC.chunk]
    np.testing.assert_array_equal(svc.decide_batch(users), full[users])
    singles = np.stack([svc.decide(int(u)) for u in users[:100]])
    np.testing.assert_array_equal(singles, full[users[:100]])
    st = svc.stats
    assert st["queries"] == 700 and st["hits"] + st["fills"] == 700
    assert st["fills"] >= 16 and st["evictions"] == st["fills"] - 4
    _, asrc = _materialise(gen)
    dev_svc = DecisionService(asrc, gen, cache_chunks=2, device="cpu")
    np.testing.assert_array_equal(dev_svc.decide_batch(users[:200]), full[users[:200]])
    with pytest.raises(IndexError, match="outside"):
        svc.decide(SPEC.n)
    with pytest.raises(ValueError, match="cache_chunks"):
        gens["eng"].decision_service(cache_chunks=0)
    with pytest.raises(ValueError, match="does not match"):
        DecisionService(synthetic_source(SPEC.replace(n=SPEC.n * 2)), gen,
                        device="cpu")


def _poison(source, chunk=2):
    inner = source.fn

    def fn(i):
        if int(i) == chunk:
            raise IOError("injected permanent fault")
        return inner(i)

    return source._replace(fn=fn)


def test_fallback_stale_rebind_and_health(gens):
    """A chunk that cannot be regenerated is answered from the fallback
    generation with ``stale=True`` (health degraded); without a fallback
    the fetch error propagates; ``rebind`` demotes the current binding to
    fallback, never hits the other generation's cache entries, and clears
    ``degraded``."""
    g0, g1, g2 = gens["gen"]
    policy = FaultPolicy(max_retries=1, backoff_base=1e-6, backoff_cap=1e-5)
    svc = DecisionService(_poison(synthetic_source(g1.spec)), g1, cache_chunks=16,
                          fault_policy=policy, fallback=(synthetic_source(g0.spec), g0),
                          device="cpu")
    user = 2 * SPEC.chunk + 5
    res = svc.lookup(user)
    assert res.stale and res.gen == 0
    np.testing.assert_array_equal(res.x, gens["ref"][0][user])
    ok = svc.lookup(7)
    assert not ok.stale and ok.gen == 1
    np.testing.assert_array_equal(ok.x, gens["ref"][1][7])
    h = svc.health()
    assert h["degraded"] and h["stale_serves"] == 1 and h["fetch_failures"] == 1
    assert h["retries"] == 1 and h["fallback_generation"] == 0
    x, stale, served = svc.lookup_batch([7, user])
    assert stale.tolist() == [False, True] and served.tolist() == [1, 0]
    fills = svc.stats["fills"]
    svc.rebind(synthetic_source(g2.spec), g2)
    np.testing.assert_array_equal(svc.decide(7), gens["ref"][2][7])
    assert svc.stats["fills"] == fills + 1
    assert not svc.health()["degraded"] and svc.health()["generation"] == 2
    bare = DecisionService(_poison(synthetic_source(g1.spec)), g1, fault_policy=policy,
                           device="cpu")
    with pytest.raises(ChunkFetchError):
        bare.lookup(user)


def test_threaded_lookups_under_rebind(gens):
    """Four threads hammer lookups while the main thread flips between two
    generations: every answer is bitwise the decision of the generation
    that answered, and the counters stay exact."""
    g0, g1 = gens["gen"][0], gens["gen"][1]
    refs = {0: gens["ref"][0], 1: gens["ref"][1]}
    svc = DecisionService(synthetic_source(g0.spec), g0, cache_chunks=3,
                          device="cpu")
    results, errors = [[] for _ in range(4)], []
    stop = threading.Event()

    def worker(t):
        rng = np.random.default_rng(t)
        try:
            for u in rng.integers(0, SPEC.n, 150):
                results[t].append((int(u), svc.lookup(int(u))))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    flip = 0
    while any(th.is_alive() for th in threads) and not stop.is_set():
        flip ^= 1
        svc.rebind(synthetic_source([g0, g1][flip].spec), [g0, g1][flip])
    for th in threads:
        th.join()
    assert not errors
    for rows in results:
        for u, res in rows:
            assert not res.stale
            np.testing.assert_array_equal(res.x, refs[res.gen][u])
    st = svc.stats
    assert st["queries"] == 600 and st["hits"] + st["fills"] == 600


# --------------------------------------------------------------------------
# The launcher.
# --------------------------------------------------------------------------

def test_refresh_smoke_cli(tmp_path, capsys):
    """``--smoke --device cpu`` runs 3 generations, warm beats cold and the
    lookups round-trip bitwise (exit 0); a relaunch with ``--resume``
    finds everything published."""
    trefresh.main(["--smoke", "--device", "cpu", "--root", str(tmp_path / "s")])
    out = capsys.readouterr().out
    assert "bitwise OK" in out and "warm" in out
    trefresh.main(["--smoke", "--device", "cpu", "--root", str(tmp_path / "s"),
                   "--resume"])
    assert "no warm refreshes ran" in capsys.readouterr().out


def test_chaos_equals_clean(tmp_path):
    """``run_chaos``: two generations under injected drops, slow reads,
    corruption and a repeat offender publish bitwise the clean records,
    and no lookup is served stale."""
    ok, out = trefresh.run_chaos(SPEC.replace(n=2048), 2, tmp_path,
                                 CFG.replace(checkpoint_every=0), device="cpu",
                                 lookups=64)
    assert ok and out["chaos"]["lookup"]["cache"]["stale_serves"] == 0
    assert out["chaos"]["lookups_bitwise"] and out["clean"]["lookups_bitwise"]
    assert os.path.isdir(tmp_path / "chaos" / "gen_000001")
