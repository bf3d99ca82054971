"""Checkpoint and resume of the port's host-fed driver, and its virtual
slots, on the CPU (the port's mirror of ``tests/test_stream_resume.py``).

Within the port, bitwise in lam, iters, r, primal, dual, tau and
``fin_hist``, at a fixed slot count: a checkpointed solve equals the
uninterrupted one; a solve killed mid-iterate or between finalize columns
(in process, and once by SIGKILL in a subprocess), or after a torn save,
then resumed, equals it too, and the resume after a kill between finalize
columns fetches only the fingerprint probe and the remaining columns.
Against the reference, on the same NumPy bytes: ``sharded_source``,
``chunk_hashes`` and ``memmap_source`` exactly; ``ordered_fold`` exactly;
the checkpoint layout read across packages; the host-fed solve at slots 2
and 4 to lam rtol 1e-5 / atol 1e-6, iterations within one, primal and
dual 1e-5 relative. The reference's 8-device mesh cases have no port
counterpart (one GPU; several are ROADMAP A8).
"""
import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import prefetch as jpf  # noqa: E402
from repro.core.chunked import ordered_fold as j_ordered_fold  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core.chunked import ordered_fold  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.data.synth import banded_host_chunk_source, sparse_host_chunk_source  # noqa: E402
from repro_torch.launch import solve as tlaunch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parent.parent
RESULT_FIELDS = ["lam", "iters", "r", "primal", "dual", "tau"]
Q = 2


def _rows(n=2048, k=8, chunk=128, seed=4):
    src = sparse_host_chunk_source(seed, n, k, chunk, q=Q, tightness=0.4)
    ps, bs = zip(*(src.fn(i) for i in range(-(-n // chunk))))
    return np.concatenate(ps)[:n], np.concatenate(bs)[:n], src.budgets


def _instance(n=2048, k=8, chunk=128, seed=4):
    return lambda: sparse_host_chunk_source(seed, n, k, chunk, q=Q, tightness=0.4)


def _solve(src, cfg, **kw):
    return tpf.solve_streaming_host(src, cfg, q=Q, device="cpu", **kw)


class _Kill(Exception):
    """In-process stand-in for preemption: raised from the source fn."""


def _killing(make_source, after):
    """Source whose fn raises _Kill after ``after`` chunk productions."""
    src = make_source()
    calls = {"n": 0}
    inner = src.fn

    def fn(i):
        calls["n"] += 1
        if calls["n"] > after:
            raise _Kill()
        return inner(i)

    return src._replace(fn=fn), calls


def _counting(make_source):
    src = make_source()
    calls = {"n": 0}
    inner = src.fn

    def fn(i):
        calls["n"] += 1
        return inner(i)

    return src._replace(fn=fn), calls


def _assert_bitwise(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert (a.fin_hist is None) == (b.fin_hist is None)
    if a.fin_hist is not None:
        for x, y in zip(a.fin_hist, b.fin_hist):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def _steps(d):
    return sorted(p.name for p in pathlib.Path(d).iterdir()
                  if p.name.startswith("step_") and not p.name.endswith(".tmp"))


CFG = SolverConfig(max_iters=20, checkpoint_every=2)


@pytest.fixture(scope="module")
def base4():
    """The uninterrupted slots=4 solve of ``_instance()``."""
    return _solve(_instance()(), CFG.replace(checkpoint_every=0), slots=4)


# ---------------------------------------------------------------------------
# Sources: the slot splitter, chunk digests and memory maps.
# ---------------------------------------------------------------------------

def test_sharded_source_splits_chunk_ranges():
    p, b, budgets = _rows(n=1000)
    src = tpf.host_array_source(p, b, budgets, 128)        # c = 8 ragged chunks
    ref = jpf.host_array_source(p, b, budgets, 128)
    for slots in (4, 3, 8):
        subs, jsubs = tpf.sharded_source(src, slots), jpf.sharded_source(ref, slots)
        assert len(subs) == slots
        assert [s.n for s in subs] == [s.n for s in jsubs]
        assert sum(sub.n for sub in subs) == 1000
        cps = -(-8 // slots)
        for s, (sub, jsub) in enumerate(zip(subs, jsubs)):
            assert sub.chunk == 128 and sub.k == src.k
            np.testing.assert_array_equal(sub.budgets, src.budgets)
            for j in range(cps):
                got, want = sub.fn(j), jsub.fn(j)
                for x, y in zip(got, want):
                    np.testing.assert_array_equal(x, y)
                if s * cps + j < 8:
                    np.testing.assert_array_equal(got[0], src.fn(s * cps + j)[0])
    p9, b9 = tpf.sharded_source(src, 9)[8].fn(0)           # past the last chunk
    assert not p9.any() and not b9.any() and p9.shape == (128, src.k)
    with pytest.raises(ValueError, match="slots"):
        tpf.sharded_source(src, 0)


def test_chunk_hashes_and_memmap_match_reference(tmp_path):
    p, b, budgets = _rows(n=1000)
    p.tofile(tmp_path / "p.f32")
    b.tofile(tmp_path / "b.f32")
    mm = tpf.memmap_source(tmp_path / "p.f32", tmp_path / "b.f32", 1000, 8,
                           budgets, 128)
    jmm = jpf.memmap_source(tmp_path / "p.f32", tmp_path / "b.f32", 1000, 8,
                            budgets, 128)
    for i in range(8):
        for x, y, z in zip(mm.fn(i), jmm.fn(i), tpf.host_array_source(
                p, b, budgets, 128).fn(i)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    got = tpf.chunk_hashes(mm)
    assert got.shape == (8, 32) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jpf.chunk_hashes(jmm))
    np.testing.assert_array_equal(tpf.chunk_hashes(mm, [5, 2]), got[[5, 2]])


# ---------------------------------------------------------------------------
# Validation and the resume fingerprint.
# ---------------------------------------------------------------------------

def test_checkpoint_and_slot_validation(tmp_path):
    make = _instance()
    with pytest.raises(ValueError, match="record_history"):
        _solve(make(), SolverConfig(checkpoint_every=2, record_history=True),
               checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="slots"):
        _solve(make(), SolverConfig(), slots=0)
    with pytest.raises(ValueError, match="checkpoint_keep"):
        _solve(make(), SolverConfig(checkpoint_every=1, checkpoint_keep=0),
               checkpoint_dir=str(tmp_path / "zero"))


def test_every_field_fingerprinted_or_exempt():
    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    hashed = set(tpf._FINGERPRINT_CFG_FIELDS) | {"dtype"}
    exempt = set(tpf.FINGERPRINT_EXEMPT_FIELDS)
    assert isinstance(tpf._FINGERPRINT_CFG_FIELDS, tuple)
    assert len(set(tpf._FINGERPRINT_CFG_FIELDS)) == len(tpf._FINGERPRINT_CFG_FIELDS)
    assert not hashed & exempt
    assert fields == hashed | exempt, sorted(fields ^ (hashed | exempt))
    src = sparse_host_chunk_source(0, 1000, 4, 256)
    base = tpf.source_fingerprint(src, SolverConfig(), 1)
    changed = SolverConfig(
        max_iters=7, checkpoint_every=5, checkpoint_keep=9, fetch_retries=2,
        fetch_backoff=0.1, fetch_backoff_growth=3.0, fetch_backoff_cap=9.0,
        fetch_jitter=0.5, fetch_timeout=1.0, verify_refetch=True,
        chunk_size=128, screening=True, screening_floor=0.25)
    np.testing.assert_array_equal(base, tpf.source_fingerprint(src, changed, 1))
    for field, value in [("bucket_half", 12), ("cd_damping", 0.25),
                         ("tol", 1e-5), ("postprocess", False),
                         ("kernel_tile", 64)]:
        assert not np.array_equal(base, tpf.source_fingerprint(
            src, SolverConfig(**{field: value}), 1)), field


def test_resume_empty_dir_is_fresh_start(tmp_path, base4):
    res = _solve(_instance()(), CFG, slots=4, resume_from=str(tmp_path))
    _assert_bitwise(res, base4)
    assert ckpt.latest_step(tmp_path) is not None   # and it checkpoints there


def test_resume_fingerprint_mismatch_refused(tmp_path):
    cfg = SolverConfig(max_iters=3, checkpoint_every=2)
    _solve(_instance(seed=4)(), cfg, slots=4, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="fingerprint"):
        _solve(_instance(seed=5)(), cfg, resume_from=str(tmp_path))
    with pytest.raises(ValueError, match="slots"):
        _solve(_instance()(), cfg, slots=8, resume_from=str(tmp_path))
    # A state the reference wrote for the same bytes is refused too: the
    # two fingerprints hash different field lists (accepted, by design).
    p, b, budgets = _rows()
    jd = tmp_path / "jax"
    jpf.solve_streaming_host(jpf.host_array_source(p, b, budgets, 128),
                             JCfg(max_iters=3, checkpoint_every=2), q=Q,
                             slots=4, checkpoint_dir=str(jd))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _solve(tpf.host_array_source(p, b, budgets, 128), cfg,
               resume_from=str(jd))


def test_checkpoint_keep_is_configurable(tmp_path, base4):
    """``cfg.checkpoint_keep`` reaches the pruning (3 by default), and a
    solve killed with one state kept resumes from it bitwise."""
    d1, d3 = tmp_path / "keep1", tmp_path / "default"
    res = _solve(_instance()(), CFG.replace(checkpoint_every=1, checkpoint_keep=1),
                 slots=4, checkpoint_dir=str(d1))
    _assert_bitwise(res, base4)
    assert len(_steps(d1)) == 1, _steps(d1)
    _solve(_instance()(), CFG.replace(checkpoint_every=1, max_iters=4), slots=4,
           checkpoint_dir=str(d3))
    assert len(_steps(d3)) == 3, _steps(d3)
    dk = tmp_path / "keep1_kill"
    cfgk = CFG.replace(checkpoint_keep=1)
    src, _ = _killing(_instance(), 70)
    with pytest.raises(_Kill):
        _solve(src, cfgk, slots=4, checkpoint_dir=str(dk))
    assert len(_steps(dk)) == 1
    _assert_bitwise(_solve(_instance()(), cfgk, resume_from=str(dk)), base4)


# ---------------------------------------------------------------------------
# Damaged checkpoint directories: loud, never a silent fresh start.
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_dir(tmp_path):
    _solve(_instance()(), SolverConfig(max_iters=4, checkpoint_every=2),
           slots=4, checkpoint_dir=str(tmp_path))
    return tmp_path


def _latest_dir(d):
    return d / f"step_{ckpt.latest_step(d):08d}"


@pytest.mark.parametrize("damage", ["truncated_manifest", "missing_leaf",
                                    "corrupt_leaf"])
def test_damaged_checkpoint_raises_actionable(ckpt_dir, damage):
    latest = ckpt.latest_step(ckpt_dir)
    step_dir = _latest_dir(ckpt_dir)
    if damage == "truncated_manifest":
        m = step_dir / "manifest.json"
        m.write_text(m.read_text()[: len(m.read_text()) // 2])
        match = "manifest.*corrupt"
    elif damage == "missing_leaf":
        victim = sorted(step_dir.glob("arr_*.npy"))[2]
        victim.unlink()
        match = victim.name
    else:
        victim = sorted(step_dir.glob("arr_*.npy"))[0]
        victim.write_bytes(victim.read_bytes()[:16])
        match = "unreadable"
    assert ckpt.latest_step(ckpt_dir) == latest      # still visible
    with pytest.raises(ValueError, match=match):
        ckpt.restore_auto(ckpt_dir, latest)
    with pytest.raises(ValueError, match="could not restore"):
        _solve(_instance()(), CFG, resume_from=str(ckpt_dir))


def test_stale_tmp_only_is_fresh_start(tmp_path, base4):
    stale = tmp_path / "step_00000004.tmp"
    stale.mkdir(parents=True)
    (stale / "manifest.json").write_text('{"truncat')
    assert ckpt.latest_step(tmp_path) is None
    res = _solve(_instance()(), CFG, slots=4, resume_from=str(tmp_path))
    _assert_bitwise(res, base4)
    assert not stale.exists(), "prune should sweep stale .tmp debris"


def test_missing_manifest_dir_and_pointer_documents(tmp_path):
    (tmp_path / "step_00000007").mkdir(parents=True)
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(ValueError, match="no manifest.json"):
        ckpt.restore_auto(tmp_path, 7)
    assert ckpt.read_json(tmp_path, "LIVE.json") is None
    ckpt.write_json(tmp_path, "LIVE.json", {"gen": 3})
    assert ckpt.read_json(tmp_path, "LIVE.json") == {"gen": 3}
    (tmp_path / "LIVE.json").write_text('{"gen"')
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.read_json(tmp_path, "LIVE.json")


def test_ckpt_format_interchange(tmp_path):
    """A directory written by one package's ``save`` reads back through the
    other's ``restore_auto``, leaf for leaf; ``restore`` checks the keys."""
    g = np.random.default_rng(0)
    tree = {"lam": g.random(5).astype(np.float32),
            "phase": np.int32(1),
            "fingerprint": g.integers(0, 255, 8).astype(np.uint8),
            "fin_ch": g.random((4, 5, 3)).astype(np.float32)}
    ckpt.save(tmp_path / "t", 7, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in tree.items()})
    jckpt.save(tmp_path / "j", 7, tree)
    for d in ("t", "j"):
        got_j = jckpt.restore_auto(tmp_path / d, 7)
        got_t = ckpt.restore_auto(tmp_path / d, 7)
        assert set(got_j) == set(got_t) == set(tree)
        for k, v in tree.items():
            np.testing.assert_array_equal(np.asarray(got_j[k]), v)
            np.testing.assert_array_equal(got_t[k].numpy(), v)
            assert got_t[k].numpy().dtype == np.asarray(v).dtype
    assert ((tmp_path / "t" / "step_00000007" / "manifest.json").read_text()
            == (tmp_path / "j" / "step_00000007" / "manifest.json").read_text())
    got = ckpt.restore(tmp_path / "j", 7, like=tree)
    np.testing.assert_array_equal(got["fin_ch"].numpy(), tree["fin_ch"])
    with pytest.raises(ValueError, match="mismatch|leaves"):
        ckpt.restore(tmp_path / "j", 7, like={"lam": tree["lam"]})


# ---------------------------------------------------------------------------
# Kill and resume: bitwise at every interruption point.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 4])
def test_kill_mid_iterate_resume_bitwise(tmp_path, slots, base4):
    base = base4 if slots == 4 else _solve(
        _instance()(), CFG.replace(checkpoint_every=0), slots=slots)
    src, _ = _killing(_instance(), 70)               # inside the 4th or 5th epoch
    with pytest.raises(_Kill):
        _solve(src, CFG, slots=slots, checkpoint_dir=str(tmp_path))
    state = ckpt.restore_auto(tmp_path, ckpt.latest_step(tmp_path))
    assert int(state["phase"]) == 0 and int(state["iters"]) > 0
    _assert_bitwise(_solve(_instance()(), CFG, resume_from=str(tmp_path)), base)


def test_kill_between_finalize_chunks_no_double_count(tmp_path):
    """Kill between columns of the fused finalize, resume from the mid-pass
    cursor: the resumed run fetches the fingerprint probe and exactly the
    columns not yet folded, and reproduces the histograms bit for bit."""
    make = _instance(chunk=64)                       # c = 32, cps = 8 at slots=4
    cfg = SolverConfig(max_iters=20, checkpoint_every=1)
    base = _solve(make(), cfg, slots=4)
    cols = 8
    # the fingerprint probe, the epochs, then 5.5 finalize columns
    kill_at = 1 + base.iters * 32 + 5 * 4 + 2
    src, _ = _killing(make, kill_at)
    with pytest.raises(_Kill):
        _solve(src, cfg, slots=4, checkpoint_dir=str(tmp_path))
    latest = ckpt.latest_step(tmp_path)
    assert latest > cfg.max_iters + 1                # a mid-finalize state
    cursor = int(ckpt.restore_auto(tmp_path, latest)["cursor"])
    assert 0 < cursor < cols
    src2, calls = _counting(make)
    _assert_bitwise(_solve(src2, cfg, resume_from=str(tmp_path)), base)
    assert calls["n"] == 1 + (cols - cursor) * 4


def test_torn_save_ignored_and_resume_from_previous(tmp_path, base4):
    real_replace = os.replace
    n_ok = {"n": 0}

    def torn_replace(a, b):
        if n_ok["n"] >= 2:                           # third save dies mid-rename
            raise OSError("simulated crash during atomic rename")
        n_ok["n"] += 1
        return real_replace(a, b)

    ckpt.os.replace = torn_replace
    try:
        with pytest.raises(OSError, match="simulated crash"):
            _solve(_instance()(), CFG, slots=4, checkpoint_dir=str(tmp_path))
    finally:
        ckpt.os.replace = real_replace
    torn = [p.name for p in tmp_path.iterdir() if p.name.endswith(".tmp")]
    assert torn, "the interrupted save should have left a .tmp directory"
    assert f"step_{ckpt.latest_step(tmp_path):08d}.tmp" not in torn
    _assert_bitwise(_solve(_instance()(), CFG, resume_from=str(tmp_path)), base4)


@pytest.mark.parametrize("slots", [1, 4])
def test_checkpointed_run_matches_uncheckpointed_bitwise(tmp_path, slots, base4):
    plain = base4 if slots == 4 else _solve(
        _instance()(), CFG.replace(checkpoint_every=0), slots=slots)
    for double_buffer in (True, False):
        res = _solve(_instance()(), CFG.replace(checkpoint_every=1), slots=slots,
                     checkpoint_dir=str(tmp_path / f"{double_buffer}"),
                     double_buffer=double_buffer)
        _assert_bitwise(res, plain)
    if slots == 1:
        _assert_bitwise(_solve(_instance()(), CFG.replace(checkpoint_every=0)), plain)


def test_resume_across_screening_toggle_bitwise(tmp_path, base4):
    """Screening is fingerprint-exempt: a state written unscreened resumes
    screened, and the other way round, bitwise."""
    for i, (before, after) in enumerate(((False, True), (True, False))):
        d = tmp_path / str(i)
        src, _ = _killing(_instance(), 70)
        with pytest.raises(_Kill):
            _solve(src, CFG.replace(screening=before), slots=4,
                   checkpoint_dir=str(d))
        res = _solve(_instance()(), CFG.replace(screening=after),
                     resume_from=str(d))
        _assert_bitwise(res, base4)
        assert (res.screen is not None) == after


def test_ordered_fold_pins_addition_order():
    rng = np.random.default_rng(0)
    x = np.asarray(rng.uniform(0.1, 1.0, (8, 10, 50)), np.float32) * np.float32(1.000123)
    acc = x[0].copy()
    for i in range(1, 8):
        acc = (acc + x[i]).astype(np.float32)
    got = ordered_fold(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, acc)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(j_ordered_fold)(x)))
    np.testing.assert_array_equal(ordered_fold(torch.from_numpy(x), dim=1).numpy(),
                                  np.asarray(j_ordered_fold(x, axis=1)))


# ---------------------------------------------------------------------------
# Against the reference: slots at a fixed count, the screened profile.
# ---------------------------------------------------------------------------

def _close(ours, theirs):
    assert abs(ours.iters - int(theirs.iters)) <= 1
    np.testing.assert_allclose(ours.lam.numpy(), np.asarray(theirs.lam),
                               rtol=1e-5, atol=1e-6)
    for f in ("primal", "dual"):
        np.testing.assert_allclose(float(getattr(ours, f)),
                                   float(getattr(theirs, f)), rtol=1e-5)


@pytest.mark.parametrize("slots,algo", [(2, "scd"), (4, "scd"), (4, "dd")])
def test_slots_match_reference(slots, algo):
    p, b, budgets = _rows(n=2000)                    # c = 16, ragged; slots 4: cps 4
    cfg = dict(algo=algo, max_iters=20 if algo == "scd" else 8)
    ours = _solve(tpf.host_array_source(p, b, budgets, 128),
                  SolverConfig(**cfg), slots=slots)
    theirs = jpf.solve_streaming_host(jpf.host_array_source(p, b, budgets, 128),
                                      JCfg(**cfg), q=Q, slots=slots)
    _close(ours, theirs)
    np.testing.assert_allclose(ours.r.numpy(), np.asarray(theirs.r), rtol=1e-5)


def test_screened_slots_bitwise_with_reference_profile():
    make = lambda: banded_host_chunk_source(7, 8 * 512 - 100, 6, 512, q=2,  # noqa: E731
                                            tightness=0.08, band=0.05)
    cfg = SolverConfig(max_iters=30, bucket_half=12)
    base = tpf.solve_streaming_host(make(), cfg, q=2, device="cpu", slots=3)
    scr = tpf.solve_streaming_host(make(), cfg.replace(screening=True), q=2,
                                   device="cpu", slots=3)
    _assert_bitwise(scr, base)
    from repro.data.synth import banded_host_chunk_source as jbanded
    jscr = jpf.solve_streaming_host(
        jbanded(7, 8 * 512 - 100, 6, 512, q=2, tightness=0.08, band=0.05),
        JCfg(max_iters=30, bucket_half=12, screening=True), q=2, slots=3)
    np.testing.assert_array_equal(scr.screen["streamed_chunks"],
                                  jscr.screen["streamed_chunks"])
    assert scr.screen["streamed_chunks"].min() < 8
    np.testing.assert_array_equal(scr.screen["active"], jscr.screen["active"])


def test_host_presolve_matches_reference():
    p, b, budgets = _rows(n=2000)
    cfg = dict(max_iters=20, presolve_samples=300)
    for slots in (1, 4):
        ours = _solve(tpf.host_array_source(p, b, budgets, 128),
                      SolverConfig(**cfg), slots=slots)
        theirs = jpf.solve_streaming_host(
            jpf.host_array_source(p, b, budgets, 128), JCfg(**cfg), q=Q,
            slots=slots)
        _close(ours, theirs)
    cold = _solve(tpf.host_array_source(p, b, budgets, 128),
                  SolverConfig(max_iters=20), slots=4)
    assert ours.iters < cold.iters


# ---------------------------------------------------------------------------
# A real SIGKILL, and the launcher.
# ---------------------------------------------------------------------------

_KILL_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    from repro_torch.core.prefetch import solve_streaming_host
    from repro_torch.core.types import SolverConfig
    from repro_torch.data.synth import sparse_host_chunk_source

    kill_after, ckpt_dir = int(sys.argv[1]), sys.argv[2]
    src = sparse_host_chunk_source(4, 2048, 8, 128, q=2, tightness=0.4)
    calls = {"n": 0}
    inner = src.fn
    def fn(i):
        calls["n"] += 1
        if calls["n"] > kill_after:
            os.kill(os.getpid(), signal.SIGKILL)
        return inner(i)
    solve_streaming_host(src._replace(fn=fn),
                         SolverConfig(max_iters=20, checkpoint_every=2), q=2,
                         slots=4, device="cpu", checkpoint_dir=ckpt_dir)
""")


def test_sigkill_and_resume_subprocess(tmp_path, base4):
    """A slots=4 solve SIGKILLed in a fresh interpreter mid-iterate, resumed
    here, equals the uninterrupted solve bitwise."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _KILL_SCRIPT, "90", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == -signal.SIGKILL, (out.returncode, out.stderr)
    assert ckpt.latest_step(tmp_path) is not None
    _assert_bitwise(_solve(_instance()(), CFG, resume_from=str(tmp_path)), base4)


def test_launcher_checkpoint_flags(tmp_path, capsys):
    d = str(tmp_path / "ck")
    common = ["--n", "4096", "--k", "6", "--max-iters", "6", "--host-feed",
              "--chunk-size", "1024", "--device", "cpu", "--slots", "2"]
    tlaunch.main(common + ["--checkpoint-dir", d, "--checkpoint-every", "2"])
    first = capsys.readouterr().out
    assert ckpt.latest_step(d) is not None
    tlaunch.main(common + ["--checkpoint-dir", d, "--checkpoint-every", "2",
                           "--resume"])
    again = capsys.readouterr().out

    def metrics(out):
        return {k: v for k, v in (line.split(": ", 1) for line in out.splitlines())
                if k not in ("wall_s",)}

    assert metrics(first) == metrics(again)
    for argv, msg in ((["--n", "4096", "--slots", "2"], "--host-feed"),
                      (common + ["--checkpoint-every", "2"], "--checkpoint-dir"),
                      (common + ["--resume"], "--checkpoint-dir")):
        with pytest.raises(SystemExit, match=msg):
            tlaunch.main(argv)
