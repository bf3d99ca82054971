"""Serving over a world of ranks (``RefreshEngine(mesh=)``), on the CPU.

The reference's engine publishes, over a mesh of any size, the record of
its one-device solve at the same slot count (its
``tests/test_refresh_engine.py`` and ``tests/test_refresh_delta.py``
SIGKILL a mesh refresh and re-drive it). Here a world of 2 gloo ranks at
``slots=4`` publishes bitwise the in-process ``slots=4`` engine's records
(every field, the fingerprint, the finalize histograms and the screening
artifacts) over a cold and a warm generation, and over screened delta
generations on the banded workload (a budget change, every chunk
inherited; then growth in n, the frontier chunks changed). A world
refresh SIGKILLed mid-solve is re-driven in process to the uninterrupted
record. A world whose rank 1 cannot fetch a chunk fails within its
timeout, leaves ``FAILED.json`` in the pending generation (written by
that rank) and ``LIVE.json`` where it was. The front's scenario over the
world (refresh churn published by the world, 2 replica processes serving
it) answers every row bitwise its generation's. And the launcher's
``--world 2 --smoke`` passes its gate.
"""
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

import _torch_world as W  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serve import RefreshEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
FIELDS = ("lam", "tau", "iters", "r", "primal", "dual", "fingerprint", "warm")
# A rank reads the fingerprint probe, then 8 chunks an epoch (16 chunks,
# 4 slots, 2 a rank): killed in the warm refresh's third iteration, after
# its save at iteration 2.
KILL_AFTER = 1 + 8 * 2 + 4
FAIL_CHUNK = 13                      # slot 3's, so rank 1's


def assert_same_generation(a, b):
    for f in FIELDS:
        assert np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes(), f
    assert (a.fin_hist is None) == (b.fin_hist is None)
    for x, y in zip(a.fin_hist or (), b.fin_hist or ()):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    ra = ckpt.restore_auto(Path(a.path) / "record", 0)
    rb = ckpt.restore_auto(Path(b.path) / "record", 0)
    assert sorted(ra) == sorted(rb)
    for key in ra:
        assert np.asarray(ra[key]).tobytes() == np.asarray(rb[key]).tobytes(), key


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The serving world, the killed world and the failing world side by
    side, then the in-process engines."""
    d = tmp_path_factory.mktemp("world_serve")
    roots = {name: str(d / f"world_{name}") for name in W.ENGINES}
    worlds = {
        "serve": tmesh.start_local_world(W.serve_world, 2, (roots, str(d / "front")),
                                         device="cpu", timeout=TIMEOUT),
        "killed": tmesh.start_local_world(W.killed_refresh, 2,
                                          (str(d / "killed"), KILL_AFTER),
                                          device="cpu", timeout=TIMEOUT),
        "failing": tmesh.start_local_world(W.failing_refresh, 2,
                                           (str(d / "failing"), FAIL_CHUNK),
                                           device="cpu", timeout=TIMEOUT),
    }
    t0 = time.monotonic()
    out = {"serve": worlds["serve"].wait()}
    for name in ("killed", "failing"):
        with pytest.raises(tmesh.WorldError) as err:
            worlds[name].wait()
        out[name] = err.value
    out["failing_s"] = time.monotonic() - t0
    out["in_process"] = {name: W.serve_generations(d / f"in_process_{name}", name)
                         for name in W.ENGINES}
    out["dir"] = d
    return out


@pytest.mark.parametrize("name,gen", [("plain", 0), ("plain", 1), ("screened", 0),
                                      ("screened", 1), ("screened", 2)])
def test_world_records_equal_in_process_slots_bitwise(runs, name, gen):
    a, b = runs["serve"][name][gen], runs["in_process"][name][gen]
    assert a.gen == b.gen == gen
    assert a.warm == (gen > 0)
    assert_same_generation(a, b)


def test_screened_delta_generations_inherit_certificates(runs):
    """The budget change inherits every chunk (fewer streamed in its first
    epoch than there are chunks); growth in n re-streams the frontier."""
    c = -(-W.SCREEN_SPEC.n // W.SCREEN_SPEC.chunk)
    first = []
    for g in runs["serve"]["screened"][1:]:
        rec = ckpt.restore_auto(Path(g.path) / "record", 0)
        first.append(int(np.asarray(rec["screen_streamed"])[0]))
    assert first[0] < c and first[1] < -(-(W.SCREEN_SPEC.n + 1000) // W.SCREEN_SPEC.chunk)


def test_only_rank_zero_writes_the_root(runs):
    """One root, one writer: each generation has its intent, record and
    checkpoints once, and the pointer names the last generation."""
    root = Path(runs["dir"]) / "world_plain"
    assert sorted(p.name for p in root.iterdir()) == ["LIVE.json", "gen_000000",
                                                      "gen_000001"]
    assert ckpt.read_json(root, "LIVE.json") == {"gen": 1}
    for g in ("gen_000000", "gen_000001"):
        assert sorted(p.name for p in (root / g).iterdir()) == ["ckpt", "record",
                                                                "spec.json"]


def test_killed_world_refresh_redriven_in_process_bitwise(runs):
    err = runs["killed"]
    assert err.returncodes == [-signal.SIGKILL] * 2
    root = Path(runs["dir"]) / "killed"
    spec, cfg, _ = W.ENGINES["plain"]
    eng = RefreshEngine(root, spec, cfg=cfg, slots=W.SERVE_SLOTS, device="cpu")
    assert eng.live_gen_id() == 0
    assert ckpt.latest_step(root / "gen_000001" / "ckpt") is not None
    rec = eng.recover()
    assert rec.gen == 1 and eng.live_gen_id() == 1
    assert_same_generation(rec, runs["in_process"]["plain"][1])


def test_failing_rank_stamps_failed_and_leaves_live(runs):
    err = runs["failing"]
    assert runs["failing_s"] < TIMEOUT / 2
    assert err.rank == 1
    assert "ChunkFetchError" in err.detail and f"chunk {FAIL_CHUNK}" in err.detail
    root = Path(runs["dir"]) / "failing"
    spec, cfg, _ = W.ENGINES["plain"]
    eng = RefreshEngine(root, spec, cfg=cfg, device="cpu")
    assert eng.live_gen_id() == 0
    failed = eng.failed()
    assert failed["gen"] == 1 and failed["chunk"] == FAIL_CHUNK


def test_front_serves_world_published_generations(runs):
    out = runs["serve"]["front"]
    assert out["parity"] and out["stale_rows"] == 0
    assert out["diff"]["parity"]
    assert out["generations_served"][-1] == 2
    assert all(r >= 1 for r in out["rebinds"])
    assert out["metrics"]["consistent"]


def test_mesh_argument_is_checked(tmp_path):
    with pytest.raises(TypeError, match="Mesh"):
        RefreshEngine(tmp_path, W.SERVE_SPEC, device="cpu", mesh=object())


def test_refresh_cli_world_smoke(tmp_path):
    """``--world 2 --smoke``: rank 0 reports the world and its slots, three
    generations, warm beating cold and lookups round-tripping bitwise
    (exit 0); the records it published are the in-process engine's (the
    tests above)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.refresh", "--smoke", "--device",
         "cpu", "--root", str(tmp_path / "world"), "--world", "2"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True,
        text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "world 2, slots 2" in out.stdout and "bitwise OK" in out.stdout
    assert sum(ln.startswith("[refresh] gen ") for ln in out.stdout.splitlines()) == 3
    eng = RefreshEngine(tmp_path / "world", W.SERVE_SPEC, device="cpu")
    assert eng.live_gen_id() == 2
    shutil.rmtree(tmp_path)
