"""The streamed drivers over a world of ranks (``launch.mesh``), on the CPU.

Worlds of gloo rank processes (``run_local_world``; the world of 1 is an
in-process ``Mesh`` of one rank, which makes no collective) at n = 20,000,
K = 8, chunk 1,024. Bitwise: the host-fed solve at ``slots=4`` over worlds
of 1, 2 and 4 equals the in-process ``slots=4`` solve field for field,
``fin_hist``, history and screening stats included, for SCD, screened SCD
(== unscreened), DD, the sampled history and ``partial_fraction=0.5``; the
device-streamed solve of a world of 2 equals the host-fed one at 2 slots;
a state written by a world of 4 that was SIGKILLed mid-iterate resumes on
a world of 2 and in process to the uninterrupted solve's bits. Against the
reference: the in-process ``slots=4`` solve with ``partial_fraction=0.5``
equals ``repro.core.prefetch.solve_streaming_host(slots=4)`` on the same
NumPy bytes, bitwise on dyadic rows and to rtol 1e-5 on random ones. A
rank whose fetch fails fails the world, well within its timeout, naming
the chunk.
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

import jax  # noqa: E402

import _torch_world as W  # noqa: E402
from repro.core import prefetch as jpf  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
FIELDS = ("lam", "r", "primal", "dual", "tau")
NAMES = ["scd", "screened", "dd", "history", "straggler"]
CKPT_CFG = SolverConfig(max_iters=30, kernel_tile=256, checkpoint_every=2)
# Each rank reads the fingerprint probe, then S / D * cps = 5 chunks an
# epoch (20 chunks, 4 slots, 5 columns): killed in iteration 6, after the
# save at iteration 4.
KILL_AFTER = 1 + 5 * 5


def assert_same(a, b):
    assert a.iters == b.iters
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.fin_hist or (), b.fin_hist or ()):
        assert torch.equal(x, y)
    assert (a.history is None) == (b.history is None)
    for key in a.history or {}:
        np.testing.assert_array_equal(a.history[key].numpy(), b.history[key].numpy())
    assert (a.screen is None) == (b.screen is None)
    for key in a.screen or {}:
        np.testing.assert_array_equal(a.screen[key], b.screen[key], err_msg=key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The killed world of 4 first (its state), then the worlds of 2 and 4
    side by side, then the in-process solves and the world of 1."""
    ckpt = tmp_path_factory.mktemp("world4_ckpt")
    with pytest.raises(tmesh.WorldError) as err:
        tmesh.run_local_world(W.killed_solve, 4, (CKPT_CFG, str(ckpt), KILL_AFTER),
                              device="cpu", timeout=TIMEOUT)
    copy = tmp_path_factory.mktemp("world2_resume") / "ckpt"
    shutil.copytree(ckpt, copy)
    two = tmesh.start_local_world(W.mesh_scenarios, 2, (NAMES,),
                                  {"streamed": True, "resume_dir": str(copy),
                                   "resume_cfg": CKPT_CFG},
                                  device="cpu", timeout=TIMEOUT)
    four = tmesh.start_local_world(W.mesh_scenarios, 4, (NAMES + ["unscreened"],),
                                   device="cpu", timeout=TIMEOUT)
    worlds = {2: two.wait(), 4: four.wait()}
    worlds[1] = W.mesh_scenarios(tmesh.Mesh(0, 1, torch.device("cpu")), NAMES)
    in_process = {name: W.host_fed(name) for name in NAMES}
    return {"killed": (ckpt, err.value), "worlds": worlds, "in_process": in_process}


@pytest.fixture(scope="module")
def in_process(runs):
    return runs["in_process"]


@pytest.fixture(scope="module")
def killed_state(runs):
    return runs["killed"]


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_world_equals_in_process_slots_bitwise(worlds, in_process, world, name):
    assert_same(worlds[world][name], in_process[name])


def test_screened_world_equals_unscreened_and_retires(worlds):
    scr, plain = worlds[4]["screened"], worlds[4]["unscreened"]
    for f in FIELDS:
        assert torch.equal(getattr(scr, f), getattr(plain, f)), f
    assert scr.iters == plain.iters
    c = -(-W.BANDED_N // W.CHUNK)
    assert min(scr.screen["streamed_chunks"]) < c


def test_streamed_world_equals_host_fed_world(worlds):
    assert_same(worlds[2]["streamed"], worlds[2]["host_fed_world_slots"])


def test_straggler_drops_slots_and_stays_feasible(in_process):
    half, full = in_process["straggler"], in_process["scd"]
    assert not torch.equal(half.lam, full.lam)
    assert torch.all(half.r <= torch.as_tensor(W.table_source().budgets))


def _dyadic_rows():
    g = np.random.default_rng(3)
    p = (g.integers(0, 64, (W.N, W.K)) / 64).astype(np.float32)
    b = (g.integers(1, 64, (W.N, W.K)) / 64).astype(np.float32)
    budgets = np.full((W.K,), 0.4 * W.N * W.Q * 0.5 / W.K, np.float32)
    return p, b, budgets


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_straggler_slots_match_reference(dyadic):
    """The in-process ``slots=4`` solve at ``partial_fraction=0.5`` against
    the reference's on the same bytes: each slot's histogram scaled by 2
    before the fold is bitwise the reference's per-row v2 scaling."""
    if dyadic:
        p, b, budgets = _dyadic_rows()
    else:
        kp = W.resident_kp(W.table_source())
        p, b, budgets = kp.p.numpy(), kp.b.numpy(), kp.budgets.numpy()
    cfg = SolverConfig(max_iters=30, partial_fraction=0.5)
    got = tpf.solve_streaming_host(tpf.host_array_source(p, b, budgets, W.CHUNK),
                                   cfg, q=W.Q, slots=W.SLOTS, device="cpu")
    ref = jpf.solve_streaming_host(jpf.host_array_source(p, b, budgets, W.CHUNK),
                                   JCfg(max_iters=30, partial_fraction=0.5),
                                   q=W.Q, slots=W.SLOTS)
    assert got.iters == int(ref.iters)
    if dyadic:
        np.testing.assert_array_equal(got.lam.numpy(), np.asarray(ref.lam))
    else:
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam), rtol=1e-5)
    for f in ("r", "primal", "dual"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5)


def test_killed_world_left_a_mid_iterate_state(killed_state):
    from repro_torch.checkpoint import ckpt
    d, err = killed_state
    assert err.returncodes == [-signal.SIGKILL] * 4
    st = ckpt.restore_auto(d, ckpt.latest_step(d))
    assert (int(st["phase"]), int(st["iters"]), int(st["slots"])) == (0, 4, 4)


@pytest.mark.parametrize("where", ["world2", "in_process"])
def test_elastic_resume_is_bitwise(killed_state, worlds, in_process, where,
                                   tmp_path):
    if where == "world2":
        res = worlds[2]["resumed"]
    else:
        copy = tmp_path / "ckpt"
        shutil.copytree(killed_state[0], copy)
        res = tpf.solve_streaming_host(W.table_source(), CKPT_CFG, q=W.Q,
                                       device="cpu", resume_from=str(copy))
    assert_same(res, in_process["scd"])


def test_failing_rank_fails_the_world_within_its_timeout():
    """Chunk 15 belongs to slot 1 (10 columns of 2 slots), so to rank 1."""
    t0 = time.monotonic()
    with pytest.raises(tmesh.WorldError) as err:
        tmesh.run_local_world(W.failing_fetch, 2, (15,), device="cpu", timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2
    assert err.value.rank == 1
    assert "ChunkFetchError" in err.value.detail and "chunk 15" in err.value.detail


def test_mesh_arguments_are_checked():
    source, cfg = W.scenario("scd")
    with pytest.raises(TypeError, match="Mesh"):
        tpf.solve_streaming_host(source, cfg, device="cpu", mesh=object())
    two = tmesh.Mesh(0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        tpf.solve_streaming_host(source, cfg, device="cpu", mesh=two, slots=3)
    with pytest.raises(ValueError, match="fused"):
        tpf.solve_streaming_host(source, cfg.replace(stream_finalize="legacy"),
                                 device="cpu", mesh=two)


def test_launcher_world_equals_in_process_slots():
    """``--world 2 --host-feed`` prints the in-process ``--slots 2`` run's
    numbers (wall and the world's keys aside)."""
    from repro_torch.configs.paper_kp import WORKLOADS, KPWorkload
    from repro_torch.launch import solve as tlaunch
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--n", "20000", "--k", "8",
         "--host-feed", "--chunk-size", "1024", "--max-iters", "20", "--device", "cpu",
         "--world", "2"], capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    skip = ("wall_s", "world", "collective_s")
    world = [ln for ln in out.stdout.splitlines() if ln.split(":")[0] not in skip]
    wl = WORKLOADS["table1"]
    row = tlaunch.run_streaming(KPWorkload(wl.name, 20000, 8, wl.q, wl.tightness),
                                SolverConfig(max_iters=20, chunk_size=1024), 1024,
                                device="cpu", slots=2)
    assert any(ln.startswith("lam: ") for ln in world)
    assert world == [f"{k}: {v}" for k, v in row.items() if k not in skip]
