"""The port's supervision layer (repro_torch/launch/supervisor.py), case for
case the reference's ``tests/test_supervisor.py``.

The coordinator state machine is exercised with *scripted fake workers*
(``worker_cmd`` override): tiny ``python -c`` subprocesses that speak the
lease file format directly without importing torch, so crash restarts,
lease-expiry hang takeovers, chaos injection, device degradation (read
off each child's ``CUDA_VISIBLE_DEVICES`` and ``REPRO_WORKER_WORLD``, on
four cards and on one) and crash-loop containment all
run in well under a second of worker time each. One end-to-end test runs
a real supervised solve worker on the CPU and pins the published record
bitwise against an in-process run; the port's record is held against the
reference's ``run_solve_task`` on the same ``WorkloadSpec`` (the same
NumPy rows) at ROADMAP C's tolerances. The full soak is the
``--chaos-soak`` gate (``chip_smoke.py`` phase 16 on the card).
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import supervisor as jsupervisor  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import env as envmod  # noqa: E402
from repro_torch.launch.supervisor import (  # noqa: E402
    ChaosSchedule,
    Supervisor,
    SupervisorConfig,
    run_solve_task,
)
from repro_torch.serve.engine import WorkloadSpec  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# A scripted worker that renews leases without importing repro_torch (or
# torch): argv = [python, -c, _FAKE, root, term, mode]. Each life first
# records its CUDA_VISIBLE_DEVICES in env_<term>.txt and its world size in
# world_<term>.txt. Modes:
#   ok            beat a few times, exit 0
#   crash-once    exit 5 in term 1, behave like "ok" afterwards
#   crash-twice   exit 5 in terms 1 and 2, behave like "ok" afterwards
#   hang          beat once, then stop beating (SIGSTOP-shaped) forever
#   crash-always  exit 7 immediately
#   work          bump progress forever (chaos-injection target) in term
#                 1, behave like "ok" afterwards
_FAKE = r"""
import hashlib, json, os, sys, time
root, term, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
with open(os.path.join(root, "env_%d.txt" % term), "w") as f:
    f.write(os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>"))
with open(os.path.join(root, "world_%d.txt" % term), "w") as f:
    f.write(os.environ.get("REPRO_WORKER_WORLD", "<unset>"))
path = os.path.join(root, "heartbeat.json")
seq = 0
def beat(progress):
    global seq
    seq += 1
    rec = dict(worker="fake", pid=os.getpid(), term=term, seq=seq,
               progress=progress, ttl=0.5, mono=time.monotonic(),
               wall=time.time())
    payload = json.dumps(rec, sort_keys=True).encode()
    data = payload + b"\n" + hashlib.sha256(payload).hexdigest().encode() \
        + b"\n"
    tmp = path + ".wtmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
if mode == "crash-always":
    sys.exit(7)
if (mode == "crash-once" and term == 1) or (mode == "crash-twice" and term <= 2):
    beat(0)
    sys.exit(5)
if mode == "hang" and term == 1:
    beat(0)
    time.sleep(3600)
if mode == "work" and term == 1:
    p = 0
    while True:
        p += 1
        beat(p)
        time.sleep(0.02)
for i in range(3):
    beat(i)
    time.sleep(0.05)
sys.exit(0)
"""

NOOP = {"kind": "noop", "device": "cpu"}


def _fake_cmd(mode):
    def cmd(root, term, devices):
        return [sys.executable, "-c", _FAKE, str(root), str(term), mode]
    return cmd


def _cfg(**kw):
    base = dict(ttl=0.4, poll=0.02, grace=5.0, max_restarts=4)
    base.update(kw)
    return SupervisorConfig(**base)


def test_clean_completion_publishes_done_status(tmp_path):
    sup = Supervisor(tmp_path, NOOP, cfg=_cfg(), devices=4,
                     worker_cmd=_fake_cmd("ok"))
    out = sup.run()
    assert out["ok"] and out["spawns"] == 1 and out["restarts"] == 0
    status = ckpt.read_json(tmp_path, "SUPERVISOR.json")
    assert status["state"] == "done" and status["ok"]
    # The durable task intent was written before the first spawn.
    assert ckpt.read_json(tmp_path, "task.json") == {**NOOP, "ttl": 0.4}
    # A CPU worker sees no card.
    assert (tmp_path / "env_1.txt").read_text() == ""


def test_crash_restart_resumes_on_degraded_devices(tmp_path, monkeypatch):
    seen = []

    def cmd(root, term, devices):
        seen.append((term, devices))
        return [sys.executable, "-c", _FAKE, str(root), str(term),
                "crash-twice"]

    # Four cards, then one card: a world of 4 ranks degrades on either.
    for visible, cards in (("0,1,2,3", ["0,1,2,3", "0,1", "0"]),
                           ("0", ["0", "0", "0"])):
        root = tmp_path / f"cards_{visible.count(',') + 1}"
        root.mkdir()
        seen.clear()
        monkeypatch.setenv(envmod.VISIBLE, visible)
        sup = Supervisor(root, {"kind": "noop", "device": "cuda"},
                         cfg=_cfg(), devices=4, worker_cmd=cmd)
        out = sup.run()
        assert out["ok"] and out["crash_restarts"] == 2
        assert out["last_rc"] == 5
        assert out["degraded_spawns"] == 2
        assert seen == [(1, 4), (2, 2), (3, 1)], "respawns must halve the devices"
        # Each child's environment held the degraded world size, 4, 2, 1,
        # and the cards it shares.
        assert [(root / f"env_{t}.txt").read_text() for t in (1, 2, 3)] == cards
        assert [(root / f"world_{t}.txt").read_text() for t in (1, 2, 3)] \
            == ["4", "2", "1"]


def test_hang_detected_by_lease_expiry_and_taken_over(tmp_path):
    sup = Supervisor(tmp_path, NOOP, cfg=_cfg(), devices=2,
                     worker_cmd=_fake_cmd("hang"))
    t0 = time.monotonic()
    out = sup.run()
    took = time.monotonic() - t0
    assert out["ok"] and out["hang_takeovers"] == 1
    assert out["crash_restarts"] == 0, "a hang is not an exit-code crash"
    # Detected by lease expiry within the deadline, not by luck: the
    # takeover must land shortly after ttl, far under the fake's sleep.
    assert took < 30.0
    # The adoption was exclusively claimed at term 2.
    assert (tmp_path / "heartbeat.json.claim_00000002").exists()
    # The takeover's recovery: expiry to the next worker's first beat.
    assert len(sup.recovery_s) == 1 and 0 < sup.recovery_s[0] < 30.0


def test_chaos_kill_fires_at_progress_threshold(tmp_path):
    sched = ChaosSchedule(seed=0, events=(("kill", 5),))
    sup = Supervisor(tmp_path, NOOP, cfg=_cfg(), devices=2,
                     worker_cmd=_fake_cmd("work"), chaos=sched)
    out = sup.run()
    assert out["ok"]
    assert out["kills_injected"] == 1 and out["crash_restarts"] == 1
    assert len(sup.recovery_s) == 1


def test_chaos_stop_detected_as_hang(tmp_path):
    sched = ChaosSchedule(seed=0, events=(("stop", 5),))
    sup = Supervisor(tmp_path, NOOP, cfg=_cfg(), devices=2,
                     worker_cmd=_fake_cmd("work"), chaos=sched)
    out = sup.run()
    assert out["ok"]
    assert out["stops_injected"] == 1
    assert out["hang_takeovers"] == 1, \
        "a SIGSTOPped worker must surface via lease expiry"
    # From the SIGSTOP: at least the lease's ttl passes before the
    # takeover, then the next worker's first beat.
    assert len(sup.recovery_s) == 1 and sup.recovery_s[0] >= 0.4


def test_crash_loop_budget_stamps_failed_and_stops(tmp_path):
    sup = Supervisor(tmp_path, NOOP, cfg=_cfg(max_restarts=2), devices=4,
                     worker_cmd=_fake_cmd("crash-always"))
    out = sup.run()
    assert not out["ok"]
    assert out["crash_restarts"] == 3          # initial + 2 budgeted
    failed = ckpt.read_json(tmp_path, "FAILED.json")
    assert failed is not None
    assert "budget" in failed["reason"]
    status = ckpt.read_json(tmp_path, "SUPERVISOR.json")
    assert status["state"] == "failed"


def test_schedule_plan_is_deterministic_interleaved_and_the_reference_s():
    a = ChaosSchedule.plan(7, kills=2, stops=1, lo=10, hi=50)
    b = ChaosSchedule.plan(7, kills=2, stops=1, lo=10, hi=50)
    assert a.events == b.events
    kinds = [k for k, _ in a.events]
    assert kinds == ["kill", "stop", "kill"]
    assert all(10 <= at < 50 for _, at in a.events)
    assert a.events != ChaosSchedule.plan(8, 2, 1, 10, 50).events
    assert a.events == jsupervisor.ChaosSchedule.plan(7, 2, 1, 10, 50).events


def test_poisoned_worker_exits_before_heavy_imports(tmp_path):
    # The real --worker entry point, poisoned: must exit with the poison
    # code fast and never read task.json (tmp_path holds none).
    env = dict(os.environ, REPRO_WORKER_POISON="3")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    rc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervisor",
         "--worker", str(tmp_path), "--term", "1"],
        env=env, timeout=60).returncode
    assert rc == 3
    # ... before torch is imported.
    code = ("import argparse, sys\n"
            "from repro_torch.launch.supervisor import _worker_main\n"
            f"rc = _worker_main(argparse.Namespace(worker={str(tmp_path)!r}, "
            "term=1))\n"
            "print(rc, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["3", "False"]


def test_next_term_skips_debris_from_previous_coordinators(tmp_path):
    sup = Supervisor(tmp_path, NOOP, cfg=_cfg(), devices=1,
                     worker_cmd=_fake_cmd("ok"))
    assert sup._next_term() == 1
    # Claim debris from a dead coordinator advances the term.
    (tmp_path / "heartbeat.json.claim_00000004").write_text("1\n")
    assert sup._next_term() == 5
    out = sup.run()                        # must claim term 5, not term 1
    assert out["ok"] and out["term"] == 5


SPEC = WorkloadSpec(seed=3, n=1024, k=4, chunk=256, q=1, tightness=0.5)
TASK_CFG = dict(reduce="bucketed", max_iters=12, checkpoint_every=4,
                bucket_half=16)
FIELDS = ["lam", "tau", "iters", "r", "primal", "dual"]


def test_supervised_solve_matches_inprocess_and_reference(tmp_path):
    """End to end with a real worker subprocess on the CPU: the supervised
    record is bitwise the in-process one, and within ROADMAP C's
    tolerances of the reference's ``run_solve_task`` on the same spec."""
    task = {"kind": "solve", "spec": SPEC.to_json(), "cfg": TASK_CFG,
            "slots": 2, "device": "cpu"}
    ref = run_solve_task(tmp_path / "ref", task)
    sup = Supervisor(tmp_path / "sup", task,
                     cfg=SupervisorConfig(ttl=5.0, poll=0.1, grace=300.0,
                                          max_restarts=2),
                     devices=1)
    out = sup.run()
    assert out["ok"], out
    got = ckpt.restore_auto(tmp_path / "sup" / "result", 0)
    for f in FIELDS:
        assert np.asarray(ref[f]).tobytes() \
            == np.asarray(got[f]).tobytes(), f
    jtask = {k: v for k, v in task.items() if k != "device"}
    jref = jsupervisor.run_solve_task(tmp_path / "jax", jtask)
    assert abs(int(jref["iters"]) - int(ref["iters"])) <= 1
    for f in ["lam", "tau", "r", "primal", "dual"]:
        np.testing.assert_allclose(ref[f], np.asarray(jref[f]), rtol=1e-5,
                                   err_msg=f)


def test_cli_without_a_card_raises_resolve_device(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda soak would run")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervisor",
         "--chaos-soak", "--smoke", "--device", "cuda",
         "--root", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not (tmp_path / "solve_ref").exists()
