"""The supervised worker as a world of ranks, on the CPU.

A worker of count D is D rank processes (``launch/mesh.py``); a respawn
halves the count, also on one card, and the count reaches the worker in
its environment (``REPRO_WORKER_WORLD``). Scripted fake workers (no torch)
drive the coordinator through counts 4, 2 and 1 on one visible card. A
real CPU worker world of 2 SIGKILLed once (its lease holder, rank 0) is
respawned on 1 rank and publishes bitwise the in-process record; a
takeover kills every rank of the worker's process group. The world's
choice of rank count (the reference's ``_task_mesh``) divides the slots.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import env as envmod  # noqa: E402
from repro_torch.launch.supervisor import (  # noqa: E402
    ChaosSchedule,
    Supervisor,
    SupervisorConfig,
    _task_world,
    run_solve_task,
)
from repro_torch.serve.engine import WorkloadSpec  # noqa: E402

# A scripted worker: records its environment and beats; mode "crash-twice"
# exits 5 in terms 1 and 2 and 0 after; mode "hang" spawns a child in its
# process group and sleeps in term 1 (both must die at the takeover).
_FAKE = r"""
import hashlib, json, os, subprocess, sys, time
root, term, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
with open(os.path.join(root, "env_%d.json" % term), "w") as f:
    json.dump({k: os.environ.get(k) for k in
               ("CUDA_VISIBLE_DEVICES", "REPRO_WORKER_WORLD")}, f)
path = os.path.join(root, "heartbeat.json")
def beat(seq):
    rec = dict(worker="fake", pid=os.getpid(), term=term, seq=seq,
               progress=0, ttl=0.5, mono=time.monotonic(), wall=time.time())
    payload = json.dumps(rec, sort_keys=True).encode()
    data = payload + b"\n" + hashlib.sha256(payload).hexdigest().encode() + b"\n"
    with open(path + ".wtmp", "wb") as f:
        f.write(data)
    os.replace(path + ".wtmp", path)
beat(1)
if mode == "hang" and term == 1:
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"])
    with open(os.path.join(root, "child.pid"), "w") as f:
        f.write(str(child.pid))
    time.sleep(3600)
if mode == "crash-twice" and term <= 2:
    sys.exit(5)
for i in range(2, 5):
    beat(i)
    time.sleep(0.05)
"""


def _fake(mode):
    def cmd(root, term, devices):
        return [sys.executable, "-c", _FAKE, str(root), str(term), mode]
    return cmd


def _cfg(**kw):
    return SupervisorConfig(**{"ttl": 0.4, "poll": 0.02, "grace": 5.0,
                               "max_restarts": 4, **kw})


def test_respawns_halve_the_world_on_one_card(tmp_path, monkeypatch):
    monkeypatch.setenv(envmod.VISIBLE, "0")
    sup = Supervisor(tmp_path, {"kind": "noop", "slots": 4, "device": "cuda"},
                     cfg=_cfg(), worker_cmd=_fake("crash-twice"))
    assert sup.devices0 == 4                 # the slot count, not the cards
    out = sup.run()
    assert out["ok"] and out["crash_restarts"] == 2
    assert out["degraded_spawns"] == 2 and out["devices"] == 1
    envs = [ckpt.read_json(tmp_path, f"env_{t}.json") for t in (1, 2, 3)]
    assert [e["REPRO_WORKER_WORLD"] for e in envs] == ["4", "2", "1"]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "0", "0"]


def test_takeover_kills_the_whole_process_group(tmp_path):
    out = Supervisor(tmp_path, {"kind": "noop", "device": "cpu"}, cfg=_cfg(),
                     devices=2, worker_cmd=_fake("hang")).run()
    assert out["ok"] and out["hang_takeovers"] == 1
    pid = int((tmp_path / "child.pid").read_text())
    deadline = time.monotonic() + 10
    while True:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        # A zombie (killed, not yet reaped by init) has state Z.
        with open(f"/proc/{pid}/stat") as f:
            if f.read().split(")")[1].split()[0] == "Z":
                break
        assert time.monotonic() < deadline, "the worker's child outlived the takeover"
        time.sleep(0.05)


@pytest.mark.parametrize("slots,count,world", [(4, 4, 4), (8, 4, 4), (4, 2, 2),
                                               (6, 4, 3), (5, 4, 1), (None, 4, 1),
                                               (4, 1, 1)])
def test_task_world_divides_the_slots(slots, count, world):
    assert _task_world(slots, count) == world


SPEC = WorkloadSpec(seed=2, n=16384, k=8, chunk=512, q=2, tightness=0.4)
TASK_CFG = dict(reduce="bucketed", max_iters=12, checkpoint_every=2,
                bucket_half=16)
# Every fetch of the supervised worker sleeps 5 ms (no change to the
# bytes): its lives last long enough for the kill to land mid-solve.
SLOW = dict(slow=1.0, slow_s=0.005)


def test_world_worker_killed_respawns_on_one_rank_bitwise(tmp_path):
    task = {"kind": "solve", "spec": SPEC.to_json(), "cfg": TASK_CFG,
            "slots": 2, "device": "cpu"}
    ref = run_solve_task(tmp_path / "ref", task)
    sup = Supervisor(tmp_path / "sup", {**task, "fault_plan": SLOW},
                     cfg=SupervisorConfig(ttl=2.5, poll=0.02, grace=120.0,
                                          max_restarts=2, progress_ttl=60.0),
                     chaos=ChaosSchedule(events=(("kill", 20),)))
    assert sup.devices0 == 2
    out = sup.run()
    assert out["ok"], out
    # The world ends with WorldError as soon as rank 0 dies; should the
    # worker's exit come after the lease's ttl, the expiry takes it over.
    assert out["kills_injected"] == 1 and out["restarts"] == 1
    assert out["degraded_spawns"] == 1 and out["devices"] == 1
    assert ckpt.read_json(tmp_path / "sup", "task.json")["progress_ttl"] == 60.0
    got = ckpt.restore_auto(tmp_path / "sup" / "result", 0)
    for f in ("lam", "tau", "iters", "r", "primal", "dual", "fin_ch", "fin_gh"):
        assert np.asarray(ref[f]).tobytes() == np.asarray(got[f]).tobytes(), f
    assert len(sup.recovery_s) == 1


def test_poisoned_world_worker_exits_before_starting_ranks(tmp_path):
    env = dict(os.environ, REPRO_WORKER_POISON="3", REPRO_WORKER_WORLD="4")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    rc = subprocess.run([sys.executable, "-m", "repro_torch.launch.supervisor",
                         "--worker", str(tmp_path), "--term", "1"],
                        env=env, timeout=60).returncode
    assert rc == 3 and not any(tmp_path.iterdir())
