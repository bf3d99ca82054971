"""Elastic supervision: heartbeat-leased workers, hang detection, self-healing.

A solve or a multi-generation refresh runs as a supervised **worker
subprocess** (``--worker``) that renews an fsync'd heartbeat lease
(:mod:`repro_torch.core.heartbeat`) alongside its normal checkpoint
cadence, while the coordinator (:class:`Supervisor`) watches two signals:

* **exit codes** — a crashed worker (SIGKILL, OOM, a bug) is respawned
  with the same task file; the solver's resume protocol re-drives it
  from the last durable checkpoint, so the eventual result is bitwise
  the undisturbed one;
* **lease expiry** — a *hung* worker (SIGSTOP-shaped: every thread
  frozen, so the renewer stops; or stuck-fetch-shaped via the optional
  progress deadline) is detected when its lease stops advancing for
  ``ttl`` seconds of the coordinator's own clock, exclusively adopted
  (:func:`repro_torch.core.heartbeat.claim_takeover`), killed, and
  respawned.

A worker's **count** is its world size: a worker of count D > 1 is a
world of D rank processes (``launch/mesh.py``) that solves over the
task's fixed ``slots`` (the widest world of at most D ranks that the
slot count divides over, the reference's ``_task_mesh``), its ranks
sharing the visible cards round-robin; a worker of count 1 runs in one
process. Each respawn may run on a **degraded count** (halving per
restart, floor ``min_devices``), carried by the child's environment
(:func:`repro_torch.launch.env.worker_env`), on one card as on several:
the bits depend on the slot count, never on the world's size, and a
world-4 resume state resumes on 2 ranks. Rank 0 holds the heartbeat
lease, and its chunk fetches are the lease's progress (the ranks move in
step through every pass's collectives, so a stalled rank stalls rank 0's
progress too). The worker runs in its own session: a takeover kills its
process group, every rank with it. A chaos kill or stop hits the lease
holder (rank 0); a world whose rank dies ends at once with
``WorldError`` (the worker exits non-zero), and a rank stuck in a
collective raises after the task's ``progress_ttl``. A bounded crash-loop budget
(``max_restarts``) escalates to a root-level ``FAILED.json`` stamp —
loud, durable, and the serving LIVE pointer untouched. Every transition
publishes supervision counters (restarts, takeovers, injected chaos,
lease ages) to ``SUPERVISOR.json``, which
:meth:`repro_torch.serve.decisions.DecisionService.health` surfaces.

``--chaos-soak`` is the end-to-end proof: a seeded kill/stop schedule
(:class:`ChaosSchedule`, deterministic thresholds on the lease's chunk
fetch counter) plus fetch-level drop/slow/corrupt injection is run
against a supervised solve AND a supervised 3-generation refresh; both
must publish records **bitwise identical** to undisturbed in-process
reference runs, and a poisoned crash-looping task must exhaust its
budget into ``FAILED.json`` while LIVE still points at the last good
generation. The gate asserts the exercised counters (kills, stops,
hang takeovers and, where the workers start on more than
``min_devices`` ranks, degraded spawns) so a schedule that silently
failed to fire cannot pass.

    PYTHONPATH=src python -m repro_torch.launch.supervisor --chaos-soak --smoke [--device cpu] [--world D]
    PYTHONPATH=src python -m repro_torch.launch.supervisor --supervise refresh \\
        --root /tmp/sup --users 65536 --generations 3 --slots 4 [--world D] [--device cpu]

``--world`` is the workers' start count (default: the slot count).

Workers run on the card unless the task says ``"device": "cpu"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

from . import env as envmod
from ..obs import MetricsRegistry

__all__ = ["SupervisorConfig", "ChaosSchedule", "Supervisor", "SoakShape",
           "run_solve_task", "run_refresh_task", "run_chaos_soak"]

_STATUS = "SUPERVISOR.json"
_FAILED = "FAILED.json"
_TASK = "task.json"
_HEARTBEAT = "heartbeat.json"
_CLAIM_RE = re.compile(r"\.claim_(\d+)$")


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Coordinator policy: deadlines, cadence, and the crash-loop budget.

    ``ttl`` is the lease deadline — a worker whose lease has not
    advanced for this many seconds (of the coordinator's clock) is
    declared hung and taken over. ``grace`` bounds process startup until
    the first beat (exec and ``import torch``, which the heartbeat module's
    package pulls in; it also covers a worker that died before its first
    beat). The task's imports, the CUDA context and the kernel library
    load after the first beat, under the renewer thread.
    ``max_restarts`` bounds crash restarts plus hang takeovers together;
    exceeding it stamps ``FAILED.json`` and stops — the containment
    path, never a spin. ``degrade`` halves the worker device count on
    every respawn (floor ``min_devices``). ``progress_ttl`` optionally
    adds stuck-fetch detection (beats alive, progress frozen).
    """

    ttl: float = 3.0
    poll: float = 0.05
    grace: float = 120.0
    max_restarts: int = 8
    degrade: bool = True
    min_devices: int = 1
    progress_ttl: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A seeded worker-level fault schedule (the FaultPlan of processes).

    ``events`` is an ordered tuple of ``(kind, at_progress)`` pairs,
    ``kind`` in {"kill", "stop"}: when the *current* worker's lease
    progress counter (chunk fetches) reaches ``at_progress``, the
    coordinator delivers SIGKILL or SIGSTOP and the event is consumed —
    so each event lands in a different worker life. Thresholds are pure
    hashes of ``(seed, index)`` in ``[lo, hi)``, so a soak replays the
    same schedule every run; the *exact* fetch the signal lands on may
    drift with OS scheduling, which is fine — the checkpoint protocol
    guarantees bitwise resume from any kill point, and the gate asserts
    the events fired, not where.
    """

    seed: int = 0
    events: tuple = ()

    @classmethod
    def plan(cls, seed: int, kills: int, stops: int,
             lo: int, hi: int) -> "ChaosSchedule":
        """Interleaved kill/stop events with hashed thresholds."""
        if hi <= lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi})")
        kinds = []
        k, s = kills, stops
        while k > 0 or s > 0:
            if k > 0:
                kinds.append("kill")
                k -= 1
            if s > 0:
                kinds.append("stop")
                s -= 1
        events = []
        for i, kind in enumerate(kinds):
            h = hashlib.sha256(f"chaos:{seed}:{i}".encode()).digest()
            at = lo + int.from_bytes(h[:8], "big") % (hi - lo)
            events.append((kind, at))
        return cls(seed=seed, events=tuple(events))


class Supervisor:
    """One supervised task: spawn, watch, re-drive, contain.

    ``root`` is the task's working directory — the worker's checkpoint
    and result/generation tree live here, next to the heartbeat lease,
    the durable ``task.json`` intent, the ``SUPERVISOR.json`` status
    document, and (on budget exhaustion) the ``FAILED.json`` stamp.
    ``task`` is the JSON-serialisable task description ``--worker``
    executes (see :func:`run_solve_task` / :func:`run_refresh_task`); its
    ``device`` ("cuda", the default, or "cpu") picks the child's cards.
    ``devices`` is the start count, the worker's world size: by default
    the task's slot count. ``worker_cmd(root, term,
    devices) -> argv`` overrides the spawned command (tests drive the
    coordinator with scripted fake workers); ``env_extra`` is merged
    into every worker environment.

    ``recovery_s`` lists, per respawn, the seconds from the failure (the
    injected signal, or the crash or expiry the coordinator observed) to
    the next worker's first beat.
    """

    def __init__(self, root, task: dict, cfg: SupervisorConfig = None,
                 devices: Optional[int] = None,
                 chaos: Optional[ChaosSchedule] = None,
                 worker_cmd: Optional[Callable] = None,
                 env_extra: Optional[dict] = None):
        self.root = pathlib.Path(root)
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.task = dict(task)
        self.task.setdefault("ttl", self.cfg.ttl)
        if self.cfg.progress_ttl is not None:
            self.task.setdefault("progress_ttl", self.cfg.progress_ttl)
        self.device = self.task.get("device", "cuda")
        if devices is None:
            devices = self.task.get("slots") or 1
        self.devices0 = int(devices)
        self.chaos = chaos
        self.worker_cmd = worker_cmd
        self.env_extra = dict(env_extra or {})
        self.hb_path = self.root / _HEARTBEAT
        self.recovery_s: list = []
        # Supervision counters live on a typed registry (monotone
        # counters for event tallies, gauges for the point-in-time
        # term/devices/lease-age readings); the :attr:`counters` dict
        # the rest of the stack consumes is assembled on read, with the
        # same 13 keys SUPERVISOR.json has always published.
        self.registry = MetricsRegistry()
        self._ctrs = {
            k: self.registry.counter(f"supervisor_{k}")
            for k in ("spawns", "crash_restarts", "hang_takeovers",
                      "kills_injected", "stops_injected",
                      "degraded_spawns")}
        self._g_ok = self.registry.gauge("supervisor_ok")
        self._g_term = self.registry.gauge("supervisor_term")
        self._g_devices = self.registry.gauge("supervisor_devices")
        self._g_devices.set(self.devices0)
        self._g_lease_age = self.registry.gauge("supervisor_max_lease_age")
        self._info = {"state": "init", "last_rc": None}

    @property
    def counters(self) -> dict:
        """The status-document dict, assembled from the registry."""
        c = {k: int(v.value) for k, v in self._ctrs.items()}
        return {
            "ok": bool(self._g_ok.value),
            "state": self._info["state"],
            "spawns": c["spawns"],
            "crash_restarts": c["crash_restarts"],
            "hang_takeovers": c["hang_takeovers"],
            "restarts": c["crash_restarts"] + c["hang_takeovers"],
            "kills_injected": c["kills_injected"],
            "stops_injected": c["stops_injected"],
            "degraded_spawns": c["degraded_spawns"],
            "max_lease_age": round(float(self._g_lease_age.value), 3),
            "term": int(self._g_term.value),
            "devices": int(self._g_devices.value),
            "last_rc": self._info["last_rc"],
        }

    # -- spawn plumbing -----------------------------------------------------

    def _argv(self, term: int, devices: int) -> list:
        if self.worker_cmd is not None:
            return list(self.worker_cmd(self.root, term, devices))
        return [sys.executable, "-m", "repro_torch.launch.supervisor",
                "--worker", str(self.root), "--term", str(term)]

    def _env(self, devices: int) -> dict:
        wenv = envmod.worker_env(devices, device=self.device)
        # The child must be able to import the running repro_torch package
        # even when the parent was launched from an installed path.
        src = str(pathlib.Path(__file__).resolve().parents[2])
        pp = wenv.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            wenv["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
        wenv.update(self.env_extra)
        return wenv

    def _spawn(self, term: int, devices: int) -> subprocess.Popen:
        # Its own session: the worker's ranks share its process group.
        return subprocess.Popen(self._argv(term, devices),
                                env=self._env(devices), start_new_session=True)

    def _next_term(self) -> int:
        """First unused term on this root (lease + claim debris aware).

        A supervisor relaunched over an existing root (its predecessor
        died) must not reuse a term: the lease records the last writer's
        term and the claim files record every adoption, so the next term
        is one past the max of both — keeping claim exclusivity
        meaningful across coordinator generations.
        """
        from ..core.heartbeat import TornLease, read_lease

        last = 0
        try:
            lease = read_lease(self.hb_path)
            if lease is not None:
                last = lease.term
        except TornLease:
            pass
        for p in self.hb_path.parent.glob(self.hb_path.name + ".claim_*"):
            m = _CLAIM_RE.search(p.name)
            if m:
                last = max(last, int(m.group(1)))
        return last + 1

    # -- status publication -------------------------------------------------

    def _publish(self, state: str):
        from ..checkpoint import ckpt

        self._info["state"] = state
        doc = self.counters
        doc["updated_wall"] = time.time()
        ckpt.write_json(self.root, _STATUS, doc)

    # -- the watch loop -----------------------------------------------------

    def _kill(self, proc: subprocess.Popen):
        """SIGKILL the worker's process group (every rank of its world;
        STOPped processes too) and reap the worker."""
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()

    def _watch(self, proc: subprocess.Popen, term: int, events: list,
               t_fail: Optional[float]):
        """Watch one worker life; returns ('done'|'crash'|'hang', rc,
        t_fail): the outcome, the exit code and the monotonic time of the
        failure that ended the life (the injected signal, else when the
        coordinator saw it). ``t_fail`` of the previous life is closed
        into :attr:`recovery_s` at this life's first fresh beat."""
        from ..core.heartbeat import LeaseMonitor

        mon = LeaseMonitor(self.hb_path, ttl=self.cfg.ttl,
                           grace=self.cfg.grace, expect_term=term,
                           progress_ttl=self.cfg.progress_ttl)
        injected = None
        while True:
            rc = proc.poll()
            st = mon.poll()
            if st["age"] is not None:
                self._g_lease_age.set_max(float(st["age"]))
            if t_fail is not None and st["state"] == "fresh":
                self.recovery_s.append(time.monotonic() - t_fail)
                t_fail = None
            if rc is not None:
                if rc == 0:
                    return "done", rc, None
                self._kill(proc)                # ranks the worker left
                return "crash", rc, injected or time.monotonic()
            if st["expired"]:
                # The hang path: no liveness evidence for ttl (or the
                # progress deadline). The worker may be SIGSTOPped,
                # wedged in a fetch, or a zombie-to-be — all get the
                # same treatment: kill, then re-drive from checkpoint.
                self._kill(proc)
                return "hang", None, injected or time.monotonic()
            # One injection a life: a world whose rank 0 was just killed
            # takes a moment to exit, and its lease reads fresh meanwhile.
            if events and injected is None and st["state"] == "fresh" \
                    and st["progress"] is not None \
                    and st["progress"] >= events[0][1]:
                kind, _ = events.pop(0)
                holder = st["lease"].pid        # rank 0 of a world
                try:
                    if kind == "kill":
                        os.kill(holder, signal.SIGKILL)
                        self._ctrs["kills_injected"].inc()
                    else:
                        os.kill(holder, signal.SIGSTOP)
                        self._ctrs["stops_injected"].inc()
                    injected = time.monotonic()
                except ProcessLookupError:
                    pass
            time.sleep(self.cfg.poll)

    # -- the coordinator loop -----------------------------------------------

    def run(self) -> dict:
        """Drive the task to completion, a FAILED stamp, or bust.

        Returns the final counter dict (``ok`` True only when a worker
        exited 0). The task intent is written durably before the first
        spawn, so a relaunched supervisor re-drives the identical task.
        """
        from ..checkpoint import ckpt
        from ..core.heartbeat import claim_takeover

        ckpt.write_json(self.root, _TASK, self.task)
        self._info.update(state="starting", last_rc=None)
        self._g_ok.set(0)
        self._g_term.set(0)
        self._g_devices.set(self.devices0)
        events = list(self.chaos.events) if self.chaos is not None else []
        devices = self.devices0
        term = self._next_term()
        t_fail = None
        while True:
            if term > 1 and not claim_takeover(self.hb_path, term):
                raise RuntimeError(
                    f"takeover claim for term {term} on {self.hb_path} "
                    "was already held — another coordinator owns this "
                    "root; standing down instead of double-driving it")
            proc = self._spawn(term, devices)
            self._ctrs["spawns"].inc()
            self._g_term.set(term)
            self._g_devices.set(devices)
            if devices < self.devices0:
                self._ctrs["degraded_spawns"].inc()
            self._publish("running")
            outcome, rc, t_fail = self._watch(proc, term, events, t_fail)
            if outcome == "done":
                self._g_ok.set(1)
                self._publish("done")
                return self.counters
            if outcome == "crash":
                self._ctrs["crash_restarts"].inc()
                self._info["last_rc"] = rc
            else:
                self._ctrs["hang_takeovers"].inc()
            if (self._ctrs["crash_restarts"].value
                    + self._ctrs["hang_takeovers"].value) \
                    > self.cfg.max_restarts:
                # Containment, not a spin: budget exhausted. The stamp is
                # root-level (the per-generation FAILED.json remains the
                # solver-level fetch-exhaustion stamp); LIVE — if this
                # root serves generations — is untouched, so readers
                # keep answering from the last good publication.
                ckpt.write_json(self.root, _FAILED, {
                    "reason": "crash-loop budget exhausted",
                    "max_restarts": self.cfg.max_restarts,
                    "counters": self.counters,
                    "task_kind": self.task.get("kind"),
                })
                self._publish("failed")
                return self.counters
            term += 1
            if self.cfg.degrade:
                devices = max(self.cfg.min_devices, devices // 2)


# ---------------------------------------------------------------------------
# The worker side: task execution (shared with in-process reference runs).
# ---------------------------------------------------------------------------

def _heartbeat_source(source, hb):
    """Wrap a chunk source so every fetch bumps the lease's progress."""
    inner = source.fn

    def fn(i):
        hb.bump()
        return inner(i)

    return source._replace(fn=fn)


def _task_source(task: dict, spec, hb=None):
    """spec -> HostChunkSource per the task: synthetic workload, optional
    FaultPlan injection underneath, heartbeat progress on top."""
    from ..core.faults import FaultPlan, faulty_source
    from ..serve.engine import synthetic_source

    src = synthetic_source(spec)
    if task.get("fault_plan"):
        src = faulty_source(src, FaultPlan(**task["fault_plan"]))
    if hb is not None:
        src = _heartbeat_source(src, hb)
    return src


def _task_cfg(task: dict):
    from ..core.types import SolverConfig

    return SolverConfig(**task.get("cfg", {}))


def _task_world(slots: Optional[int], count: int) -> int:
    """The widest world of at most ``count`` ranks that the task's slot
    count divides over (the reference's ``_task_mesh``)."""
    s = slots or 1
    return max(d for d in range(1, min(count, s) + 1) if s % d == 0)


def run_solve_task(root, task: dict, hb=None, mesh=None) -> dict:
    """Execute (or resume) a ``kind == "solve"`` task under ``root``.

    Solves the task's workload on ``task["device"]`` (the card unless
    "cpu") through ``task["slots"]`` virtual slots, with checkpointing
    into ``root/ckpt`` and resume from the same directory — a respawned
    worker picks up where its predecessor died — and publishes the
    result record durably at ``root/result`` (ckpt protocol, step 0).
    Idempotent: a worker killed between the record save and its exit is
    a no-op on the next life. Returns the record as NumPy arrays. Over a
    ``mesh`` every rank calls this and solves over the world; rank 0
    writes the checkpoints and the record, and every rank returns it.
    """
    import numpy as np

    from ..checkpoint import ckpt
    from ..core.prefetch import solve_streaming_host
    from ..serve.engine import WorkloadSpec

    root = pathlib.Path(root)
    result_dir = root / "result"
    if ckpt.latest_step(result_dir) is not None:
        return {k: np.asarray(v)
                for k, v in ckpt.restore_auto(result_dir, 0).items()}
    spec = WorkloadSpec.from_json(task["spec"])
    ckdir = str(root / "ckpt")
    res = solve_streaming_host(
        _task_source(task, spec, hb), _task_cfg(task), q=spec.q,
        device=task.get("device", "cuda"), mesh=mesh, slots=task.get("slots"),
        checkpoint_dir=ckdir, resume_from=ckdir)
    record = {
        "lam": res.lam.numpy(), "tau": res.tau.numpy(),
        "iters": np.int32(res.iters), "r": res.r.numpy(),
        "primal": res.primal.numpy(), "dual": res.dual.numpy(),
    }
    if res.fin_hist is not None:
        record["fin_ch"] = np.asarray(res.fin_hist[0])
        record["fin_gh"] = np.asarray(res.fin_hist[1])
    if mesh is None or mesh.rank == 0:
        ckpt.save(result_dir, 0, record)
    if mesh is not None:
        mesh.barrier()
    return record


def run_refresh_task(root, task: dict, hb=None, mesh=None) -> dict:
    """Execute (or resume) a ``kind == "refresh"`` task under ``root``.

    Drives a :class:`~repro_torch.serve.engine.RefreshEngine` over ``root``
    on ``task["device"]`` through the task's budget-scale schedule until
    ``generations`` generations are live. Re-entrant by construction:
    ``recover()`` finishes a preempted generation first, then the loop
    continues from the live pointer — the engine's two-step publication
    makes every completed generation bitwise the undisturbed one. Over a
    ``mesh`` every rank calls this, and the engine runs over the world.
    """
    from ..serve.engine import RefreshEngine, WorkloadSpec

    spec = WorkloadSpec.from_json(task["spec"])
    engine = RefreshEngine(
        pathlib.Path(root), spec,
        make_source=lambda s: _task_source(task, s, hb),
        cfg=_task_cfg(task), mesh=mesh, slots=task.get("slots"),
        device=task.get("device", "cuda"))
    engine.recover()
    generations = int(task["generations"])
    scales = task.get("budget_scales") or [1.0] * generations
    start = (engine.live_gen_id() + 1
             if engine.live_gen_id() is not None else 0)
    for g in range(start, generations):
        engine.refresh(budget_scale=scales[g])
    return {"live": engine.live_gen_id()}


def _run_task(root: pathlib.Path, task: dict, term: int, mesh=None):
    """The durable task under ``root``, with the heartbeat lease held by
    this process (rank 0 of a world; the other ranks hold none)."""
    if task["kind"] not in ("solve", "refresh"):
        raise ValueError(f"unknown task kind {task['kind']!r} in "
                         f"{root / _TASK}")
    run = run_solve_task if task["kind"] == "solve" else run_refresh_task
    if mesh is not None and mesh.rank != 0:
        run(root, task, None, mesh)
        return

    from ..core.heartbeat import HeartbeatWriter

    hb = HeartbeatWriter(root / _HEARTBEAT, worker=task.get("kind", "task"),
                         term=term, ttl=float(task.get("ttl", 3.0)))
    with hb:
        run(root, task, hb, mesh)


def _worker_rank(mesh, root: str, term: int):
    """One rank of a worker's world."""
    root = pathlib.Path(root)
    _run_task(root, json.loads((root / _TASK).read_text()), term, mesh)


def _worker_main(args) -> int:
    """``--worker`` entry: heartbeat up, then run the durable task.

    The poison hook (``REPRO_WORKER_POISON`` = exit code) sits before
    every heavy import: it is the deterministic crash-loop fixture the
    containment gate and tests drive budget exhaustion with, and its
    earliness keeps those loops cheap (no ``import torch``). The first
    beat lands before the task's heavy imports; ``import torch`` comes
    before it, with the ``repro_torch.core`` package, inside ``grace``:
    loading torch's CUDA libraries holds the interpreter lock, which
    would starve the renewer thread under a short ``ttl``.

    A worker of count D > 1 (``REPRO_WORKER_WORLD``) starts a world of
    ranks (:func:`_task_world` of them) and waits for it; rank 0 beats
    once its world has joined. The world has no wall deadline (the
    supervisor watches its lease), and each collective times out after
    the task's ``progress_ttl`` (default the world's 600 s).
    """
    if os.environ.get("REPRO_WORKER_POISON"):
        return int(os.environ["REPRO_WORKER_POISON"])
    root = pathlib.Path(args.worker)
    task = json.loads((root / _TASK).read_text())
    world = _task_world(task.get("slots"), int(os.environ.get(envmod.WORLD, "1")))
    if world == 1:
        _run_task(root, task, args.term)
        return 0
    from .mesh import DEFAULT_TIMEOUT, start_local_world

    start_local_world(_worker_rank, world, (str(root), args.term),
                      device=task.get("device", "cuda"),
                      timeout=float(task.get("progress_ttl") or DEFAULT_TIMEOUT),
                      wall=float("inf")).wait()
    return 0


# ---------------------------------------------------------------------------
# The chaos soak: supervised self-healing, proven bitwise.
# ---------------------------------------------------------------------------

# Fetch-level injection riding under the process-level chaos (the
# "corrupt" leg of the soak schedule). Rates are deliberately milder
# than the --chaos gate's: with verify_refetch doubling reads, an
# attempt succeeds with (1 - drop - corrupt)^2 and the soak's workers
# re-fetch across several lives.
_SOAK_PLAN_KW = dict(drop=0.04, slow=0.02, slow_s=0.002, corrupt=0.02)
_SOAK_CFG_KW = dict(fetch_retries=8, fetch_backoff=1e-4,
                    fetch_backoff_cap=1e-3, verify_refetch=True)

_RESULT_FIELDS = ["lam", "tau", "iters", "r", "primal", "dual"]


class SoakShape(NamedTuple):
    """The soak's workload (K = 8, Q = 2, tightness 0.4), its bucket
    ladder and its chaos thresholds: ``lo``/``hi`` bound the lease
    progress (chunk reads, two per fetch under ``verify_refetch``) at
    which an event fires, and must land inside one worker life. The
    reference's ``bucket_half=16`` converges at its n <= 65,536; at
    N = 2^22 it runs to ``max_iters``, where the serving default (24)
    converges in 8 iterations."""

    n: int
    chunk: int
    generations: int
    max_iters: int
    lo: int
    hi: int
    slots: int = 4
    bucket_half: int = 16


SOAK_SMOKE = SoakShape(n=4096, chunk=512, generations=3, max_iters=40,
                       lo=12, hi=40)
SOAK_FULL = SoakShape(n=65536, chunk=2048, generations=3, max_iters=60,
                      lo=30, hi=150)


def _diff_records(tag: str, want: dict, got: dict, fields) -> list:
    import numpy as np

    diffs = []
    for f in fields:
        a, b = want.get(f), got.get(f)
        if a is None or b is None:
            if (a is None) != (b is None):
                diffs.append(f"{tag}: field {f} present in only one run")
            continue
        if np.asarray(a).tobytes() != np.asarray(b).tobytes():
            diffs.append(f"{tag}: field {f} differs bitwise")
    return diffs


def _sample_decisions(spec, record: dict, users, device):
    """Decision rows for sampled users straight from a published record
    (lam + tau are the whole decision rule; the source bytes are the
    spec's), computed on ``device``."""
    import numpy as np
    import torch

    from ..core.chunked import decisions_rows
    from ..serve.engine import synthetic_source

    src = synthetic_source(spec)
    dev = torch.device(device)
    lam = torch.as_tensor(np.asarray(record["lam"], np.float32)).to(dev)
    tau = torch.as_tensor(np.asarray(record["tau"], np.float32)).to(dev)
    out = []
    for u in users:
        ci, off = divmod(int(u), src.chunk)
        p, b = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                for a in src.fn(ci))
        rows = ci * src.chunk + torch.arange(src.chunk, device=dev)
        x = decisions_rows(p, b, lam, spec.q, rows < src.n, tau)
        out.append(x[off].cpu().numpy())
    return np.asarray(out)


def run_chaos_soak(root, smoke: bool = False, seed: int = 0,
                   device: str = "cuda",
                   shape: Optional[SoakShape] = None,
                   world: Optional[int] = None) -> tuple:
    """The supervision gate; returns ``(ok, report)``.

    Proves, end to end on ``device``: a supervised solve and a
    supervised multi-generation refresh each survive a seeded schedule
    of worker SIGKILLs and SIGSTOP hangs (plus fetch-level drop/corrupt
    injection under retries) and publish records **bitwise identical**
    to undisturbed in-process reference runs, and a poisoned
    crash-looping task exhausts its restart budget into a root-level
    ``FAILED.json`` while the serving LIVE pointer still names the last
    good generation. Every exercised path is counter-asserted: a soak in
    which the schedule silently failed to fire fails the gate. The
    workers start as worlds of ``world`` ranks (default: the slot count)
    and halve per respawn; degraded respawns are required whenever they
    start on more than ``min_devices`` ranks (on one card too), and
    waived, with a note in the report, for a start count of 1. ``shape``
    overrides the smoke or full :class:`SoakShape`.
    """
    import numpy as np

    from ..checkpoint import ckpt
    from ..serve.engine import RefreshEngine, WorkloadSpec
    from .refresh import _budget_schedule

    root = pathlib.Path(root)
    if shape is None:
        shape = SOAK_SMOKE if smoke else SOAK_FULL
    n, chunk, generations, max_iters, lo, hi, slots, bucket_half = shape
    spec = WorkloadSpec(seed=seed, n=n, k=8, chunk=chunk, q=2,
                        tightness=0.4)
    base_cfg = dict(reduce="bucketed", max_iters=max_iters,
                    checkpoint_every=2, bucket_half=bucket_half)
    chaos_cfg = {**base_cfg, **_SOAK_CFG_KW}
    plan = dict(seed=seed, **_SOAK_PLAN_KW)
    scales = _budget_schedule(generations, seed)
    # progress_ttl: the deadline of a world whose rank stopped or hangs in
    # a collective (the chaos stops hit rank 0, and expire its lease).
    sup_cfg = SupervisorConfig(ttl=2.5, poll=0.05, grace=120.0,
                               max_restarts=10, progress_ttl=60.0)
    devices = world

    report: dict = {"smoke": smoke, "seed": seed, "device": device,
                    "shape": shape._asdict()}
    diffs: list = []
    walls: dict = {}

    # ---- undisturbed references, in-process, fault-free ------------------
    print(f"[soak] reference solve -> {root / 'solve_ref'}")
    t0 = time.perf_counter()
    ref_solve = run_solve_task(root / "solve_ref", {
        "kind": "solve", "spec": spec.to_json(), "cfg": base_cfg,
        "slots": slots, "device": device})
    walls["solve_ref"] = time.perf_counter() - t0
    print(f"[soak] reference refresh ({generations} generations) -> "
          f"{root / 'refresh_ref'}")
    t0 = time.perf_counter()
    run_refresh_task(root / "refresh_ref", {
        "kind": "refresh", "spec": spec.to_json(), "cfg": base_cfg,
        "slots": slots, "generations": generations,
        "budget_scales": scales, "device": device})
    walls["refresh_ref"] = time.perf_counter() - t0
    ref_eng = RefreshEngine(root / "refresh_ref", spec, device=device)
    report["iters"] = {"solve": int(ref_solve["iters"]),
                       "refresh": [int(ref_eng.generation(g).iters)
                                   for g in range(generations)]}

    # ---- the supervised chaos solve and refresh, side by side ------------
    # Independent tasks (own roots, schedules and workers); each waits
    # mostly on its workers' interpreter starts and lease expiries.
    solve_sched = ChaosSchedule.plan(seed, kills=1, stops=1, lo=lo, hi=hi)
    refresh_sched = ChaosSchedule.plan(seed + 1, kills=1, stops=1,
                                       lo=lo, hi=hi)
    sups = {
        "solve": Supervisor(
            root / "solve_chaos",
            {"kind": "solve", "spec": spec.to_json(), "cfg": chaos_cfg,
             "slots": slots, "fault_plan": plan, "device": device},
            cfg=sup_cfg, devices=devices, chaos=solve_sched),
        "refresh": Supervisor(
            root / "refresh_chaos",
            {"kind": "refresh", "spec": spec.to_json(), "cfg": chaos_cfg,
             "slots": slots, "generations": generations,
             "budget_scales": scales, "fault_plan": plan, "device": device},
            cfg=sup_cfg, devices=devices, chaos=refresh_sched)}
    print(f"[soak] supervised chaos solve ({solve_sched.events}) -> "
          f"{root / 'solve_chaos'} and refresh ({refresh_sched.events}) -> "
          f"{root / 'refresh_chaos'}")

    def supervise(name):
        t0 = time.perf_counter()
        out = sups[name].run()
        walls[f"{name}_chaos"] = time.perf_counter() - t0
        return out

    with ThreadPoolExecutor(2) as pool:
        s_solve, s_refresh = pool.map(supervise, ("solve", "refresh"))
    report["solve"] = s_solve
    report["solve_recovery_s"] = sups["solve"].recovery_s
    devices0 = sups["solve"].devices0
    if not s_solve["ok"]:
        diffs.append("solve: supervised run did not complete")
    else:
        got_solve = {k: np.asarray(v) for k, v in ckpt.restore_auto(
            root / "solve_chaos" / "result", 0).items()}
        diffs += _diff_records("solve", ref_solve, got_solve,
                               _RESULT_FIELDS + ["fin_ch", "fin_gh"])
        rng = np.random.default_rng(seed)
        users = rng.integers(0, spec.n, 32)
        if not np.array_equal(
                _sample_decisions(spec, ref_solve, users, device),
                _sample_decisions(spec, got_solve, users, device)):
            diffs.append("solve: sampled decisions differ")

    report["refresh"] = s_refresh
    report["refresh_recovery_s"] = sups["refresh"].recovery_s
    if not s_refresh["ok"]:
        diffs.append("refresh: supervised run did not complete")
    else:
        got_eng = RefreshEngine(root / "refresh_chaos", spec, device=device)
        rng = np.random.default_rng(seed + 1)
        users = rng.integers(0, spec.n, 32)
        for g in range(generations):
            want, got = ref_eng.generation(g), got_eng.generation(g)
            fields = ["lam", "tau", "iters", "r", "primal", "dual",
                      "fingerprint"]
            diffs += _diff_records(
                f"refresh gen {g}",
                {f: getattr(want, f) for f in fields},
                {f: getattr(got, f) for f in fields}, fields)
            for i, (x, y) in enumerate(zip(want.fin_hist or (),
                                           got.fin_hist or ())):
                if np.asarray(x).tobytes() != np.asarray(y).tobytes():
                    diffs.append(f"refresh gen {g}: fin_hist[{i}] differs")
        live_want, live_got = ref_eng.live(), got_eng.live()
        rec_w = {"lam": live_want.lam, "tau": live_want.tau}
        rec_g = {"lam": live_got.lam, "tau": live_got.tau}
        if not np.array_equal(
                _sample_decisions(live_want.spec, rec_w, users, device),
                _sample_decisions(live_got.spec, rec_g, users, device)):
            diffs.append("refresh: sampled live decisions differ")

    # ---- containment: crash-loop budget -> FAILED.json, LIVE untouched ---
    live_before = RefreshEngine(root / "refresh_chaos", spec).live_gen_id()
    print("[soak] containment: poisoned crash-looping task "
          f"(budget 2) on {root / 'refresh_chaos'}")
    s_poison = Supervisor(
        root / "refresh_chaos",
        {"kind": "refresh", "spec": spec.to_json(), "cfg": chaos_cfg,
         "slots": slots, "generations": generations + 1,
         "budget_scales": scales + [1.0], "device": device},
        cfg=dataclasses.replace(sup_cfg, max_restarts=2),
        devices=devices, env_extra={"REPRO_WORKER_POISON": "3"}).run()
    report["poison"] = s_poison
    live_after = RefreshEngine(root / "refresh_chaos", spec).live_gen_id()
    failed = ckpt.read_json(root / "refresh_chaos", _FAILED)
    if s_poison["ok"]:
        diffs.append("containment: poisoned task reported success")
    if failed is None:
        diffs.append("containment: no FAILED.json stamped")
    if live_after != live_before:
        diffs.append(f"containment: LIVE moved {live_before} -> "
                     f"{live_after} under a failing task")

    # ---- skip-proof counter assertions -----------------------------------
    kills = s_solve["kills_injected"] + s_refresh["kills_injected"]
    stops = s_solve["stops_injected"] + s_refresh["stops_injected"]
    hangs = s_solve["hang_takeovers"] + s_refresh["hang_takeovers"]
    crashes = s_solve["crash_restarts"] + s_refresh["crash_restarts"]
    degraded = s_solve["degraded_spawns"] + s_refresh["degraded_spawns"]
    exercised = {"kills_injected": kills, "stops_injected": stops,
                 "hang_takeovers": hangs, "crash_restarts": crashes,
                 "degraded_spawns": degraded}
    report["exercised"] = exercised
    need = [("kills_injected", kills, 2), ("stops_injected", stops, 1),
            ("hang_takeovers", hangs, 1), ("crash_restarts", crashes, 2)]
    if devices0 > sup_cfg.min_devices:
        need.append(("degraded_spawns", degraded, 1))
        report["degrade"] = f"{devices0} ranks at start: degrade required"
    else:
        report["degrade"] = (f"{devices0} rank at start: no degrade possible "
                             f"(min_devices {sup_cfg.min_devices})")
    print(f"[soak] degrade: {report['degrade']}")
    for name, got_n, need_n in need:
        if got_n < need_n:
            diffs.append(f"soak under-exercised: {name} = {got_n} < "
                         f"{need_n} — the schedule did not fire; the gate "
                         "proves nothing")
    if hangs < stops:
        diffs.append(f"soak: {stops} SIGSTOPs injected but only {hangs} "
                     "lease-expiry takeovers — a hang went undetected")

    report["walls_s"] = walls
    report["diffs"] = diffs
    report["ok"] = not diffs
    ckpt.write_json(root, "SOAK.json", report)
    for d in diffs:
        print(f"[soak] FAIL: {d}")
    if not diffs:
        print(f"[soak] OK: solve + {generations}-generation refresh "
              f"bitwise identical to undisturbed runs under {kills} kills, "
              f"{stops} stops ({hangs} lease-expiry takeovers, {degraded} "
              f"degraded respawns); crash-loop contained to FAILED.json "
              "with LIVE untouched")
    return not diffs, report


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------

def main():
    """CLI dispatch: --worker / --chaos-soak / --supervise."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", default=None, metavar="ROOT",
                    help="internal: run the durable task under ROOT as a "
                         "supervised worker")
    ap.add_argument("--term", type=int, default=1)
    ap.add_argument("--chaos-soak", action="store_true",
                    help="supervised self-healing gate: seeded kills/"
                         "stops/corruption against a solve and a refresh; "
                         "exit 1 unless results are bitwise identical to "
                         "the undisturbed runs and every chaos path "
                         "actually fired")
    ap.add_argument("--smoke", action="store_true",
                    help="small scenario (the CI gate size)")
    ap.add_argument("--supervise", choices=["solve", "refresh"],
                    default=None,
                    help="run one supervised task to completion")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the workers and the "
                         "in-process references")
    ap.add_argument("--root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=65536)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--tightness", type=float, default=0.4)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--world", type=int, default=None,
                    help="the workers' start count, as worlds of ranks "
                         "(default: the slot count; halves per respawn)")
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--ttl", type=float, default=3.0)
    ap.add_argument("--max-restarts", type=int, default=8)
    args = ap.parse_args()

    if args.worker is not None:
        sys.exit(_worker_main(args))

    import tempfile

    from ..core.solver import resolve_device

    device = resolve_device(args.device).type
    root = args.root or tempfile.mkdtemp(prefix="supervisor_")
    if args.chaos_soak:
        ok, _ = run_chaos_soak(root, smoke=args.smoke, seed=args.seed,
                               device=device, world=args.world)
        sys.exit(0 if ok else 1)
    if args.supervise is not None:
        from ..serve.engine import WorkloadSpec
        from .refresh import _budget_schedule

        spec = WorkloadSpec(seed=args.seed, n=args.users, k=args.k,
                            chunk=args.chunk, q=args.q,
                            tightness=args.tightness)
        cfg = dict(reduce="bucketed", max_iters=args.max_iters,
                   checkpoint_every=args.checkpoint_every)
        task = {"kind": args.supervise, "spec": spec.to_json(),
                "cfg": cfg, "slots": args.slots, "device": device}
        if args.supervise == "refresh":
            task["generations"] = args.generations
            task["budget_scales"] = _budget_schedule(args.generations,
                                                     args.seed)
        sup = Supervisor(root, task,
                         cfg=SupervisorConfig(ttl=args.ttl,
                                              max_restarts=args.max_restarts),
                         devices=args.world)
        out = sup.run()
        print(f"[supervisor] {out}")
        sys.exit(0 if out["ok"] else 1)
    ap.error("pick a mode: --worker, --chaos-soak, or --supervise")


if __name__ == "__main__":
    main()
