"""A world of ranks: one process per device, joined by ``torch.distributed``.

Each rank's place in the world is a ``core.mesh.Mesh`` (rank, size, device,
the gloo group and its collectives); this module starts the world and builds
the ``Mesh``. Two ways in:

* ``torchrun --nproc-per-node D -m repro_torch.launch.solve ...``: each rank
  calls :func:`init_mesh`, which reads ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` as ``torchrun`` sets them;
* :func:`run_local_world` (the launcher's ``--world D``, the tests and
  ``chip_smoke.py``): starts ``D`` fresh interpreters on this host, each
  calling ``target(mesh, *args, **kwargs)``, over a file rendezvous in a
  temporary directory, and returns rank 0's result. A rank that fails
  fails the world: the others are killed and :class:`WorldError` carries
  that rank's error. Every collective is bounded by the world's timeout.

Rank r takes the device ``cuda:{LOCAL_RANK % device_count}``, so D ranks
share one card where there is one; ``device="cpu"`` runs every rank on the
CPU. Ranks are never forked from a process that holds a CUDA context.
"""
from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..core.mesh import Mesh
from ..core.solver import resolve_device

__all__ = ["init_mesh", "run_local_world", "start_local_world",
           "LocalWorld", "WorldError", "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = 600.0
_INIT_ENV = "REPRO_MESH_INIT"          # the rendezvous of a local world
_SRC = str(Path(__file__).resolve().parents[2])


def _rank_device(device, local_rank):
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)                   # raises without CUDA
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return resolve_device(dev)


def init_mesh(device="cuda", timeout: float = DEFAULT_TIMEOUT) -> Optional[Mesh]:
    """The world this process is a rank of, or None outside one.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (as ``torchrun`` or
    :func:`run_local_world` set them; None when ``WORLD_SIZE`` is unset),
    gives the rank its device (``cuda:{LOCAL_RANK % device_count}``, or the
    CPU where ``device="cpu"``; without CUDA ``"cuda"`` raises) and joins
    the gloo process group, whose collectives time out after ``timeout``
    seconds.
    """
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=os.environ.get(_INIT_ENV, "env://"),
            rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout))
    return Mesh(rank, size, dev, dist.group.WORLD)


# --------------------------------------------------------------------------
# A local world: D rank processes on this host.
# --------------------------------------------------------------------------

class WorldError(RuntimeError):
    """A world that failed: ``rank`` is the rank that failed first (None on a
    timeout), ``returncodes`` every rank's exit code (negative: killed by
    that signal), ``detail`` the failing rank's traceback or output."""

    def __init__(self, msg, rank=None, returncodes=(), detail=""):
        super().__init__(f"{msg}\n{detail}" if detail else msg)
        self.rank, self.returncodes, self.detail = rank, list(returncodes), detail


def _target_ref(target):
    if isinstance(target, str):
        mod, _, name = target.partition(":")
        return ("module", mod, name)
    mod, name = target.__module__, target.__qualname__
    if mod == "__main__":
        main = sys.modules["__main__"]
        spec = getattr(main, "__spec__", None)
        if spec is not None and spec.name:    # run with ``python -m``
            return ("module", spec.name, name)
        return ("file", os.path.abspath(main.__file__), name)
    return ("module", mod, name)


def _resolve(ref):
    kind, where, name = ref
    if kind == "file":
        spec = importlib.util.spec_from_file_location("_repro_world_main", where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


class LocalWorld:
    """The handle of a started local world: its rank processes (``procs``),
    :meth:`wait` for rank 0's result, :meth:`kill` to SIGKILL every rank."""

    def __init__(self, procs, wdir, wall):
        self.procs, self.wdir = procs, Path(wdir)
        self.deadline = time.monotonic() + wall
        self.wall = wall

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _detail(self, rank):
        err = self.wdir / f"error.{rank}"
        if err.exists():
            return err.read_text().split("\n", 1)[1]
        log = self.wdir / f"rank{rank}.log"
        return log.read_text()[-4000:] if log.exists() else ""

    def _first_failed(self, failed):
        """The failed rank that raised first (its error file's clock); a rank
        with no error file (killed by a signal) counts as failing now."""
        def when(r):
            err = self.wdir / f"error.{r}"
            return float(err.read_text().split("\n", 1)[0]) if err.exists() else time.time()
        return min(failed, key=when)

    def wait(self):
        """Rank 0's return value once every rank exited 0. Raises
        :class:`WorldError` when a rank fails (the others are killed) or the
        timeout passes (every rank is killed)."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    time.sleep(0.5)           # let a rank that failed with it report
                    codes = [p.poll() for p in self.procs]
                    failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                    self.kill()
                    rank = self._first_failed(failed)
                    raise WorldError(
                        f"rank {rank} of {len(self.procs)} failed with exit code "
                        f"{codes[rank]}", rank,
                        [p.returncode for p in self.procs], self._detail(rank))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    self.kill()
                    raise WorldError(
                        f"the world of {len(self.procs)} did not finish within "
                        f"{self.wall} s", None, [p.returncode for p in self.procs])
                time.sleep(0.02)
            with open(self.wdir / "result.pkl", "rb") as f:
                return pickle.load(f)
        finally:
            self.kill()
            shutil.rmtree(self.wdir, ignore_errors=True)


def start_local_world(target, world: int, args=(), kwargs=None, device="cuda",
                      timeout: float = DEFAULT_TIMEOUT, echo: bool = False,
                      wall: Optional[float] = None) -> LocalWorld:
    """Start ``world`` rank processes on this host; see :func:`run_local_world`.
    ``wall`` bounds the world's run (default ``timeout``; ``inf`` for none)
    apart from each collective's ``timeout``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    wdir = Path(tempfile.mkdtemp(prefix="repro_world_"))
    payload = {"target": _target_ref(target), "args": tuple(args),
               "kwargs": dict(kwargs or {}), "device": str(device),
               "timeout": float(timeout), "sys_path": list(sys.path)}
    with open(wdir / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p])
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if torch.device(device).type == "cpu":
        # One core a CPU rank: the ranks are the parallelism.
        base.setdefault("OMP_NUM_THREADS", "1")
    base[_INIT_ENV] = f"file://{wdir / 'rendezvous'}"
    procs = []
    for r in range(world):
        rank_env = dict(base, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                        LOCAL_WORLD_SIZE=str(world))
        log = open(wdir / f"rank{r}.log", "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "from repro_torch.launch.mesh import _rank_main; _rank_main()",
             str(wdir)], env=rank_env, stdout=None if echo and r == 0 else log,
            stderr=log))
        log.close()
    return LocalWorld(procs, wdir, timeout if wall is None else wall)


def run_local_world(target, world: int, args=(), kwargs=None, device="cuda",
                    timeout: float = DEFAULT_TIMEOUT, echo: bool = False):
    """Run ``target(mesh, *args, **kwargs)`` on every rank of a world of
    ``world`` fresh processes on this host; return rank 0's result.

    ``target`` is a module-level function (or ``"module:function"``),
    imported by each rank; ``args`` and ``kwargs`` and the result must
    pickle. Each rank's ``mesh`` comes from :func:`init_mesh` on ``device``
    (D ranks share the one card where there is one). The world fails as a
    whole: when a rank exits non-zero the others are killed and
    :class:`WorldError` names it with its traceback; past ``timeout``
    seconds (which also bounds every collective) every rank is killed.
    With ``echo`` rank 0's standard output is this process's (a launcher's
    report); every other stream goes to the rank's log.
    """
    return start_local_world(target, world, args, kwargs, device, timeout,
                             echo).wait()


def _rank_main():
    """A rank process of :func:`start_local_world`."""
    wdir = Path(sys.argv[1])
    rank = int(os.environ["RANK"])
    try:
        with open(wdir / "payload.pkl", "rb") as f:
            payload = pickle.load(f)
        sys.path.extend(p for p in payload["sys_path"] if p not in sys.path)
        fn = _resolve(payload["target"])
        mesh = init_mesh(payload["device"], payload["timeout"])
        out = fn(mesh, *payload["args"], **payload["kwargs"])
        if rank == 0:
            tmp = wdir / "result.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, wdir / "result.pkl")
        mesh.barrier()
        dist.destroy_process_group()
    except BaseException:
        err = wdir / f"error.{rank}"
        err.write_text(f"{time.time()}\n{traceback.format_exc()}")
        sys.stderr.write(traceback.format_exc())
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
