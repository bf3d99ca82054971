"""Worker environments: which cards a spawned process may see.

Anything that spawns workers (the supervisor in
:mod:`repro_torch.launch.supervisor`, the front's replicas in
:mod:`repro_torch.launch.front`) must fix the child's devices **before**
the child's interpreter starts: CUDA reads ``CUDA_VISIBLE_DEVICES`` once,
when the process first initialises it. So that variable is the lever
here, as XLA's host-device-count flag is in the reference's
``launch/env.py`` (whose flag surgery and x64 switch have no counterpart
in the port):

* :func:`worker_env` — the subprocess environment for one worker of
  ``devices`` ranks: the base environment (default ``os.environ``) with
  the world size in ``REPRO_WORKER_WORLD`` and ``CUDA_VISIBLE_DEVICES``
  cut to the first ``devices`` of the parent's visible cards (all of them
  when there are fewer: the ranks share them round-robin, as
  ``launch/mesh.py`` places them), or emptied for a CPU worker, which then
  cannot touch a card. This is how the supervisor respawns a takeover on
  a *degraded* world, also on one card.
* :func:`set_visible_devices` — the in-process setter for the same
  variable, guarded against the footgun of calling it after this process
  has initialised CUDA (it would silently do nothing).
* :func:`describe` — the effective environment, for logs and health.
"""
from __future__ import annotations

import os
import sys
from typing import Mapping, Optional

__all__ = ["VISIBLE", "WORLD", "visible_devices", "worker_env",
           "set_visible_devices", "describe"]

VISIBLE = "CUDA_VISIBLE_DEVICES"
WORLD = "REPRO_WORKER_WORLD"            # a worker's rank count


def visible_devices(base: Optional[Mapping] = None) -> list:
    """The card ids visible to a process started with environment ``base``
    (default ``os.environ``): the entries of ``CUDA_VISIBLE_DEVICES`` when
    it is set (an empty value hides every card), else ``0 .. n-1`` for the
    n cards the driver reports (counted without initialising CUDA in this
    process)."""
    env = os.environ if base is None else base
    value = env.get(VISIBLE)
    if value is not None:
        return [v.strip() for v in value.split(",") if v.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def worker_env(devices: int, base: Optional[Mapping] = None,
               device: str = "cuda") -> dict:
    """The environment for one spawned worker of ``devices`` ranks.

    ``base`` defaults to ``os.environ`` (the worker inherits PYTHONPATH,
    locale, everything); ``REPRO_WORKER_WORLD`` carries ``devices``. For
    ``device="cuda"`` the child sees the first ``devices`` of the cards
    visible under ``base``, or all of them when fewer are visible (its
    ranks then share them); raises ValueError when none is. For
    ``device="cpu"`` it sees none (``CUDA_VISIBLE_DEVICES=""``). The
    returned dict is a copy: mutating it never touches the parent's
    environment.
    """
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    env = dict(os.environ if base is None else base)
    env[WORLD] = str(devices)
    if device == "cpu":
        env[VISIBLE] = ""
        return env
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    ids = visible_devices(env)
    if not ids:
        raise ValueError(f"a worker on cuda needs at least one visible card; "
                         f"{VISIBLE} gives none")
    env[VISIBLE] = ",".join(ids[:devices])
    return env


def _cuda_initialized() -> bool:
    """Whether this process has already initialised CUDA."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def set_visible_devices(devices: int) -> None:
    """Restrict this process to the first ``devices`` visible cards.

    Mutates ``os.environ['CUDA_VISIBLE_DEVICES']``. Must run before this
    process initialises CUDA: afterwards the variable is read-once stale
    and this raises instead of silently doing nothing. Worker processes
    should prefer :func:`worker_env`, which sets the child environment
    before its interpreter even starts.
    """
    if _cuda_initialized():
        raise RuntimeError(
            "set_visible_devices called after CUDA was initialised in this "
            "process; the visible cards are fixed at first use. Set them "
            "earlier, or spawn the work into a subprocess with worker_env()")
    os.environ.update({VISIBLE: worker_env(devices)[VISIBLE]})


def describe() -> dict:
    """The effective environment (for logs and the supervisor's status):
    the torch version, whether CUDA is available, the device count and the
    first device's name."""
    import torch

    out = {"torch": torch.__version__,
           "cuda_visible_devices": os.environ.get(VISIBLE),
           "cuda_available": torch.cuda.is_available(),
           "device_count": torch.cuda.device_count(),
           "pid": os.getpid()}
    out["device_name"] = (torch.cuda.get_device_name(0)
                          if out["cuda_available"] else None)
    return out
