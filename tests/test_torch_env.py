"""The port's worker environments (repro_torch/launch/env.py), case for case
the reference's ``tests/test_env.py`` with ``CUDA_VISIBLE_DEVICES`` in the
place of XLA's host-device-count flag.

Pure dict behaviour is tested directly; the in-process setter's
after-initialisation guard is tested with CUDA's initialisation state
patched, since this machine has no card to initialise.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

from repro_torch.launch import env  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_worker_env_keeps_the_first_visible_cards_preserving_others():
    base = {"PYTHONPATH": "/x", env.VISIBLE: "3,1,2"}
    out = env.worker_env(2, base=base)
    assert out[env.VISIBLE] == "3,1"
    assert out["PYTHONPATH"] == "/x"
    assert env.worker_env(3, base=base)[env.VISIBLE] == "3,1,2"


def test_visible_devices_parses_and_handles_empty_and_unset():
    assert env.visible_devices({env.VISIBLE: "0, 2,"}) == ["0", "2"]
    assert env.visible_devices({env.VISIBLE: ""}) == []
    # Unset: every card the driver reports (none on this machine).
    assert env.visible_devices({}) == [str(i) for i in
                                      range(torch.cuda.device_count())]


def test_worker_env_rejects_nonpositive_and_unknown_devices():
    with pytest.raises(ValueError):
        env.worker_env(0, base={})
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        env.worker_env(1, base={}, device="tpu")


def test_worker_env_cpu_hides_every_card_without_mutating_base():
    base = {"PYTHONPATH": "/x", env.VISIBLE: "0,1"}
    out = env.worker_env(3, base=base, device="cpu")
    assert out[env.VISIBLE] == ""
    assert out["PYTHONPATH"] == "/x"
    assert base == {"PYTHONPATH": "/x", env.VISIBLE: "0,1"}, \
        "worker_env must return a copy"


def test_worker_env_defaults_to_os_environ():
    out = env.worker_env(2, device="cpu")
    # Inherits unrelated variables from the real environment.
    assert out.get("PATH") == os.environ.get("PATH")


def test_setter_raises_after_cuda_initialised(monkeypatch):
    monkeypatch.setenv(env.VISIBLE, "5,6")
    env.set_visible_devices(1)              # before CUDA: takes effect
    assert os.environ[env.VISIBLE] == "5"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="worker_env"):
        env.set_visible_devices(1)


def test_describe_reports_effective_environment():
    d = env.describe()
    assert d["torch"] == torch.__version__
    assert d["pid"] == os.getpid()
    assert d["cuda_available"] == torch.cuda.is_available()
    assert d["device_count"] == torch.cuda.device_count()
    if not d["cuda_available"]:
        assert d["device_name"] is None


def test_worker_env_raises_when_fewer_cards_are_visible():
    # Fewer cards than ranks: the world's ranks share the visible ones.
    out = env.worker_env(2, base={env.VISIBLE: "0"})
    assert (out[env.VISIBLE], out[env.WORLD]) == ("0", "2")
    with pytest.raises(ValueError, match="at least one visible card"):
        env.worker_env(1, base={env.VISIBLE: ""})


def test_cpu_worker_child_sees_no_card():
    wenv = env.worker_env(1, device="cpu")
    wenv["PYTHONPATH"] = str(ROOT / "src")
    code = ("import os, torch\n"
            "print(repr(os.environ['CUDA_VISIBLE_DEVICES']), "
            "torch.cuda.device_count())\n")
    out = subprocess.run([sys.executable, "-c", code], env=wenv,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["''", "0"]
