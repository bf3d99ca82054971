"""The port stands alone: no JAX, nothing of the reference package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


# The LM slices: the model stack (Mamba2 and the encoder-decoder too), the
# architecture configs, the router, the serving launcher, and training's
# optimizer, data and launcher, and the rules over a world of ranks are
# among the modules walked below.
LM_SLICE = ("repro_torch.core.moe_router", "repro_torch.launch.serve",
            "repro_torch.configs.registry", "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.gemma_2b", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.blocks",
            "repro_torch.models.lm", "repro_torch.models.model",
            "repro_torch.models.mamba2", "repro_torch.models.encdec",
            "repro_torch.configs.mamba2_370m", "repro_torch.configs.jamba_v01_52b",
            "repro_torch.configs.seamless_m4t_medium",
            "repro_torch.configs.deepseek_v2_236b",
            "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.launch.train",
            "repro_torch.data", "repro_torch.data.synth", "repro_torch.checkpoint.ckpt",
            "repro_torch.models.sharding")


def test_walk_covers_the_lm_slice():
    mods = set(_modules())
    assert set(LM_SLICE) <= mods, sorted(set(LM_SLICE) - mods)
    assert {m for m in mods if m.startswith("repro_torch.optim.")} >= {
        f"repro_torch.optim.{f.stem}" for f in (PKG / "optim").glob("*.py")
        if f.stem != "__init__"}
    assert {m for m in mods if m.startswith("repro_torch.configs.")} >= {
        f"repro_torch.configs.{f.stem}" for f in (PKG / "configs").glob("*.py")
        if f.stem != "__init__"}


def test_every_arch_config_resolves_without_jax():
    code = ("import sys\n"
            "from repro_torch.configs import registry\n"
            "from repro_torch.models import model\n"
            "for name in registry.names():\n"
            "    registry.get(name).smoke()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports_in_source(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_build_module_imports_without_nvcc(tmp_path):
    code = ("from repro_torch.kernels import _build\n"
            "try:\n"
            "    _build.nvcc()\n"
            "except RuntimeError as e:\n"
            "    print('raised', 'nvcc not found' in str(e))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised True"
