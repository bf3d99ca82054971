"""Architecture registry: --arch <id> resolution for every launcher."""
from __future__ import annotations

import importlib

ARCHS = {
    "mamba2-370m": "mamba2_370m",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "yi-34b": "yi_34b",
    "gemma-2b": "gemma_2b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-4b": "qwen3_4b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-26b": "internvl2_26b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def names():
    return list(ARCHS)
