"""Top-level model API: shape cells, init, the prefill and decode steps
(``src/repro/models/model.py``).

    cfg    = configs.registry.get("moonshot-v1-16b-a3b")
    gen    = torch.Generator(device="cuda").manual_seed(0)
    params = init(cfg, gen, device="cuda")
    logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    caches = init_cache(cfg, params, batch, seq_len)
    logits, caches = make_decode_step(cfg)(params, caches, token, pos)

The steps are plain functions: PyTorch runs them eagerly. The port's
entry points run on the card unless asked for the CPU. The training step
comes with the training slice; the reference's input specs and sharding
rules are lowering helpers that wait for the dry-run (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.solver import resolve_device
from . import lm
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the (arch, cell) pair runs; otherwise the skip reason."""
    if cell.name == "long_500k":
        has_ssm = "mamba" in cfg.pattern
        if not has_ssm and not cfg.window:
            return ("long_500k needs sub-quadratic attention; "
                    f"{cfg.name} is pure full attention (skip per spec)")
    return None


# ---------------------------------------------------------------------------
# init / steps
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """The parameter tree on ``device``, drawn from ``gen`` (a generator on
    that device; the ``meta`` device gives shapes and dtypes only). Runs on
    the card unless asked for the CPU; raises without CUDA."""
    if cfg.kind == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model (src/repro/models/encdec.py) "
            "is not ported yet; it comes with ROADMAP A10's slice after training "
            "(Mamba2, MLA, encoder-decoder)")
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type != "meta" and gen.device.type != dev.type:
        raise ValueError(f"the generator lies on {gen.device}, the parameters "
                         f"go to {dev}")
    return lm.init_lm(gen, cfg, dev)


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> (B, V) logits at the last position."""

    def prefill_step(params, batch):
        h = lm.forward(params, cfg, batch["tokens"],
                       extra_embeds=batch.get("patches"))
        return h[:, -1] @ lm.head_params(params)["e"].to(h.dtype).T
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, caches, token, pos) -> (logits (B, 1, V), caches)."""

    def decode_step(params, caches, token, pos):
        return lm.decode_step(params, cfg, caches, token, pos)
    return decode_step


def init_cache(cfg: ModelConfig, params, batch, seq_len):
    """Zero caches for ``batch`` sequences of ``seq_len``, on the params'
    device."""
    return lm.init_cache(cfg, batch, seq_len, params["embed"]["e"].device)
