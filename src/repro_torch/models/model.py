"""Top-level model API: shape cells, init, the train, prefill and decode
steps (``src/repro/models/model.py``).

    cfg    = configs.registry.get("moonshot-v1-16b-a3b")
    gen    = torch.Generator(device="cuda").manual_seed(0)
    params = init(cfg, gen, device="cuda")
    state  = optim.init_opt_state(params, opt_cfg)
    params, state, metrics = make_train_step(cfg, opt_cfg)(params, state, batch)
    logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    caches = init_cache(cfg, params, batch, seq_len)
    logits, caches = make_decode_step(cfg)(params, caches, token, pos)

The steps are plain functions: PyTorch runs them eagerly. The train step
updates the parameters (leaf tensors with ``requires_grad``) and the
optimizer state in place, where the reference donates them to its jitted
step. The port's entry points run on the card unless asked for the CPU.
The reference's input specs and sharding rules are lowering helpers that
wait for the dry-run (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.solver import resolve_device
from ..optim import OptConfig, apply_updates
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

def _check_kind(cfg):
    if cfg.kind == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model (src/repro/models/encdec.py) "
            "is not ported yet; it comes with ROADMAP A10's next slice "
            "(Mamba2, MLA, encoder-decoder)")


def init(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """The parameter tree on ``device``, drawn from ``gen`` (a generator on
    that device; the ``meta`` device gives shapes and dtypes only). Runs on
    the card unless asked for the CPU; raises without CUDA."""
    _check_kind(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type != "meta" and gen.device.type != dev.type:
        raise ValueError(f"the generator lies on {gen.device}, the parameters "
                         f"go to {dev}")
    return lm.init_lm(gen, cfg, dev)


def _frames_len(cfg, seq_len):
    # audio stub: encoder frames take half the cell's token budget
    return max(seq_len // 2, 8)


def _text_len(cfg, seq_len):
    if cfg.kind == "encdec":
        return max(seq_len - _frames_len(cfg, seq_len), 8)
    if cfg.n_patches:
        return max(seq_len - cfg.n_patches, 8)
    return seq_len


def loss_fn(params, cfg, batch):
    """Mean next-token cross-entropy of ``batch`` (tokens, targets, and
    ``patches`` or ``mask`` where given)."""
    _check_kind(cfg)
    return lm.lm_loss(params, cfg, batch["tokens"], batch["targets"],
                      mask=batch.get("mask"), extra_embeds=batch.get("patches"))


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the loss's gradients, then one AdamW step, both in place. ``metrics``
    holds ``loss``, ``grad_norm`` and ``lr`` (0-dim tensors)."""
    _check_kind(cfg)

    def train_step(params, opt_state, batch):
        leaves = lm.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, cfg, batch)
        loss.backward()
        grads = lm.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
        for p in leaves:
            p.grad = None                 # never accumulated across steps
        params, opt_state, metrics = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), **metrics}
    return train_step


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
