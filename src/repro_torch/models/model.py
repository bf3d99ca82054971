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

An encoder-decoder (``cfg.kind == "encdec"``) takes ``frames`` (B, F,
d_model) in its batches and in ``init_cache``.

The steps are plain functions: PyTorch runs them eagerly. The train step
updates the parameters (leaf tensors with ``requires_grad``) and the
optimizer state in place, where the reference donates them to its jitted
step. The port's entry points run on the card unless asked for the CPU.
The reference's input specs and sharding specs are lowering helpers that
wait for the dry-run (ROADMAP A10).

Over a world of ranks, every rank runs the same steps under
``sharding.set_rules(rules, mesh=)`` with "batch" and "experts" bound to
the world: each rank draws (or carries) the whole tree, keeps its experts
(``sharding.shard_experts``), and gives the steps and ``init_cache`` the
global batch, of which it takes its ``B / D`` rows; the steps return the
logits of those rows, and ``init_cache`` builds caches of them. The
train step runs there too (:func:`loss_and_grads`: the rank's rows, the
backward through the all-to-all, the replicated leaves' gradients folded
in rank order; ``optim.apply_updates(mesh=)``: the global norm). Bindings
the port has not implemented raise ``NotImplementedError``
(``sharding.check_step_rules``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.bucketing import ordered_fold
from ..core.solver import resolve_device
from ..optim import OptConfig, apply_updates
from . import encdec as ed
from . import lm, sharding
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
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type != "meta" and gen.device.type != dev.type:
        raise ValueError(f"the generator lies on {gen.device}, the parameters "
                         f"go to {dev}")
    if cfg.kind == "encdec":
        return ed.init_encdec(gen, cfg, dev)
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


def _rank_rows(a):
    """This rank's rows of ``a`` (a tensor or range whose first axis is the
    global batch) where the rules bind "batch" to the world; ``a``
    otherwise."""
    sharding.check_step_rules()
    mesh = sharding.get_mesh()
    if a is None or mesh is None or not sharding.on_world("batch"):
        return a
    lo, hi = sharding.rank_rows(len(a), mesh)
    return a[lo:hi]


def _nll(params, cfg, batch):
    """(summed next-token cross-entropy, token count) of ``batch``."""
    if cfg.kind == "encdec":
        return ed.encdec_nll(params, cfg, batch["frames"], batch["tokens"],
                             batch["targets"])
    return lm.lm_nll(params, cfg, batch["tokens"], batch["targets"],
                     mask=batch.get("mask"), extra_embeds=batch.get("patches"))


def loss_fn(params, cfg, batch):
    """Mean next-token cross-entropy of ``batch`` (tokens, targets, and
    ``frames``, ``patches`` or ``mask`` where given)."""
    return lm.mean_nll(*_nll(params, cfg, batch))


def _world_of_training():
    """The rules' ``Mesh`` when a step trains over a world, else None. A
    world trains under the batch binding only (``sharding.BATCH_RULES``):
    the bindings of ``sharding.UNPORTED`` raise ``NotImplementedError``,
    and "batch" and "experts" must be bound to the world."""
    mesh = sharding.get_mesh()
    if mesh is None:
        return None
    sharding.check_step_rules()
    if not (sharding.on_world("batch") and sharding.on_world("experts")):
        raise ValueError("a train step over a world runs under the batch binding: "
                         "'batch' and 'experts' bound to the world "
                         f"({sharding.WORLD!r}, sharding.BATCH_RULES), got batch "
                         f"{sharding.mesh_axis('batch')!r}, experts "
                         f"{sharding.mesh_axis('experts')!r}")
    return mesh


def loss_and_grads(params, cfg, batch):
    """(loss, grads): the mean loss of ``batch`` (0-dim, detached) and the
    gradient tree of ``params`` (leaf tensors; their ``.grad`` is cleared).

    Over a world of ranks (the rules carry this rank's ``Mesh``; see
    :func:`_world_of_training`) every rank gives the global ``batch`` and
    its cut tree (``sharding.shard_experts``). The rank runs its ``B / D``
    rows and differentiates its summed loss over the global token count
    (the ranks' counts folded in rank order, exact); the loss is the ranks'
    sums folded in rank order over that count, the same on every rank. A
    replicated leaf's gradient is the ranks' gathered, folded in rank order
    in float32 and rounded once to the leaf's dtype (never a float
    ``all_reduce``), leaf by leaf; an expert leaf's stays the rank's."""
    mesh = _world_of_training()
    leaves = lm.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    if mesh is None:
        loss = loss_fn(params, cfg, batch)
        loss.backward()
    else:
        total, count = _nll(params, cfg, {k: _rank_rows(v) for k, v in batch.items()})
        dev = total.device
        count = ordered_fold(mesh.gather(count.detach())).to(dev)
        lm.mean_nll(total, count).backward()
        loss = lm.mean_nll(ordered_fold(mesh.gather(total.detach())).to(dev), count)
    grads = {id(p): torch.zeros_like(p) if p.grad is None else p.grad for p in leaves}
    for p in leaves:
        p.grad = None                     # never accumulated across steps
    if mesh is not None:
        for p, ax in zip(leaves, sharding.expert_axes(params)):
            if ax is None:
                g = grads[id(p)]
                grads[id(p)] = ordered_fold(mesh.gather(g).to(g.device),
                                            dtype=torch.float32).to(g.dtype)
    return loss.detach(), lm.tree_map(lambda p: grads[id(p)], params)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the loss's gradients (:func:`loss_and_grads`, over a world too), then
    one AdamW step, both in place. ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` (0-dim tensors), the same on every rank of a
    world."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        params, opt_state, metrics = apply_updates(params, grads, opt_state, opt_cfg,
                                                   mesh=sharding.get_mesh())
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> (B, V) logits at the last position
    (an encoder-decoder encodes ``batch["frames"]`` and runs the decoder
    teacher-forced over the tokens)."""

    def prefill_step(params, batch):
        batch = {k: _rank_rows(v) for k, v in batch.items()}
        if cfg.kind == "encdec":
            memory = ed.encode(params, cfg, batch["frames"])
            h = ed.decode_train(params, cfg, batch["tokens"], memory)
        else:
            h = lm.forward(params, cfg, batch["tokens"],
                           extra_embeds=batch.get("patches"))
        return h[:, -1] @ lm.head_params(params)["e"].to(h.dtype).T
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, caches, token, pos) -> (logits (B, 1, V), caches)."""

    def decode_step(params, caches, token, pos):
        token = _rank_rows(token)
        if cfg.kind == "encdec":
            return ed.encdec_decode_step(params, cfg, caches, token, pos)
        return lm.decode_step(params, cfg, caches, token, pos)
    return decode_step


def init_cache(cfg: ModelConfig, params, batch, seq_len, frames=None):
    """Zero caches for ``batch`` sequences of ``seq_len``, on the params'
    device; an encoder-decoder's also hold the cross K/V of ``frames``
    encoded. Over a world of ranks, ``batch`` and ``frames`` are global
    and the caches hold this rank's rows."""
    frames, batch = _rank_rows(frames), len(_rank_rows(range(batch)))
    if cfg.kind == "encdec":
        return ed.init_encdec_cache(params, cfg, frames, batch, seq_len)
    return lm.init_cache(cfg, batch, seq_len, params["embed"]["e"].device)
