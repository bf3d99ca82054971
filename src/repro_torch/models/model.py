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

The reference's lowering helpers are here in the port's terms, for the
dry-run (``launch/dryrun.py``): :func:`input_specs` gives a cell's inputs
as ``meta`` tensors, and :func:`param_specs`, :func:`opt_specs`,
:func:`batch_specs`, :func:`cache_specs` and :func:`shardings` give, for
each leaf, the dim that the rules in effect split over the world, or
None (:func:`sanitize` drops a split that does not divide).

Over a world of ranks, every rank runs the same steps under
``sharding.set_rules(rules, mesh=)`` and gives them and ``init_cache`` the
global batch. Under the batch binding ("batch" and "experts" bound to the
world, ``sharding.BATCH_RULES``) each rank draws (or carries) the whole
tree, keeps its experts (``sharding.shard_experts``) and takes its
``B / D`` rows; the steps return the logits of those rows, and
``init_cache`` builds caches of them. The train step runs there too
(:func:`loss_and_grads`: the rank's rows, the backward through the
all-to-all, the replicated leaves' gradients folded in rank order;
``optim.apply_updates(mesh=)``: the global norm). Under the reference's
production rules (``sharding.PRODUCTION_RULES``: tensor and sequence
parallelism, "batch" off the world) each rank keeps its block of every
leaf that :func:`param_specs` splits (:func:`shard_params`) and every rank
runs every row: the prefill and decode steps of the attention LMs return
the whole (B, V) logits, the same bits on every rank, and ``init_cache``
builds the rank's block of each KV cache; the train step runs every row
on every rank through the backward of those collectives
(:func:`loss_and_grads`: the vocab-parallel loss, each partial leaf's
gradient folded in rank order; ``optim.apply_updates(mesh=, blocks=)``:
the global norm over the cut leaves). What the port has not implemented
raises ``NotImplementedError`` (``sharding.check_step_rules``).
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
    otherwise (under the production rules every rank runs every row)."""
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


def _world_of_training(cfg):
    """The rules' ``Mesh`` when a step trains over a world, else None. A
    world trains under the batch binding ("batch" and "experts" bound to
    the world, ``sharding.BATCH_RULES``) or with "batch" off the world,
    every rank running every row (the production rules,
    ``sharding.PRODUCTION_RULES``: tensor and sequence parallelism); what
    the port has not implemented raises ``NotImplementedError``
    (``sharding.check_step_rules``)."""
    mesh = sharding.get_mesh()
    if mesh is None:
        return None
    sharding.check_step_rules(cfg, "train")
    if sharding.on_world("batch") and not sharding.on_world("experts"):
        raise ValueError("a train step with 'batch' on the world runs under the batch "
                         "binding: 'batch' and 'experts' bound to the world "
                         f"({sharding.WORLD!r}, sharding.BATCH_RULES), got experts "
                         f"{sharding.mesh_axis('experts')!r}")
    return mesh


def _whole_leaf_split(path):
    """The split besides "seq" under which a rank's gradient of the whole
    leaf at ``path`` is a partial: "heads" for the attention's leaves (they
    serve the rank's heads: ``wk``/``wv`` kept whole, the q and k norms),
    "routed" for the router (the MoE's cut tokens), None for a leaf that
    meets only the residual or the replicated logits (the block norms, the
    final norm, ``e``, a dense FFN's ``wi``/``wo`` kept whole). A whole leaf
    this table does not know raises: its gradient may be a partial the
    fold would miss."""
    key = path[-1]
    if "mixer" in path and key in ("wq", "wk", "wv", "wo", "scale"):
        return "heads"
    if key == "router":
        return "routed"
    if key in ("scale", "e", "wi", "wo"):
        return None
    raise NotImplementedError("the train step's gradient fold does not know the whole "
                              f"leaf {'/'.join(map(str, path))}")


def _partial_grads(cfg, params, blocks, batch):
    """For each leaf of ``params`` (in ``tree_leaves`` order) under rules
    that keep "batch" off the world: whether this rank's gradient of it is
    a partial, whose sum over the ranks is the gradient. A cut leaf's
    (``blocks``) is the rank's own. A whole leaf's is a partial where the
    rank uses it on its share of the work, and whole where every rank does
    the same work with it; which one is decided from the splits in effect
    for this step, not from the leaf's name alone:

    * "seq" splits the residual (D divides the positions): every whole
      leaf meets the rank's block of positions (the norms, the router,
      uncut projections; the embedding's lookup and the loss's rows);
    * the heads split: the attention's whole leaves serve the rank's heads;
    * the MoE cuts the replicated tokens (``moe.moe_train``): the router
    (:func:`_whole_leaf_split`, which refuses a whole leaf it does not know).

    Where a split is dropped (D does not divide it) every rank sees the same
    data, and its gradient is already whole: folding it would multiply it
    by D."""
    from .attention import rank_heads

    mesh = sharding.get_mesh()
    tokens = batch["tokens"]
    patches = batch.get("patches")
    s = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    seq = sharding.seq_range(s) is not None
    heads = rank_heads(cfg) is not None
    routed = seq or (sharding.on_world("experts") and (tokens.shape[0] * s) % mesh.size == 0)
    out = []
    for (path, _), block in zip(lm.tree_leaves_with_paths(params), blocks):
        split = None if block is not None else _whole_leaf_split(path)
        out.append(block is None and (seq or (heads and split == "heads")
                                      or (routed and split == "routed")))
    return out


def loss_and_grads(params, cfg, batch):
    """(loss, grads): the mean loss of ``batch`` (0-dim, detached) and the
    gradient tree of ``params`` (leaf tensors; their ``.grad`` is cleared).

    Over a world of ranks (the rules carry this rank's ``Mesh``; see
    :func:`_world_of_training`) every rank gives the global ``batch`` and
    its cut tree (``shard_params``). Under the batch binding the rank runs
    its ``B / D`` rows and differentiates its summed loss over the global
    token count (the ranks' counts folded in rank order, exact); the loss
    is the ranks' sums folded in rank order over that count, the same on
    every rank, and every leaf but the experts' is a partial. Under the
    production rules every rank runs every row and the loss is
    ``lm.lm_nll``'s, the same bits on every rank; a leaf is a partial
    where :func:`_partial_grads` says so. A partial's gradient is the
    ranks' gathered, folded in rank order in float32 and rounded once to
    the leaf's dtype (never a float ``all_reduce``), leaf by leaf; a cut
    leaf's (``sharding.param_blocks``) stays the rank's, and a whole one's
    is the rank's own, the same on every rank."""
    mesh = _world_of_training(cfg)
    leaves = lm.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    if mesh is None:
        loss = loss_fn(params, cfg, batch)
        loss.backward()
    elif sharding.on_world("batch"):
        total, count = _nll(params, cfg, {k: _rank_rows(v) for k, v in batch.items()})
        dev = total.device
        count = ordered_fold(mesh.gather(count.detach())).to(dev)
        lm.mean_nll(total, count).backward()
        loss = lm.mean_nll(ordered_fold(mesh.gather(total.detach())).to(dev), count)
    else:
        loss = loss_fn(params, cfg, batch)
        loss.backward()
    grads = {id(p): torch.zeros_like(p) if p.grad is None else p.grad for p in leaves}
    for p in leaves:
        p.grad = None                     # never accumulated across steps
    if mesh is not None:
        blocks = sharding.param_blocks(cfg, params, mesh)
        partial = ([b is None for b in blocks] if sharding.on_world("batch")
                   else _partial_grads(cfg, params, blocks, batch))
        for p, fold in zip(leaves, partial):
            if fold:
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
        mesh = sharding.get_mesh()
        params, opt_state, metrics = apply_updates(
            params, grads, opt_state, opt_cfg, mesh=mesh,
            blocks=None if mesh is None else sharding.param_blocks(cfg, params, mesh))
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> (B, V) logits at the last position
    (an encoder-decoder encodes ``batch["frames"]`` and runs the decoder
    teacher-forced over the tokens)."""

    def prefill_step(params, batch):
        sharding.check_step_rules(cfg, "prefill")
        batch = {k: _rank_rows(v) for k, v in batch.items()}
        if cfg.kind == "encdec":
            memory = ed.encode(params, cfg, batch["frames"])
            h = ed.decode_train(params, cfg, batch["tokens"], memory)
            return h[:, -1] @ lm.head_params(params)["e"].to(h.dtype).T
        patches = batch.get("patches")
        h = lm.forward(params, cfg, batch["tokens"], extra_embeds=patches)
        seq = batch["tokens"].shape[1] + (0 if patches is None else patches.shape[1])
        return lm.prefill_logits(params, cfg, h, seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, caches, token, pos) -> (logits (B, 1, V), caches)."""

    def decode_step(params, caches, token, pos):
        sharding.check_step_rules(cfg, "decode")
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


# ---------------------------------------------------------------------------
# Lowering helpers in the port's terms (the dry-run's currency)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell, params=None):
    """The cell's inputs as ``meta`` tensors of the dtypes the port's callers
    give (``data.synth.lm_batch``'s int64 tokens). A decode cell's are
    ``caches`` (``init_cache`` on meta, from ``params`` or a meta tree;
    over a world, under the rules in effect, the rank's rows), ``token``
    and ``pos``, the cache's last index."""
    b, tl = cell.global_batch, _text_len(cfg, cell.seq_len)
    meta = torch.device("meta")
    frames = (torch.empty((b, _frames_len(cfg, cell.seq_len), cfg.d_model),
                          dtype=cfg.dtype, device=meta) if cfg.kind == "encdec" else None)
    if cell.kind in ("train", "prefill"):
        batch = {"tokens": torch.empty((b, tl), dtype=torch.long, device=meta)}
        if cell.kind == "train":
            batch["targets"] = torch.empty((b, tl), dtype=torch.long, device=meta)
        if frames is not None:
            batch["frames"] = frames
        if cfg.n_patches:
            batch["patches"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                           dtype=cfg.dtype, device=meta)
        return batch
    params = init(cfg, None, "meta") if params is None else params
    with torch.no_grad():
        caches = init_cache(cfg, params, b, cell.seq_len, frames=frames)
    return {"caches": caches, "token": torch.empty((b, 1), dtype=torch.long, device=meta),
            "pos": cell.seq_len - 1}


def production_rules(multi_pod: bool, fsdp_mode: str = "full"):
    """The reference's production rule dicts (its 16 x 16 or 2 x 16 x 16
    mesh). On the port's flat world, ``production_rules(False)`` is
    ``sharding.PRODUCTION_RULES``: its prefill, decode and train steps run
    for the attention LMs (:func:`check_rules` refuses the rest)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    rules = {"batch": batch, "seq": "model", "kv_seq": "model", "heads": "model",
             "kv_heads": "model", "ffn": "model", "experts": "model", "vocab": "model",
             "fsdp": "data", None: None}
    if fsdp_mode == "fsdp_only":
        rules.update(heads=None, kv_heads=None, ffn=None)
    elif fsdp_mode == "dp_full":
        rules.update(batch=("data", "model"), seq="pod" if multi_pod else None,
                     kv_seq=None, heads=None, kv_heads=None, ffn=None, vocab=None)
    return rules


def check_rules(rules, cfg=None, kind=None):
    """Raise ``NotImplementedError`` (as ``sharding.check_step_rules``) where
    ``rules`` cannot run a ``kind`` step of ``cfg`` over the world
    (``sharding.refusal``)."""
    why = sharding.refusal(rules, cfg, kind)
    if why:
        raise NotImplementedError(why)


def _world_size(logical):
    return sharding.axis_size(logical)


def sanitize(dim, shape, size=None):
    """``dim`` where ``size`` (default: the world's, where the rules bind
    "batch") divides ``shape[dim]``, else None: the split is dropped, as
    the reference's ``sanitize`` drops an entry that does not divide."""
    size = _world_size("batch") if size is None else size
    if dim is None or size <= 1 or shape[dim] % size:
        return None
    return dim


def param_specs(cfg: ModelConfig, params):
    """For each leaf of the whole parameter tree (``init``'s, same nesting),
    the dim split over the world, or None: the expert axis where the rules
    bind "experts" (``sharding.leaf_role``); under tensor parallelism the
    heads of ``wq`` and the attention ``wo`` ("heads"), of ``wk``/``wv``
    ("kv_heads"), the columns of a dense ``wi`` and rows of its ``wo``
    ("ffn", shared experts too), the rows of the embed and head ``e``
    ("vocab"); each where the world's size divides it (:func:`sanitize`)."""
    def walk(t, path, parent):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,), t) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,), None) for i, v in enumerate(t)]
        role = sharding.leaf_role(path, parent or {})
        if role is None or t is None or not sharding.on_world(role[0]):
            return None
        return sanitize(role[1], t.shape, _world_size(role[0]))
    return walk(params, (), None)
def opt_specs(cfg: ModelConfig, pspecs):
    """The optimizer state's specs: the moments split as the parameters."""
    from ..optim import OptState
    return OptState(step=None, mu=pspecs, nu=pspecs, err=None)


def _batch_dim(path):
    """The batch dim of a cache leaf: 1 under a stack over layers ("slots",
    and an encoder-decoder's "self" and "cross"), else 0."""
    return 1 if path[0] in ("slots", "self", "cross") else 0


def cache_specs(cfg: ModelConfig, cell: ShapeCell, caches):
    """For each leaf of the whole (global-batch) cache tree, the batch dim
    where the rules bind "batch" to the world; else for an attention
    cache's k and v the KV-head dim or the position dim by
    ``attention.kv_split`` (decided from the world's size, where the
    reference decides from a constant ``model_size`` of 16, which moves
    its layout only); else None."""
    from .attention import kv_split
    size = _world_size("batch")

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        dim = _batch_dim(path)
        if size > 1 or path[-1] not in ("k", "v"):
            return sanitize(dim, t.shape, size)
        split = kv_split(cfg, t.shape[dim + 1])
        return None if split is None else dim + (2 if split[0] == "heads" else 1)
    return walk(caches, ())


def batch_specs(cfg: ModelConfig, cell: ShapeCell, caches=None):
    """The cell's inputs' specs: dim 0 of each batch input (dim 1 of the
    stacked caches, :func:`cache_specs` of ``caches``, whole) where the
    rules bind "batch" to the world, else None."""
    b = cell.global_batch
    row = sanitize(0, (b,))
    if cell.kind in ("train", "prefill"):
        names = ["tokens"] + (["targets"] if cell.kind == "train" else [])
        names += (["frames"] if cfg.kind == "encdec" else []) + (
            ["patches"] if cfg.n_patches else [])
        return {k: row for k in names}
    return {"caches": None if caches is None else cache_specs(cfg, cell, caches),
            "token": row, "pos": None}


def shardings(cfg: ModelConfig, cell: ShapeCell, params=None):
    """(param_specs, opt_specs or None, batch_specs) of a cell under the
    rules in effect; ``params``: the whole tree (default: ``init`` on
    meta)."""
    params = init(cfg, None, "meta") if params is None else params
    ps = param_specs(cfg, params)
    return ps, (opt_specs(cfg, ps) if cell.kind == "train" else None), batch_specs(cfg, cell)


def shard_params(cfg: ModelConfig, params, mesh):
    """The parameter tree with each leaf that :func:`param_specs` splits
    under the rules in effect cut to this rank's block and copied (so the
    whole tree can be freed); every other leaf is the same tensor. Under
    the batch binding it cuts what ``sharding.shard_experts`` cuts."""
    return _cut(params, param_specs(cfg, params), mesh, copy=True)


def cut(tree, specs, mesh):
    """This rank's block of each leaf of ``tree`` along its spec's dim (the
    ``rank``-th of ``size`` equal blocks), a view; a None spec keeps the
    leaf whole."""
    return _cut(tree, specs, mesh)


def _cut(tree, specs, mesh, copy=False):
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, w) for v, w in zip(t, s)]
        if s is None or t is None:
            return t
        step = t.shape[s] // mesh.size
        block = t.narrow(s, mesh.rank * step, step)
        return block.clone() if copy else block
    return walk(tree, specs)
