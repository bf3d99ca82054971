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
runs every row: the prefill and decode steps of every arch return the
whole (B, V) logits, the same bits on every rank, and ``init_cache``
builds the rank's block of each cache (:func:`cache_specs`); the train
step runs every row on every rank through the backward of those
collectives (:func:`loss_and_grads`: the vocab-parallel loss, each
partial leaf's gradient folded in rank order;
``optim.apply_updates(mesh=, blocks=)``: the global norm over the cut
leaves). Under FSDP (``sharding.FSDP_RULES``,
the reference's (D, 1) mesh, and the layouts of ``cfg.fsdp_mode``) each
rank stores its blocks of the leaves the reference's ``param_specs`` puts
on the world (:func:`param_specs`, :func:`shard_params`; under "zero1" the
moments' blocks, :func:`init_opt`) and runs its ``B / D`` rows as under
the batch binding; each layer gathers its leaves at use (``lm.gather``),
whose backward reduce-scatters their gradients. What the port has not
implemented raises ``NotImplementedError`` (``sharding.check_step_rules``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..core.bucketing import ordered_fold
from ..core.mesh import check_mesh
from ..core.solver import resolve_device
from ..optim import OptConfig, apply_updates, init_opt_state
from . import encdec as ed
from . import lm, sharding
from .attention import mla_heads, rank_heads
from .mamba2 import ssm_heads
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


def _seq(batch):
    """The positions of ``batch``'s sequence: its tokens and patches."""
    patches = batch.get("patches")
    return batch["tokens"].shape[1] + (0 if patches is None else patches.shape[1])


def _frames(batch):
    """The encoder's positions of an encoder-decoder's ``batch``, else None."""
    frames = batch.get("frames")
    return None if frames is None else frames.shape[1]


def _nll(params, cfg, batch):
    """(summed next-token cross-entropy, token count) of ``batch``, each
    stored block gathered at use (:func:`gather_plan`)."""
    plan = gather_plan(cfg, batch["tokens"].shape[0], _seq(batch), _frames(batch))
    if cfg.kind == "encdec":
        return ed.encdec_nll(params, cfg, batch["frames"], batch["tokens"],
                             batch["targets"], plan=plan)
    return lm.lm_nll(params, cfg, batch["tokens"], batch["targets"],
                     mask=batch.get("mask"), extra_embeds=batch.get("patches"), plan=plan)


def loss_fn(params, cfg, batch):
    """Mean next-token cross-entropy of ``batch`` (tokens, targets, and
    ``frames``, ``patches`` or ``mask`` where given)."""
    return lm.mean_nll(*_nll(params, cfg, batch))


def _world_of_training(cfg):
    """The rules' ``Mesh`` when a step trains over a world, else None. A
    world trains with "batch" on it (the batch binding,
    ``sharding.BATCH_RULES``, and FSDP, ``sharding.FSDP_RULES``: "experts"
    bound, to the world or to an axis of size 1) or with "batch" off it,
    every rank running every row (the production rules,
    ``sharding.PRODUCTION_RULES``: tensor and sequence parallelism); what
    the port has not implemented raises ``NotImplementedError``
    (``sharding.check_step_rules``)."""
    mesh = sharding.get_mesh()
    if mesh is None:
        return None
    sharding.check_step_rules()
    if sharding.on_world("batch") and sharding.mesh_axis("experts") is None:
        raise ValueError("a train step with 'batch' on the world runs under the batch "
                         "binding or FSDP: 'batch' and 'experts' bound, experts to the "
                         f"world ({sharding.WORLD!r}, sharding.BATCH_RULES) or to an axis "
                         f"of size 1 (sharding.FSDP_RULES), got experts "
                         f"{sharding.mesh_axis('experts')!r}")
    return mesh


def _partial_grads(cfg, params, blocks, batch):
    """For each leaf of ``params`` (in ``tree_leaves`` order): whether this
    rank's gradient of it is a partial to fold over the ranks, whose sum is
    the gradient. A cut leaf's (``blocks``) is the rank's own: used as it
    is stored, or gathered at use, whose backward reduce-scatters it
    (``models/lm.gather``). A whole leaf's is a partial where the rank uses
    it on its share of the work (:func:`_partial`: always where "batch" is
    on the world; otherwise by the splits in effect for this step, not from
    the leaf's name alone)."""
    partial = _partial(cfg, batch["tokens"].shape[0], _seq(batch), _frames(batch))
    return [block is None and partial(path, False)
            for (path, _), block in zip(lm.tree_leaves_with_paths(params), blocks)]


def loss_and_grads(params, cfg, batch):
    """(loss, grads): the mean loss of ``batch`` (0-dim, detached) and the
    gradient tree of ``params`` (leaf tensors; their ``.grad`` is cleared).

    Over a world of ranks (the rules carry this rank's ``Mesh``; see
    :func:`_world_of_training`) every rank gives the global ``batch`` and
    its cut tree (``shard_params``). With "batch" on the world (the batch
    binding, FSDP) the rank runs its ``B / D`` rows and differentiates its
    summed loss over the global token count (the ranks' counts folded in
    rank order, exact); the loss is the ranks' sums folded in rank order
    over that count, the same on every rank. Under the production rules
    every rank runs every row and the loss is ``lm.lm_nll``'s, the same
    bits on every rank. A whole leaf's gradient is folded where
    :func:`_partial_grads` says it is a partial: the ranks' gathered,
    folded in rank order in float32 and rounded once to the leaf's dtype
    (never a float ``all_reduce``), leaf by leaf; a cut leaf's
    (:func:`param_blocks`) is the rank's block (a leaf gathered at use
    gets its block reduce-scattered by the gather's backward), and a whole
    one's otherwise the rank's own, the same on every rank."""
    mesh = _world_of_training(cfg)
    leaves = lm.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    if mesh is not None and sharding.on_world("batch"):
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
        blocks = param_blocks(cfg, params, mesh)
        for p, fold in zip(leaves, _partial_grads(cfg, params, blocks, batch)):
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
            blocks=None if mesh is None else param_blocks(cfg, params, mesh),
            moment_blocks=None if mesh is None else moment_blocks(cfg, params, mesh))
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> (B, V) logits at the last position
    (an encoder-decoder encodes ``batch["frames"]`` and runs the decoder
    teacher-forced over the tokens)."""

    def prefill_step(params, batch):
        sharding.check_step_rules()
        batch = {k: _rank_rows(v) for k, v in batch.items()}
        seq = _seq(batch)
        plan = gather_plan(cfg, batch["tokens"].shape[0], seq, _frames(batch))
        params = lm.gather_top(params, plan)
        if cfg.kind == "encdec":
            return ed.encdec_prefill(params, cfg, batch["frames"], batch["tokens"], plan)
        h = lm.forward(params, cfg, batch["tokens"], batch.get("patches"), plan)
        return lm.prefill_logits(params, cfg, h, seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, caches, token, pos) -> (logits (B, 1, V), caches)."""

    def decode_step(params, caches, token, pos):
        sharding.check_step_rules()
        token = _rank_rows(token)
        plan = gather_plan(cfg, token.shape[0], 1)
        if cfg.kind == "encdec":
            return ed.encdec_decode_step(params, cfg, caches, token, pos, plan)
        return lm.decode_step(params, cfg, caches, token, pos, plan)
    return decode_step


def init_cache(cfg: ModelConfig, params, batch, seq_len, frames=None):
    """Zero caches for ``batch`` sequences of ``seq_len``, on the params'
    device; an encoder-decoder's also hold the cross K/V of ``frames``
    encoded. Over a world of ranks, ``batch`` and ``frames`` are global
    and the caches hold this rank's rows."""
    frames, batch = _rank_rows(frames), len(_rank_rows(range(batch)))
    if cfg.kind == "encdec":
        return ed.init_encdec_cache(params, cfg, frames, batch, seq_len,
                                    gather_plan(cfg, batch, 1))
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
    mesh; ``sharding.production_rules``). On the port's flat world,
    ``production_rules(False)`` is ``sharding.PRODUCTION_RULES``: its
    prefill, decode and train steps run for every arch, and each
    ``fsdp_mode``'s rules under a config laid out by it. The same rules on
    the reference's (D, 1) mesh are ``sharding.fsdp_rules(fsdp_mode)``."""
    return sharding.production_rules(multi_pod, fsdp_mode)


def check_rules(rules):
    """Raise ``NotImplementedError`` (as ``sharding.check_step_rules``) where
    ``rules`` cannot run a step over the world (``sharding.refusal``)."""
    why = sharding.refusal(rules)
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


# ---------------------------------------------------------------------------
# The parameter tree's layout over a world of ranks
# ---------------------------------------------------------------------------

# The keys a checkpoint or optimizer state puts in front of a parameter
# path: the checkpoint's halves and ``optim.OptState``'s fields.
_HOLDERS = ("params", "opt", "step", "mu", "nu", "err")


def _leaves_with_roles(tree):
    """(path, leaf, role) of every leaf of ``tree`` in ``jax.tree.leaves``
    order (dict keys sorted, lists, tuples and ``NamedTuple`` fields in
    order, no leaf for None); ``role``: ``sharding.leaf_role``'s."""
    out = []

    def walk(t, path, parent):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,), t)
        elif isinstance(t, (list, tuple)):
            names = getattr(t, "_fields", range(len(t)))
            for name, v in zip(names, t):
                walk(v, path + (name,), None)
        else:
            out.append((path, t, sharding.leaf_role(path, parent or {}) if path else None))
    walk(tree, (), None)
    return out


def _leaf_axes(s: str, shape) -> tuple:
    """The reference's ``_leaf_spec`` for one unstacked leaf at the path
    ``s`` ("slots/0/mixer/wq"): the mesh axis ("model", "data" for its FSDP
    axis, or None) of each dim."""
    m, f = "model", "data"
    last, nd = s.rsplit("/", 1)[-1], len(shape)
    in_ffn = "/ffn/" in s or s.endswith("ffn") or "/shared/" in s
    if last == "e":
        ax = (m, f)
    elif last in ("wq", "wk", "wv"):
        ax = (f, m, None)                   # a head dim the model axis does not
    elif last == "wo" and not in_ffn:       # divide takes it on head_dim (below)
        ax = (m, None, f)
    elif last == "wi":
        ax = (m, f, None, None) if nd == 4 else (f, None, m)
    elif last == "wo":
        ax = (m, None, f) if nd == 3 else (m, f)
    elif last in ("router", "wq_a", "wkv_a"):
        ax = (f, None)
    elif last == "in_proj":
        ax = (f, m)
    elif last == "conv_w":
        ax = (None, m)
    elif last in ("conv_b", "a_log", "d_skip", "dt_bias"):
        ax = (m,)
    elif last == "out_proj":
        ax = (m, f)
    elif last in ("wq_b", "wk_b", "wv_b"):
        ax = (None, m, None)
    elif last == "scale":
        ax = (m,) if "out_norm" in s else (None,)
    else:
        ax = ()
    return (tuple(ax) + (None,) * nd)[:nd]


def _ref_spec(cfg, path, whole_shape, sizes) -> tuple:
    """The reference's ``param_specs`` entry of the (stacked) leaf at
    ``path`` of ``shape`` on a ("data", "model") mesh of ``sizes``, after its
    ``sanitize``; with the moments' (``opt_specs`` under "zero1": the first
    free dim that the "data" axis divides) as a second tuple."""
    s = "/".join(map(str, path))
    lead = 1 if path[0] in sharding.STACKS else 0
    shape = tuple(whole_shape[lead:])
    size = lambda e: (1 if e is None else sizes["model"] * sizes["data"]  # noqa: E731
                      if e == "both" else sizes[e])
    mode = cfg.fsdp_mode
    expert = ("/ffn/" in s or s.endswith("router")) and len(shape) >= 3
    if mode in ("fsdp_only", "dp_full") and len(shape) >= 2 and not expert:
        # fsdp_only_spec: the largest dim both axes divide, else "data"
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        i = next((i for i in order if shape[i] % size("both") == 0), None)
        e = "both"
        if i is None:
            i, e = next((i for i in order if shape[i] % sizes["data"] == 0), None), "data"
        ax = tuple(e if j == i else None for j in range(len(shape)))
    else:
        ax = _leaf_axes(s, shape)
        if ax[:1] == ("data",) and s.rsplit("/", 1)[-1] in ("wq", "wk", "wv") \
                and shape[1] % sizes["model"]:
            ax = ("data", None, "model")    # few KV heads: head_dim takes "model"
        if mode in ("zero1", "none"):
            ax = tuple(None if e == "data" else e for e in ax)
    ax = (None,) * lead + tuple(e if d % size(e) == 0 else None
                                for e, d in zip(ax, shape))
    full = tuple(whole_shape)
    free = next((i for i, e in enumerate(ax) if e is None and full[i] % sizes["data"] == 0),
                None) if mode == "zero1" else None
    mom = ax if free is None else tuple("data" if i == free else e for i, e in enumerate(ax))
    return ax, mom


def layout(cfg: ModelConfig, rules=None, size=None) -> dict:
    """``{path: (store, use, moment, shape)}`` for every leaf of ``cfg``'s
    whole parameter tree (paths as ``lm.tree_leaves_with_paths`` gives
    them) under ``rules`` (default: those in effect) over a world of
    ``size`` (default: the rules' ``Mesh``'s): the dim of the stored leaf
    that each rank holds a block of, or None (kept whole); the dim it is
    used cut along (``sharding.leaf_role`` bound to the world), or None
    (used whole; a leaf stored cut and used whole is gathered at use,
    :func:`gather_plan`); the dim of its AdamW moments' blocks; and its
    whole shape.

    Where "fsdp" is on the world (``sharding.FSDP_RULES``, the reference's
    (D, 1) mesh) and wherever ``cfg.fsdp_mode`` is "fsdp_only" or
    "dp_full", the stored dim is the reference's ``param_specs``' entry of
    the world's axis ("data" on the (D, 1) mesh, "model" on the (1, D)
    one); the moments follow it but under "zero1" (D, 1), where they take
    the first free dim that D divides. Otherwise (the (1, D) mesh in the
    modes "full", "zero1" and "none", and the batch binding) a leaf is
    stored as it is used, by its role, as the port laid it out before
    FSDP. A split D does not divide is dropped (the reference's
    ``sanitize``; Mamba2's inner width by its SSD heads, :func:`_extent`).

    Mamba2's fused leaves (``in_proj``: [z | x | B | C | dt]; ``conv_w``,
    ``conv_b``: [x | B | C]) have no role there: every rank stores them
    whole and slices its heads' columns of z, x and dt and all of B and C
    at use (``models/mamba2.py``: with one group every head reads the one
    B and C), where the reference splits the fused dim evenly across the
    pieces; their gradients are folded as partials (:func:`_whole_leaf_split`).
    A layout-only difference."""
    rules = sharding.get_rules() if rules is None else rules
    mesh = sharding.get_mesh()
    size = (1 if mesh is None else mesh.size) if size is None else size
    return _layout(cfg, tuple(sorted((rules or {}).items(), key=lambda kv: str(kv[0]))),
                   size)


@functools.lru_cache(maxsize=None)
def _layout(cfg, rule_items, d):
    """:func:`layout` of the rules ``dict(rule_items)``, computed once (a
    step asks for it several times)."""
    rules = dict(rule_items)
    data = sharding.binds(rules, "fsdp")
    sizes = {"data": d, "model": 1} if data else {"data": 1, "model": d}
    axis = "data" if data else "model"
    ref = data or cfg.fsdp_mode in ("fsdp_only", "dp_full")
    out = {}
    for path, leaf, role in _leaves_with_roles(init(cfg, None, "meta")):
        shape = tuple(leaf.shape)
        use = None
        if role is not None and sharding.binds(rules, role[0]) and \
                _extent(cfg, path, shape, role[1]) % d == 0:
            use = role[1]
        if not ref:
            out[path] = (use, use, use, shape)
            continue
        on = [[i for i, e in enumerate(ax) if e in (axis, "both")]
              for ax in _ref_spec(cfg, path, shape, sizes)]
        out[path] = (on[0][0] if on[0] else None, use, on[1][0] if on[1] else None, shape)
    return out


def _extent(cfg, path, shape, dim):
    """The count that the world must divide for the leaf at ``path`` to split
    along ``dim``: the dim's length, but Mamba2's SSD heads for its inner
    width (``out_norm``, ``out_proj``'s rows), which a rank holds whole
    heads of (``mamba2.ssm_heads``)."""
    if "mixer" in path and (path[-1] == "out_proj" or "out_norm" in path):
        return cfg.mamba.n_heads(cfg.d_model)
    return shape[dim]


def _param_path(path):
    """``path`` (a leaf's keys in a checkpoint, an optimizer state or a
    parameter tree) without the holders' keys in front: (the parameter's
    path, whether the leaf is an AdamW moment)."""
    i = 0
    while i < len(path) and path[i] in _HOLDERS:
        i += 1
    return tuple(path[i:]), any(k in ("mu", "nu") for k in path[:i])


def param_blocks(cfg: ModelConfig, tree, mesh, rules=None) -> list:
    """For each leaf of ``tree`` (a parameter tree of ``cfg`` as
    :func:`shard_params` cuts it for this rank, an optimizer state
    mirroring one as :func:`init_opt` cuts it, or a dict or tuple of them,
    as a checkpoint holds them) in ``jax.tree.leaves`` order, the block
    this rank of ``mesh`` holds under ``rules`` (default: the rules in
    effect): ``(axis, rank, size)``, the ``rank``-th of ``size`` equal
    blocks along ``axis`` (:func:`layout`: the stored dim, a moment's own
    under "zero1"), else None (a whole leaf); every leaf None for one
    process. Under the batch binding only the experts' leaves are cut. The
    ``blocks`` of ``checkpoint.ckpt.save`` and ``restore`` and of
    ``optim.apply_updates``; the train step keeps a cut leaf's gradient as
    the rank's (a leaf gathered at use gets it reduce-scattered)."""
    rules = sharding.get_rules() if rules is None else rules
    mesh = check_mesh(mesh)
    if mesh is None:
        return [None] * len(_leaves_with_roles(tree))
    lay = layout(cfg, rules, mesh.size)
    out = []
    for path, _, role in _leaves_with_roles(tree):
        ppath, moment = _param_path(path)
        if ppath in lay:
            dim = lay[ppath][2 if moment else 0]
        else:                   # a subtree (a bare MoE's): its leaves' roles
            dim = (None if role is None or not sharding.binds(rules, role[0])
                   or _whole_size(cfg, path, role[0]) % mesh.size else role[1])
        out.append(None if dim is None else (dim, mesh.rank, mesh.size))
    return out


def _whole_size(cfg, path, name):
    """The whole extent of a leaf's dim named ``name`` in ``cfg``."""
    if name == "experts":
        return cfg.moe.n_experts
    if name == "vocab":
        return cfg.vocab
    if name == "heads":
        return cfg.n_heads
    if name == "kv_heads":
        return cfg.n_kv_heads
    if "shared" in path:
        return cfg.moe.n_shared * cfg.moe.d_ff
    return cfg.first_dense_ff if "block0" in path and cfg.first_dense_ff else cfg.d_ff


def moment_blocks(cfg: ModelConfig, params, mesh) -> list:
    """For each leaf of the parameter tree ``params``, its AdamW moments'
    block where it is not the leaf's own (``fsdp_mode`` "zero1" on the (D,
    1) mesh: the leaf whole, its moments cut), else None; under the rules in
    effect. ``optim.apply_updates(moment_blocks=)``."""
    mesh = check_mesh(mesh)
    if mesh is None:
        return [None] * len(_leaves_with_roles(params))
    lay = layout(cfg, sharding.get_rules(), mesh.size)
    out = []
    for path, _, _ in _leaves_with_roles(params):
        store, _, mom, _ = lay.get(path, (None, None, None, None))
        out.append(None if mom == store else (mom, mesh.rank, mesh.size))
    return out


# Mamba2's leaves (``models/mamba2.init_mamba``; its gated norm's scale
# sits under "out_norm").
_SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "out_proj")


def _whole_leaf_split(path):
    """The split besides "seq" under which a rank's gradient of the whole
    leaf at ``path`` is a partial where "batch" is off the world: "heads"
    for the attention's leaves (they serve the rank's heads: ``wk``/``wv``
    kept whole, the q and k norms, MLA's ``wq_a``, ``wkv_a`` and their
    norms, which feed every head, the encoder-decoder's self and cross
    attention), "ssm" for Mamba2's (its ``in_proj`` and conv, kept whole,
    serve the rank's SSD heads: their columns of z, x and dt take only the
    rank's gradient, exact zeros elsewhere, and the B and C columns a
    partial, so the fold adds exactly the partial part), "routed" for the
    router (the MoE's cut tokens), None for a leaf that meets only the
    residual or the replicated logits (the block norms, the final norm,
    ``e``, a dense FFN's ``wi``/``wo`` kept whole). A whole leaf this table
    does not know raises: its gradient may be a partial the fold would
    miss."""
    key = path[-1]
    mixer = any(k in sharding.MIXERS for k in path)
    if mixer and (key in _SSM_LEAVES or "out_norm" in path):
        return "ssm"
    if mixer and key in ("wq", "wk", "wv", "wo", "scale", "wq_a", "wkv_a", "wq_b", "wk_b",
                         "wv_b"):
        return "heads"
    if key == "router":
        return "routed"
    if key in ("scale", "e", "wi", "wo"):
        return None
    raise NotImplementedError("the train step's gradient fold does not know the whole "
                              f"leaf {'/'.join(map(str, path))}")


def _partial(cfg, batch: int, seq: int, frames: Optional[int] = None):
    """``partial(path, cut)``: whether this rank's gradient of the leaf at
    ``path``, used whole (``cut`` False) or cut to its block of a whole
    leaf (True), is a partial whose sum over the ranks is the gradient, in
    a step of ``batch`` rows of ``seq`` positions (an encoder-decoder's
    decoder; ``frames``: its encoder's) under the rules in effect. Where
    "batch" is on the world every leaf's is (the rank's rows); otherwise
    (every rank every row) a used-cut leaf's is, and a whole leaf's where
    the rank uses it on its share of the work, decided from the splits in
    effect for this step:

    * "seq" splits the residual (D divides the positions; the encoder's
      leaves by its frames): every leaf meets the rank's block of
      positions;
    * the heads split: the attention's leaves serve the rank's heads (MLA's
      by "heads", GQA's by :func:`attention.rank_heads`), Mamba2's its SSD
      heads (``mamba2.ssm_heads``);
    * the MoE cuts the replicated tokens (``moe.moe_train``): the router
      (:func:`_whole_leaf_split`, which refuses a leaf it does not know).

    Where a split is dropped (D does not divide it) every rank sees the same
    data, and its gradient is already whole: folding it would multiply it
    by D."""
    mesh = sharding.get_mesh()
    if mesh is None or mesh.size == 1:
        return lambda path, cut: False
    if sharding.on_world("batch"):
        return lambda path, cut: True
    seq_split = sharding.seq_range(seq) is not None
    enc_split = frames is not None and sharding.seq_range(frames) is not None
    heads = (mla_heads(cfg) if cfg.use_mla else rank_heads(cfg)) is not None
    ssm = "mamba" in cfg.pattern and ssm_heads(cfg) is not None
    routed = seq_split or (sharding.on_world("experts") and (batch * seq) % mesh.size == 0)

    def partial(path, cut):
        if cut or (enc_split if path[0] in ("enc", "enc_norm") else seq_split):
            return True
        split = _whole_leaf_split(path)
        return ((heads and split == "heads") or (ssm and split == "ssm")
                or (routed and split == "routed"))
    return partial


def gather_plan(cfg: ModelConfig, batch: int, seq: int, frames: Optional[int] = None):
    """What a step of ``batch`` rows of ``seq`` positions (and ``frames``
    encoder positions) gathers at use
    under the rules in effect: a tree nesting as the parameter tree, a
    stacked leaf's entry for one layer's slice, each leaf ``(dim, n,
    partial)`` where the rank stores a block of it along ``dim`` and uses
    it whole (or cut to another block), ``n`` the whole extent, ``partial``
    whether its gradient is (:func:`_partial`: the backward reduce-scatters
    it, else keeps the rank's block), else None; None when no leaf is
    gathered. The steps hand it to the forward (``lm.gather``)."""
    mesh = sharding.get_mesh()
    if mesh is None or mesh.size == 1:
        return None
    lay = layout(cfg)
    if all(store == use for store, use, _, _ in lay.values()):
        return None
    partial = _partial(cfg, batch, seq, frames)
    plan = {}
    for path, (store, use, _, shape) in lay.items():
        if store is not None and store != use:
            lead = 1 if path[0] in sharding.STACKS else 0
            _put(plan, path, (store - lead, shape[store], partial(path, use is not None)))
    return plan


def _put(tree, path, value):
    """Set ``tree[path]``, making the dicts (and lists, at int keys) on the
    way."""
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            while len(node) <= k:
                node.append(None)
            node[k] = child if node[k] is None else node[k]
            node = node[k]
        else:
            node = node.setdefault(k, child)
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def param_specs(cfg: ModelConfig, params):
    """For each leaf of the whole parameter tree (``init``'s, same nesting),
    the dim whose blocks the world's ranks store, or None
    (:func:`layout`): under FSDP (``sharding.FSDP_RULES``, and the
    "fsdp_only" and "dp_full" layouts on the production rules' world) the
    reference's ``param_specs`` entry of the world's mesh axis; otherwise
    each leaf's role (``sharding.leaf_role``): the expert axis where the
    rules bind "experts", under tensor parallelism the heads of ``wq`` and
    the attention ``wo`` ("heads"), of ``wk``/``wv`` ("kv_heads"), the
    columns of a dense ``wi`` and rows of its ``wo`` ("ffn", shared experts
    too), the rows of the embed and head ``e`` ("vocab"); each where the
    world's size divides it (:func:`sanitize`)."""
    lay = layout(cfg)
    return _specs(params, lambda path: lay[path][0])


def _specs(params, dim):
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        return None if t is None else dim(path)
    return walk(params, ())


def opt_specs(cfg: ModelConfig, pspecs, params=None):
    """The optimizer state's specs: the moments split as the parameters,
    or under ``fsdp_mode`` "zero1" on the (D, 1) mesh by their own blocks
    (the reference's ``shard_first_free``; ``params``: the whole tree,
    default ``init`` on meta)."""
    from ..optim import OptState
    if cfg.fsdp_mode == "zero1":
        lay = layout(cfg)
        params = init(cfg, None, "meta") if params is None else params
        pspecs = _specs(params, lambda path: lay[path][2])
    return OptState(step=None, mu=pspecs, nu=pspecs, err=None)


def _batch_dim(path):
    """The batch dim of a cache leaf: 1 under a stack over layers ("slots",
    and an encoder-decoder's "self" and "cross"), else 0."""
    return 1 if path[0] in ("slots", "self", "cross") else 0


def cache_specs(cfg: ModelConfig, cell: ShapeCell, caches):
    """For each leaf of the whole (global-batch) cache tree, the batch dim
    where the rules bind "batch" to the world (FSDP too: decided by
    whether D divides the batch, where the reference decides from ``b >=
    16``, which moves its layout only); else the dim that the rank holds a
    block of: for an attention cache's k and v the KV-head dim or the
    position dim by ``attention.kv_split`` (decided from the world's size,
    where the reference decides from a constant ``model_size`` of 16,
    which moves its layout only); for an encoder-decoder's cross k and v
    the KV-head dim where the rank's heads split (``attention.rank_heads``);
    for MLA's ``c_kv`` and ``k_rope`` the position dim where "kv_seq" is on
    the world (``attention.mla_split``); for Mamba2's SSM state the head
    dim where its SSD heads split; else None. Mamba2's conv window holds
    the rank's x channels and all of B and C (``mamba2.init_mamba_cache``),
    which is no block of the whole window: None, where the reference splits
    its channels evenly (a layout-only difference)."""
    from .attention import kv_split, mla_split
    size = _world_size("batch")

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        dim, key = _batch_dim(path), path[-1]
        if size > 1:
            return sanitize(dim, t.shape, size)
        if key in ("k", "v") and path[0] == "cross":
            return None if rank_heads(cfg) is None else dim + 2
        if key in ("k", "v"):
            split = kv_split(cfg, t.shape[dim + 1])
            return None if split is None else dim + (2 if split[0] == "heads" else 1)
        if key in ("c_kv", "k_rope"):
            return None if mla_split(t.shape[dim + 1]) is None else dim + 1
        if key == "ssm":
            return None if ssm_heads(cfg) is None else dim + 1
        return None
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
    return (ps, (opt_specs(cfg, ps, params) if cell.kind == "train" else None),
            batch_specs(cfg, cell))


def shard_params(cfg: ModelConfig, params, mesh):
    """The parameter tree with each leaf that :func:`param_specs` splits
    under the rules in effect cut to this rank's block and copied (so the
    whole tree can be freed); every other leaf is the same tensor. Under
    the batch binding it cuts what ``sharding.shard_experts`` cuts."""
    return _cut(params, param_specs(cfg, params), mesh, copy=True)


def init_opt(cfg: ModelConfig, params, opt_cfg: OptConfig, mesh=None):
    """``optim.init_opt_state`` of this rank's tree (``shard_params``'),
    each moment cut to its own block where it has one (``fsdp_mode``
    "zero1" on the (D, 1) mesh: :func:`moment_blocks`)."""
    state = init_opt_state(params, opt_cfg)
    if mesh is None:
        return state
    lay = layout(cfg, size=mesh.size)
    specs = _specs(params, lambda path: None if lay[path][2] == lay[path][0]
                   else lay[path][2])
    if not lm.tree_leaves(specs):
        return state
    return state._replace(mu=_cut(state.mu, specs, mesh, copy=True),
                          nu=_cut(state.nu, specs, mesh, copy=True))


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
