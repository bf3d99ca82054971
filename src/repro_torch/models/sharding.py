"""Logical-axis rules over a world of ranks (``src/repro/models/sharding.py``).

Models name their axes logically ("batch", "seq", "heads", "ffn",
"experts", "vocab"); the launcher binds logical names to mesh axes once
(:func:`set_rules`). The reference binds them to the axes of a JAX mesh and
constrains its arrays to them. The port's world is flat (``core.mesh.Mesh``,
one process a rank), so it has one mesh axis, the world, under the name
:data:`WORLD` ("model", the reference's expert axis); the reference's other
axis names ("pod", "data") stand for axes of size 1, and binding a logical
name to them shards nothing. The rules carry the rank's ``Mesh`` where the
reference reads the active mesh.

What runs over the world:

* "experts" -> world: rank r holds the contiguous experts
  ``[r E / D, (r + 1) E / D)`` (:func:`expert_range`, :func:`shard_experts`;
  the reference's ``P(model_ax, ...)`` on ``wi``/``wo``), and the MoE takes
  its all-to-all path (``models/moe.py``), whose tokens may be cut by batch
  or by sequence;
* "batch" -> world: each rank runs the prefill, decode and train steps
  on its ``B / D`` rows (:func:`rank_rows`), every other weight
  replicated; training runs under :data:`BATCH_RULES` ("batch" and
  "experts" bound), and :func:`map_experts` cuts a tree's expert leaves
  (``models/model.param_blocks`` says which leaves are a rank's blocks);
* tensor and sequence parallelism, the names of :data:`TP_NAMES` -> world
  (the prefill, decode and train steps of every arch, under
  :data:`PRODUCTION_RULES`, the reference's ``production_rules(False)``):
  "heads" and "kv_heads" the attention heads (:func:`head_range`,
  :func:`kv_head_range`; MLA's heads and Mamba2's SSD heads by "heads"),
  "ffn" the dense FFN's columns (:func:`ffn_range`), "vocab" the
  embedding and head rows (:func:`vocab_range`), "seq" the residual
  stream between blocks (:func:`seq_range`, Megatron-style; an encoder's
  frames too), and "kv_seq" the decode cache's positions where the KV
  heads do not split (MLA's headless latent cache always).
  Each helper gives this rank's block, or None where the rules leave the
  name off the world or D does not divide it (the reference's
  ``sanitize`` drops such a split). ``models/model.param_specs`` lays the
  parameters out by the same roles (:func:`leaf_role`), and
  ``models/model.param_blocks`` says, for every leaf of a parameter,
  optimizer or checkpoint tree, the block this rank holds under the rules
  in effect (the train step's gradient fold, ``optim.apply_updates``'s
  norm and the world's checkpoint read it).

* FSDP, :data:`FSDP_RULES` (``--rules fsdp``): the reference's (D, 1)
  ("data", "model") mesh, "batch" and "fsdp" on the world and every other
  name on an axis of size 1 (:data:`UNIT`, its "model" axis). Each rank
  stores its block of the leaves the reference's ``_leaf_spec`` gives an
  FSDP entry (``models/model.layout``), runs its ``B / D`` rows, and
  gathers each block's leaves whole where it uses them (``models/lm.py``,
  ``core.mesh.all_gather``: the backward reduce-scatters their gradients).
  ``cfg.fsdp_mode`` picks the reference's layout ("full", "zero1",
  "none", "fsdp_only", "dp_full": :func:`production_rules`); the same
  modes run under the production rules on the world as its "model" axis,
  the (1, D) mesh, where "fsdp_only" and "dp_full" spread the non-expert
  weights over the world and "zero1" and "none" are the production
  layout.

The steps refuse what the port has not implemented (:func:`refusal`,
:func:`check_step_rules`: ``NotImplementedError`` naming
:data:`_UNPORTED_ITEM`): "batch" or "fsdp" on the world together with a
name of :data:`TP_NAMES` ("fsdp" also with "experts": a 2-D world).
Eager torch has nothing to constrain: :func:`constrain` returns its input,
and :func:`spec` the tuple of bound names where the reference builds a
``PartitionSpec``.
"""
from __future__ import annotations

import threading
from typing import Optional

from ..core.mesh import check_mesh, fold_sum

__all__ = ["DEFAULT_RULES", "WORLD", "TP_NAMES", "set_rules", "get_rules",
           "get_mesh", "spec", "constrain", "mesh_axis", "axis_size",
           "on_world", "binds", "refusal", "check_step_rules", "rank_rows",
           "expert_range", "shard_experts", "map_experts", "BATCH_RULES",
           "PRODUCTION_RULES", "head_range", "kv_head_range", "ffn_range",
           "vocab_range", "seq_range", "world_sum", "RULES", "leaf_role",
           "UNIT", "FSDP_MODES", "FSDP_RULES", "production_rules", "fsdp_rules",
           "rules_for", "MIXERS", "STACKS"]

_state = threading.local()

WORLD = "model"

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": "model",
    "kv_seq": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
    "fsdp": "data",
    "d_model": None,
    "state": None,
    None: None,
}

# The batch binding: "batch" and "experts" on the world, tensor and
# sequence parallelism (TP_NAMES) unbound. Training over a world runs under
# it (``launch/train.py``).
BATCH_RULES = dict(DEFAULT_RULES, batch=WORLD, seq=None, kv_seq=None, heads=None,
                   kv_heads=None, ffn=None, vocab=None)

# An axis of size 1 besides the world: under FSDP_RULES the reference's
# "model" axis of its (D, 1) mesh. A name bound to it shards nothing, but
# "experts" bound there runs the MoE's all-to-all path over a world of one
# (``models/moe.py``), as the reference's does over its model axis.
UNIT = "unit"

# The reference's layout modes (``cfg.fsdp_mode``; :func:`production_rules`).
FSDP_MODES = ("full", "zero1", "none", "fsdp_only", "dp_full")


def production_rules(multi_pod: bool, fsdp_mode: str = "full") -> dict:
    """The reference's ``production_rules`` (``src/repro/models/model.py``)
    over its mesh axes "pod", "data" and "model": the port's flat world is
    its "model" axis (the (1, D) mesh), the other two of size 1."""
    if fsdp_mode not in FSDP_MODES:
        raise ValueError(f"fsdp_mode must be one of {FSDP_MODES}, got {fsdp_mode!r}")
    rules = {"batch": ("pod", "data") if multi_pod else ("data",), "seq": "model",
             "kv_seq": "model", "heads": "model", "kv_heads": "model", "ffn": "model",
             "experts": "model", "vocab": "model", "fsdp": "data", None: None}
    if fsdp_mode == "fsdp_only":
        rules.update(heads=None, kv_heads=None, ffn=None)
    elif fsdp_mode == "dp_full":
        rules.update(batch=("data", "model"), seq="pod" if multi_pod else None,
                     kv_seq=None, heads=None, kv_heads=None, ffn=None, vocab=None)
    return rules


def fsdp_rules(fsdp_mode: str = "full") -> dict:
    """``production_rules(False, fsdp_mode)`` on the reference's (D, 1)
    mesh: its "data" axis is the world, its "model" axis :data:`UNIT`."""
    on = {"data": WORLD, "model": UNIT}
    return {k: (tuple(on.get(a, a) for a in v) if isinstance(v, tuple) else on.get(v, v))
            for k, v in production_rules(False, fsdp_mode).items()}


# The reference's production rules on one pod (``production_rules(False)``):
# "batch" and "fsdp" on its "data" axis, of size 1 in the port's flat world,
# every other name on the world.
PRODUCTION_RULES = production_rules(False)

# FSDP over the world (the reference's (D, 1) mesh, "full" mode): "batch"
# and "fsdp" on the world, tensor parallelism and the experts on UNIT.
FSDP_RULES = fsdp_rules("full")

# The rule sets a world runs under, by the name the launchers' ``--rules``
# takes (each a function of ``cfg.fsdp_mode``: :func:`rules_for`).
RULES = {"batch": BATCH_RULES, "production": PRODUCTION_RULES, "fsdp": FSDP_RULES}

# Tensor and sequence parallelism: the prefill, decode and train steps of
# every arch run with these on the world.
TP_NAMES = ("seq", "kv_seq", "heads", "kv_heads", "ffn", "vocab")
_UNPORTED_ITEM = "ROADMAP A10 item 5, second part"


def rules_for(name: str, fsdp_mode: str = "full") -> dict:
    """The rules named ``name`` (a key of :data:`RULES`) for a config laid
    out by ``fsdp_mode``: the mode's changes to the reference's production
    rules, on the (1, D) mesh ("production") or the (D, 1) mesh ("fsdp");
    the batch binding has none."""
    if name not in RULES:
        raise ValueError(f"rules must be one of {sorted(RULES)}, got {name!r}")
    if name == "production":
        return production_rules(False, fsdp_mode)
    if name == "fsdp":
        return fsdp_rules(fsdp_mode)
    return RULES[name]


def set_rules(rules: Optional[dict], mesh=None):
    """Bind logical axes to mesh axes, over ``mesh`` (this rank's
    ``core.mesh.Mesh``, or None: one process). None disables all rules."""
    _state.rules = rules
    _state.mesh = check_mesh(mesh) if rules is not None else None


def get_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def get_mesh():
    """The ``Mesh`` the rules carry, or None."""
    return getattr(_state, "mesh", None)


def spec(*logical) -> tuple:
    """The mesh axes bound to a tuple of logical names (None entries ok),
    a one-name tuple as its name (as ``PartitionSpec`` keeps it); ``()``
    without rules."""
    rules = get_rules()
    if rules is None:
        return ()
    axes = (rules.get(ax, None) for ax in logical)
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)


def constrain(x, *logical):
    """``x``: an eager tensor has no layout to constrain."""
    return x


def mesh_axis(logical: str):
    """The mesh axis (name or tuple) bound to a logical axis, or None."""
    rules = get_rules()
    if rules is None:
        return None
    return rules.get(logical, None)


def on_world(logical: str) -> bool:
    """Whether the rules in effect bind ``logical`` to the world axis."""
    return binds(get_rules(), logical)


def axis_size(logical: str) -> int:
    """Size of the mesh axis bound to a logical name: the world's size where
    the binding names :data:`WORLD` and the rules carry a mesh, else 1."""
    mesh = get_mesh()
    return mesh.size if mesh is not None and on_world(logical) else 1


def binds(rules, name) -> bool:
    """Whether ``rules`` (any dict, not only those in effect) bind ``name``
    to the world."""
    ax = (rules or {}).get(name)
    return WORLD in (ax if isinstance(ax, tuple) else (ax,))


def refusal(rules):
    """Why ``rules`` cannot run a step over the world, or None: "batch" or
    "fsdp" on it together with a name of :data:`TP_NAMES` ("fsdp" also
    with "experts"), which is a 2-D world (data x model). Each names
    :data:`_UNPORTED_ITEM`."""
    tp = [n for n in TP_NAMES if binds(rules, n)]
    model = tp + (["experts"] if binds(rules, "experts") else [])
    if binds(rules, "fsdp") and model:
        return (f"the rules bind 'fsdp' and {model} to the one world axis: a 2-D world "
                f"(data x model) is not ported ({_UNPORTED_ITEM})")
    if tp and binds(rules, "batch"):
        return (f"the rules bind 'batch' and {tp} to the one world axis: a 2-D world "
                f"(data x model) is not ported ({_UNPORTED_ITEM})")
    return None


def check_step_rules():
    """Raise ``NotImplementedError`` with :func:`refusal`'s reason where the
    rules in effect refuse the step."""
    why = refusal(get_rules())
    if why:
        raise NotImplementedError(why)


def _block(n: int, mesh, what: str):
    d = 1 if mesh is None else check_mesh(mesh).size
    if n % d:
        raise ValueError(f"{n} {what} do not split over a world of {d} ranks")
    r = 0 if mesh is None else mesh.rank
    return r * (n // d), (r + 1) * (n // d)


def rank_rows(n: int, mesh):
    """``(lo, hi)``: this rank's rows of a batch of ``n``; ``n % D`` is
    refused."""
    return _block(n, mesh, "batch rows")


def expert_range(n_experts: int, mesh):
    """``(lo, hi)``: this rank's experts of ``n_experts``; ``E % D`` is
    refused."""
    return _block(n_experts, mesh, "experts")


def _world_block(n: int, logical: str):
    """``(lo, hi)``: this rank's contiguous block of ``n`` along a dim that
    the rules bind by ``logical``; None where they do not bind it to a world
    of D > 1 or D does not divide ``n`` (the split is dropped, as the
    reference's ``sanitize`` drops one)."""
    mesh = get_mesh()
    if mesh is None or mesh.size == 1 or not on_world(logical) or n % mesh.size:
        return None
    k = n // mesh.size
    return mesh.rank * k, (mesh.rank + 1) * k


def head_range(n_heads: int):
    """This rank's q heads under "heads" (:func:`_world_block`)."""
    return _world_block(n_heads, "heads")


def kv_head_range(n_kv_heads: int):
    """This rank's KV heads under "kv_heads", where D divides them."""
    return _world_block(n_kv_heads, "kv_heads")


def ffn_range(d_ff: int):
    """This rank's columns of a dense FFN's ``d_ff`` under "ffn"."""
    return _world_block(d_ff, "ffn")


def vocab_range(vocab: int):
    """This rank's rows of the embedding and head tables under "vocab"."""
    return _world_block(vocab, "vocab")


def seq_range(seq: int):
    """This rank's positions of a prefill's residual stream under "seq"."""
    return _world_block(seq, "seq")


def world_sum(t):
    """The sum over the ranks of the rules' ``Mesh`` of their ``t`` (the
    same shape on each), gathered and folded in rank order in float32,
    rounded once to ``t``'s dtype, on ``t``'s device: every rank gets the
    same bits. Differentiable: each rank's partial takes the sum's gradient
    (``core.mesh.fold_sum``)."""
    return fold_sum(get_mesh(), t)


def _expert_axis(parent: dict, key):
    """The expert axis of ``parent[key]``, or None: an MoE's ``wi`` and
    ``wo`` are cut over their experts, dim 1 of a leaf stacked over periods,
    dim 0 of a bare ``init_moe`` tree. The one place that says which leaves
    are cut over the experts: :func:`shard_experts` (through
    :func:`map_experts`) and :func:`leaf_role` read it."""
    if key in ("wi", "wo") and {"router", "wi", "wo"} <= parent.keys():
        return parent["wi"].dim() - 4                 # (periods,) E, d, 2, f
    return None


# The parents of an attention's leaves: a block's "mixer" (GQA, MQA, MLA;
# Mamba2's leaves sit there too) and the encoder-decoder's "attn", "self"
# and "cross"; and the parameter tree's keys whose leaves are stacked over
# layers (the reference's ``stacked_prefixes``: their leading axis is the
# layer).
MIXERS = ("mixer", "attn", "self", "cross")
STACKS = ("slots", "enc", "dec")


def leaf_role(path, parent):
    """(logical name, dim) of a parameter leaf's split by the reference's
    ``_leaf_spec`` roles, the dim of the stored leaf (its layer axis first
    under "slots", "enc" and "dec"); None: kept whole (the router, the
    norms, MLA's ``wq_a``/``wkv_a``, Mamba2's fused ``in_proj`` and its
    conv). ``path`` is the leaf's keys from the root of a parameter tree,
    or of a tree that holds one (a checkpoint's ``{"params", "opt"}``, an
    optimizer state's moments); ``parent`` the dict that holds the leaf.
    ``wk``/``wv`` split on their KV heads where D divides them and are
    otherwise kept whole: the reference splits their head dim there, which
    moves its layout only. Mamba2's per-head leaves and its inner width
    (``out_norm``, ``out_proj``'s rows) split by its SSD heads ("heads");
    its ``in_proj`` ([z | x | B | C | dt]) and conv ([x | B | C]) stay
    whole, and each rank slices its heads' columns and all of B and C at
    use, where the reference splits the fused dim evenly: a layout-only
    difference (``models/mamba2.py``)."""
    key, lead = path[-1], 1 if any(k in STACKS for k in path) else 0
    ax = _expert_axis(parent, key)
    if ax is not None:
        return "experts", ax
    if key == "e":
        return "vocab", 0
    if len(path) >= 3 and path[-2] == "out_norm" and path[-3] == "mixer":
        return "heads", lead
    if len(path) >= 2 and path[-2] in MIXERS:
        return {"wq": ("heads", lead + 1), "wk": ("kv_heads", lead + 1),
                "wv": ("kv_heads", lead + 1), "wo": ("heads", lead),
                "wq_b": ("heads", lead + 1), "wk_b": ("heads", lead + 1),
                "wv_b": ("heads", lead + 1), "a_log": ("heads", lead),
                "d_skip": ("heads", lead), "dt_bias": ("heads", lead),
                "out_proj": ("heads", lead)}.get(key)
    if len(path) >= 2 and path[-2] in ("ffn", "shared"):
        return {"wi": ("ffn", lead + 2), "wo": ("ffn", lead)}.get(key)
    return None


def map_experts(fn, tree):
    """``tree`` (a parameter tree, an optimizer state mirroring one, or a
    dict, list or tuple of them) with every leaf replaced by ``fn(leaf,
    axis)``, ``axis`` its expert axis or None; None stays None."""
    def walk(t, axis):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, _expert_axis(t, k)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, None) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, None) for v in t)
        return fn(t, axis)
    return walk(tree, None)


def shard_experts(params, mesh):
    """The parameter tree (``model.init``'s or
    ``carry.params_from_reference``'s) with each MoE's ``wi`` and ``wo`` cut
    to this rank's experts (:func:`expert_range`), copied, so the rest can
    be freed; every other leaf is the same tensor."""
    def cut(a, axis):
        if axis is None:
            return a
        lo, hi = expert_range(a.shape[axis], mesh)
        return a.narrow(axis, lo, hi - lo).clone()
    return map_experts(cut, params)
