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
  "experts" bound), and :func:`map_experts` / :func:`expert_axes` say
  which leaves of a tree (parameters, optimizer state, checkpoint) are
  the rank's blocks of the experts.

The steps refuse the bindings the port has not implemented
(:data:`UNPORTED`: tensor and sequence parallelism) with
``NotImplementedError`` (:func:`check_step_rules`). Eager torch has nothing
to constrain: :func:`constrain` returns its input, and :func:`spec` the
tuple of bound names where the reference builds a ``PartitionSpec``.
"""
from __future__ import annotations

import threading
from typing import Optional

from ..core.mesh import check_mesh

__all__ = ["DEFAULT_RULES", "WORLD", "UNPORTED", "set_rules", "get_rules",
           "get_mesh", "spec", "constrain", "mesh_axis", "axis_size",
           "on_world", "check_step_rules", "rank_rows",
           "expert_range", "shard_experts", "map_experts", "expert_axes",
           "expert_blocks", "BATCH_RULES"]

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

# The batch binding: "batch" and "experts" on the world, every name the
# steps refuse over a world (UNPORTED) unbound. Training over a world runs
# under it (``launch/train.py``).
BATCH_RULES = dict(DEFAULT_RULES, batch=WORLD, seq=None, kv_seq=None, heads=None,
                   kv_heads=None, ffn=None, vocab=None)

# Bindings the steps refuse on the world.
UNPORTED = ("seq", "kv_seq", "heads", "kv_heads", "ffn", "vocab")
_UNPORTED_ITEM = ("ROADMAP A10, 'tensor and sequence parallelism over the "
                  "world'")


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
    """Whether the rules bind ``logical`` to the world axis."""
    ax = mesh_axis(logical)
    return WORLD in (ax if isinstance(ax, tuple) else (ax,))


def axis_size(logical: str) -> int:
    """Size of the mesh axis bound to a logical name: the world's size where
    the binding names :data:`WORLD` and the rules carry a mesh, else 1."""
    mesh = get_mesh()
    return mesh.size if mesh is not None and on_world(logical) else 1


def check_step_rules():
    """Raise ``NotImplementedError`` where the rules bind a name of
    :data:`UNPORTED` to the world."""
    bound = [ax for ax in UNPORTED if on_world(ax)]
    if bound:
        raise NotImplementedError(
            f"the rules bind {bound} to the world ({WORLD!r}); the port runs "
            f"a step over a world with 'batch' and 'experts' bound only: "
            f"{_UNPORTED_ITEM} is not ported")


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


def _expert_axis(parent: dict, key):
    """The expert axis of ``parent[key]``, or None: an MoE's ``wi`` and
    ``wo`` are cut over their experts, dim 1 of a leaf stacked over periods,
    dim 0 of a bare ``init_moe`` tree. The one place that says which leaves
    are cut over the experts: :func:`shard_experts`, the train step's
    gradient fold, ``optim.apply_updates``'s norm and the world's
    checkpoint read it through :func:`map_experts` and :func:`expert_axes`."""
    if key in ("wi", "wo") and {"router", "wi", "wo"} <= parent.keys():
        return parent["wi"].dim() - 4                 # (periods,) E, d, 2, f
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


def expert_axes(tree) -> list:
    """The expert axis of each leaf of ``tree`` (None: a whole leaf), in the
    order of ``jax.tree.leaves`` (dict keys sorted, lists and tuples in
    order, no leaf for None)."""
    out = []

    def walk(t, axis):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], _expert_axis(t, k))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, None)
        elif t is not None:
            out.append(axis)
    walk(tree, None)
    return out


def expert_blocks(tree, mesh) -> list:
    """For each leaf of ``tree`` in ``expert_axes`` order, the block that
    this rank of ``mesh`` holds: ``(axis, rank, size)`` for an expert leaf
    (the ``rank``-th of ``size`` equal blocks along ``axis``), None for a
    whole leaf, every leaf for one process (``mesh=None``); the ``blocks``
    of ``checkpoint.ckpt.save`` and ``restore``."""
    axes = expert_axes(tree)
    if check_mesh(mesh) is None:
        return [None] * len(axes)
    return [None if ax is None else (ax, mesh.rank, mesh.size) for ax in axes]


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
