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
* "batch" -> world: each rank runs the prefill and decode steps on its
  ``B / D`` rows (:func:`rank_rows`), every other weight replicated.

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
           "expert_range", "shard_experts"]

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


def shard_experts(params, mesh):
    """The parameter tree (``model.init``'s or
    ``carry.params_from_reference``'s) with each MoE's ``wi`` and ``wo`` cut
    to this rank's experts (:func:`expert_range`), copied, so the rest can
    be freed; every other leaf is the same tensor. The expert axis is dim 1
    of a leaf stacked over periods, dim 0 of a bare ``init_moe`` tree."""
    if isinstance(params, list):
        return [shard_experts(v, mesh) for v in params]
    if not isinstance(params, dict):
        return params
    if {"router", "wi", "wo"} <= params.keys():
        axis = params["wi"].dim() - 4               # (periods,) E, d, 2, f
        lo, hi = expert_range(params["wi"].shape[axis], mesh)
        return {**params, **{k: params[k].narrow(axis, lo, hi - lo).clone()
                             for k in ("wi", "wo")}}
    return {k: shard_experts(v, mesh) for k, v in params.items()}
