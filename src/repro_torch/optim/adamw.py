"""AdamW with global-norm clipping and optional int8 error-feedback
gradient compression (``src/repro/optim/adamw.py``).

The optimizer state mirrors the parameter tree: float32 moments ``mu`` and
``nu`` per parameter, ``step`` an int32 tensor, and with compression the
error-feedback accumulator ``err`` (Seide et al. / EF-SGD): gradients are
quantised to int8 with a per-tensor scale, the quantisation error is kept
and added back next step.

The arithmetic is the reference's, in its order and in float32:
``m = b1*m + (1-b1)*g``, ``mhat = m / (1 - b1**step)``, ``delta =
mhat/(sqrt(vhat)+eps) + wd*p``, ``p - lr*delta`` cast back to the
parameter's dtype. Unlike the reference's ``jax.tree.map``, which holds
every leaf's float32 temporaries at once, :func:`apply_updates` updates the
parameters and moments in place under ``torch.no_grad``, one leaf at a
time, and a leaf stacked over the LM's layer periods (under ``"slots"``)
one period slice at a time: the extra memory is a few float32 copies of
one period of one leaf. Elementwise, a slice's update is bitwise the
whole leaf's. The global norm adds each leaf's float32 sum of squares in
the order of ``jax.tree.leaves`` (dict keys sorted, lists in order); a
stacked leaf's sum is its period slices' sums added in period order.

Over a world of ranks (``mesh=``, the train step's), every rank holds the
replicated leaves whole, with the same folded gradients, and its own
block of each expert leaf (``models.sharding.expert_axes``). A replicated
slice's sum of squares is computed locally (the same bits on every
rank); the expert slices' partial sums are gathered once a step as one
vector and folded in rank order (``bucketing.ordered_fold``), as the
reference's ``sum`` over the whole sharded leaf adds them. With
compression an expert leaf's int8 scale is its global amax
(``Mesh.amax``, exact); the error feedback stays with the rank's block.
The updates stay elementwise and in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..core.bucketing import ordered_fold
from ..core.mesh import check_mesh
from ..models import sharding
from ..models.lm import tree_leaves, tree_leaves_with_paths, tree_map

# The parameter tree's key whose leaves are stacked over layer periods
# (``models.lm.init_lm``): their leading axis is the period.
STACKED = "slots"


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    compress_grads: bool = False


class OptState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: Any
    nu: Any
    err: Optional[Any]          # error-feedback accumulator (compression)


def init_opt_state(params, cfg: OptConfig) -> OptState:
    """Zero float32 moments on each parameter's device; ``step`` 0 (int32)
    on the device of the first leaf."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    first = tree_leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(zeros32, params),
        nu=tree_map(zeros32, params),
        err=tree_map(zeros32, params) if cfg.compress_grads else None,
    )


def _const(x, like):
    """A float32 scalar on ``like``'s device. Dividing by it is a true
    division on the card too (a CPU-scalar divisor is a reciprocal there)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _quantize_int8(g):
    scale = torch.clamp_min(g.abs().amax(), 1e-12) / _const(127.0, g)
    q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g, err):
    """int8 EF round-trip for one tensor; returns (g_hat, new_err)."""
    g32 = g.float() + err
    q, scale = _quantize_int8(g32)
    g_hat = q.float() * scale
    return g_hat, g32 - g_hat


def _schedule(cfg: OptConfig, step):
    warm = torch.clamp_max(step.float() / _const(max(cfg.warmup, 1), step), 1.0)
    return cfg.lr * warm


def _slices(path, t):
    """The pieces a leaf is updated in: its period slices when it is
    stacked over periods, else the whole leaf."""
    return t.unbind(0) if path and path[0] == STACKED else (t,)


def _amax(path, g, err):
    """max |g + err| of one leaf (float32), slice by slice."""
    return torch.stack([(gi.float() + ei).abs().amax()
                        for gi, ei in zip(_slices(path, g), _slices(path, err))]).amax()


def _compressed(path, g, err, amax):
    """Compress one leaf slice by slice with the whole leaf's scale (from
    its ``amax``, :func:`_amax`); the leaf's ``err`` is updated in place.
    Returns the int8 leaf and its scale (the decompressed gradient is
    ``q.float() * scale``)."""
    gs, es = _slices(path, g), _slices(path, err)
    scale = torch.clamp_min(amax, 1e-12) / _const(127.0, g)
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    for gi, ei, qi in zip(gs, es, _slices(path, q)):
        g32 = gi.float() + ei
        qi.copy_(torch.round(g32 / scale).clamp_(-127, 127))
        ei.copy_(g32 - qi.float() * scale)
    return q, scale


def _update_(p, g32, m, v, k):
    """One AdamW update of ``p`` (any dtype), ``m`` and ``v`` in place.
    ``g32`` is a float32 gradient this call may overwrite; ``k`` holds the
    step's constants."""
    g32.mul_(k["scale"])
    m.mul_(k["b1"]).add_(g32 * k["1-b1"])
    v.mul_(k["b2"]).add_(g32.square_().mul_(k["1-b2"]))
    step = m / k["b1c"]
    den = (v / k["b2c"]).sqrt_().add_(k["eps"])
    step.div_(den)
    del den
    p32 = p.float()
    step.add_(p32 * k["wd"])                                  # delta
    p.copy_(p32 - step.mul_(k["lr"]))


def apply_updates(params, grads, state: OptState, cfg: OptConfig, mesh=None):
    """One AdamW step, in place. Returns (params, new_state, metrics), the
    parameters and moments the same tensors, updated. ``mesh``: this
    rank's ``core.mesh.Mesh`` when the expert leaves of ``params`` are the
    rank's blocks (module docstring); every rank makes the same calls."""
    mesh = check_mesh(mesh)
    with torch.no_grad():
        pl = tree_leaves_with_paths(params)
        gl, ml, vl = tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
        cut = [] if mesh is None else [i for i, ax in enumerate(sharding.expert_axes(params))
                                       if ax is not None]
        if cfg.compress_grads:
            el = tree_leaves(state.err)
            amax = [_amax(path, g, e) for (path, _), g, e in zip(pl, gl, el)]
            if cut:                                   # the expert leaves' global amax
                world = mesh.amax(torch.stack([amax[i] for i in cut]))
                for i, a in zip(cut, world.to(amax[0].device).unbind(0)):
                    amax[i] = a
            packed = [_compressed(path, g, e, a)
                      for (path, _), g, e, a in zip(pl, gl, el, amax)]
            pieces = [[lambda qi=qi, s=s: qi.float() * s for qi in _slices(path, q)]
                      for (path, _), (q, s) in zip(pl, packed)]
        else:
            pieces = [[lambda gi=gi: gi.to(torch.float32, copy=True) for gi in _slices(path, g)]
                      for (path, _), g in zip(pl, gl)]

        # global-norm clip in f32: leaves in order, a stacked leaf's slices
        # in period order; an expert slice's sum folded over the ranks
        sums = [[piece().square_().sum() for piece in leaf] for leaf in pieces]
        if cut:
            at = [(i, j) for i in cut for j in range(len(sums[i]))]
            world = ordered_fold(mesh.gather(torch.stack([sums[i][j] for i, j in at])))
            for (i, j), t in zip(at, world.to(sums[0][0].device).unbind(0)):
                sums[i][j] = t
        total = None
        for leaf in sums:
            s = None
            for t in leaf:
                s = t if s is None else s + t
            total = s if total is None else total + s
        gnorm = torch.sqrt(total)
        scale = torch.clamp_max(_const(cfg.clip_norm, gnorm)
                                / torch.clamp_min(gnorm, 1e-12), 1.0)

        step = state.step + 1
        lr = _schedule(cfg, step)
        b1c = 1.0 - torch.pow(cfg.b1, step.float())
        b2c = 1.0 - torch.pow(cfg.b2, step.float())
        k = {"scale": scale, "b1": cfg.b1, "b2": cfg.b2, "1-b1": 1 - cfg.b1,
             "1-b2": 1 - cfg.b2, "b1c": b1c, "b2c": b2c, "eps": cfg.eps,
             "wd": cfg.weight_decay, "lr": lr}
        for (path, p), leaf, m, v in zip(pl, pieces, ml, vl):
            for piece, pi, mi, vi in zip(leaf, _slices(path, p), _slices(path, m),
                                         _slices(path, v)):
                _update_(pi, piece(), mi, vi, k)
    return params, OptState(step, state.mu, state.nu, state.err), \
        {"grad_norm": gnorm, "lr": lr}
