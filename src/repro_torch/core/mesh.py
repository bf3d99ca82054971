"""This process's place in a world of ranks, and the collectives the solvers use.

The reference's mesh is one JAX process driving many devices. The port's is
a ``torch.distributed`` world: rank r runs the same program on its own
device over its own share of users or chunks, and every rank ends with the
same replicated multipliers and scalars. ``mesh=None`` everywhere means one
process. ``launch.mesh`` starts a world and builds each rank's :class:`Mesh`.

The collectives are gloo's, over host tensors: what crosses ranks is the
constant-size partials of each pass (a few KB), already on the host for the
fold, and the expert-parallel MoE's token rows (:meth:`Mesh.all_to_all`,
``models/moe.py``), staged through the host too; :func:`all_to_all`
is the same exchange recorded by autograd, whose backward is the
exchange of the incoming gradient. No float sum relies on
the order inside a collective: a sum across
ranks is :meth:`Mesh.gather` of the per-rank (or per-slot) partials and then
``bucketing.ordered_fold`` in slot order on every rank, the addition chain
of the reference's CPU ``psum`` (DESIGN.md §7). Maxima and minima are exact
in any order and go through :meth:`Mesh.amax` / :meth:`Mesh.amin`.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["Mesh", "check_mesh", "all_to_all"]


class Mesh:
    """This process's place in a world: ``rank``, ``size``, its ``device``
    and the process ``group`` of the collectives. ``comm_s`` counts the
    seconds spent in collectives (the gather behind every fold, the
    maxima, the barriers, the all-to-alls with their host copies), and
    ``comm_split`` the same seconds by kind ("gather", "all_to_all",
    "reduce", "barrier")."""

    def __init__(self, rank: int, size: int, device: torch.device, group=None):
        self.rank, self.size, self.device, self.group = rank, size, device, group
        self.comm_s = 0.0
        self.comm_split = {}

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device})"

    def _timed(self, kind, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        self.comm_s += dt
        self.comm_split[kind] = self.comm_split.get(kind, 0.0) + dt
        return out

    def gather(self, t) -> torch.Tensor:
        """Every rank's ``t`` (same shape and dtype on each), stacked in rank
        order: a (size, ...) CPU tensor."""
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if self.size == 1:
            return t[None].clone()

        def run():
            out = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(out, t, group=self.group)
            return torch.stack(out)

        return self._timed("gather", run)

    def all_to_all(self, t) -> torch.Tensor:
        """Row r of ``t`` (size, ...) goes to rank r; row r of the result
        came from rank r (the reference's ``all_to_all(t, axis, 0, 0,
        tiled=True)``). Staged through the host, as every collective here
        is, and returned on ``t``'s device; the copies count in ``comm_s``."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, ...) rows, got "
                             f"{tuple(t.shape)}")
        if self.size == 1:
            return t.clone()

        def run():
            src = t.detach().cpu().contiguous()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            return out.to(t.device)

        return self._timed("all_to_all", run)

    def _reduce(self, t, op):
        t = torch.as_tensor(t).detach().cpu().clone()
        if self.size > 1:
            self._timed("reduce", lambda: dist.all_reduce(t, op=op, group=self.group))
        return t

    def amax(self, t) -> torch.Tensor:
        """Elementwise maximum over the ranks (exact in any order), on the CPU."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def amin(self, t) -> torch.Tensor:
        """Elementwise minimum over the ranks, on the CPU."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def barrier(self):
        if self.size > 1:
            self._timed("barrier", lambda: dist.barrier(group=self.group))


class _AllToAll(torch.autograd.Function):
    """:meth:`Mesh.all_to_all` under autograd. The tiled exchange along dim
    0 is a permutation of row blocks that is its own transpose (as
    ``jax.lax.all_to_all``'s is), so the backward is the same exchange of
    the incoming gradient.

    The backward's exchange is a collective too: every rank must reach it
    in the same order, which it does when every rank builds the same graph
    (the same layers, the same remat recompute). A rank that takes another
    order waits until the world's collective timeout and then fails
    (``launch.mesh.init_mesh``)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_to_all(grad.contiguous()), None


def all_to_all(mesh, t) -> torch.Tensor:
    """``mesh.all_to_all(t)``, differentiable in ``t``."""
    return _AllToAll.apply(t, mesh)


def check_mesh(mesh):
    """``mesh`` as given, when it is None (one process) or a
    :class:`Mesh`; raises ``TypeError`` otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a repro_torch.core.mesh.Mesh (a world "
                        f"of ranks, from launch.mesh.init_mesh) or None, got "
                        f"{type(mesh).__name__}")
    return mesh
