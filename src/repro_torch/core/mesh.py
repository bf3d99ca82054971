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
exchange of the incoming gradient. Tensor and sequence parallelism
(``models/attention.py``, ``layers.py``, ``blocks.py``, ``lm.py``) moves
activations with :meth:`Mesh.all_gather` (the ranks' blocks joined along a
dim) and :meth:`Mesh.reduce_scatter` (the ranks' partial sums folded, this
rank's block kept), both staged through the host; :func:`all_gather`,
:func:`reduce_scatter`, :func:`fold_sum`, :func:`copy_in` and
:func:`split` are the same exchanges recorded by autograd, with the
backward each one's transpose (Megatron's conjugate pairs), so training
runs through them (module docstring of :func:`all_gather`). No float sum relies on
the order inside a collective: a sum across
ranks is :meth:`Mesh.gather` of the per-rank (or per-slot) partials and then
``bucketing.ordered_fold`` in slot order on every rank, the addition chain
of the reference's CPU ``psum`` (DESIGN.md §7). Maxima and minima are exact
in any order and go through :meth:`Mesh.amax` / :meth:`Mesh.amin`.

:class:`DryMesh` is rank r of a world of D with no process group: its
collectives return ``meta`` tensors of the result shapes and count the
bytes a real world's rank would send (the dry-run, ``launch/dryrun.py``).
The autograd functions call the mesh's methods, so over a ``DryMesh`` a
train step's backward counts its collectives too.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .bucketing import ordered_fold

__all__ = ["Mesh", "DryMesh", "check_mesh", "all_to_all", "all_gather",
           "reduce_scatter", "fold_sum", "copy_in", "split"]


class Mesh:
    """This process's place in a world: ``rank``, ``size``, its ``device``
    and the process ``group`` of the collectives. ``comm_s`` counts the
    seconds spent in collectives (the gather behind every fold, the
    maxima, the barriers, the all-to-alls with their host copies), and
    ``comm_split`` the same seconds by kind ("gather", "all_to_all",
    "reduce", "barrier"). ``comm_bytes`` counts by kind the payload this
    rank sends: the tensor it gives ``gather``, ``all_to_all``, ``amax`` or
    ``amin`` (a world of one sends nothing), and ``comm_calls`` those
    collectives."""

    def __init__(self, rank: int, size: int, device: torch.device, group=None):
        self.rank, self.size, self.device, self.group = rank, size, device, group
        self.comm_s = 0.0
        self.comm_split = {}
        self.comm_bytes = {}
        self.comm_calls = {}

    def _sent(self, kind, t):
        if self.size > 1:
            self.comm_bytes[kind] = self.comm_bytes.get(kind, 0) + t.numel() * t.element_size()
            self.comm_calls[kind] = self.comm_calls.get(kind, 0) + 1

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
        return self._stacked("gather", t)

    def _stacked(self, kind, t):
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if self.size == 1:
            return t[None].clone()
        self._sent(kind, t)

        def run():
            out = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(out, t, group=self.group)
            return torch.stack(out)

        return self._timed(kind, run)

    def _block(self, t, dim):
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not "
                             f"split over {self.size} ranks")
        return self.rank * (n // self.size), n // self.size

    def all_gather(self, t, dim) -> torch.Tensor:
        """The ranks' ``t`` (the same shape on each but along ``dim``'s
        blocks) joined along ``dim`` in rank order, on ``t``'s device."""
        if self.size == 1:
            return t
        st = self._stacked("all_gather", t)
        return torch.cat(st.unbind(0), dim=dim).to(t.device)

    def reduce_scatter(self, t, dim) -> torch.Tensor:
        """The sum over the ranks of their ``t`` (each rank's partial of the
        same shape), folded in rank order in float32 (``ordered_fold``) and
        rounded once to ``t``'s dtype, of this rank's block along ``dim``
        only; on ``t``'s device. Every rank sends its whole ``t``."""
        if self.size == 1:
            return t
        lo, n = self._block(t, dim)
        part = self._stacked("reduce_scatter", t).narrow(dim + 1, lo, n).to(t.device)
        return ordered_fold(part, dtype=torch.float32).to(t.dtype)

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
        self._sent("all_to_all", t)

        def run():
            src = t.detach().cpu().contiguous()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            return out.to(t.device)

        return self._timed("all_to_all", run)

    def _reduce(self, t, op):
        t = torch.as_tensor(t).detach().cpu().clone()
        self._sent("reduce", t)
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


class DryMesh(Mesh):
    """Rank ``rank`` of a world of ``size`` that exists only on paper: no
    process group, and every collective returns a ``meta`` tensor of its
    result's shape (``gather`` a (size, ...) stack, ``all_to_all`` and the
    maxima ``t``'s shape, ``all_gather`` the joined shape) after counting in
    ``comm_bytes`` what this rank would send; ``reduce_scatter`` folds a
    (size, ...) stack of the rank's blocks as :class:`Mesh` folds the one it
    copies to the device, so the dry-run sees the same allocations.
    ``all_to_all`` keeps :func:`all_to_all`'s backward. The dry-run runs a
    rank's step on ``meta`` over it."""

    def __init__(self, rank: int, size: int):
        super().__init__(rank, size, torch.device("meta"))

    def __repr__(self):
        return f"DryMesh(rank={self.rank}, size={self.size})"

    @staticmethod
    def _like(t, shape=None):
        t = torch.as_tensor(t)
        return torch.empty(t.shape if shape is None else shape, dtype=t.dtype,
                           device="meta")

    def gather(self, t) -> torch.Tensor:
        t = torch.as_tensor(t)
        self._sent("gather", t)
        return self._like(t, (self.size, *t.shape))

    def all_to_all(self, t) -> torch.Tensor:
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, ...) rows, got "
                             f"{tuple(t.shape)}")
        self._sent("all_to_all", t)
        return self._like(t)

    def all_gather(self, t, dim) -> torch.Tensor:
        self._sent("all_gather", t)
        shape = list(t.shape)
        shape[dim] *= self.size
        return self._like(t, shape)

    def reduce_scatter(self, t, dim) -> torch.Tensor:
        _, n = self._block(t, dim)
        self._sent("reduce_scatter", t)
        shape = list(t.shape)
        shape[dim] = n
        part = self._like(t, (self.size, *shape))
        return ordered_fold(part, dtype=torch.float32).to(t.dtype)

    def _reduce(self, t, op):
        t = torch.as_tensor(t)
        self._sent("reduce", t)
        return self._like(t)

    def barrier(self):
        pass


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


def _folded(mesh, t):
    """The ranks' ``t`` gathered and folded in rank order in float32,
    rounded once to ``t``'s dtype, on ``t``'s device."""
    return ordered_fold(mesh.gather(t).to(t.device), dtype=torch.float32).to(t.dtype)


class _AllGather(torch.autograd.Function):
    """:meth:`Mesh.all_gather` under autograd. Each rank's gradient of the
    joined tensor is its partial where the rank's users of it differ (its
    heads, its FFN columns, its vocab rows, its share of the positions):
    the backward folds the ranks' partials and keeps this rank's block
    (:meth:`Mesh.reduce_scatter`). With ``whole`` the users are the same on
    every rank (a replicated residual) and the gradient is already whole:
    the backward keeps the rank's block of it."""

    @staticmethod
    def forward(ctx, t, mesh, dim, whole):
        ctx.mesh, ctx.dim, ctx.whole = mesh, dim, whole
        return mesh.all_gather(t, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if ctx.whole:
            lo, n = ctx.mesh._block(grad, ctx.dim)
            return grad.narrow(ctx.dim, lo, n), None, None, None
        return ctx.mesh.reduce_scatter(grad, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """:meth:`Mesh.reduce_scatter` under autograd: every rank's partial
    reaches every block of the sum, so the backward joins the blocks'
    gradients (:meth:`Mesh.all_gather`)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.reduce_scatter(t, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather(grad.contiguous(), ctx.dim), None, None


class _FoldSum(torch.autograd.Function):
    """The sum over the ranks of their partials (:func:`_folded`) under
    autograd: the sum is the same on every rank, so is its gradient, and
    each rank's partial takes it as it is (not D times)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return _folded(mesh, t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    """A tensor the same on every rank (a replicated residual) entering
    computations that differ by rank (its heads, its columns, its vocab
    rows): the identity, whose backward folds the ranks' partial gradients
    (:func:`_folded`), so the replicated tensor's gradient is whole and the
    same bits on every rank."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t

    @staticmethod
    def backward(ctx, grad):
        return _folded(ctx.mesh, grad.contiguous()), None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor the same on every rank:
    the backward joins the blocks' gradients (:meth:`Mesh.all_gather`), the
    replicated tensor's whole gradient on every rank."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        lo, n = mesh._block(t, dim)
        return t.narrow(dim, lo, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather(grad.contiguous(), ctx.dim), None, None


def all_gather(mesh, t, dim, whole=False) -> torch.Tensor:
    """``mesh.all_gather(t, dim)``, differentiable in ``t``.

    Autograd's convention over a world: a tensor the same on every rank
    (replicated) carries the same, whole gradient on every rank; a rank's
    block, or a partial, carries this rank's. The five functions here keep
    it at each change of layout: :func:`all_gather` (blocks -> joined;
    backward: reduce-scatter, or with ``whole`` the rank's block),
    :func:`reduce_scatter` (partials -> block; all-gather),
    :func:`fold_sum` (partials -> replicated; identity), :func:`copy_in`
    (replicated -> rank-specific users; the fold) and :func:`split`
    (replicated -> block; all-gather). The backward's collectives are
    collectives too: every rank reaches them in the same order when every
    rank builds the same graph (:class:`_AllToAll`)."""
    if mesh.size == 1:
        return t
    return _AllGather.apply(t, mesh, dim, whole)


def reduce_scatter(mesh, t, dim) -> torch.Tensor:
    """``mesh.reduce_scatter(t, dim)``, differentiable in ``t``."""
    if mesh.size == 1:
        return t
    return _ReduceScatter.apply(t, mesh, dim)


def fold_sum(mesh, t) -> torch.Tensor:
    """The ranks' ``t`` gathered and folded in rank order in float32,
    rounded once to ``t``'s dtype (every rank gets the same bits),
    differentiable in ``t`` (:func:`all_gather`'s convention)."""
    return _FoldSum.apply(t, mesh)


def copy_in(mesh, t) -> torch.Tensor:
    """``t`` (the same on every rank) as the input of rank-specific
    computations: the identity, whose backward folds the gradient over the
    ranks."""
    if mesh.size == 1:
        return t
    return _CopyIn.apply(t, mesh)


def split(mesh, t, dim) -> torch.Tensor:
    """This rank's block along ``dim`` of ``t`` (the same on every rank),
    differentiable in ``t``."""
    if mesh.size == 1:
        return t
    return _Split.apply(t, mesh, dim)


def check_mesh(mesh):
    """``mesh`` as given, when it is None (one process) or a
    :class:`Mesh`; raises ``TypeError`` otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a repro_torch.core.mesh.Mesh (a world "
                        f"of ranks, from launch.mesh.init_mesh) or None, got "
                        f"{type(mesh).__name__}")
    return mesh
