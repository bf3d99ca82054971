"""Capacity-constrained MoE routing as a sparse GKP (the paper inside the LM).

The Section 5.1 sparse knapsack is expert routing:

    users  = tokens            items = experts (M == K, diagonal costs b=1)
    p_ik   = router affinity   B_k  = expert k's token capacity
    Q      = top-k per token   x_ik = token i routed to expert k

A few synchronous coordinate-descent iterations price each expert with a
multiplier lam_k so that the realised load respects capacity. Each
iteration is one launch of the fused Alg-5 map and §5.2 histogram
(``kernels.ops.scd_fused_hist`` with b = 1) and the host-side threshold
search (``bucketing.threshold_from_hist``); the Alg-1 assignment, the
top-Q strictly positive adjusted affinities, is ``kernels.ops.adjusted_topc``
at the final lam (with b = 1, ``p - lam*b`` rounds as ``probs - lam``
does). The prices and the masks are computed without gradients (the
reference's ``stop_gradient``); gradients reach the chosen experts'
combine weights as in top-k routing. The §5.4 projection per expert then
keeps the capacity-many tokens with the largest adjusted affinity (two
stable argsorts over the tokens). On CPU tensors ``kernels.ops`` runs the
plain versions, on CUDA tensors the kernels, which take up to 256 experts
(deepseek-v2-236b routes 160; above 64 through their wide instances, the
fused one at the tile ``router_tile`` picks).

The histogram adds in the kernel's tile order, not the reference's
row-order scatter-add; with b = 1 every bucket mass is a count, which both
orders add exactly.

``scd_route_shmap`` is the reference's token-sharded router, over a world
of ranks (``core.mesh.Mesh``): each rank holds its own tokens, the capacity
is global (the rank's, times the world's size), and each price iteration
gathers the ranks' histograms and folds them in rank order
(``bucketing.ordered_fold``; counts, so exact) and takes the maximum
candidate across ranks (``Mesh.amax``), so every rank prices the same lam,
bitwise the one-process lam from the same probabilities wherever the
capacities agree. Like the reference's, it applies no §5.4 projection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels._wrap import MAX_SMEM, hist_smem_bytes
from .bucketing import make_edges, ordered_fold, threshold_from_hist
from .mesh import check_mesh

__all__ = ["RouterOut", "scd_route", "scd_route_probs", "scd_route_shmap",
           "scd_route_shmap_probs", "topk_route", "router_tile"]

# The fused kernel's tile on the router's path, chosen from K and the
# ladder's E: the largest of ROUTER_TILES whose block fits in shared memory.
# A block stages its rows of p and b there (at most HIST_SUB = 512 of
# them): with the default ladder (E = 33) 128 rows take 110 KB at K = 64
# (512 would take 414 KB, above a block's 227 KB), while K = 160 experts
# need 275 KB at 128 rows and 148 KB at 64, and K = 256 136 KB at 32. With
# b = 1 the tile changes no result: every bucket mass is a count, which any
# addition order sums exactly.
ROUTER_TILES = (128, 64, 32)


def router_tile(k, e):
    """The router's ``scd_fused_hist`` tile for K experts and E edges."""
    for t in ROUTER_TILES:
        if hist_smem_bytes(k, e, t, True) <= MAX_SMEM:
            return t
    raise ValueError(f"no router tile of {ROUTER_TILES} fits K = {k}, E = {e} "
                     f"in {MAX_SMEM} bytes of shared memory")


class RouterOut(NamedTuple):
    combine: torch.Tensor  # (T, E) combine weights (0 where not routed)
    mask: torch.Tensor     # (T, E) bool assignment
    lam: torch.Tensor      # (E,) expert prices
    load: torch.Tensor     # (E,) realised token counts (after the projection)


def _scd_prices(p, capacity, q, iters, bucket_half, bucket_delta, bucket_growth,
                mesh=None):
    """SCD iterations on the routing GKP from lam = 0. p: (T, E) >= 0
    float32, capacity: (E,). Returns lam (E,).

    ``mesh``: the world the tokens are cut over; the histograms are
    gathered and folded in rank order and the maximum taken across ranks,
    so lam is global (the reference's ``psum`` and ``pmax`` over ``axis``).
    """
    ones = torch.ones_like(p)
    lam = torch.zeros((p.shape[-1],), dtype=p.dtype, device=p.device)
    for _ in range(iters):
        edges = make_edges(lam, bucket_delta, bucket_growth, bucket_half)
        tile = router_tile(*edges.shape)
        hist, top = ops.scd_fused_hist(p, ones, lam, edges, q, tile_n=tile)
        if mesh is not None:
            hist = ordered_fold(mesh.gather(hist)).to(p.device)
            top = mesh.amax(top).to(p.device)
        lam = threshold_from_hist(hist, edges, capacity, top)
    return lam


def scd_route_probs(probs, q=2, capacity_factor=1.25, iters=4, bucket_half=16,
                    bucket_delta=1e-4, bucket_growth=1.8, dtype=torch.float32):
    """:func:`scd_route` from the router's probabilities (T, E) float32;
    ``combine`` is cast to ``dtype`` (the logits' dtype)."""
    t, e = probs.shape
    capacity = torch.full((e,), capacity_factor * q * t / e, dtype=torch.float32,
                          device=probs.device)
    with torch.no_grad():
        p = probs.detach().contiguous()
        lam = _scd_prices(p, capacity, q, iters, bucket_half, bucket_delta,
                          bucket_growth)
        # Alg 1 (sparse): top-Q positive adjusted affinities per token.
        mask = ops.adjusted_topc(p, torch.ones_like(p), lam, q)[0]
        # §5.4 per-expert projection to hard capacity: keep the capacity-many
        # best adjusted affinities among assigned tokens (floor: capacity is a
        # count, an integer rank must stay strictly below it).
        score = torch.where(mask, p - lam[None, :], float("-inf"))
        erank = torch.argsort(torch.argsort(-score, dim=0, stable=True), dim=0,
                              stable=True)
        mask = mask & (erank < torch.floor(capacity)[None, :])
        load = mask.sum(dim=0).to(torch.float32)
    combine = torch.where(mask, probs, 0.0).to(dtype)
    return RouterOut(combine=combine, mask=mask, lam=lam, load=load)


def scd_route(logits, q=2, capacity_factor=1.25, iters=4, bucket_half=16,
              bucket_delta=1e-4, bucket_growth=1.8):
    """Knapsack-priced top-Q routing with exact expert capacity.

    logits: (T, E). Returns RouterOut with sum(mask, axis=0) <= capacity
    and sum(mask, axis=1) <= q.
    """
    probs = torch.softmax(logits.float(), dim=-1)        # p_ik >= 0
    return scd_route_probs(probs, q, capacity_factor, iters, bucket_half,
                           bucket_delta, bucket_growth, dtype=logits.dtype)


def scd_route_shmap_probs(probs, q, capacity_factor, iters, mesh,
                          dtype=torch.float32):
    """:func:`scd_route_shmap` from this rank's probabilities (T_local, E)
    float32: a ``RouterOut`` whose ``combine`` is renormalised over the
    chosen experts and cast to ``dtype``, ``lam`` the global prices and
    ``load`` this rank's counts."""
    if check_mesh(mesh) is None:
        raise TypeError("scd_route_shmap needs a repro_torch.core.mesh.Mesh "
                        "(one process: Mesh(0, 1, device))")
    t_local, e = probs.shape
    capacity = torch.full((e,), capacity_factor * q * t_local / e,
                          dtype=torch.float32, device=probs.device) * mesh.size
    with torch.no_grad():
        p = probs.detach().contiguous()
        lam = _scd_prices(p, capacity, q, iters, 16, 1e-4, 1.8, mesh=mesh)
        mask = ops.adjusted_topc(p, torch.ones_like(p), lam, q)[0]
        load = mask.sum(dim=0).to(torch.float32)
    combine = torch.where(mask, probs, 0.0)
    combine = combine / torch.clamp_min(combine.sum(-1, keepdim=True), 1e-9)
    return RouterOut(combine=combine.to(dtype), mask=mask, lam=lam, load=load)


def scd_route_shmap(logits, q, capacity_factor, iters, mesh):
    """The token-sharded router over a world of ranks: ``logits`` (T_local,
    E) are this rank's tokens; capacity and prices are global across
    ``mesh`` (a ``core.mesh.Mesh``). Returns (combine, mask) with combine
    weights renormalised over the chosen experts, in the logits' dtype."""
    probs = torch.softmax(logits.float(), dim=-1)
    out = scd_route_shmap_probs(probs, q, capacity_factor, iters, mesh,
                                dtype=logits.dtype)
    return out.combine, out.mask


def topk_route(logits, q=2):
    """Baseline heuristic top-k routing (no capacity guarantee)."""
    probs = torch.softmax(logits.float(), dim=-1)
    with torch.no_grad():
        order = torch.argsort(-probs, dim=-1, stable=True)
        mask = torch.argsort(order, dim=-1, stable=True) < q
        load = mask.sum(dim=0).to(torch.float32)
    combine = torch.where(mask, probs, 0.0).to(logits.dtype)
    return RouterOut(combine=combine, mask=mask,
                     lam=torch.zeros((logits.shape[-1],), dtype=torch.float32,
                                     device=logits.device),
                     load=load)
