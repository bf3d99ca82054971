"""The resident GKP solver: SCD (Alg 4) and DD (Alg 2), on one device or
sharded over a world of ranks.

The instance (``SparseKP`` or ``DenseKP``) lives on one device. Each
iteration runs the map over the whole shard, or over user chunks with
``cfg.chunk_size``, on that device, and hands a constant-size result to
the host: the (K, E+1) histogram and the (K,) top of the bucketed reduce,
the (K,) thresholds of the exact reduce, or the (K,) consumption of DD.
The multiplier tail (threshold recovery, damped step, the convergence
test the loop needs) runs on the host CPU in float32, as in the host-fed
driver of ``core/prefetch.py``. So ``lam`` is a CPU tensor, and a resident
bucketed solve follows the host-fed one bit for bit on the same rows when
both run the same kernel tile.

Which map runs:

* sparse, bucketed: the fused kernel ``scd_fused_hist`` (candidates,
  histogram and top in one pass), over the whole shard or per chunk
  seeded with the running histogram;
* sparse, exact: the ``scd_candidates`` kernel, then the exact reduce,
  which sorts all (n, K) candidates;
* dense (Alg 3): ``candidates_general``, then the ``bucket_hist`` kernel
  (seeded per chunk when chunked) or the exact reduce;
* DD: the greedy primal at lam (sparse: the ``adjusted_topc`` kernel) and
  its (K,) consumption.

Chunked-vs-unchunked contract (``cfg.chunk_size``): with the bucketed
reduce the chunked solve equals the unchunked one bitwise in every field
when both run the same kernel tile and the tile divides the chunk's rows
(the default ``ops.MAP_TILE`` divides every chunk size that is a multiple
of 8,192; ``cfg.kernel_tile`` pins another): each chunk's kernel call is
seeded with the running histogram, so the tile records are folded in the
same order. The
ragged last chunk is padded with inert p = b = 0 users. The exact reduce
cannot be chunked and raises ``ValueError``; chunked DD sums r per chunk,
so it matches unchunked DD to float32 reduce order, not bitwise.

Sharded (:func:`solve_sharded`): each rank of a ``launch.mesh`` world holds
n / D users on its own device and runs the same map; the constant-size
results of every pass are gathered and folded in rank order on the host
(``bucketing.ordered_fold``, the reference's CPU ``psum``), top by max,
so every rank takes the same host decisions from the same bits. The exact
reduce gathers every rank's candidates, the presolve samples each shard,
the §5.4 projection is the bucketed one, and ``cfg.partial_fraction``
drops the ranks past that fraction (``straggler_mask``).

On the card every reduction of this module has an order fixed by the
shape alone (no atomics, and ``bucketing.ordered_cumsum`` for the scans),
so repeated solves give the same bits. Against the same solve on the CPU
the sums differ in the last bits, and the result agrees to tolerance.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import row_sum
from .bucketing import (exact_threshold, make_edges, ordered_colsum, ordered_fold,
                        threshold_from_hist)
from .greedy import adjusted_profit, consumption, fma_dot, greedy_solve
from .mesh import check_mesh
from .postprocess import (feasibility_threshold_bucketed, feasibility_threshold_exact,
                          group_profit)
from .scd import candidates_general
from .types import DenseKP, SolverConfig, SparseKP

__all__ = ["SolveResult", "solve", "solve_sharded", "solve_shard",
           "dual_objective", "iterate_multipliers", "damped_multiplier_step",
           "dd_proposal", "scd_chunk_accumulate", "resolve_device",
           "straggler_mask", "hist_scale"]


class SolveResult(NamedTuple):
    """What ``solve`` returns. ``x`` stays on the instance's device; the
    other tensors are on the CPU. ``history`` holds (max_iters, ...) CPU
    records with ``cfg.record_history``, else None."""

    lam: torch.Tensor       # (K,) final multipliers
    x: torch.Tensor         # (n, K) or (n, M) bool primal (post-processed)
    iters: int              # iterations until convergence
    r: torch.Tensor         # (K,) consumption (post-processed)
    primal: torch.Tensor    # () primal objective (post-processed)
    dual: torch.Tensor      # () dual objective at lam
    history: Optional[dict]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the card by "
                "default. Pass device='cpu' (--device cpu) to run the plain "
                "PyTorch versions on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def _map_tile(cfg):
    """User-axis tile of the histogram kernels (``scd_fused_hist``,
    ``bucket_hist``): the cfg override or ``ops.MAP_TILE``, whatever n is."""
    return cfg.kernel_tile if cfg.kernel_tile else ops.MAP_TILE


def _finalize_tile(cfg, n):
    """User-axis tile of the finalize kernel (at most 1,024 rows): the cfg
    override or ``ops.pick_tile``'s ladder."""
    return cfg.kernel_tile if cfg.kernel_tile else ops.pick_tile(n)


# --------------------------------------------------------------------------
# Across a mesh: the collectives and the straggler mask.
# --------------------------------------------------------------------------

def _psum(x, mesh):
    """The sum of every rank's ``x``: gathered and folded in rank order on
    the host, the addition chain of the reference's CPU ``psum``. Without a
    mesh, ``x`` itself."""
    return x if mesh is None else ordered_fold(mesh.gather(x))


def _pmax(x, mesh):
    return x if mesh is None else mesh.amax(x)


def _all_gather(t, mesh):
    """Every rank's rows in rank order, on ``t``'s device (the reference's
    tiled ``all_gather``); ``t`` itself without a mesh."""
    if mesh is None:
        return t
    return mesh.gather(t).reshape((-1,) + tuple(t.shape[1:])).to(t.device)


def straggler_mask(partial_fraction, index, size):
    """(keep, scale) of shard ``index`` of ``size`` when a solve proceeds
    with a fraction of its shards: the shards past ``partial_fraction *
    size`` are dropped and the map results of the others are scaled by
    1 / fraction (the §5.3 estimator). In float32, as the reference
    computes it; (1.0, 1.0) at a fraction of 1."""
    if partial_fraction >= 1.0:
        return 1.0, 1.0
    f32 = np.float32
    keep = f32((f32(index) + f32(1.0)) <= f32(partial_fraction) * f32(size))
    frac = max(f32(partial_fraction), f32(1.0) / f32(size))
    return float(keep), float(f32(1.0) / frac)


def hist_scale(keep, scale):
    """The straggler mask's factor on an accumulated histogram (linear in
    v2): ``keep * scale`` in float32."""
    return float(np.float32(keep) * np.float32(scale))


def _mask(cfg, mesh):
    if mesh is None:
        return 1.0, 1.0
    return straggler_mask(cfg.partial_fraction, mesh.rank, mesh.size)


# --------------------------------------------------------------------------
# Maps and reduces: lam (K,) on the CPU -> proposed lam (K,) on the CPU.
# --------------------------------------------------------------------------

def scd_chunk_accumulate(p_c, b_c, lam, edges, q, cfg, hist, top):
    """Fold one (c, K) chunk into the running (hist (K, E+1), top (K,)).

    The carry seeds the chunk's tile fold, so a chunked pass performs the
    same additions as one pass over all rows (chunk a multiple of the tile).
    """
    return ops.scd_fused_hist(p_c, b_c, lam, edges, q,
                              tile_n=_map_tile(cfg),
                              hist_init=hist, top_init=top)


def _edges(lam, cfg):
    return make_edges(lam, cfg.bucket_delta, cfg.bucket_growth, cfg.bucket_half)


def _threshold(hist, edges, kp, top, mesh=None, scale=None):
    """The bucketed reduce's tail, on the host. Over a mesh every rank's
    histogram (times ``scale``, the straggler mask, when given) is gathered
    and folded in rank order, and top is the ranks' max."""
    hist, top = hist.cpu(), top.cpu()
    if scale is not None:
        hist = hist * scale
    return threshold_from_hist(_psum(hist, mesh), edges, kp.budgets.cpu(),
                               _pmax(top, mesh))


def _scd_candidates(kp, lam, q):
    """Alg 5 (sparse) or Alg 3 (dense) map at lam (on kp's device):
    (v1, v2) of shape (Z, K), Z = n or n * P (user-major)."""
    if isinstance(kp, SparseKP):
        return ops.scd_candidates(kp.p, kp.b, lam, q)
    v1, v2 = candidates_general(kp.p, kp.b, lam, kp.sets, kp.caps)
    n, k, pp = v1.shape
    return (v1.transpose(1, 2).reshape(n * pp, k),
            v2.transpose(1, 2).reshape(n * pp, k))


def _scd_reduce(v1, v2, lam, kp, cfg, mesh=None):
    """Alg 4 reduce over all K coordinates: exact (over a mesh, on every
    rank's candidates gathered) or §5.2 bucketed."""
    if cfg.reduce == "exact":
        v1, v2 = _all_gather(v1, mesh), _all_gather(v2, mesh)
        return exact_threshold(v1.T, v2.T, kp.budgets).cpu()
    edges = _edges(lam, cfg)
    hist = ops.bucket_hist(v1, v2, edges.to(v1.device),
                           tile_n=_map_tile(cfg))
    return _threshold(hist, edges, kp, torch.amax(v1, dim=0), mesh)


def _scd_step_fused(kp, lam, q, cfg, mesh=None, scale=None):
    """Map + bucketed reduce of the sparse shard in one kernel call: only
    the (K, E+1) histogram and the (K,) top leave the device."""
    edges = _edges(lam, cfg)
    dev = kp.p.device
    hist, top = ops.scd_fused_hist(kp.p, kp.b, lam.to(dev), edges.to(dev), q,
                                   tile_n=_map_tile(cfg))
    return _threshold(hist, edges, kp, top, mesh, scale)


def _chunk_xs(kp, chunk):
    """The user axis in chunks of ``chunk`` rows: (p_c, b_c) views, the
    ragged last chunk padded with inert p = b = 0 users (no candidate, never
    selected, no consumption; their zero mass adds nothing)."""
    n = kp.p.shape[0]
    for s in range(0, n, chunk):
        p_c, b_c = kp.p[s:s + chunk], kp.b[s:s + chunk]
        pad = chunk - p_c.shape[0]
        if pad:
            p_c = torch.cat([p_c, p_c.new_zeros((pad,) + p_c.shape[1:])])
            b_c = torch.cat([b_c, b_c.new_zeros((pad,) + b_c.shape[1:])])
        yield p_c, b_c


def _scd_pass_chunked(kp, lam, q, cfg, mesh=None, mask=(1.0, 1.0)):
    """One SCD map + bucketed reduce with the user axis in chunks."""
    edges = _edges(lam, cfg)
    dev = kp.p.device
    lam_d, edges_d = lam.to(dev), edges.to(dev)
    k = kp.budgets.shape[0]
    hist = torch.zeros((k, edges.shape[-1] + 1), dtype=torch.float32, device=dev)
    top = torch.full((k,), float("-inf"), dtype=torch.float32, device=dev)
    dense = isinstance(kp, DenseKP)
    for p_c, b_c in _chunk_xs(kp, cfg.chunk_size):
        if dense:
            v1, v2 = _scd_candidates(kp._replace(p=p_c, b=b_c), lam_d, q)
            if mesh is not None:
                v2 = v2 * mask[0] * mask[1]
            hist = ops.bucket_hist(v1, v2, edges_d,
                                   tile_n=_map_tile(cfg),
                                   hist_init=hist)
            top = torch.maximum(top, torch.amax(v1, dim=0))
        else:
            hist, top = scd_chunk_accumulate(p_c, b_c, lam_d, edges_d, q, cfg,
                                             hist, top)
    scale = hist_scale(*mask) if mesh is not None and not dense else None
    return _threshold(hist, edges, kp, top, mesh, scale)


def _scd_pass(kp, lam, q, cfg, mesh=None, mask=(1.0, 1.0)):
    """One full SCD map + reduce at ``lam`` -> proposed multipliers (K,).
    The straggler mask scales the sparse kernel's histogram (linear in v2)
    and, on the other maps, v2 itself, as the reference's kernel and
    default paths do."""
    if cfg.chunk_size is not None:
        return _scd_pass_chunked(kp, lam, q, cfg, mesh, mask)
    if isinstance(kp, SparseKP) and cfg.reduce == "bucketed":
        scale = hist_scale(*mask) if mesh is not None else None
        return _scd_step_fused(kp, lam, q, cfg, mesh, scale)
    v1, v2 = _scd_candidates(kp, lam.to(kp.p.device), q)
    if mesh is not None:
        v2 = v2 * mask[0] * mask[1]
    return _scd_reduce(v1, v2, lam, kp, cfg, mesh)


def _scd_update(kp, lam, q, cfg, mesh=None):
    """One SCD iteration. ``sync``: every coordinate from one map pass
    (Alg 4). ``cyclic``: K passes, coordinate k re-mapped at the already
    updated multipliers."""
    mask = _mask(cfg, mesh)
    if cfg.cd_mode == "cyclic":
        lam = lam.clone()
        for kk in range(kp.budgets.shape[0]):
            lam[kk] = _scd_pass(kp, lam, q, cfg, mesh, mask)[kk]
        return lam
    return _scd_pass(kp, lam, q, cfg, mesh, mask)


def _solve_primal(kp, lam, q):
    """Greedy primal at lam (on kp's device) and its (n, K) consumption.
    Sparse: the ``adjusted_topc`` kernel (``select_sparse`` is its oracle
    in the tests)."""
    if isinstance(kp, SparseKP):
        return ops.adjusted_topc(kp.p, kp.b, lam, q)
    x = greedy_solve(adjusted_profit(kp.p, kp.b, lam), kp.sets, kp.caps)
    return x, consumption(kp.b, x)


def dd_proposal(lam, r, budgets, cfg):
    """Alg 2's projected sub-gradient step on the host:
    max(lam + dd_lr * (r - budgets), 0). lam, r, budgets: (K,) CPU."""
    return torch.clamp_min(lam + cfg.dd_lr * (r - budgets), 0.0)


def _dd_update(kp, lam, q, cfg, mesh=None):
    """Alg 2: projected sub-gradient step on the dual. Chunked, r is summed
    chunk by chunk, each chunk's rows by ``ordered_colsum`` (as the host-fed
    DD epoch sums them), so a chunked DD solve has the same bits on the
    card and the CPU. Over a mesh the ranks' r (a dropped straggler's as
    zeros) fold in rank order and are then scaled."""
    lam_d = lam.to(kp.p.device)
    if cfg.chunk_size is None:
        r = torch.sum(_solve_primal(kp, lam_d, q)[1], dim=0)
    else:
        r = torch.zeros_like(lam_d)
        for p_c, b_c in _chunk_xs(kp, cfg.chunk_size):
            r = r + ordered_colsum(_solve_primal(kp._replace(p=p_c, b=b_c), lam_d, q)[1])
    r = r.cpu()
    if mesh is not None:
        keep, scale = _mask(cfg, mesh)
        r = _psum(r * keep, mesh) * scale
    return dd_proposal(lam, r, kp.budgets.cpu(), cfg)


def dual_objective(kp, lam, q, primal=None, mesh=None):
    """g(lam) = sum_i max_x [p~ . x_i] + lam . B (an upper bound of the IP),
    on kp's device (over a mesh, on the host, the ranks' sums folded in rank
    order). ``primal`` passes a precomputed ``(x, cons)`` at lam."""
    lam = lam.to(kp.p.device)
    x, _ = _solve_primal(kp, lam, q) if primal is None else primal
    if isinstance(kp, SparseKP):
        ap = kp.p - lam[None, :] * kp.b
    else:
        ap = adjusted_profit(kp.p, kp.b, lam)
    per_user = row_sum(torch.where(x, ap, 0.0))
    if mesh is None:
        return torch.sum(per_user) + fma_dot(lam, kp.budgets)
    return _psum(torch.sum(per_user), mesh) + fma_dot(lam, kp.budgets).cpu()


# --------------------------------------------------------------------------
# The multiplier iteration.
# --------------------------------------------------------------------------

def damped_multiplier_step(lam, dprev, prop, cfg):
    """Proposed lam -> (lam_new, delta, moved).

    A coordinate whose step reverses sign against the previous step is
    scaled by ``cfg.cd_damping`` (SCD only: DD's projected step must reach
    lam = 0 exactly); ``moved`` (a 0-d bool tensor) says the largest move
    still exceeds ``tol * (1 + max(lam))``.
    """
    delta = prop - lam
    if cfg.cd_damping < 1.0 and cfg.algo == "scd":
        delta = delta * torch.where(delta * dprev < 0.0,
                                    torch.full_like(delta, cfg.cd_damping),
                                    torch.ones_like(delta))
    lam_new = lam + delta
    moved = torch.max(torch.abs(lam_new - lam)) > cfg.tol * (1.0 + torch.max(lam))
    return lam_new, delta, moved


def iterate_multipliers(update, lam0, cfg, metrics_fn=None):
    """The damped fixed-point iteration: ``update(lam) -> proposed lam``.

    Without ``cfg.record_history`` it stops when lam stops moving or at
    ``cfg.max_iters``, reading one bool from the step per iteration. With
    it, the loop runs ``max_iters`` times, iterations after convergence are
    frozen (lam, iters and the record repeat), and ``metrics_fn(lam, it)``
    records each one. Returns (lam, iters, history).
    """
    lam, dprev, it, done = lam0, torch.zeros_like(lam0), 0, False
    if not cfg.record_history:
        while it < cfg.max_iters and not done:
            lam, dprev, moved = damped_multiplier_step(lam, dprev, update(lam), cfg)
            it += 1
            done = not bool(moved)
        return lam, it, None
    recs, rec = [], None
    for _ in range(cfg.max_iters):
        if not done:
            lam, dprev, moved = damped_multiplier_step(lam, dprev, update(lam), cfg)
            it += 1
            done = not bool(moved)
            rec = metrics_fn(lam, it)
        recs.append(rec)
    if not recs:
        return lam, it, None
    return lam, it, {key: torch.stack([r[key] for r in recs]) for key in recs[0]}


def _metrics(kp, lam, q, mesh=None):
    """x, cons, r, primal, dual and max_violation at lam, on kp's device
    (over a mesh, the sums on the host, folded across the ranks)."""
    x, cons = _solve_primal(kp, lam, q)
    r = _psum(torch.sum(cons, dim=0), mesh)
    primal = _psum(torch.sum(torch.where(x, kp.p, 0.0)), mesh)
    dual = dual_objective(kp, lam, q, primal=(x, cons), mesh=mesh)
    budgets = kp.budgets if mesh is None else kp.budgets.cpu()
    viol = torch.amax(torch.clamp_min(r - budgets, 0.0) / budgets)
    return x, cons, r, primal, dual, viol


def _iterate(kp, lam0, q, cfg, metrics_fn=None, mesh=None):
    update = _scd_update if cfg.algo == "scd" else _dd_update
    return iterate_multipliers(lambda lam: update(kp, lam, q, cfg, mesh), lam0,
                               cfg, metrics_fn)


def _solve_local(kp, lam0, q, cfg, mesh=None):
    """Iterate, then the final primal, metrics and §5.4 projection over the
    whole shard (also when the iteration map is chunked): exact on one
    device, bucketed across a mesh (``feasibility_threshold_bucketed``), as
    in the reference."""
    dev = kp.p.device

    def metrics_fn(lam, _it):
        _, _, _, primal, dual, viol = _metrics(kp, lam.to(dev), q, mesh)
        return {"lam": lam, "primal": primal.cpu(), "dual": dual.cpu(),
                "gap": (dual - primal).cpu(), "max_violation": viol.cpu()}

    lam, iters, hist = _iterate(kp, lam0, q, cfg, metrics_fn, mesh)
    lam_d = lam.to(dev)
    x, cons, r, primal, dual, _ = _metrics(kp, lam_d, q, mesh)
    if cfg.postprocess:
        pt = group_profit(kp.p, cons, lam_d, x)
        if mesh is None:
            tau = feasibility_threshold_exact(pt, cons, kp.budgets)
        else:
            tau = feasibility_threshold_bucketed(pt, cons, r, kp.budgets,
                                                 mesh=mesh).to(dev)
        drop = pt <= tau
        x = x & ~drop[:, None]
        cons = cons * (~drop[:, None]).to(cons.dtype)
        r = _psum(torch.sum(cons, dim=0), mesh)
        primal = _psum(torch.sum(torch.where(x, kp.p, 0.0)), mesh)
    return SolveResult(lam, x, iters, r.cpu(), primal.cpu(), dual.cpu(), hist)


def _presolve(kp, lam0, q, cfg, mesh=None):
    """§5.3: warm-start lam by solving the first ``presolve_samples`` users
    (of each shard, over a mesh) with budgets scaled by the sample fraction
    of the shard."""
    s = cfg.presolve_samples
    if s <= 0:
        return lam0
    n = kp.p.shape[0]
    s = min(s, n)
    small = kp._replace(p=kp.p[:s], b=kp.b[:s], budgets=kp.budgets * (s / n))
    sub = cfg.replace(presolve_samples=0, record_history=False, postprocess=False)
    return _iterate(small, lam0, q, sub, mesh=mesh)[0]


def _validate_cfg(cfg):
    if cfg.chunk_size is not None:
        if cfg.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {cfg.chunk_size}")
        if cfg.algo == "scd" and cfg.reduce != "bucketed":
            raise ValueError(
                "chunk_size requires reduce='bucketed': the exact reduce "
                "sorts all candidates and cannot stream the item dimension")


def _on_device(kp, dev):
    def f32(t):
        return torch.as_tensor(t).to(device=dev, dtype=torch.float32).contiguous()

    out = kp._replace(p=f32(kp.p), b=f32(kp.b), budgets=f32(kp.budgets))
    if isinstance(kp, DenseKP):
        out = out._replace(sets=torch.as_tensor(kp.sets).to(dev, torch.bool),
                           caps=torch.as_tensor(kp.caps).to(dev))
    return out


def _lam0(lam0, k, cfg):
    return (torch.ones((k,), dtype=cfg.dtype) if lam0 is None
            else torch.as_tensor(lam0, dtype=cfg.dtype).cpu())


def solve(kp, cfg: SolverConfig = SolverConfig(), q: int = 1, lam0=None,
          device="cuda") -> SolveResult:
    """Single-device solve of a resident instance.

    kp: ``SparseKP`` (p, b: (n, K)) or ``DenseKP`` (p: (n, M), b: (n, M, K));
    q: the sparse at-most-Q cap (ignored for dense); lam0: (K,) warm start,
    default ones. Runs on the card unless ``device="cpu"``, and raises
    without CUDA otherwise; the instance is moved to that device. See the
    module docstring for the maps, the host tail and the chunked contract.
    """
    _validate_cfg(cfg)
    kp = _on_device(kp, resolve_device(device))
    lam0 = _presolve(kp, _lam0(lam0, kp.budgets.shape[0], cfg), q, cfg)
    return _solve_local(kp, lam0, q, cfg)


def solve_shard(kp, mesh, cfg: SolverConfig = SolverConfig(), q: int = 1,
                lam0=None) -> SolveResult:
    """:func:`solve_sharded` from this rank's own rows: ``kp`` holds rank
    r's n / D users (rows [r*n/D, (r+1)*n/D) of the instance) and the
    global budgets, so no rank ever holds the whole instance (the
    launcher draws only its own chunks). Every rank calls it, with the
    same cfg, q and lam0."""
    check_mesh(mesh)
    if mesh is None:
        raise TypeError("solve_shard needs a mesh (launch.mesh.init_mesh)")
    _validate_cfg(cfg)
    kp = _on_device(kp, mesh.device)
    lam0 = _presolve(kp, _lam0(lam0, kp.budgets.shape[0], cfg), q, cfg, mesh)
    return _solve_local(kp, lam0, q, cfg, mesh)


def solve_sharded(kp, mesh, cfg: SolverConfig = SolverConfig(), q: int = 1,
                  lam0=None, axes=None) -> SolveResult:
    """Multi-device solve: the users sharded over the ranks of ``mesh``.

    Every rank of the world (``launch.mesh``) calls it with the same global
    instance; rank r moves only its rows [r*n/D, (r+1)*n/D) to its device
    (D, the world size, must divide n). Each iteration runs the rank's map
    and then a constant-size reduce across the ranks: the (K, E+1)
    histograms (or DD's (K,) consumption) gathered and folded in rank
    order, top by max; the exact reduce gathers every rank's (v1, v2)
    instead (O(n K) through the host). ``cfg.partial_fraction < 1`` drops
    the ranks past that fraction and scales the rest (the straggler mask).
    The presolve samples each shard; the §5.4 projection is the bucketed
    one (``postprocess.feasibility_threshold_bucketed``), as in the
    reference; ``cfg.chunk_size`` chunks each rank's map, and chunked
    equals unchunked bitwise on the SCD bucketed path.

    Returns ``x`` as the rank's rows (on its device) and lam, iterations
    and the scalars replicated (CPU), the same bits on every rank. ``axes``
    other than None raises ``ValueError``: the port's mesh is flat.
    """
    check_mesh(mesh)
    if mesh is None:
        raise TypeError("solve_sharded needs a mesh (launch.mesh.init_mesh); "
                        "for one device call solve")
    if axes is not None:
        raise ValueError("axes: the port's mesh is one flat world of ranks; "
                         "users shard over all of it")
    n = kp.p.shape[0]
    if n % mesh.size:
        raise ValueError(f"the user dimension ({n}) must divide the mesh size "
                         f"({mesh.size})")
    lo, hi = mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size
    return solve_shard(kp._replace(p=kp.p[lo:hi], b=kp.b[lo:hi]), mesh, cfg, q, lam0)
