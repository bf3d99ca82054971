"""Wrappers of the two CUDA kernels in ``csrc/scd_fused.cu``.

``scd_fused_hist`` replaces the reference's Pallas ``scd_fused_hist``
(src/repro/kernels/scd_fused.py, ``_kernel``) and ``scd_finalize_hist``
its ``_finalize_kernel``, with the same signatures and ``*_init`` seeds.
Each wrapper checks its inputs, allocates the per-tile partials and the
output with ``torch.empty``, launches the tile kernel and the ordered fold
on the current stream without synchronising, and raises if the launch
returned a CUDA error. They take CUDA tensors only; ``kernels.ops``
sends CPU tensors to the plain versions in ``kernels/ref.py``.

``LAUNCHES`` counts the launches of each kernel, one per wrapper call.
"""
from __future__ import annotations

import torch

from . import _build, ref

KMAX = 64
MAX_TILE = 1024
MAX_SMEM = 232448

LAUNCHES = {"scd_fused_hist": 0, "scd_finalize_hist": 0}


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(fn, p, b, lam, tile_n):
    if not p.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel and takes CUDA tensors; "
                         f"got p on {p.device} (kernels.ops sends CPU tensors "
                         "to the plain version)")
    if p.dim() != 2:
        raise ValueError(f"p must be (n, K), got shape {tuple(p.shape)}")
    n, k = p.shape
    if n < 1 or not 1 <= k <= KMAX:
        raise ValueError(f"{fn} takes 1 <= K <= {KMAX} and n >= 1, got {(n, k)}")
    if not 1 <= tile_n <= MAX_TILE:
        raise ValueError(f"tile_n must be in [1, {MAX_TILE}], got {tile_n}")
    _check("p", p, (n, k), p.device)
    _check("b", b, (n, k), p.device)
    _check("lam", lam, (k,), p.device)
    return n, k


def _launch(fn, err, lib):
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.scd_error_string(err).decode()})")
    LAUNCHES[fn] += 1


def scd_fused_hist(p, b, lam, edges, q, tile_n=512, hist_init=None,
                   top_init=None):
    """Fused Alg-5 map + §5.2 histogram on the card.

    p, b: (n, K) f32 CUDA; lam: (K,); edges: (K, E) ascending per row.
    Returns (hist (K, E+1), top (K,)): the v2 mass per searchsorted-left
    bucket of v1 and the max of v1, folded onto ``hist_init`` (zeros) and
    ``top_init`` (-inf) in tile order.
    """
    tile_n = min(tile_n, p.shape[0])
    n, k = _check_rows("scd_fused_hist", p, b, lam, tile_n)
    e = edges.shape[-1]
    _check("edges", edges, (k, e), p.device)
    lib = _build.load()
    smem = lib.scd_fused_smem_bytes(k, e, tile_n)
    if smem > MAX_SMEM:
        raise ValueError(f"tile_n={tile_n}, K={k}, E={e} needs {smem} bytes of "
                         f"shared memory per block, above {MAX_SMEM}")
    init = ref.pack_fused_init(k, e, hist_init, top_init, p.device)
    rec, _ = ref.fused_layout(k, e)
    n_tiles = -(-n // tile_n)
    part = torch.empty((n_tiles, rec), dtype=torch.float32, device=p.device)
    out = torch.empty((rec,), dtype=torch.float32, device=p.device)
    err = lib.scd_fused_hist_launch(
        p.data_ptr(), b.data_ptr(), lam.data_ptr(), edges.data_ptr(),
        init.data_ptr(), part.data_ptr(), out.data_ptr(), n, k, e, q, tile_n,
        torch.cuda.current_stream(p.device).cuda_stream)
    _launch("scd_fused_hist", err, lib)
    return ref.unpack_fused(out, k, e)


def scd_finalize_hist(p, b, lam, pedges, q, tile_n=512, with_hist=True,
                      cons_hist_init=None, gain_hist_init=None, r_init=None,
                      sums_init=None, maxs_init=None):
    """Fused streaming-finalize pass on the card.

    Greedy top-Q at lam; r (K,), primal, dual sum and the (lo, hi) range
    of the per-row group profit over rows that selected anything; with
    ``with_hist`` the removable consumption (K, E+1) and raw-profit (E+1,)
    histograms of that profit against ``pedges`` (E,). Seeds: ``r_init``,
    ``sums_init`` (primal, dual), ``maxs_init`` (hi, -lo) and the
    histogram inits. Returns (cons_hist, gain_hist, r, primal, dual, lo, hi).
    """
    tile_n = min(tile_n, p.shape[0])
    n, k = _check_rows("scd_finalize_hist", p, b, lam, tile_n)
    e = 0
    if with_hist:
        e = pedges.shape[-1]
        _check("pedges", pedges, (e,), p.device)
    lib = _build.load()
    smem = lib.scd_finalize_smem_bytes(k, e, tile_n)
    if smem > MAX_SMEM:
        raise ValueError(f"tile_n={tile_n}, K={k}, E={e} needs {smem} bytes of "
                         f"shared memory per block, above {MAX_SMEM}")
    init = ref.pack_finalize_init(k, e, with_hist, p.device, cons_hist_init,
                                  gain_hist_init, r_init, sums_init, maxs_init)
    rec, _ = ref.finalize_layout(k, e, with_hist)
    n_tiles = -(-n // tile_n)
    part = torch.empty((n_tiles, rec), dtype=torch.float32, device=p.device)
    out = torch.empty((rec,), dtype=torch.float32, device=p.device)
    err = lib.scd_finalize_hist_launch(
        p.data_ptr(), b.data_ptr(), lam.data_ptr(),
        pedges.data_ptr() if with_hist else None,
        init.data_ptr(), part.data_ptr(), out.data_ptr(), n, k, e, q, tile_n,
        int(with_hist), torch.cuda.current_stream(p.device).cuda_stream)
    _launch("scd_finalize_hist", err, lib)
    return ref.unpack_finalize(out, k, e, with_hist)
