"""Wrapper of the CUDA kernel in ``csrc/bucket_hist.cu``.

``bucket_hist`` replaces the reference's Pallas ``bucket_hist``
(src/repro/kernels/bucket_hist.py): the §5.2 histogram of (n, K)
candidates, here with an optional ``hist_init`` seed that the ordered fold
starts from (the reference's chunked dense map scatters onto its running
histogram in jnp instead). It checks its inputs, allocates its scratch
and output with ``torch.empty``, launches one kernel (which folds its
records itself) on the current stream without synchronising and raises if
the launch returned a CUDA error. CUDA tensors only; ``kernels.ops`` sends CPU
tensors to ``ref.bucket_hist_plain``.
"""
from __future__ import annotations

from . import _build, ref
from ._wrap import check, check_rows, flat_seed, hist_buffers, launched, ptr, stream_of

__all__ = ["bucket_hist"]


def bucket_hist(v1, v2, edges, tile_n=ref.MAP_TILE, hist_init=None):
    """§5.2 histogram on the card, in one launch: v1, v2 (n, K) f32 CUDA;
    edges (K, E) ascending per row; tile_n any size >= 1. Returns (K, E+1):
    the v2 mass per searchsorted-left bucket of v1, folded onto
    ``hist_init`` (zeros) in tile order."""
    tile_n = min(tile_n, v1.shape[0])
    n, k = check_rows("bucket_hist", v1, tile_n, max_tile=None)
    check("v1", v1, (n, k), v1.device)
    check("v2", v2, (n, k), v1.device)
    e = edges.shape[-1]
    check("edges", edges, (k, e), v1.device)
    hist_init = flat_seed("hist_init", hist_init, k * (e + 1), v1.device)
    lib = _build.load()
    scratch, tickets, out = hist_buffers(lib, v1, e, tile_n, False)
    err = lib.bucket_hist_launch(v1.data_ptr(), v2.data_ptr(), edges.data_ptr(),
                                 ptr(hist_init), scratch.data_ptr(), tickets.data_ptr(),
                                 out.data_ptr(), n, k, e, tile_n, stream_of(v1))
    launched("bucket_hist", err, lib)
    return out.view(k, e + 1)
