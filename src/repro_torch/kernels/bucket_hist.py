"""Wrapper of the CUDA kernel in ``csrc/bucket_hist.cu``.

``bucket_hist`` replaces the reference's Pallas ``bucket_hist``
(src/repro/kernels/bucket_hist.py): the §5.2 histogram of (n, K)
candidates, here with an optional ``hist_init`` seed that the ordered fold
starts from (the reference's chunked dense map scatters onto its running
histogram in jnp instead). It checks its inputs, allocates the per-tile
partials and the output with ``torch.empty``, launches the tile kernel and
the fold on the current stream without synchronising and raises if the
launch returned a CUDA error. CUDA tensors only; ``kernels.ops`` sends CPU
tensors to ``ref.bucket_hist_plain``.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._wrap import check, check_rows, check_smem, launched, stream_of

__all__ = ["bucket_hist"]


def bucket_hist(v1, v2, edges, tile_n=512, hist_init=None):
    """§5.2 histogram on the card: v1, v2 (n, K) f32 CUDA; edges (K, E)
    ascending per row. Returns (K, E+1): the v2 mass per searchsorted-left
    bucket of v1, folded onto ``hist_init`` (zeros) in tile order."""
    tile_n = min(tile_n, v1.shape[0])
    n, k = check_rows("bucket_hist", v1, tile_n)
    check("v1", v1, (n, k), v1.device)
    check("v2", v2, (n, k), v1.device)
    e = edges.shape[-1]
    check("edges", edges, (k, e), v1.device)
    lib = _build.load()
    check_smem(lib.bucket_hist_smem_bytes(k, e, tile_n), tile_n, k, e)
    init = ref.pack_hist_init(k, e, hist_init, v1.device)
    n_tiles = -(-n // tile_n)
    part = torch.empty((n_tiles, k * (e + 1)), dtype=torch.float32, device=v1.device)
    out = torch.empty((k * (e + 1),), dtype=torch.float32, device=v1.device)
    err = lib.bucket_hist_launch(v1.data_ptr(), v2.data_ptr(), edges.data_ptr(),
                                 init.data_ptr(), part.data_ptr(), out.data_ptr(),
                                 n, k, e, tile_n, stream_of(v1))
    launched("bucket_hist", err, lib)
    return out.view(k, e + 1)
