"""Wrapper of the CUDA kernel in ``csrc/screen_bound.cu``.

``screen_bound`` replaces the reference's Pallas ``screen_bound``
(src/repro/kernels/screen_bound.py): the (K,) screening certificate of a
chunk, the column max of ``p / b`` over rows with ``b > 0`` (-inf where a
column has none). It checks its inputs, allocates the per-tile partials
and the output with ``torch.empty``, launches the tile kernel and the
ordered fold on the current stream without synchronising, and raises if
the launch returned a CUDA error. CUDA tensors only; ``kernels.ops`` sends
CPU tensors to ``ref.screen_bound_plain``.
"""
from __future__ import annotations

import torch

from . import _build
from ._wrap import check, check_rows, launched, stream_of

__all__ = ["screen_bound"]

TILE = 1024          # rows per block: 256 threads, four rows each


def screen_bound(p, b):
    """Chunk certificate on the card: p, b (n, K) f32 CUDA -> (K,) f32."""
    n, k = check_rows("screen_bound", p)
    check("p", p, (n, k), p.device)
    check("b", b, (n, k), p.device)
    lib = _build.load()
    n_tiles = -(-n // TILE)
    init = torch.full((k,), float("-inf"), dtype=torch.float32, device=p.device)
    part = torch.empty((n_tiles, k), dtype=torch.float32, device=p.device)
    out = torch.empty((k,), dtype=torch.float32, device=p.device)
    err = lib.screen_bound_launch(p.data_ptr(), b.data_ptr(), init.data_ptr(),
                                  part.data_ptr(), out.data_ptr(), n, k, TILE,
                                  stream_of(p))
    launched("screen_bound", err, lib)
    return out
