"""Wrapper of the CUDA kernel in ``csrc/adjusted_topc.cu``.

``adjusted_topc`` replaces the reference's Pallas ``adjusted_topc``
(src/repro/kernels/adjusted_topc.py): the sparse greedy primal at lam,
the top-Q strictly positive ``p - lam*b`` per row (ties to the lower
index) as a bool mask ``x`` and the consumption ``v = where(x, b, 0)``.
It checks its inputs, allocates x and v with ``torch.empty``, launches on
the current stream without synchronising and raises if the launch
returned a CUDA error. CUDA tensors only; ``kernels.ops`` sends CPU
tensors to ``ref.adjusted_topc_plain``.
"""
from __future__ import annotations

import torch

from . import _build
from ._wrap import KWIDE, check_p_b_lam, launched, stream_of

__all__ = ["adjusted_topc"]


def adjusted_topc(p, b, lam, q):
    """Greedy primal on the card: p, b (n, K) f32 CUDA with K <= 256, lam
    (K,) -> (x (n, K) bool, v (n, K) f32)."""
    n, k = check_p_b_lam("adjusted_topc", p, b, lam, kmax=KWIDE)
    lib = _build.load()
    x = torch.empty((n, k), dtype=torch.bool, device=p.device)
    v = torch.empty((n, k), dtype=torch.float32, device=p.device)
    err = lib.adjusted_topc_launch(p.data_ptr(), b.data_ptr(), lam.data_ptr(),
                                   x.data_ptr(), v.data_ptr(), n, k, q,
                                   stream_of(p))
    launched("adjusted_topc", err, lib)
    return x, v
