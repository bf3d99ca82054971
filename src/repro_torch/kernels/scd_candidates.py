"""Wrapper of the CUDA kernel in ``csrc/scd_candidates.cu``.

``scd_candidates`` replaces the reference's Pallas ``scd_candidates``
(src/repro/kernels/scd_candidates.py): the unfused Alg-5 map, writing the
(n, K) candidate arrays. It checks its inputs, allocates v1 and v2 with
``torch.empty``, launches on the current stream without synchronising and
raises if the launch returned a CUDA error. CUDA tensors only;
``kernels.ops`` sends CPU tensors to ``ref.candidates_block``.
"""
from __future__ import annotations

import torch

from . import _build
from ._wrap import check_p_b_lam, launched, stream_of

__all__ = ["scd_candidates"]


def scd_candidates(p, b, lam, q):
    """Alg-5 candidates on the card: p, b (n, K) f32 CUDA, lam (K,) ->
    (v1, v2) (n, K); invalid candidates are (-1, 0)."""
    n, k = check_p_b_lam("scd_candidates", p, b, lam)
    lib = _build.load()
    v1 = torch.empty((n, k), dtype=torch.float32, device=p.device)
    v2 = torch.empty((n, k), dtype=torch.float32, device=p.device)
    err = lib.scd_candidates_launch(p.data_ptr(), b.data_ptr(), lam.data_ptr(),
                                    v1.data_ptr(), v2.data_ptr(), n, k, q,
                                    stream_of(p))
    launched("scd_candidates", err, lib)
    return v1, v2
