"""Wrapper of the CUDA kernel in ``csrc/screen_bound.cu``.

``screen_bound`` replaces the reference's Pallas ``screen_bound``
(src/repro/kernels/screen_bound.py): the (K,) screening certificate of a
chunk, the column max of ``p / b`` over rows with ``b > 0`` (-inf where a
column has none). It checks its inputs, launches the one kernel on the
current stream without synchronising, and raises if the launch returned a
CUDA error. The partials and the ticket come from buffers kept per
(device, stream) (``_wrap.screen_scratch``, ``_wrap.tickets``), and the
result goes into ``out`` when given (the screened driver passes its chunk's
row of the certificate buffer), so such a call allocates nothing. CUDA
tensors only; ``kernels.ops`` sends CPU tensors to
``ref.screen_bound_plain``.
"""
from __future__ import annotations

import torch

from . import _build
from ._wrap import check, check_rows, launched, screen_scratch, stream_of, tickets

__all__ = ["screen_bound"]


def screen_bound(p, b, out=None):
    """Chunk certificate on the card: p, b (n, K) f32 CUDA -> (K,) f32,
    written into ``out`` (a contiguous (K,) f32 tensor on p's device) when
    given, and returned."""
    n, k = check_rows("screen_bound", p)
    check("p", p, (n, k), p.device)
    check("b", b, (n, k), p.device)
    if out is None:
        out = torch.empty((k,), dtype=torch.float32, device=p.device)
    else:
        check("out", out, (k,), p.device)
    lib = _build.load()
    part, sms = screen_scratch(p)
    err = lib.screen_bound_launch(p.data_ptr(), b.data_ptr(), part.data_ptr(),
                                  tickets(p, 1).data_ptr(), out.data_ptr(), n, k, sms,
                                  part.numel(), stream_of(p))
    launched("screen_bound", err, lib)
    return out
