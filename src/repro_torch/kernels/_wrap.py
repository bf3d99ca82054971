"""What the kernel wrappers share: input checks, the launch check, the
launch counts and the scratch kept per (device, stream): ticket counters
and ``screen_bound``'s partials.

``LAUNCHES`` counts the launches of each kernel, one per wrapper call
that launched it (the wrappers in ``scd_fused``, ``scd_candidates``,
``bucket_hist``, ``screen_bound`` and ``adjusted_topc``);
``reset_launches`` sets every count to 0.
"""
from __future__ import annotations

import torch

KMAX = 64
MAX_TILE = 1024
MAX_SMEM = 232448

LAUNCHES = {"scd_fused_hist": 0, "scd_finalize_hist": 0, "scd_candidates": 0,
            "bucket_hist": 0, "screen_bound": 0, "adjusted_topc": 0}


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check(name, t, shape, device):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(fn, x, tile_n=None, max_tile=MAX_TILE):
    """Raise unless ``x`` is an (n, K) CUDA tensor with n >= 1, 1 <= K <= KMAX
    (and, when given, 1 <= tile_n <= max_tile; None: no cap); returns (n, K)."""
    if not x.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel and takes CUDA tensors; "
                         f"got one on {x.device} (kernels.ops sends CPU tensors "
                         "to the plain version)")
    if x.dim() != 2:
        raise ValueError(f"{fn} takes (n, K) rows, got shape {tuple(x.shape)}")
    n, k = x.shape
    if n < 1 or not 1 <= k <= KMAX:
        raise ValueError(f"{fn} takes 1 <= K <= {KMAX} and n >= 1, got {(n, k)}")
    if tile_n is not None and (tile_n < 1 or (max_tile and tile_n > max_tile)):
        raise ValueError(f"tile_n must be in [1, {max_tile or 'any'}], got {tile_n}")
    return n, k


def check_p_b_lam(fn, p, b, lam, tile_n=None, max_tile=MAX_TILE):
    """``check_rows`` of p, then p, b (n, K) and lam (K,); returns (n, K)."""
    n, k = check_rows(fn, p, tile_n, max_tile)
    check("p", p, (n, k), p.device)
    check("b", b, (n, k), p.device)
    check("lam", lam, (k,), p.device)
    return n, k


def check_smem(smem, tile_n, k, e):
    if smem > MAX_SMEM:
        raise ValueError(f"tile_n={tile_n}, K={k}, E={e} needs {smem} bytes of "
                         f"shared memory per block, above {MAX_SMEM}")


def flat_seed(name, x, numel, device):
    """An optional seed as a flat contiguous float32 tensor of ``numel`` on
    ``device`` (None stays None: the kernel starts from zeros or -inf)."""
    if x is None:
        return None
    if (x.dtype == torch.float32 and x.device == device and x.numel() == numel
            and x.is_contiguous()):
        return x                      # the kernel reads it as flat as it is
    x = x.reshape(-1).to(torch.float32).contiguous()
    check(name, x, (numel,), device)
    return x


def ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


_TICKETS: dict = {}
_SCREEN: dict = {}


def tickets(x, need):
    """int32 counters for the kernels' last-block tickets on ``x``'s device
    and current stream, at least ``need`` of them, all zero: each kernel
    puts the counters it takes back to zero, so one buffer per (device,
    stream) serves every call on that stream and grows when a call needs
    more."""
    key = (x.device, stream_of(x))
    t = _TICKETS.get(key)
    if t is None or t.numel() < need:
        t = torch.zeros((max(need, 4096),), dtype=torch.int32, device=x.device)
        _TICKETS[key] = t
    return t


def hist_buffers(lib, x, e, tile_n, fused):
    """What one launch of the histogram kernels of ``csrc/hist_tile.cuh`` on
    the (n, K) rows ``x`` needs beside its inputs: (scratch, tickets, out).
    The scratch holds the sub-tile and tile records."""
    (n, k), device = x.shape, x.device
    check_smem(lib.hist_smem_bytes(k, e, tile_n, int(fused)), tile_n, k, e)
    rec = k * (e + 1) + (k if fused else 0)
    scratch = torch.empty((lib.hist_scratch(n, k, e, tile_n, int(fused)),),
                          dtype=torch.float32, device=device)
    out = torch.empty((rec,), dtype=torch.float32, device=device)
    return scratch, tickets(x, -(-n // tile_n) + 1), out


def screen_scratch(x):
    """What ``screen_bound`` needs on ``x``'s device and current stream,
    made once and kept: (partials, SM count). The kernel runs at most
    2 x SMs + KMAX blocks of K <= KMAX partial maxima, each written before
    it is read, so the buffer is never cleared."""
    key = (x.device, stream_of(x))
    hit = _SCREEN.get(key)
    if hit is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        part = torch.empty(((2 * sms + KMAX) * KMAX,), dtype=torch.float32,
                           device=x.device)
        hit = _SCREEN[key] = (part, sms)
    return hit


def launched(fn, err, lib):
    """Raise if the launch returned a CUDA error; else count it."""
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.scd_error_string(err).decode()})")
    LAUNCHES[fn] += 1


def stream_of(t):
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
