"""What each kernel launch costs, from its shapes alone, and the kernels'
shape path on the ``meta`` device.

For each of the six kernels (both the ``KMAX`` and the ``KWIDE`` instance
of ``scd_fused_hist`` and ``adjusted_topc``: the K bound is the only
difference) one function gives, from the shapes, q and the tile, a
:class:`Cost`: the output shapes and dtypes, the scratch that the card's
wrapper allocates beside them (``_wrap.hist_buffers``, the finalize's tile
records), the bytes the function must move (each input read once, each
output written once) and its float32 operations. ``bound_ms`` turns bytes
and operations into the least time an H100 SXM could take. The on-card
smoke (``chip_smoke.py``) and the dry-run (``launch/dryrun.py``) use these
formulas, so one formula serves both.

``kernels.ops`` sends a ``meta`` tensor to :func:`on_meta`: it allocates
the scratch and the outputs on ``meta`` (so a live-memory tracker counts
them), records ``(kernel, n, K, E, q, tile, bytes, ops)`` into the active
:func:`recording`, and returns the empty outputs. The kernel's plain
version is never run there: it walks its tiles in Python, and the record
shows the kernel's work. Persistent per-stream buffers (the ticket
counters, ``screen_bound``'s partials) are made once a process and are not
counted.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import ref
from ._wrap import HIST_SUB, KMAX, KWIDE, MAX_SMEM, MAX_TILE, check_smem, hist_smem_bytes

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

F32, BOOL = torch.float32, torch.bool


class Cost(NamedTuple):
    """One launch's shapes and work: ``outputs`` and ``scratch`` are lists of
    (shape, dtype); ``bytes`` and ``ops`` the function's traffic and float32
    operations."""
    outputs: list
    scratch: list
    bytes: int
    ops: int


def bound_ms(bytes_, ops):
    """(least time in ms for this work on an H100 SXM, "bytes" or
    "operations": which of the two bounds it)."""
    tb, to = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _tiles(n, tile):
    return -(-n // max(tile, 1))


def hist_scratch(n, k, e, tile_n, fused):
    """Floats of the histogram kernels' sub-tile and tile records
    (``hist_scratch_floats`` of ``csrc/hist_tile.cuh``)."""
    rec = k * (e + 1) + (k if fused else 0)
    subs = -(-tile_n // HIST_SUB)
    return (_tiles(n, tile_n) * subs * rec if subs > 1 else 0) + _tiles(n, tile_n) * rec


def _round4(x):
    return (x + 3) & ~3


def finalize_part_stride(k, e):
    """Floats between two finalize tile records (``scd_finalize_part_stride``
    of ``csrc/scd_fused.cu``: the record rounded up to a multiple of 4)."""
    return _round4((k * (e + 1) + e + 1 if e > 0 else 0) + k + 4)


def finalize_smem_bytes(k, e, tile_n):
    """Dynamic shared memory of a finalize block (``scd_finalize_smem_bytes``
    of ``csrc/scd_fused.cu``): the tile's b, a stage of ``sub`` rows of p
    (the whole tile where it fits, else halving by 32-row steps), the
    edges, lam, per-row and per-bin words and the per-warp maxima."""
    nb, warps = (e + 1 if e > 0 else 0), -(-tile_n // 32)

    def floats(sub):
        return (_round4(tile_n * k) + _round4(sub * k) + e + k + 3 * tile_n
                + nb * (warps + 2) + (1 if nb else 0) + 2 * 32)
    sub = tile_n
    while 4 * floats(sub) > MAX_SMEM:
        if sub <= 32:
            return 4 * floats(min(32, tile_n))
        sub = (sub // 2 + 31) // 32 * 32
    return 4 * floats(sub)


def check_launch(kernel, n, k, e, tile_n):
    """Raise ``ValueError`` where the card's wrapper would refuse the launch:
    no rows, K above the kernel's bound (``KWIDE`` for the router's two,
    ``KMAX`` for the others), a block's shared memory above ``MAX_SMEM``
    (the histogram kernels and the finalize), a finalize tile above
    ``MAX_TILE``."""
    kmax = KWIDE if kernel in ("scd_fused_hist", "adjusted_topc") else KMAX
    if n < 1 or not 1 <= k <= kmax:
        raise ValueError(f"{kernel} takes 1 <= K <= {kmax} and n >= 1, got {(n, k)}")
    if kernel in ("scd_fused_hist", "bucket_hist"):
        check_smem(hist_smem_bytes(k, e, tile_n, kernel == "scd_fused_hist"), tile_n, k, e)
    elif kernel == "scd_finalize_hist":
        if not 1 <= tile_n <= MAX_TILE:
            raise ValueError(f"tile_n must be in [1, {MAX_TILE}], got {tile_n}")
        check_smem(finalize_smem_bytes(k, e, tile_n), tile_n, k, e)


def scd_fused_hist(n, k, e, q, tile_n=ref.MAP_TILE):
    """Fused map + histogram over (n, K) rows against (K, E) edges: reads
    p, b, lam, the edges and the seeds, writes the (K, E+1) histogram and
    (K,) top; 8 + E + q + 1 operations a row and item."""
    tile_n = min(tile_n, n)
    rec = ref.fused_layout(k, e)[0]
    return Cost([((rec,), F32)], [((hist_scratch(n, k, e, tile_n, True),), F32)],
                4 * (2 * n * k + k) + 4 * (k * e + 2 * rec),
                n * k * (8 + e + q + 1))


def scd_finalize_hist(n, k, e, q, tile_n=512, with_hist=True):
    """Fused streaming finalize over (n, K) rows against E profit edges
    (E = 0 without the histograms): reads p, b, lam, the edges and the
    seeds, writes the record; (5 + q) operations a row and item and
    E + K + 1 a row."""
    tile_n = min(tile_n, n)
    e = e if with_hist else 0
    rec = ref.finalize_layout(k, e, with_hist)[0]
    return Cost([((rec + 1,), F32)],
                [((_tiles(n, tile_n), finalize_part_stride(k, e)), F32)],
                4 * (2 * n * k + k) + 4 * (e + 2 * rec),
                n * k * (5 + q) + n * (e + k + 1))


def scd_candidates(n, k, q):
    """Unfused map: reads p, b, lam, writes v1 and v2 (n, K)."""
    return Cost([((n, k), F32), ((n, k), F32)], [], 4 * (4 * n * k + k),
                n * k * (11 + 2 * q))


def bucket_hist(n, k, e, tile_n=ref.MAP_TILE, v1_width=None):
    """Histogram of (n, K) candidates against (K, E) edges: reads v1, v2,
    the edges and the seed, writes (K, E+1); E + 1 operations a row and
    item. ``v1_width=1``: the v1 the function is given is one value a row,
    broadcast over K by the caller (``postprocess.removable_hist``, whose
    edges are one (E,) ladder)."""
    tile_n = min(tile_n, n)
    rec = k * (e + 1)
    if v1_width == 1:
        read = 4 * (n + n * k + e)
    else:
        read = 4 * (2 * n * k + k * e)
    return Cost([((rec,), F32)], [((hist_scratch(n, k, e, tile_n, False),), F32)],
                read + 4 * 2 * rec, n * k * (e + 1))


def screen_bound(n, k, out=False):
    """Column max of p / b over b > 0: reads p and b, writes (K,); two
    operations a row and item. ``out``: the caller gives the output."""
    return Cost([] if out else [((k,), F32)], [], 4 * (2 * n * k + k), 2 * n * k)


def adjusted_topc(n, k, q):
    """Greedy top-q at lam: reads p, b, lam, writes x (bool) and v (n, K);
    2 + 2q operations a row and item."""
    return Cost([((n, k), BOOL), ((n, k), F32)], [], 4 * (2 * n * k + k) + 5 * n * k,
                n * k * (2 + 2 * q))


# --------------------------------------------------------------------------
# The shape path on ``meta``.
# --------------------------------------------------------------------------

_RECORD = []


@contextlib.contextmanager
def recording():
    """Collect the meta launches inside into the list this yields: one dict
    a launch, ``kernel n k e q tile bytes ops``."""
    rec = []
    _RECORD.append(rec)
    try:
        yield rec
    finally:
        _RECORD.remove(rec)


def _empty(spec, device):
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device=device)


def on_meta(kernel, x, cost, e=0, q=0, tile=0):
    """The launch of ``kernel`` on the (n, K) meta rows ``x``, refused where
    the card's wrapper refuses it (:func:`check_launch`): its scratch and
    outputs allocated on ``x``'s device (the scratch freed on return, as
    the card's wrapper frees it) and the launch recorded. Returns the
    outputs, a list of empty tensors."""
    n, k = x.shape
    check_launch(kernel, n, k, e, tile)
    scratch = [_empty(s, x.device) for s in cost.scratch]
    outs = [_empty(s, x.device) for s in cost.outputs]
    for rec in _RECORD:
        rec.append({"kernel": kernel, "n": n, "k": k, "e": e, "q": q, "tile": tile,
                    "bytes": cost.bytes, "ops": cost.ops})
    del scratch
    return outs


def summary(record):
    """Launches, bytes, operations and the summed ``bound_ms`` of each
    kernel in a record (a launch's bound is its own, so bounds add)."""
    out = {}
    for r in record:
        s = out.setdefault(r["kernel"], {"launches": 0, "bytes": 0, "ops": 0,
                                         "bound_ms": 0.0})
        s["launches"] += 1
        s["bytes"] += r["bytes"]
        s["ops"] += r["ops"]
        s["bound_ms"] += bound_ms(r["bytes"], r["ops"])[0]
    return out
