"""Synthetic host-side KP instances, restart-deterministic per chunk."""
from __future__ import annotations

import numpy as np

from ..core.prefetch import HostChunkSource


def sparse_host_chunk_source(seed, n, k, chunk, q=1, tightness=0.5,
                             b_high=1.0):
    """§6 sparse instance as NumPy chunks: chunk ``i`` is a pure function
    of ``(seed, i)`` (NumPy Philox, counter = i), so any worker regenerates
    it byte for byte. p ~ U[0, 1), b ~ U[0, b_high); budgets
    ``tightness * n * q * (b_high / 2) / k``; rows past n are zero."""
    budgets = np.full((k,), tightness * n * q * (b_high / 2.0) / k,
                      np.float32)

    def fn(i):
        rng = np.random.Generator(np.random.Philox(key=seed, counter=i))
        p = rng.random((chunk, k), np.float32)
        b = rng.random((chunk, k), np.float32) * np.float32(b_high)
        live = ((i * chunk + np.arange(chunk)) < n)[:, None]
        return np.where(live, p, 0.0).astype(np.float32), \
            np.where(live, b, 0.0).astype(np.float32)

    return HostChunkSource(n=n, k=k, chunk=chunk, budgets=budgets, fn=fn)


def banded_host_chunk_source(seed, n, k, chunk, q=1, tightness=0.5,
                             band=0.05, period=8, b_lo=0.5):
    """Ratio-banded instance as NumPy chunks: the screening workload.

    The reference's generator, byte for byte (NumPy Philox, counter = i).
    Costs are uniform on [b_lo, 1); chunk ``i``'s profits are uniform on
    [0, band) (a cold cohort) except every ``period``-th chunk, uniform on
    [0, 1) (a hot one). With ``band=0.05, b_lo=0.5`` a cold chunk's ratios
    stay below 0.1 while the multipliers settle near the hot chunks'
    marginal ratio, so cold chunks retire after the first epoch. Budgets
    ``tightness * n * q * ((b_lo + 1) / 2) / k``; rows past n are zero.
    """
    budgets = np.full((k,), tightness * n * q * ((b_lo + 1.0) / 2.0) / k,
                      np.float32)

    def fn(i):
        rng = np.random.Generator(np.random.Philox(key=seed, counter=i))
        scale = np.float32(1.0 if i % period == 0 else band)
        p = rng.random((chunk, k), np.float32) * scale
        b = np.float32(b_lo) + rng.random((chunk, k), np.float32) \
            * np.float32(1.0 - b_lo)
        live = ((i * chunk + np.arange(chunk)) < n)[:, None]
        return np.where(live, p, 0.0).astype(np.float32), \
            np.where(live, b, 0.0).astype(np.float32)

    return HostChunkSource(n=n, k=k, chunk=chunk, budgets=budgets, fn=fn)
