"""Synthetic KP instances, restart-deterministic per chunk: NumPy chunks
for the host-fed driver, and chunks generated on the device for the
device-streamed one."""
from __future__ import annotations

import numpy as np
import torch

from ..core.chunked import ChunkSource
from ..core.prefetch import HostChunkSource
from ..core.solver import resolve_device


def sparse_chunk_source(seed, n, k, chunk, q=1, tightness=0.5, b_high=1.0,
                        device="cuda") -> ChunkSource:
    """§6 sparse instance generated on ``device``, chunk by chunk.

    Chunk ``i`` is a pure function of ``(seed, i)`` on one device: a
    ``torch.Generator`` there, seeded with ``seed * 2**32 + i``, draws
    p ~ U[0, 1) and then b ~ U[0, b_high); rows past n are zero. The
    (n, K) instance never exists anywhere, so the device-streamed solve
    holds O(chunk x K) whatever n is. The bytes are not ``jax.random``'s
    (nor the NumPy sources'), and a generator's stream may differ between
    device types: compare solves on one device. Budgets follow the
    reference's formula in float32, ``tightness * n * q * (b_high / 2) / k``.
    """
    dev = resolve_device(device)
    budgets = torch.full((k,), tightness * n * q * (b_high / 2.0) / k,
                         dtype=torch.float32)
    gen = torch.Generator(device=dev)
    rows = torch.arange(chunk, device=dev)

    def fn(i):
        i = int(i)
        gen.manual_seed((seed & 0xFFFFFFFF) << 32 | (i & 0xFFFFFFFF))
        p = torch.rand((chunk, k), generator=gen, device=dev)
        b = torch.rand((chunk, k), generator=gen, device=dev) * b_high
        if (i + 1) * chunk > n:
            live = ((i * chunk + rows) < n)[:, None]
            p, b = torch.where(live, p, 0.0), torch.where(live, b, 0.0)
        return p, b

    return ChunkSource(n=n, k=k, chunk=chunk, budgets=budgets, fn=fn)


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
