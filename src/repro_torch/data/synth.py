"""Synthetic data, restart-deterministic per (seed, step, shard): token
batches for LM training, KP shards, NumPy chunks for the host-fed driver
and chunks generated on the device for the device-streamed one
(``src/repro/data/synth.py``).

After a failure any worker regenerates exactly the byte-identical batch or
shard it would have seen, so checkpoint and restart never replay or skip
data. The reference draws ``jax.random``, which PyTorch cannot reproduce;
these draw NumPy Philox (or a ``torch.Generator`` on the device), so a
test carries one package's batch or instance into the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.chunked import ChunkSource
from ..core.prefetch import HostChunkSource, sharded_source
from ..core.solver import resolve_device


def lm_batch(cfg, cell_or_shape, step, seed=0, device="cuda"):
    """Token batch for ``train_step`` on ``device``. cell_or_shape:
    ShapeCell or (b, s).

    A pure function of ``(seed, step)`` (NumPy Philox keyed by both), with
    the reference's structure: a learnable stream whose target is a fixed
    affine function of the input token, ``(7 t + 3) % vocab``, with 10 % of
    the targets replaced by uniform noise, so a model that learns anything
    drives the loss well below ln(vocab) within tens of steps. Vision
    configs get ``patches`` and audio ones ``frames``: N(0, 1) in
    ``cfg.dtype``, times 0.02.
    """
    from ..models import model as M

    dev = resolve_device(device)
    if hasattr(cell_or_shape, "global_batch"):
        b, s = cell_or_shape.global_batch, cell_or_shape.seq_len
    else:
        b, s = cell_or_shape
    tl = M._text_len(cfg, s)
    rng = np.random.Generator(np.random.Philox(
        key=np.array([seed & (2 ** 64 - 1), step & (2 ** 64 - 1)], np.uint64)))
    toks = rng.integers(0, cfg.vocab, (b, tl))
    clean = (toks * 7 + 3) % cfg.vocab
    noise = rng.integers(0, cfg.vocab, (b, tl))
    flip = rng.random((b, tl)) < 0.1
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    batch = {"tokens": put(toks), "targets": put(np.where(flip, noise, clean))}

    def normal(shape):
        x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, cfg.dtype)
        return x * 0.02

    if cfg.kind == "encdec":
        batch["frames"] = normal((b, max(s // 2, 8), cfg.d_model))
    if cfg.n_patches:
        batch["patches"] = normal((b, cfg.n_patches, cfg.d_model))
    return batch


def kp_shard(workload, shard: int, n_shards: int, seed: int = 0, device="cuda"):
    """Shard ``shard`` of ``n_shards`` of a paper-scale sparse instance (§6
    setup) on ``device``: ``instances.sparse_instance`` at the shard's
    ``n_users // n_shards`` rows, keyed by ``instances.shard_key(seed,
    shard)``, so a pure function of ``(seed, shard)``, different for each
    shard. Budgets are global: the shard-local ones times ``n_shards``.
    Returns (SparseKP, q)."""
    from ..core.instances import shard_key, sparse_instance

    dev = resolve_device(device)
    n_local = workload.n_users // n_shards
    kp, q = sparse_instance(shard_key(seed, shard), n_local, workload.k, workload.q,
                            tightness=workload.tightness, device=dev)
    return kp._replace(budgets=kp.budgets * n_shards), q


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


def sparse_host_shard_sources(seed, n, k, chunk, slots, q=1, tightness=0.5,
                              b_high=1.0):
    """Per-slot host sources of one §6 instance: ``prefetch.sharded_source``
    over :func:`sparse_host_chunk_source`. Slot ``s`` serves the chunk range
    [s*cps, (s+1)*cps), cps = ceil(c / slots), and inert zero chunks past
    the last one. The Philox counter is the global chunk index, so a worker
    resumed on fewer ranks, owning other slots, regenerates the bytes the
    lost worker streamed. Returns a list of ``slots`` HostChunkSources."""
    return sharded_source(
        sparse_host_chunk_source(seed, n, k, chunk, q=q, tightness=tightness,
                                 b_high=b_high), slots)


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
