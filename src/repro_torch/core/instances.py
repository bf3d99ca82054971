"""Synthetic GKP instances with the reference's distributions (§6).

Profits p ~ U[0, 1); costs b ~ U[0, b_high) (sparse) or U[0, 1), half of
them scaled to U[0, 10) with ``mixed_b`` (Figure 1's diverse items);
budgets scaled with N so the constraints bind. The reference draws from
``jax.random``, which PyTorch cannot reproduce; these draw from NumPy
Philox, so a test carries the reference's own instance across instead
(``carry.instance_from_reference``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.synth import sparse_host_chunk_source
from .types import DenseKP, SparseKP, cardinality_set, disjoint_partition_sets

__all__ = ["sparse_instance", "dense_instance"]


def sparse_instance(seed, n, k, q=1, tightness=0.5, b_high=1.0, device="cpu",
                    chunk=65536, rows=None):
    """Section 5.1 sparse instance on ``device``; returns (SparseKP, q).

    The rows are those of ``data.synth.sparse_host_chunk_source(seed, n, k,
    chunk, ...)``, so one seed and chunk give the same instance resident
    and host-fed. Budgets ``tightness * n * q * (b_high / 2) / k`` (of the
    whole instance). ``rows=(lo, hi)`` draws only the chunks that hold
    rows [lo, hi) and returns those rows (a rank's shard of a world).
    """
    src = sparse_host_chunk_source(seed, n, k, chunk, q=q, tightness=tightness,
                                   b_high=b_high)
    lo, hi = (0, n) if rows is None else rows
    p = np.empty((hi - lo, k), np.float32)
    b = np.empty((hi - lo, k), np.float32)
    for i in range(lo // chunk, -(-hi // chunk)):
        pc, bc = src.fn(i)
        a, z = max(i * chunk, lo), min((i + 1) * chunk, hi)
        p[a - lo:z - lo], b[a - lo:z - lo] = pc[a - i * chunk:z - i * chunk], \
            bc[a - i * chunk:z - i * chunk]
    return SparseKP(p=torch.from_numpy(p).to(device),
                    b=torch.from_numpy(b).to(device),
                    budgets=torch.from_numpy(src.budgets).to(device)), q


def dense_instance(seed, n, m, k, local="C1", tightness=0.25, mixed_b=False,
                   device="cpu"):
    """General instance (Figure 1 setup) on ``device``.

    local: "C1" (at most 1 of the M items), "C2" (at most 2) or "C223"
    (two disjoint halves capped at 2 under a root capped at 3). Budgets
    ``tightness * n * cap_total * mean(b)``.
    """
    rng = np.random.Generator(np.random.Philox(key=seed))
    p = rng.random((n, m), np.float32)
    b = rng.random((n, m, k), np.float32)
    if mixed_b:
        wide = rng.random((n, m, k), np.float32) < 0.5
        b = np.where(wide, b * np.float32(10.0), b).astype(np.float32)
    if local == "C1":
        sets, cap_total = cardinality_set(m, 1), 1
    elif local == "C2":
        sets, cap_total = cardinality_set(m, 2), 2
    elif local == "C223":
        h = m // 2
        base = disjoint_partition_sets([h, m - h], [2, 2], m)
        root = cardinality_set(m, 3)
        sets = type(base)(torch.cat([base.sets, root.sets]),
                          torch.cat([base.caps, root.caps]))
        cap_total = 3
    else:
        raise ValueError(local)
    eb = float(b.mean(dtype=np.float64))
    budgets = np.full((k,), tightness * n * cap_total * eb, np.float32)
    return DenseKP(p=torch.from_numpy(p).to(device), b=torch.from_numpy(b).to(device),
                   budgets=torch.from_numpy(budgets).to(device),
                   sets=sets.sets.to(device), caps=sets.caps.to(device))
