"""Section 5.1 / Algorithm 5: linear-time candidate generation (sparse GKP).

Each user emits at most one candidate per knapsack k:

  * adjusted profit ap[k] = max(p_ik - lam_k * b_ik, 0)
  * pbar = (Q+1)-th largest ap if item k is in the top Q, else the Q-th
    largest: the profit level item k has to beat to (stay) in.
  * if p_ik > pbar: candidate v1 = (p_ik - pbar) / b_ik with mass v2 = b_ik.
"""
from __future__ import annotations

import torch

__all__ = ["candidates_sparse", "select_sparse"]


def candidates_sparse(p, b, lam, q):
    """Algorithm 5 over a shard. p, b: (n, K); lam: (K,).

    Returns (v1, v2), each (n, K). Invalid candidates are v1 = -1, v2 = 0.
    """
    n, k = p.shape
    ap = torch.clamp_min(p - lam[None, :] * b, 0.0)
    if q >= k:
        pbar = torch.zeros_like(ap)
    else:
        top = torch.topk(ap, q + 1, dim=-1).values           # (n, q+1) desc
        q_th = (top[:, q - 1] if q >= 1
                else torch.full((n,), float("inf"), dtype=ap.dtype,
                                device=ap.device))
        q1_th = top[:, q]
        in_top = ap >= q_th[:, None]
        pbar = torch.where(in_top, q1_th[:, None], q_th[:, None])
    valid = (p > pbar) & (b > 0)
    safe_b = torch.where(b > 0, b, torch.ones_like(b))
    v1 = torch.where(valid, (p - pbar) / safe_b, torch.full_like(p, -1.0))
    v2 = torch.where(valid, b, torch.zeros_like(b))
    return v1, v2


def select_sparse(p, b, lam, q):
    """Primal solution at lam: the top-Q positive adjusted profits per user,
    ties to the lower item index (two stable argsorts). Returns (n, K) bool."""
    ap = p - lam[None, :] * b
    k = p.shape[1]
    if q >= k:
        return ap > 0
    order = torch.argsort(-ap, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ap > 0) & (ranks < q)
