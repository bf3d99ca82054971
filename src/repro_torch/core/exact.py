"""Exact / relaxation oracles for tests and the Figure 1 benchmark.

* ``brute_force`` — exhaustive optimum of the full GKP (tiny N*M only).
* ``brute_force_subproblem`` — exhaustive optimum of one per-user IP
  (validates Prop 4.1: Alg 1 greedy == optimum for laminar constraints).
* ``lp_upper_bound`` — LP relaxation via scipy.optimize.linprog (HiGHS):
  the paper's Figure 1 upper bound ("optimality ratio" denominator).

These run on host (numpy / scipy) by design: they are the independent
reference implementations the solver is validated against. The module is
the JAX package's, copied (it needs neither JAX nor PyTorch).
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = ["brute_force", "brute_force_subproblem", "lp_upper_bound",
           "lp_upper_bound_sparse", "milp_optimum"]


def _local_ok(xi, sets, caps):
    return all(xi[s].sum() <= c for s, c in zip(sets, caps))


def brute_force_subproblem(p_adj, sets, caps):
    """Optimal value/solution of max p_adj . x s.t. laminar caps. O(2^M)."""
    m = p_adj.shape[0]
    sets = np.asarray(sets)
    caps = np.asarray(caps)
    best_v, best_x = 0.0, np.zeros(m, bool)
    for bits in itertools.product([0, 1], repeat=m):
        xi = np.asarray(bits, bool)
        if not _local_ok(xi, sets, caps):
            continue
        v = float(p_adj[xi].sum())
        if v > best_v + 1e-12:
            best_v, best_x = v, xi
    return best_v, best_x


def brute_force(p, b, budgets, sets, caps):
    """Exhaustive optimum of the full GKP. p: (N, M), b: (N, M, K)."""
    n, m = p.shape
    sets = np.asarray(sets)
    caps = np.asarray(caps)
    budgets = np.asarray(budgets)
    per_user = []
    for i in range(n):
        opts = []
        for bits in itertools.product([0, 1], repeat=m):
            xi = np.asarray(bits, bool)
            if _local_ok(xi, sets, caps):
                opts.append(xi)
        per_user.append(opts)
    best_v = -1.0
    best_x = None
    for combo in itertools.product(*per_user):
        x = np.stack(combo)                                  # (N, M)
        use = np.einsum("nmk,nm->k", b, x.astype(np.float64))
        if np.any(use > budgets + 1e-9):
            continue
        v = float((p * x).sum())
        if v > best_v:
            best_v, best_x = v, x
    return best_v, best_x


def lp_upper_bound(p, b, budgets, sets, caps):
    """LP relaxation (0 <= x <= 1) optimum via scipy HiGHS; Figure 1's bound."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    p = np.asarray(p, np.float64)
    b = np.asarray(b, np.float64)
    budgets = np.asarray(budgets, np.float64)
    sets = np.asarray(sets, bool)
    caps = np.asarray(caps, np.float64)
    n, m = p.shape
    k = budgets.shape[0]
    l = sets.shape[0]
    nv = n * m
    a = lil_matrix((k + n * l, nv))
    rhs = np.empty(k + n * l)
    for kk in range(k):
        a[kk, :] = b[:, :, kk].reshape(-1)
        rhs[kk] = budgets[kk]
    row = k
    for i in range(n):
        for ll in range(l):
            cols = i * m + np.nonzero(sets[ll])[0]
            a[row, cols] = 1.0
            rhs[row] = caps[ll]
            row += 1
    res = linprog(
        -p.reshape(-1), A_ub=a.tocsr(), b_ub=rhs, bounds=(0.0, 1.0),
        method="highs",
    )
    assert res.status == 0, res.message
    return -res.fun


def milp_optimum(p, b, budgets, sets, caps, time_limit=60.0):
    """Exact IP optimum via scipy.optimize.milp (HiGHS branch-and-bound)."""
    from scipy.optimize import LinearConstraint, milp
    from scipy.sparse import lil_matrix

    p = np.asarray(p, np.float64)
    b = np.asarray(b, np.float64)
    budgets = np.asarray(budgets, np.float64)
    sets = np.asarray(sets, bool)
    caps = np.asarray(caps, np.float64)
    n, m = p.shape
    k = budgets.shape[0]
    l = sets.shape[0]
    nv = n * m
    a = lil_matrix((k + n * l, nv))
    rhs = np.empty(k + n * l)
    for kk in range(k):
        a[kk, :] = b[:, :, kk].reshape(-1)
        rhs[kk] = budgets[kk]
    row = k
    for i in range(n):
        for ll in range(l):
            cols = i * m + np.nonzero(sets[ll])[0]
            a[row, cols] = 1.0
            rhs[row] = caps[ll]
            row += 1
    res = milp(
        -p.reshape(-1),
        constraints=LinearConstraint(a.tocsr(), -np.inf, rhs),
        integrality=np.ones(nv),
        bounds=(0, 1),
        options={"time_limit": time_limit},
    )
    assert res.status == 0, res.message
    return -res.fun


def lp_upper_bound_sparse(p, b, budgets, q):
    """LP bound for the sparse (Section 5.1) form."""
    n, k = p.shape
    sets = np.ones((1, k), bool)
    caps = np.asarray([q])
    b_dense = np.zeros((n, k, k))
    idx = np.arange(k)
    b_dense[:, idx, idx] = np.asarray(b)
    return lp_upper_bound(p, b_dense, budgets, sets, caps)
