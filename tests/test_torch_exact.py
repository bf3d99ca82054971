"""The port's exact and relaxation oracles (``core/exact.py``, a copy of the
reference's) against the reference's, on tiny instances: every value equal,
and the brute-force solutions equal entry for entry. Then what the oracles
are for: the port's greedy (Alg 1) is the optimum of each per-user IP
(Proposition 4.1), and the port's resident solve stays within the LP bound
and at or below the IP optimum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import exact as jexact  # noqa: E402
from repro_torch.core import exact as texact  # noqa: E402
from repro_torch.core.greedy import greedy_solve  # noqa: E402
from repro_torch.core.solver import solve  # noqa: E402
from repro_torch.core.types import DenseKP, hierarchy_from_lists  # noqa: E402


def _instance(seed, n=3, m=4, k=2):
    g = np.random.default_rng(seed)
    p = g.random((n, m)).astype(np.float32)
    b = g.random((n, m, k)).astype(np.float32)
    budgets = (0.3 * b.sum(axis=(0, 1))).astype(np.float32)
    lam = hierarchy_from_lists([[0, 1], [0, 1, 2, 3]], [1, 2], m)
    return p, b, budgets, lam.sets.numpy(), lam.caps.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_equal_the_reference(seed):
    p, b, budgets, sets, caps = _instance(seed)
    tv, tx = texact.brute_force(p, b, budgets, sets, caps)
    jv, jx = jexact.brute_force(p, b, budgets, sets, caps)
    assert tv == jv
    np.testing.assert_array_equal(tx, jx)
    padj = p[0] - b[0] @ np.float32([0.4, 0.6])
    tv, tx = texact.brute_force_subproblem(padj, sets, caps)
    jv, jx = jexact.brute_force_subproblem(padj, sets, caps)
    assert tv == jv
    np.testing.assert_array_equal(tx, jx)
    for fn in ("lp_upper_bound", "milp_optimum"):
        assert getattr(texact, fn)(p, b, budgets, sets, caps) == \
            getattr(jexact, fn)(p, b, budgets, sets, caps)
    sp, sb = p[:, :2], b[:, :2, 0]
    assert texact.lp_upper_bound_sparse(sp, sb, budgets, 1) == \
        jexact.lp_upper_bound_sparse(sp, sb, budgets, 1)


@pytest.mark.parametrize("seed", [3, 4])
def test_greedy_is_the_subproblem_optimum_and_solve_within_bounds(seed):
    p, b, budgets, sets, caps = _instance(seed)
    g = np.random.default_rng(seed)
    for _ in range(20):
        padj = (g.random(4) - 0.3).astype(np.float32)
        x = greedy_solve(torch.from_numpy(padj), torch.from_numpy(sets),
                         torch.from_numpy(caps)).numpy()
        best, _ = texact.brute_force_subproblem(padj, sets, caps)
        assert float(padj[x].sum()) == pytest.approx(best, abs=1e-6)
    kp = DenseKP(*(torch.from_numpy(a) for a in (p, b, budgets, sets, caps)))
    res = solve(kp, q=0, device="cpu")
    opt = texact.milp_optimum(p, b, budgets, sets, caps)
    assert float(res.primal) <= opt + 1e-5
    assert opt <= texact.lp_upper_bound(p, b, budgets, sets, caps) + 1e-6
