"""Port numerics against the JAX reference on the same numpy inputs.

Held bitwise: Alg-5 candidates, the greedy selection, the bucket edge
ladder, the fixed §5.4 ladder and the synthetic host chunks. Held to
rtol 1e-6: the threshold recoveries fed the reference's own histograms
(the reference's cumsum is a log-depth scan, the port's sequential),
with tau exactly equal or infinite on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bucketing as jb  # noqa: E402
from repro.core import postprocess as jpp  # noqa: E402
from repro.core import sparse_scd as js  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.core import bucketing as tb  # noqa: E402
from repro_torch.core import postprocess as tpp  # noqa: E402
from repro_torch.core import sparse_scd as ts  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _inst(n, k, seed, ties=False):
    g = np.random.default_rng(seed)
    p = g.random((n, k), dtype=np.float32)
    b = g.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    if ties:
        # Coarse grids give equal adjusted profits within a row.
        p = np.round(p * 4) / 4
        b = np.round(b * 4) / 4
        b[b == 0] = 0.25
    b[::7] = 0.0                      # rows with b = 0
    b[3::11, 1] = 0.0
    lam = g.uniform(0.0, 1.5, (k,)).astype(np.float32)
    if ties:
        lam = np.round(lam * 2) / 2
    return p.astype(np.float32), b.astype(np.float32), lam.astype(np.float32)


def _t(a):
    return torch.tensor(np.array(a))


@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_candidates_and_selection_bitwise(q, ties):
    p, b, lam = _inst(517, 8, seed=q + 10 * ties, ties=ties)
    jv1, jv2 = js.candidates_sparse(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q)
    tv1, tv2 = ts.candidates_sparse(_t(p), _t(b), _t(lam), q)
    np.testing.assert_array_equal(tv1.numpy(), np.asarray(jv1))
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    jx = js.select_sparse(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q)
    tx = ts.select_sparse(_t(p), _t(b), _t(lam), q)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("lam_scale", [0.0, 1e-3, 1.0, 37.5])
def test_make_edges_bitwise(lam_scale):
    lam = (np.random.default_rng(1).random(10) * lam_scale).astype(np.float32)
    je = jb.make_edges(jnp.asarray(lam), 1e-4, 1.6, 24)
    te = tb.make_edges(_t(lam), 1e-4, 1.6, 24)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_profit_edges_fixed_bitwise():
    for n_edges, lo, hi in [(512, 1e-6, 1e6), (64, 1e-3, 10.0)]:
        je = jpp.profit_edges_fixed(n_edges, lo, hi, jnp.float32)
        te = tpp.profit_edges_fixed(n_edges, lo, hi, torch.float32)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("tight", [0.05, 0.3, 5.0])
def test_threshold_from_hist_on_reference_hist(tight):
    p, b, lam = _inst(2048, 10, seed=3)
    edges = jb.make_edges(jnp.asarray(lam), 1e-4, 1.6, 24)
    v1, v2 = js.candidates_sparse(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), 1)
    hist = jb.bucket_histogram(v1, v2, edges)
    top = jnp.max(v1, axis=0)
    budgets = jnp.asarray(np.float32(tight) * np.asarray(v2).sum(0) / 2)
    jv = jb.threshold_from_hist(hist, edges, budgets, top)
    tv = tb.threshold_from_hist(_t(hist), _t(edges), _t(budgets), _t(top))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)


@pytest.mark.parametrize("excess", [0.0, 0.02, 0.5, 100.0])
def test_threshold_and_removed_on_reference_hist(excess):
    g = np.random.default_rng(5)
    n, k = 4000, 10
    pt = g.lognormal(-1.0, 1.5, n).astype(np.float32)
    cons = (g.random((n, k)) * (g.random((n, k)) < 0.2)).astype(np.float32)
    gain = g.random(n).astype(np.float32)
    pedges = jpp.profit_edges_fixed(512, 1e-6, 1e6, jnp.float32)
    ch = jpp.removable_hist(jnp.asarray(pt), jnp.asarray(cons), pedges)
    gh = jpp.removable_hist(jnp.asarray(pt), jnp.asarray(gain)[:, None], pedges)[0]
    r = jnp.asarray(cons.sum(0))
    budgets = r / np.float32(1.0 + excess)
    jtau, jrc, jrg = jpp.threshold_and_removed(ch, gh, pedges, r, budgets)
    ttau, trc, trg = tpp.threshold_and_removed(_t(ch), _t(gh), _t(pedges), _t(r),
                                               _t(budgets))
    assert float(ttau) == float(jtau)
    np.testing.assert_allclose(trc.numpy(), np.asarray(jrc), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(trg), float(jrg), rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed,i", [(0, 0), (0, 3), (7, 1), (123, 40)])
def test_sparse_host_chunk_source_same_bytes(seed, i):
    js_ = jsynth.sparse_host_chunk_source(seed, 10_000, 10, 1024, q=1)
    ts_ = tsynth.sparse_host_chunk_source(seed, 10_000, 10, 1024, q=1)
    for a, b in zip(js_.fn(i), ts_.fn(i)):
        assert a.tobytes() == b.tobytes()
    assert js_.budgets.tobytes() == ts_.budgets.tobytes()
