"""The port's general (dense, Alg 3) GKP against the JAX reference.

The reference's ``dense_instance`` crosses as numpy arrays
(``carry.instance_from_reference``). Held bitwise on the CPU: the laminar
set builders, ``topc_mask`` / ``greedy_solve`` masks, ``adjusted_profit``
(a float32 FMA chain over K, as the reference's einsum adds) and the Alg 3
candidates ``candidates_general`` (masks and values). The plain ``bucket_hist`` against the reference's Pallas
kernel in interpret mode: masses rtol 1e-5 / atol 1e-5 (the Pallas kernel
contracts a tile at once, the port adds row by row), bitwise on dyadic
inputs. The dense solve against ``repro.core.solver.solve``, kernels on
and off, bucketed, exact and cyclic: lam rtol 1e-5 / atol 1e-6, iterations
within one, primal and dual 1e-5 relative. Within the port the chunked
dense solve equals the unchunked one bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import greedy as jg  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import types as jt  # noqa: E402
from repro.core.bucketing import make_edges as j_make_edges  # noqa: E402
from repro.core.instances import dense_instance as j_dense_instance  # noqa: E402
from repro.core.instances import shard_key  # noqa: E402
from repro.core.scd import candidates_general as j_candidates  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import greedy as tg  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core import types as tt  # noqa: E402
from repro_torch.core.carry import config_from_reference, instance_from_reference  # noqa: E402
from repro_torch.core.instances import dense_instance  # noqa: E402
from repro_torch.core.scd import candidates_general, num_candidates  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.tensor(np.array(a))


def _ref_dense(seed, n, m, k, local, mixed_b=True):
    return j_dense_instance(shard_key(seed), n=n, m=m, k=k, local=local,
                            tightness=0.25, mixed_b=mixed_b)


def test_laminar_set_builders_match_reference():
    pairs = [(jt.cardinality_set(6, 2), tt.cardinality_set(6, 2)),
             (jt.disjoint_partition_sets([2, 4], [1, 2]),
              tt.disjoint_partition_sets([2, 4], [1, 2])),
             (jt.hierarchy_from_lists([[0, 1, 2, 3], [0, 1], [4]], [3, 1, 1], 6),
              tt.hierarchy_from_lists([[0, 1, 2, 3], [0, 1], [4]], [3, 1, 1], 6))]
    for j, t in pairs:
        np.testing.assert_array_equal(t.sets.numpy(), np.asarray(j.sets))
        np.testing.assert_array_equal(t.caps.numpy(), np.asarray(j.caps))
    with pytest.raises(ValueError, match="laminar"):
        tt.hierarchy_from_lists([[0, 1], [1, 2]], [1, 1], 3)


@pytest.mark.parametrize("local", ["C1", "C2", "C223"])
@pytest.mark.parametrize("ties", [False, True])
def test_greedy_matches_reference(local, ties):
    kp = _ref_dense(3, 400, 8, 5, local)
    lam = np.random.default_rng(1).uniform(0, 0.5, 5).astype(np.float32)
    if ties:
        lam = np.round(lam * 4) / 4
    tkp = instance_from_reference(kp)
    jap = jg.adjusted_profit(kp.p, kp.b, jnp.asarray(lam))
    tap = tg.adjusted_profit(tkp.p, tkp.b, _t(lam))
    np.testing.assert_array_equal(tap.numpy(), np.asarray(jap))
    if ties:                  # coarse profits: equal scores within a row
        jap = jnp.round(jap * 2) / 2
        tap = torch.round(tap * 2) / 2
    jx = jg.greedy_solve(jap, kp.sets, kp.caps)
    tx = tg.greedy_solve(tap, tkp.sets, tkp.caps)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tg.topc_mask(tap, 3).numpy(),
                                  np.asarray(jg.topc_mask(jap, 3)))
    np.testing.assert_array_equal(tg.consumption(tkp.b, tx).numpy(),
                                  np.asarray(jg.consumption(kp.b, jx)))


@pytest.mark.parametrize("local", ["C1", "C2", "C223"])
def test_candidates_general_matches_reference(local):
    kp = _ref_dense(5, 300, 6, 4, local)
    tkp = instance_from_reference(kp)
    lam = np.random.default_rng(2).uniform(0, 1, 4).astype(np.float32)
    jv1, jv2 = map(np.asarray, j_candidates(kp.p, kp.b, jnp.asarray(lam),
                                            kp.sets, kp.caps))
    tv1, tv2 = candidates_general(tkp.p, tkp.b, _t(lam), tkp.sets, tkp.caps)
    assert tv1.shape == (300, 4, num_candidates(6))
    np.testing.assert_array_equal(tv1.numpy() >= 0, jv1 >= 0)
    np.testing.assert_array_equal(tv2.numpy() > 0, jv2 > 0)
    np.testing.assert_array_equal(tv1.numpy(), jv1)
    np.testing.assert_array_equal(tv2.numpy(), jv2)


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_bucket_hist_plain_vs_pallas(dyadic, seeded):
    g = np.random.default_rng(4)
    n, k = 2053, 6                       # prime: a ragged last tile
    v1 = g.uniform(-0.3, 2.0, (n, k)).astype(np.float32)
    v2 = g.random((n, k)).astype(np.float32)
    if dyadic:
        v2 = (np.round(v2 * 64) / 64).astype(np.float32)
    v2[v1 < 0] = 0.0
    edges = np.asarray(j_make_edges(jnp.asarray(g.random(k).astype(np.float32)),
                                    1e-4, 1.6, 24))
    jh = np.asarray(jops.bucket_hist(jnp.asarray(v1), jnp.asarray(v2),
                                     jnp.asarray(edges), tile_n=256, interpret=True))
    init = (np.round(g.random((k, 50)) * 64) / 64).astype(np.float32) if seeded else None
    th = ops.bucket_hist(_t(v1), _t(v2), _t(edges), tile_n=256,
                         hist_init=None if init is None else _t(init)).numpy()
    if seeded:
        jh = jh + init
    np.testing.assert_array_equal(th > 0, jh > 0)
    if dyadic:
        np.testing.assert_array_equal(th, jh)
    else:
        np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-5)


def test_bucket_hist_chunked_seed_bitwise():
    g = np.random.default_rng(6)
    v1 = _t(g.uniform(-0.3, 2.0, (3000, 5)).astype(np.float32))
    v2 = _t(g.random((3000, 5)).astype(np.float32))
    edges = _t(np.sort(g.random((5, 9)).astype(np.float32), axis=1))
    whole = ops.bucket_hist(v1, v2, edges, tile_n=128)
    h = None
    for s in range(0, 3000, 512):
        h = ops.bucket_hist(v1[s:s + 512], v2[s:s + 512], edges, tile_n=128,
                            hist_init=h)
    assert torch.equal(h, whole)


@pytest.mark.parametrize("tile", [4, 50, 1500, ops.MAP_TILE])
@pytest.mark.parametrize("dyadic", [False, True])
def test_bucket_hist_tiles_vs_pallas(tile, dyadic):
    """The in-tile order (runs, sub-tiles, tile) at tiles above 1,024 with a
    ragged tail, off the run length, tile 4 and the default map tile,
    against the Pallas kernel at its own tile 256."""
    g = np.random.default_rng(tile)
    n, k = 3001, 6
    v1 = g.uniform(-0.3, 2.0, (n, k)).astype(np.float32)
    v2 = g.random((n, k)).astype(np.float32)
    if dyadic:
        v2 = (np.round(v2 * 64) / 64).astype(np.float32)
    v2[v1 < 0] = 0.0
    edges = np.asarray(j_make_edges(jnp.asarray(g.random(k).astype(np.float32)),
                                    1e-4, 1.6, 24))
    jh = np.asarray(jops.bucket_hist(jnp.asarray(v1), jnp.asarray(v2),
                                     jnp.asarray(edges), tile_n=256, interpret=True))
    th = ops.bucket_hist(_t(v1), _t(v2), _t(edges), tile_n=tile).numpy()
    np.testing.assert_array_equal(th > 0, jh > 0)
    if dyadic:
        np.testing.assert_array_equal(th, jh)
    else:
        np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile,chunk", [(ops.MAP_TILE, 16384), (1500, 3000), (50, 200)])
def test_bucket_hist_chunked_tiles_bitwise(tile, chunk):
    g = np.random.default_rng(chunk)
    n = 40_000
    v1 = _t(g.uniform(-0.3, 2.0, (n, 5)).astype(np.float32))
    v2 = _t(g.random((n, 5)).astype(np.float32))
    edges = _t(np.sort(g.random((5, 9)).astype(np.float32), axis=1))
    kw = {} if tile == ops.MAP_TILE else {"tile_n": tile}
    whole = ops.bucket_hist(v1, v2, edges, **kw)
    h = None
    for s in range(0, n, chunk):
        h = ops.bucket_hist(v1[s:s + chunk], v2[s:s + chunk], edges, hist_init=h, **kw)
    assert torch.equal(h, whole)


@pytest.fixture(scope="module")
def ref_dense():
    return _ref_dense(11, 300, 6, 4, "C223")


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("kw", [{}, {"reduce": "exact"},
                                {"reduce": "exact", "cd_mode": "cyclic",
                                 "max_iters": 20}],
                         ids=["bucketed", "exact", "cyclic"])
def test_dense_solve_matches_reference(ref_dense, kw, use_kernels):
    jcfg = jt.SolverConfig(**kw, use_kernels=use_kernels)
    jr = jsolver.solve(ref_dense, jcfg, q=0)
    tr = tsolver.solve(instance_from_reference(ref_dense),
                       config_from_reference(dataclasses.asdict(jcfg)), q=0,
                       device="cpu")
    np.testing.assert_allclose(tr.lam.numpy(), np.asarray(jr.lam), rtol=1e-5, atol=1e-6)
    assert abs(tr.iters - int(jr.iters)) <= 1
    np.testing.assert_allclose(float(tr.primal), float(jr.primal), rtol=1e-5)
    np.testing.assert_allclose(float(tr.dual), float(jr.dual), rtol=1e-5)
    np.testing.assert_allclose(tr.r.numpy(), np.asarray(jr.r), rtol=1e-5)
    assert bool(torch.all(tr.r <= tr.r.new_tensor(np.asarray(ref_dense.budgets))))


@pytest.mark.parametrize("algo", ["scd", "dd"])
def test_dense_chunked(algo):
    """SCD bucketed: bitwise (chunk 64 users x 21 candidates, tile 64,
    ragged last chunk). DD: r summed per chunk, lam within float32 order."""
    kp = dense_instance(1, 300, 6, 4, local="C223", mixed_b=True)
    cfg = tt.SolverConfig(algo=algo, kernel_tile=64, max_iters=12)
    a = tsolver.solve(kp, cfg, q=0, device="cpu")
    b = tsolver.solve(kp, cfg.replace(chunk_size=64), q=0, device="cpu")
    if algo == "scd":
        assert a.iters == b.iters
        for f in ("lam", "x", "r", "primal", "dual"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert bool(torch.all(a.r <= kp.budgets)) and float(a.dual) >= float(a.primal)
    else:
        torch.testing.assert_close(a.lam, b.lam, rtol=1e-6, atol=1e-7)


def test_dense_instance_structure():
    kp = dense_instance(7, 50, 6, 3, local="C223", tightness=0.2, mixed_b=True)
    ref = _ref_dense(7, 50, 6, 3, "C223")
    assert kp.p.shape == (50, 6) and kp.b.shape == (50, 6, 3)
    np.testing.assert_array_equal(kp.sets.numpy(), np.asarray(ref.sets))
    np.testing.assert_array_equal(kp.caps.numpy(), np.asarray(ref.caps))
    assert float(kp.b.max()) > 1.0 and float(kp.b.min()) >= 0.0
    expect = 0.2 * 50 * 3 * float(kp.b.double().mean())
    np.testing.assert_allclose(kp.budgets.numpy(), np.full(3, expect), rtol=1e-6)
    again = dense_instance(7, 50, 6, 3, local="C223", tightness=0.2, mixed_b=True)
    assert all(torch.equal(x, y) for x, y in zip(kp, again))
