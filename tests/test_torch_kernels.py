"""Plain versions of the port's kernels against the reference's Pallas
kernels (interpret mode) on the same numpy inputs, and the port's own
chunked == unchunked contract.

Tolerances: ``top`` and, at q = 1, the finalize's lo/hi and bucket
pattern are exact against the reference's jnp path (max is order-free and
the per-row values are bitwise equal). The Pallas kernels in interpret
mode let XLA contract ``p - lam*b`` into a fused multiply-add, so their
per-row values may sit one ulp away: against them ``top`` and lo/hi are
held to rtol 1e-6 (lo/hi with atol 1e-7, one ulp of the profits). Masses and sums are held to the reference kernels' own
tolerance (rtol 1e-5, atol 1e-5): the Pallas kernel sums a tile as one
contraction, the port row by row. With dyadic inputs (p, b on a 2^-6
grid, lam on a 2^-3 grid) every value is exact, so there every output
must match bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.bucketing import make_edges as j_make_edges  # noqa: E402
from repro.core.chunked import _metrics_init as j_metrics_init  # noqa: E402
from repro.core.chunked import finalize_chunk_accumulate as j_fin_acc  # noqa: E402
from repro.core.sparse_scd import candidates_sparse as j_candidates  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.core.postprocess import profit_edges_fixed as j_pedges  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TILE = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _inst(n, k, seed, dyadic=False):
    g = np.random.default_rng(seed)
    if dyadic:
        p = g.integers(0, 64, (n, k)) / 64.0
        b = g.integers(1, 64, (n, k)) / 64.0
        lam = g.integers(0, 12, (k,)) / 8.0
    else:
        p = g.random((n, k))
        b = g.uniform(0.05, 1.0, (n, k))
        lam = g.uniform(0.0, 1.5, (k,))
    return p.astype(np.float32), b.astype(np.float32), lam.astype(np.float32)


def _t(a):
    return torch.tensor(np.array(a))


def _fused_pair(p, b, lam, q, edges, seeds=None, tile=TILE):
    seeds = seeds or {}
    jh, jt = jops.scd_fused_hist(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam),
                                 jnp.asarray(edges), q, tile_n=tile, interpret=True,
                                 **{k: jnp.asarray(v) for k, v in seeds.items()})
    th, tt = ops.scd_fused_hist(_t(p), _t(b), _t(lam), _t(edges), q, tile_n=tile,
                                **{k: _t(v) for k, v in seeds.items()})
    return (np.asarray(jh), np.asarray(jt)), (th.numpy(), tt.numpy())


def _fin_pair(p, b, lam, q, pedges, seeds=None, tile=TILE):
    seeds = seeds or {}
    j = jops.scd_finalize_hist(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam),
                               jnp.asarray(pedges), q, tile_n=tile, interpret=True,
                               **{k: jnp.asarray(v) for k, v in seeds.items()})
    t = ops.scd_finalize_hist(_t(p), _t(b), _t(lam), _t(pedges), q, tile_n=tile,
                              **{k: _t(v) for k, v in seeds.items()})
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _fin_seeds(k, nb, seed):
    g = np.random.default_rng(seed)
    return {"cons_hist_init": g.random((k, nb)).astype(np.float32),
            "gain_hist_init": g.random((nb,)).astype(np.float32),
            "r_init": g.random((k,)).astype(np.float32),
            "sums_init": g.random((2,)).astype(np.float32) * 10,
            "maxs_init": np.array([0.5, -0.25], np.float32)}


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("seeded", [False, True])
def test_fused_hist_plain_vs_pallas(q, seeded):
    n, k = 1021, 10                       # prime n: a ragged last tile
    p, b, lam = _inst(n, k, seed=n + q)
    edges = np.asarray(j_make_edges(jnp.asarray(lam), 1e-4, 1.6, 24))
    seeds = None
    if seeded:
        g = np.random.default_rng(9)
        seeds = {"hist_init": g.random((k, 50)).astype(np.float32),
                 "top_init": g.uniform(-1, 3, (k,)).astype(np.float32)}
    (jh, jt), (th, tt) = _fused_pair(p, b, lam, q, edges, seeds)
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    np.testing.assert_allclose(th, jh, **TOL)
    v1, _ = j_candidates(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q)
    top = np.asarray(jnp.max(v1, axis=0))
    if seeded:
        top = np.maximum(top, seeds["top_init"])
    np.testing.assert_array_equal(tt, top)


@pytest.mark.parametrize("q", [1, 3])
def test_fused_hist_dyadic_bitwise(q):
    p, b, lam = _inst(1021, 10, seed=q, dyadic=True)
    edges = np.asarray(j_make_edges(jnp.asarray(lam), 1e-4, 1.6, 24))
    (jh, jt), (th, tt) = _fused_pair(p, b, lam, q, edges)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tt, jt)


def test_fused_hist_ties_on_edges_and_invalid_tiles():
    k = 4
    edges = np.tile(np.array([[0.5, 1.0, 1.5]], np.float32), (k, 1))
    vals = np.array([0.5, 1.0, 1.5, 0.25, 1.75, 1.0], np.float32)
    p = np.tile(vals[:, None], (1, k))
    b = np.ones_like(p)
    lam = np.zeros((k,), np.float32)
    (jh, jt), (th, tt) = _fused_pair(p, b, lam, k, edges, tile=4)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(th[0], np.array([2.0, 2.0, 1.0, 1.0]))
    np.testing.assert_array_equal(tt, jt)
    # All-invalid tiles: no mass, top is the -1 sentinel.
    p0 = np.zeros((256, 8), np.float32)
    b1 = np.ones((256, 8), np.float32)
    lam0 = np.full((8,), 0.7, np.float32)
    e0 = np.asarray(j_make_edges(jnp.asarray(lam0), 1e-4, 1.6, 24))
    (jh, jt), (th, tt) = _fused_pair(p0, b1, lam0, 2, e0, tile=64)
    assert not th.any() and not jh.any()
    np.testing.assert_array_equal(tt, np.full(8, -1.0, np.float32))
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("seeded", [False, True])
def test_finalize_plain_vs_pallas(q, seeded):
    n, k = 1021, 10
    p, b, lam = _inst(n, k, seed=2 * n + q)
    pedges = np.asarray(j_pedges(512, 1e-6, 1e6, jnp.float32))
    seeds = _fin_seeds(k, 513, 3) if seeded else None
    j, t = _fin_pair(p, b, lam, q, pedges, seeds)
    jch, jgh, jr, jprim, jdual, jlo, jhi = j
    tch, tgh, tr, tprim, tdual, tlo, thi = t
    np.testing.assert_allclose(tch, jch, **TOL)
    np.testing.assert_allclose(tgh, jgh, **TOL)
    np.testing.assert_allclose(tr, jr, **TOL)
    np.testing.assert_allclose(tprim, jprim, rtol=1e-5)
    np.testing.assert_allclose(tdual, jdual, rtol=1e-5)
    # The reference's one-ulp FMA difference in p - lam*b is absolute
    # (about 6e-8 at profits near 1), so small group profits need an atol.
    np.testing.assert_allclose([tlo, thi], [jlo, jhi], rtol=1e-6, atol=1e-7)
    if q == 1 and not seeded:
        # One item per row: pt is exact, so lo/hi and the bin of every row
        # equal the reference's jnp finalize bit for bit.
        carry = j_metrics_init(k, jnp.float32) + (jnp.zeros((k, 513)),
                                                  jnp.zeros((513,)))
        out = j_fin_acc(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q,
                        JCfg(), carry, jnp.asarray(pedges))
        assert tlo == float(out[3]) and thi == float(out[4])
        np.testing.assert_array_equal(tch > 0, np.asarray(out[5]) > 0)
        np.testing.assert_allclose(tch, np.asarray(out[5]), **TOL)


@pytest.mark.parametrize("q", [1, 3])
def test_finalize_dyadic_bitwise(q):
    p, b, lam = _inst(1021, 10, seed=40 + q, dyadic=True)
    pedges = np.asarray(j_pedges(512, 1e-6, 1e6, jnp.float32))
    j, t = _fin_pair(p, b, lam, q, pedges, _fin_seeds(10, 513, 4))
    for a, c in zip(t, j):
        np.testing.assert_array_equal(a, c)


def test_finalize_metrics_only_variant():
    p, b, lam = _inst(700, 8, seed=11)
    j = jops.scd_finalize_hist(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam),
                               jnp.zeros((1,)), 1, tile_n=TILE, interpret=True,
                               with_hist=False)
    t = ops.scd_finalize_hist(_t(p), _t(b), _t(lam), None, 1, tile_n=TILE,
                              with_hist=False)
    assert t[0] is None and t[1] is None
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), **TOL)
    for a, c in zip(t[3:5], j[3:5]):
        np.testing.assert_allclose(float(a), float(c), rtol=1e-5)
    np.testing.assert_allclose([float(t[5]), float(t[6])],
                               [float(j[5]), float(j[6])], rtol=1e-6)


@pytest.mark.parametrize("q", [1, 3])
def test_chunked_equals_unchunked_bitwise(q):
    n, k = 1000, 10                       # ragged last chunk and tile
    p, b, lam = (_t(a) for a in _inst(n, k, seed=77 + q))
    edges = torch.tensor(np.asarray(j_make_edges(jnp.asarray(lam.numpy()),
                                                 1e-4, 1.6, 24)))
    pedges = torch.tensor(np.asarray(j_pedges(512, 1e-6, 1e6, jnp.float32)))
    chunk = 2 * TILE
    h1, t1 = ops.scd_fused_hist(p, b, lam, edges, q, tile_n=TILE)
    f1 = ops.scd_finalize_hist(p, b, lam, pedges, q, tile_n=TILE)
    h, top, f = None, None, None
    for s in range(0, n, chunk):
        pc, bc = p[s:s + chunk], b[s:s + chunk]
        h, top = ops.scd_fused_hist(pc, bc, lam, edges, q, tile_n=TILE,
                                    hist_init=h, top_init=top)
        seeds = {} if f is None else {
            "cons_hist_init": f[0], "gain_hist_init": f[1], "r_init": f[2],
            "sums_init": torch.stack([f[3], f[4]]),
            "maxs_init": torch.stack([f[6], -f[5]])}
        f = ops.scd_finalize_hist(pc, bc, lam, pedges, q, tile_n=TILE, **seeds)
    assert torch.equal(h, h1) and torch.equal(top, t1)
    for a, c in zip(f, f1):
        assert torch.equal(a, c)



# The histogram kernels' in-tile order (runs of 32 rows, sub-tiles of 512,
# then the tile) at tiles above 1,024 with a ragged tail, tiles that are not
# a multiple of the run, tile 4 and the default map tile. The reference's
# Pallas kernel keeps its own tile (TILE): bitwise on dyadic inputs. On
# random inputs its FMA-contracted v1 can sit one ulp across a bucket edge
# (ROADMAP C), so there the port is held to the reference's jnp path, whose
# per-row values it equals bitwise: masses to rounding, top exactly.
HIST_TILES = [4, 50, 1500, ops.MAP_TILE]


@pytest.mark.parametrize("tile", HIST_TILES)
@pytest.mark.parametrize("dyadic", [False, True])
def test_fused_hist_tiles_vs_pallas(tile, dyadic):
    n, k = 3001, 10
    p, b, lam = _inst(n, k, seed=tile % 97, dyadic=dyadic)
    edges = np.asarray(j_make_edges(jnp.asarray(lam), 1e-4, 1.6, 24))
    g = np.random.default_rng(tile)
    seeds = {"hist_init": (np.round(g.random((k, 50)) * 64) / 64).astype(np.float32),
             "top_init": np.full((k,), -1.0, np.float32)}
    th, tt = ops.scd_fused_hist(_t(p), _t(b), _t(lam), _t(edges), 1, tile_n=tile,
                                **{key: _t(v) for key, v in seeds.items()})
    if dyadic:
        (jh, jt), _ = _fused_pair(p, b, lam, 1, edges, seeds)
        np.testing.assert_array_equal(th.numpy(), jh)
        np.testing.assert_array_equal(tt.numpy(), jt)
    else:
        jh, jt = jops.scd_fused_hist(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam),
                                     jnp.asarray(edges), 1, use_pallas=False,
                                     **{key: jnp.asarray(v) for key, v in seeds.items()})
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _order_ref(v1, v2, edges, tile, init):
    """The histogram kernels' addition order written out with float32
    scalars: runs of 32 rows from 0.0, run sums into sub-tiles of 512 rows
    from 0.0, sub-tile records into the tile from 0.0, tiles onto init."""
    n, k = v1.shape
    nb = edges.shape[1] + 1
    bins = (v1[:, :, None] > edges[None, :, :]).sum(-1)
    acc = init.astype(np.float32).copy()
    for t0 in range(0, n, tile):
        t1 = min(t0 + tile, n)
        tile_rec = np.zeros((k, nb), np.float32)
        for s0 in range(t0, t1, 512):
            sub_rec = np.zeros((k, nb), np.float32)
            for r0 in range(s0, min(s0 + 512, t1), 32):
                run = np.zeros((k, nb), np.float32)
                for r in range(r0, min(r0 + 32, s0 + 512, t1)):
                    for j in range(k):
                        run[j, bins[r, j]] = np.float32(run[j, bins[r, j]] + v2[r, j])
                sub_rec = sub_rec + run
            tile_rec = tile_rec + sub_rec
        acc = acc + tile_rec
    return acc


@pytest.mark.parametrize("tile", HIST_TILES)
def test_hist_plain_addition_order(tile):
    """Random masses, where the order shows in the last bits: both plain
    versions equal the order written out, bit for bit."""
    n, k = 2100, 3
    p, b, lam = _inst(n, k, seed=5 + tile % 13)
    edges = np.asarray(j_make_edges(jnp.asarray(lam), 1e-4, 1.6, 6))
    v1, v2 = (x.numpy() for x in ops.scd_candidates(_t(p), _t(b), _t(lam), 1))
    init = np.random.default_rng(1).random((k, edges.shape[1] + 1)).astype(np.float32)
    want = _order_ref(v1, v2, edges, tile, init)
    got = ops.bucket_hist(_t(v1), _t(v2), _t(edges), tile_n=tile, hist_init=_t(init))
    np.testing.assert_array_equal(got.numpy(), want)
    fh, _ = ops.scd_fused_hist(_t(p), _t(b), _t(lam), _t(edges), 1, tile_n=tile,
                               hist_init=_t(init))
    np.testing.assert_array_equal(fh.numpy(), want)


@pytest.mark.parametrize("tile,chunk,n", [(ops.MAP_TILE, 2 * ops.MAP_TILE, 5 * 8192 + 77),
                                          (1500, 3000, 7001), (50, 200, 1001)])
def test_fused_hist_chunked_equals_unchunked_tiles(tile, chunk, n):
    p, b, lam = (_t(a) for a in _inst(n, 10, seed=chunk % 89))
    edges = torch.tensor(np.asarray(j_make_edges(jnp.asarray(lam.numpy()),
                                                 1e-4, 1.6, 24)))
    kw = {} if tile == ops.MAP_TILE else {"tile_n": tile}
    h1, t1 = ops.scd_fused_hist(p, b, lam, edges, 1, **kw)
    h, top = None, None
    for s in range(0, n, chunk):
        h, top = ops.scd_fused_hist(p[s:s + chunk], b[s:s + chunk], lam, edges, 1,
                                    hist_init=h, top_init=top, **kw)
    assert torch.equal(h, h1) and torch.equal(top, t1)


# The finalize's in-tile order, and the redesigned kernel's K branches
# (KC = 8, 16, 64) against the reference.
@pytest.mark.parametrize("k", [8, 9, 17])
def test_finalize_plain_vs_pallas_k_branches(k):
    p, b, lam = _inst(1021, k, seed=3 * k)
    pedges = np.asarray(j_pedges(512, 1e-6, 1e6, jnp.float32))
    j, t = _fin_pair(p, b, lam, 2, pedges, _fin_seeds(k, 513, k))
    for a, c in zip(t[:5], j[:5]):
        np.testing.assert_allclose(a, c, **TOL)
    np.testing.assert_allclose(t[5:], j[5:], rtol=1e-6, atol=1e-7)


def _finalize_order_ref(p, b, lam, q, pedges, tile, seeds, with_hist):
    """The finalize written out with float32 scalars: per row the top-Q
    selection (ties to the lower index, only values > 0), gain and pt left to
    right from 0.0 and the bin (count of edges below pt); per tile every
    histogram bin, r[j], primal and dual a sum over the tile's rows in row
    order from 0.0; the tile records onto the seeds in tile order."""
    f32 = np.float32
    n, k = p.shape
    nb = pedges.shape[0] + 1
    acc_ch = seeds["cons_hist_init"].astype(f32).copy()
    acc_gh = seeds["gain_hist_init"].astype(f32).copy()
    acc_r = seeds["r_init"].astype(f32).copy()
    acc_s = seeds["sums_init"].astype(f32).copy()
    hi, nlo = f32(seeds["maxs_init"][0]), f32(seeds["maxs_init"][1])
    for t0 in range(0, n, tile):
        ch = np.zeros((k, nb), f32)
        gh = np.zeros((nb,), f32)
        r = np.zeros((k,), f32)
        s = np.zeros((2,), f32)
        for row in range(t0, min(t0 + tile, n)):
            ap = [f32(p[row, j] - f32(lam[j] * b[row, j])) for j in range(k)]
            work, x = list(ap), [False] * k
            for _ in range(q):
                m = max(work)
                if not m > 0:
                    break
                pick = work.index(m)
                x[pick], work[pick] = True, -np.inf
            gain, pt = f32(0.0), f32(0.0)
            for j in range(k):
                gain = f32(gain + (p[row, j] if x[j] else f32(0.0)))
                pt = f32(pt + (ap[j] if x[j] else f32(0.0)))
            bin_ = int((pedges < pt).sum())
            for j in range(k):
                cons = b[row, j] if x[j] else f32(0.0)
                r[j] = f32(r[j] + cons)
                ch[j, bin_] = f32(ch[j, bin_] + cons)
            gh[bin_] = f32(gh[bin_] + gain)
            s[0], s[1] = f32(s[0] + gain), f32(s[1] + pt)
            if any(x):
                hi, nlo = max(hi, pt), max(nlo, f32(-pt))
        acc_ch, acc_gh = acc_ch + ch, acc_gh + gh
        acc_r, acc_s = acc_r + r, acc_s + s
    return ((acc_ch, acc_gh) if with_hist else (None, None)) + (
        acc_r, acc_s[0], acc_s[1], -nlo, hi)


@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("q", [1, 3])
def test_finalize_plain_addition_order(q, with_hist):
    """Random rows whose group profits share a few bins, where the order
    shows in the last bits: the plain finalize equals the order written
    out, bit for bit. The card's walks must reproduce this order."""
    n, k, tile = 300, 4, 128                 # a ragged last tile
    p, b, lam = _inst(n, k, seed=31 + q)
    pedges = np.geomspace(1e-2, 2.0, 12).astype(np.float32)
    g = np.random.default_rng(q)
    nb = pedges.shape[0] + 1
    seeds = {"cons_hist_init": g.random((k, nb)).astype(np.float32),
             "gain_hist_init": g.random((nb,)).astype(np.float32),
             "r_init": g.random((k,)).astype(np.float32),
             "sums_init": (g.random((2,)) * 10).astype(np.float32),
             "maxs_init": np.array([0.5, -0.25], np.float32)}
    want = _finalize_order_ref(p, b, lam, q, pedges, tile, seeds, with_hist)
    kw = dict(seeds) if with_hist else {key: v for key, v in seeds.items()
                                       if "hist" not in key}
    got = ops.scd_finalize_hist(_t(p), _t(b), _t(lam), _t(pedges), q, tile_n=tile,
                                with_hist=with_hist, **{key: _t(v) for key, v in kw.items()})
    for a, c in zip(got, want):
        if c is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(c, np.float32))
