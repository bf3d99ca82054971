"""The port's greedy primal (``adjusted_topc``) and host-fed DD against the
JAX reference, on the same numpy inputs.

Exact: the plain ``adjusted_topc`` against the reference's jnp
``adjusted_topc_ref`` and the port's ``select_sparse`` (a mask and a
select, no sums); within the port, host-fed DD against the resident
chunked DD at the same chunk (the same per-chunk sums and the same host
step). The reference's Pallas ``adjusted_topc`` in interpret mode lets XLA
contract ``p - lam*b`` into a fused multiply-add, so its mask is held to
the top-Q of the contracted values instead, and the entries where it
differs from the port's are counted. To tolerance against the reference's
host-fed DD: lam rtol 1e-5 / atol 1e-6, primal and dual 1e-5 relative
(sums in another order), equal iterations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import prefetch as jpf  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core.instances import sparse_instance  # noqa: E402
from repro_torch.core.sparse_scd import select_sparse  # noqa: E402
from repro_torch.core.types import SolverConfig, SparseKP  # noqa: E402
from repro_torch.data.synth import sparse_host_chunk_source  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import solve as tlaunch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# A small kernel tile keeps the plain finalize's row loop short (it walks
# one tile's rows in Python).
N, K, CHUNK, TILE = 8192, 10, 2048, 64


def _inst(n, k, seed, dyadic):
    g = np.random.default_rng(seed)
    if dyadic:
        p = g.integers(0, 64, (n, k)) / 64.0
        b = g.integers(0, 64, (n, k)) / 64.0
        lam = g.integers(0, 12, (k,)) / 8.0
    else:
        p, b, lam = g.random((n, k)), g.uniform(0.0, 1.0, (n, k)), g.uniform(0, 1.5, k)
    return tuple(a.astype(np.float32) for a in (p, b, lam))


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("q", [1, 3, 10])
@pytest.mark.parametrize("n", [513, 4099])
def test_adjusted_topc_plain_vs_reference(n, q, dyadic):
    p, b, lam = _inst(n, K, n + q, dyadic)
    tp, tb, tl = map(torch.tensor, (p, b, lam))
    x, v = ref.adjusted_topc_plain(tp, tb, tl, q)
    jx, jv = jref.adjusted_topc_ref(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert torch.equal(x, select_sparse(tp, tb, tl, q))
    assert torch.equal(v, torch.where(x, tb, 0.0))
    assert x.dtype == torch.bool and v.dtype == torch.float32


@pytest.mark.parametrize("q", ["1", "3", "K"])
@pytest.mark.parametrize("k", [8, 9, 17])
def test_adjusted_topc_plain_vs_reference_k_branches(k, q):
    """At each compile-time branch of the kernel (KC = 8, 16, 64) and its
    edges, with b = 0 rows and all-tied rows: equal to the reference's jnp
    version bit for bit."""
    q = k if q == "K" else int(q)
    p, b, lam = _inst(1000, k, 7 * k + q, False)
    b[::7] = 0.0
    p[1::5] = p[1::5, :1]
    b[1::5] = 0.0
    x, v = ref.adjusted_topc_plain(*map(torch.tensor, (p, b, lam)), q)
    jx, jv = jref.adjusted_topc_ref(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert x[1::5].sum(1).eq(min(q, k)).all()         # the tied rows pick q items


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adjusted_topc_plain_vs_pallas(seed):
    """Interpret-mode Pallas equals the top-Q of the FMA-contracted
    ``p - lam*b``; where that differs from the port, only ties at an ulp
    change (0 entries on these seeds)."""
    p, b, lam = _inst(4099, K, 100 + seed, False)
    for q in (1, 3):
        jx, jv = jops.adjusted_topc(jnp.asarray(p), jnp.asarray(b),
                                    jnp.asarray(lam), q, tile_n=512, interpret=True)
        fma = (p.astype(np.float64) - lam.astype(np.float64) * b).astype(np.float32)
        want = ref.topq_mask(torch.tensor(fma), q).numpy()
        np.testing.assert_array_equal(np.asarray(jx), want)
        np.testing.assert_array_equal(np.asarray(jv), np.where(want, b, 0.0))
        x, _ = ref.adjusted_topc_plain(*map(torch.tensor, (p, b, lam)), q)
        assert int((x.numpy() != np.asarray(jx)).sum()) == 0


def test_solve_primal_uses_the_kernel_path(monkeypatch):
    """The sparse primal goes through ops.adjusted_topc and equals the
    select_sparse oracle."""
    p, b, lam = map(torch.tensor, _inst(1000, K, 7, False))
    kp = SparseKP(p, b, torch.ones(K))
    calls = []
    real = ops.adjusted_topc
    monkeypatch.setattr(ops, "adjusted_topc",
                        lambda *a: calls.append(1) or real(*a))
    x, cons = tsolver._solve_primal(kp, lam, 2)
    assert calls == [1]
    assert torch.equal(x, select_sparse(p, b, lam, 2))
    assert torch.equal(cons, b * x.to(b.dtype))


@pytest.fixture(scope="module")
def rows():
    src = jsynth.sparse_host_chunk_source(0, N, K, CHUNK)
    ps, bs = zip(*(src.fn(i) for i in range(-(-N // CHUNK))))
    return np.concatenate(ps)[:N], np.concatenate(bs)[:N], src.budgets


@pytest.mark.parametrize("max_iters", [8, 25])
def test_host_fed_dd_matches_reference(rows, max_iters):
    p, b, budgets = rows
    ours = tpf.solve_streaming_host(
        tpf.host_array_source(p, b, budgets, CHUNK),
        SolverConfig(algo="dd", max_iters=max_iters, kernel_tile=TILE), q=1,
        device="cpu")
    theirs = jpf.solve_streaming_host(
        jpf.host_array_source(p, b, budgets, CHUNK),
        JCfg(algo="dd", max_iters=max_iters, kernel_tile=TILE), q=1)
    assert ours.iters == int(theirs.iters)
    np.testing.assert_allclose(ours.lam.numpy(), np.asarray(theirs.lam),
                               rtol=1e-5, atol=1e-6)
    for f in ("primal", "dual"):
        np.testing.assert_allclose(float(getattr(ours, f)),
                                   float(getattr(theirs, f)), rtol=1e-5)
    assert float(ours.tau) == float(theirs.tau)


@pytest.mark.parametrize("n", [N, N - 37])
def test_host_fed_dd_equals_resident_chunked(n):
    cfg = SolverConfig(algo="dd", max_iters=8, kernel_tile=TILE)
    kp, q = sparse_instance(0, n, K, chunk=CHUNK)
    resident = tsolver.solve(kp, cfg.replace(chunk_size=CHUNK), q=q, device="cpu")
    for double_buffer in (True, False):
        host = tpf.solve_streaming_host(sparse_host_chunk_source(0, n, K, CHUNK),
                                        cfg, q=q, device="cpu",
                                        double_buffer=double_buffer)
        assert host.iters == resident.iters
        assert torch.equal(host.lam, resident.lam)


def test_launcher_host_fed_dd(capsys):
    tlaunch.main(["--n", "4096", "--max-iters", "3", "--host-feed",
                  "--chunk-size", "1024", "--algo", "dd", "--device", "cpu"])
    out = dict(line.split(": ", 1)
               for line in capsys.readouterr().out.strip().splitlines())
    assert out["iterations"] == "3" and "screen_chunks_per_iter" not in out


def test_ops_adjusted_topc_routes_cpu_to_plain():
    p, b, lam = map(torch.tensor, _inst(300, K, 9, False))
    got = ops.adjusted_topc(p, b, lam, 2)
    want = ref.adjusted_topc_plain(p, b, lam, 2)
    assert all(torch.equal(a, e) for a, e in zip(got, want))
