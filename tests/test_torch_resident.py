"""The port's resident sparse solve against the JAX reference's, same instance.

The reference's ``sparse_instance`` (n = 2,000, K = 10, Q = 1, tightness
0.4) crosses as numpy arrays (``carry.instance_from_reference``), and its
``SolverConfig`` through ``config_from_reference``. Against
``repro.core.solver.solve``, kernels on and off, for sync bucketed, exact,
cyclic, DD, presolve and history: lam rtol 1e-5 / atol 1e-6, iterations
within one, primal and dual 1e-5 relative (the port sums in another order),
r rtol 1e-5, and at most 0.1 % of the decisions differ.

The pieces: the plain ``scd_candidates`` equals the reference's jnp
``scd_candidates_ref`` bitwise and its Pallas kernel in interpret mode to
rtol 1e-6 / atol 1.2e-6 (there XLA contracts ``p - lam*b`` into an FMA:
one ulp of pbar near 1, 6e-8, over the smallest b, 0.05);
``bucket_histogram(init=)`` adds in the reference's row order (masses
rtol 1e-5, bitwise on dyadic inputs); ``exact_threshold`` is exact on
dyadic inputs and rtol 1e-6 on random ones.

Within the port, bitwise: chunked == unchunked, and the resident chunked
solve == the host-fed solve on the same rows (lam and iterations).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bucketing as jb  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core.instances import shard_key  # noqa: E402
from repro.core.instances import sparse_instance as j_sparse_instance  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import solve as jlaunch  # noqa: E402
from repro_torch.core import bucketing as tb  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core.carry import config_from_reference, instance_from_reference  # noqa: E402
from repro_torch.core.instances import sparse_instance  # noqa: E402
from repro_torch.core.prefetch import solve_streaming_host  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.data.synth import sparse_host_chunk_source  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import solve as tlaunch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def ref_inst():
    kp, q = j_sparse_instance(shard_key(5), n=2000, k=10, q=1, tightness=0.4)
    return kp, q


def _t(a):
    return torch.tensor(np.array(a))


def assert_solves_close(tr, jr):
    """lam rtol 1e-5 / atol 1e-6, iterations within one, primal and dual
    1e-5 relative."""
    np.testing.assert_allclose(tr.lam.numpy(), np.asarray(jr.lam), rtol=1e-5, atol=1e-6)
    assert abs(tr.iters - int(jr.iters)) <= 1
    np.testing.assert_allclose(float(tr.primal), float(jr.primal), rtol=1e-5)
    np.testing.assert_allclose(float(tr.dual), float(jr.dual), rtol=1e-5)


CONFIGS = {
    "bucketed": {},
    "exact": {"reduce": "exact"},
    "cyclic": {"cd_mode": "cyclic", "max_iters": 10},
    "dd": {"algo": "dd", "max_iters": 15},
    "presolve": {"presolve_samples": 500},
    "history": {"record_history": True, "max_iters": 12},
}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_matches_reference(ref_inst, name, use_kernels):
    kp, q = ref_inst
    jcfg = JCfg(**CONFIGS[name], use_kernels=use_kernels)
    jr = jsolver.solve(kp, jcfg, q=q)
    tr = tsolver.solve(instance_from_reference(kp),
                       config_from_reference(dataclasses.asdict(jcfg)), q=q,
                       device="cpu")
    assert_solves_close(tr, jr)
    np.testing.assert_allclose(tr.r.numpy(), np.asarray(jr.r), rtol=1e-5)
    assert np.mean(tr.x.numpy() != np.asarray(jr.x)) <= 1e-3
    if name == "history":
        # The gap is a difference of two sums: held to 1e-5 of the dual.
        h, jh = tr.history, {k: np.asarray(v) for k, v in jr.history.items()}
        assert set(h) == set(jh)
        scale = float(np.abs(jh["dual"]).max())
        tol = {"lam": (1e-5, 1e-6), "primal": (1e-5, 0), "dual": (1e-5, 0),
               "gap": (0, 1e-5 * scale), "max_violation": (0, 1e-5)}
        for key, (rtol, atol) in tol.items():
            np.testing.assert_allclose(h[key].numpy(), jh[key], rtol=rtol, atol=atol)
    else:
        assert tr.history is None


@pytest.mark.parametrize("q", [1, 3])
def test_scd_candidates_plain_vs_reference(q):
    g = np.random.default_rng(q)
    p = g.random((1021, 10), dtype=np.float32)
    b = g.uniform(0.05, 1.0, (1021, 10)).astype(np.float32)
    b[::7] = 0.0
    lam = g.uniform(0, 1.5, 10).astype(np.float32)
    tv1, tv2 = ops.scd_candidates(_t(p), _t(b), _t(lam), q)
    jv1, jv2 = jref.scd_candidates_ref(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), q)
    np.testing.assert_array_equal(tv1.numpy(), np.asarray(jv1))
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    kv1, kv2 = jops.scd_candidates(jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam),
                                   q, tile_n=128, interpret=True)
    np.testing.assert_allclose(tv1.numpy(), np.asarray(kv1), rtol=1e-6, atol=1.2e-6)
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(kv2))


@pytest.mark.parametrize("dyadic", [False, True])
def test_bucket_histogram_seeded_vs_reference(dyadic):
    g = np.random.default_rng(7)
    n, k = 3000, 6
    v1 = g.uniform(-0.5, 2.0, (n, k)).astype(np.float32)
    v2 = g.random((n, k)).astype(np.float32)
    init = g.random((k, 50)).astype(np.float32)
    if dyadic:
        v2, init = np.round(v2 * 64) / 64, np.round(init * 64) / 64
    v2[v1 < 0] = 0.0
    edges = np.asarray(jb.make_edges(jnp.asarray(g.random(k).astype(np.float32)),
                                     1e-4, 1.6, 24))
    jh = np.asarray(jb.bucket_histogram(jnp.asarray(v1), jnp.asarray(v2),
                                        jnp.asarray(edges), init=jnp.asarray(init)))
    th = tb.bucket_histogram(_t(v1), _t(v2), _t(edges), init=_t(init)).numpy()
    np.testing.assert_array_equal(th > init, jh > init)
    if dyadic:
        np.testing.assert_array_equal(th, jh)
    else:
        np.testing.assert_allclose(th, jh, rtol=1e-5)


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("tight", [0.0, 0.3, 2.0])
def test_exact_threshold_vs_reference(dyadic, tight):
    g = np.random.default_rng(11)
    z, k = 4000, 5
    v1 = g.uniform(-0.2, 3.0, (z, k)).astype(np.float32)
    v2 = g.random((z, k)).astype(np.float32)
    if dyadic:
        v1, v2 = np.round(v1 * 8) / 8, np.round(v2 * 64) / 64   # ties in v1
    v1, v2 = np.where(v1 < 0, -1.0, v1), np.where(v1 < 0, 0.0, v2)
    budgets = (np.float32(tight) * v2.sum(0) / 2).astype(np.float32)
    jv = jax.vmap(jb.exact_threshold, in_axes=(1, 1, 0))(
        jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(budgets))
    tv = tb.exact_threshold(_t(v1).T, _t(v2).T, _t(budgets))
    if dyadic:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    one = tb.exact_threshold(_t(v1[:, 0]), _t(v2[:, 0]), _t(budgets[0]))
    assert float(one) == float(tv[0])


def test_ordered_cumsum_matches_cumsum_on_dyadic():
    g = np.random.default_rng(2)
    x = torch.tensor(np.round(g.random((3, 5000)) * 64) / 64, dtype=torch.float32)
    for dim in (0, 1, -1):
        assert torch.equal(tb.ordered_cumsum(x, dim), torch.cumsum(x, dim))
    y = torch.tensor(g.random(3001), dtype=torch.float32)
    torch.testing.assert_close(tb.ordered_cumsum(y), torch.cumsum(y, 0),
                               rtol=1e-6, atol=0)


def _bitwise(a, b):
    assert a.iters == b.iters
    for f in ("lam", "x", "r", "primal", "dual"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def port_inst():
    return sparse_instance(3, 3000, 10, chunk=1024)


@pytest.mark.parametrize("chunk", [1024, 768])
def test_chunked_equals_unchunked_bitwise(port_inst, chunk):
    """Chunk 768 leaves a ragged last chunk of padded users."""
    kp, q = port_inst
    cfg = SolverConfig(kernel_tile=256)
    _bitwise(tsolver.solve(kp, cfg, q=q, device="cpu"),
             tsolver.solve(kp, cfg.replace(chunk_size=chunk), q=q, device="cpu"))


def test_resident_chunked_equals_host_fed(port_inst):
    kp, q = port_inst
    cfg = SolverConfig(kernel_tile=256, chunk_size=1024)
    res = tsolver.solve(kp, cfg, q=q, device="cpu")
    host = solve_streaming_host(sparse_host_chunk_source(3, 3000, 10, 1024), cfg,
                                q=q, device="cpu")
    assert host.iters == res.iters and torch.equal(host.lam, res.lam)


def test_chunked_dd_close(port_inst):
    kp, q = port_inst
    cfg = SolverConfig(algo="dd", max_iters=20)
    a = tsolver.solve(kp, cfg, q=q, device="cpu")
    b = tsolver.solve(kp, cfg.replace(chunk_size=700), q=q, device="cpu")
    assert a.iters == b.iters
    torch.testing.assert_close(a.lam, b.lam, rtol=1e-6, atol=1e-7)


def test_exact_reduce_cannot_be_chunked(port_inst):
    kp, q = port_inst
    with pytest.raises(ValueError, match="bucketed"):
        tsolver.solve(kp, SolverConfig(reduce="exact", chunk_size=1024), q=q,
                      device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        tsolver.solve(kp, SolverConfig(chunk_size=0), q=q, device="cpu")


def test_solve_raises_without_cuda(port_inst, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kp, q = port_inst
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsolver.solve(kp, SolverConfig(max_iters=1), q=q)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--n", "4096"])


@pytest.mark.parametrize("extra", [[], ["--reduce", "exact"], ["--algo", "dd"],
                                   ["--chunk-size", "1024"], ["--presolve", "512"]])
def test_resident_cli_prints_reference_keys(capsys, extra):
    wl = jlaunch.WORKLOADS["table1"]
    small = jlaunch.KPWorkload(wl.name, 4096, wl.k, wl.q, wl.tightness)
    ref_keys = set(jlaunch.run(small, JCfg(max_iters=3)))
    tlaunch.main(["--workload", "table1", "--n", "4096", "--max-iters", "3",
                  "--device", "cpu", *extra])
    out = dict(line.split(": ", 1)
               for line in capsys.readouterr().out.strip().splitlines())
    assert set(out) == ref_keys | {"device"}
    assert out["device"] == "cpu" and int(out["n_users"]) == 4096
    assert float(out["dual"]) >= float(out["primal"])
