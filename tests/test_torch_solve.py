"""The port's host-fed solve against the JAX reference's, same instance.

Both packages' ``host_array_source`` serve the same numpy rows (n = 20,000,
K = 10, chunk 4096, kernel tile 512). Against the reference, with its
kernels on and off: lam allclose (rtol 1e-5, atol 1e-6), iterations
within one, primal and dual within 1e-5 relative, tau equal; decisions
equal row for row at the same (lam, tau). Within the port: double buffering
on and off gives bitwise-equal results; chunk 4096 and 8192 give bitwise
equal iterations and histograms, and each chunking's scalar sums are
bitwise its chunk-grouped fold.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import chunked as jchunked  # noqa: E402
from repro.core import prefetch as jpf  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.launch import solve as jlaunch  # noqa: E402
from repro_torch.core import chunked as tchunked  # noqa: E402
from repro_torch.core import postprocess as tpost  # noqa: E402
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core.carry import (  # noqa: E402
    config_from_reference,
    state_from_reference,
)
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import solve as tlaunch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N, K, CHUNK, TILE = 20_000, 10, 4096, 512


@pytest.fixture(scope="module")
def inst():
    src = jsynth.sparse_host_chunk_source(0, N, K, CHUNK)
    ps, bs = zip(*(src.fn(i) for i in range(-(-N // CHUNK))))
    return np.concatenate(ps)[:N], np.concatenate(bs)[:N], src.budgets


def _jax(inst, use_kernels, max_iters=40, lam0=None):
    p, b, budgets = inst
    cfg = JCfg(max_iters=max_iters, kernel_tile=TILE, use_kernels=use_kernels)
    return jpf.solve_streaming_host(jpf.host_array_source(p, b, budgets, CHUNK),
                                    cfg, q=1, lam0=lam0), cfg


def _port(inst, cfg, chunk=CHUNK, double_buffer=True, lam0=None):
    p, b, budgets = inst
    return tpf.solve_streaming_host(tpf.host_array_source(p, b, budgets, chunk),
                                    cfg, q=1, lam0=lam0, device="cpu",
                                    double_buffer=double_buffer)


@pytest.fixture(scope="module")
def port_default(inst):
    return _port(inst, SolverConfig(max_iters=40, kernel_tile=TILE))


def _assert_close(tr, jr):
    np.testing.assert_allclose(tr.lam.numpy(), np.asarray(jr.lam),
                               rtol=1e-5, atol=1e-6)
    assert abs(tr.iters - int(jr.iters)) <= 1
    np.testing.assert_allclose(float(tr.primal), float(jr.primal), rtol=1e-5)
    np.testing.assert_allclose(float(tr.dual), float(jr.dual), rtol=1e-5)
    assert float(tr.tau) == float(jr.tau)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_solve_matches_reference(inst, port_default, use_kernels):
    jr, jcfg = _jax(inst, use_kernels)
    tcfg = config_from_reference(dataclasses.asdict(jcfg))
    assert tcfg == SolverConfig(max_iters=40, kernel_tile=TILE)
    _assert_close(port_default, jr)


def test_projection_active_and_decisions(inst):
    """Started below the fixed point and stopped after 3 iterations, the
    solve over-consumes: the §5.4 projection removes groups and tau is
    finite on both sides."""
    lam0 = np.full((K,), 0.5, np.float32)
    jr, jcfg = _jax(inst, False, max_iters=3, lam0=lam0)
    tr = _port(inst, config_from_reference(dataclasses.asdict(jcfg)), lam0=lam0)
    assert np.isfinite(float(jr.tau))
    _assert_close(tr, jr)
    np.testing.assert_allclose(tr.r.numpy(), np.asarray(jr.r), rtol=1e-5)
    assert float(torch.max(tr.r - torch.tensor(inst[2]))) <= 0.0
    p, b, _ = inst
    lam, tau = np.asarray(jr.lam), np.asarray(jr.tau)
    for s in range(0, N, CHUNK):
        pc, bc = p[s:s + CHUNK], b[s:s + CHUNK]
        valid = np.ones(pc.shape[0], bool)
        jx = jchunked.decisions_rows(jnp.asarray(pc), jnp.asarray(bc),
                                     jnp.asarray(lam), 1, jnp.asarray(valid),
                                     jnp.asarray(tau))
        tx = tchunked.decisions_rows(torch.tensor(pc), torch.tensor(bc),
                                     torch.tensor(lam), 1, torch.tensor(valid),
                                     torch.tensor(tau))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_finalize_from_reference_lambda(inst):
    jr, jcfg = _jax(inst, False, max_iters=3, lam0=np.full((K,), 0.5, np.float32))
    state = state_from_reference("cpu", lam=np.asarray(jr.lam))
    cfg = config_from_reference(dataclasses.asdict(jcfg)).replace(max_iters=0)
    tr = _port(inst, cfg, lam0=state.lam)
    assert tr.iters == 0 and torch.equal(tr.lam, state.lam)
    np.testing.assert_allclose(tr.r.numpy(), np.asarray(jr.r), rtol=1e-5)
    np.testing.assert_allclose(float(tr.primal), float(jr.primal), rtol=1e-5)
    np.testing.assert_allclose(float(tr.dual), float(jr.dual), rtol=1e-5)
    assert float(tr.tau) == float(jr.tau)


def _assert_bitwise(a, b):
    assert a.iters == b.iters
    for f in ("lam", "r", "primal", "dual", "tau"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.fin_hist, b.fin_hist):
        assert torch.equal(x, y)


def _chunk_grouped(inst, res, chunk):
    """(r, primal, dual, tau) as the streamed finalize groups its scalar
    sums, written out: each chunk's finalize at the solved lam from 0.0
    (the kernel's tile order), the chunks added onto the carry in order
    (one float32 add each, the reference's default path), then the §5.4
    projection off the run's removable histograms."""
    p, b, budgets = inst
    src = tpf.host_array_source(p, b, budgets, chunk)
    pedges = tpost.profit_edges_fixed()
    r, primal, dual = torch.zeros(K), torch.zeros(()), torch.zeros(())
    for i in range(-(-N // chunk)):
        pc, bc = (torch.from_numpy(a) for a in src.fn(i))
        _, _, rc, primal_c, dual_c, _, _ = ops.scd_finalize_hist(
            pc, bc, res.lam, pedges, 1, tile_n=TILE)
        r, primal, dual = r + rc, primal + primal_c, dual + dual_c
    budgets = torch.from_numpy(budgets)
    dual = dual + torch.sum(res.lam * budgets)
    tau, rm_cons, rm_gain = tpost.threshold_and_removed(*res.fin_hist, pedges,
                                                        r, budgets)
    return {"r": r - rm_cons, "primal": primal - rm_gain, "dual": dual,
            "tau": tau}


def test_chunk_size_invariance_bitwise(inst, port_default):
    """Chunk 4096 and 8192: the iteration and the finalize's removable
    histograms are bitwise equal. The scalar sums group by chunk, as the
    reference's default path adds them, so each chunking's (r, primal,
    dual, tau) is bitwise its own chunk-grouped fold."""
    other = _port(inst, SolverConfig(max_iters=40, kernel_tile=TILE), chunk=2 * CHUNK)
    assert port_default.iters == other.iters
    assert torch.equal(port_default.lam, other.lam)
    for x, y in zip(port_default.fin_hist, other.fin_hist):
        assert torch.equal(x, y)
    for res, chunk in ((port_default, CHUNK), (other, 2 * CHUNK)):
        for f, want in _chunk_grouped(inst, res, chunk).items():
            assert torch.equal(getattr(res, f), want), (chunk, f)


def test_double_buffer_invariance_bitwise(inst, port_default):
    sync = _port(inst, SolverConfig(max_iters=40, kernel_tile=TILE),
                 double_buffer=False)
    _assert_bitwise(port_default, sync)


def test_cli_prints_reference_keys(capsys):
    wl = jlaunch.WORKLOADS["table1"]
    small = jlaunch.KPWorkload(wl.name, 4096, wl.k, wl.q, wl.tightness)
    ref_keys = set(jlaunch.run_streaming(small, JCfg(max_iters=3), 1024,
                                         host_feed=True))
    tlaunch.main(["--workload", "table1", "--n", "4096", "--max-iters", "3",
                  "--host-feed", "--chunk-size", "1024", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = dict(line.split(": ", 1) for line in lines)
    assert ref_keys <= set(out)
    assert out["device"] == "cpu" and int(out["n_users"]) == 4096


def test_entry_points_raise_without_cuda(inst, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, b, budgets = inst
    src = tpf.host_array_source(p, b, budgets, CHUNK)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpf.solve_streaming_host(src, SolverConfig(max_iters=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--n", "4096", "--host-feed", "--chunk-size", "1024"])


def test_unported_options_raise(inst):
    """The host-fed driver refuses cyclic CD and the exact reduce with the
    reference's ValueError, and a ``mesh`` that is not a ``core.mesh.Mesh``
    with ``TypeError``. The legacy finalize, the sampled history, the
    launcher's ``--streaming`` (ROADMAP A3) and the straggler mask
    (``partial_fraction``, A8) are ported: accepted and run."""
    for kw in ({"stream_finalize": "legacy"}, {"metrics_every": 2}):
        assert getattr(SolverConfig(**kw), next(iter(kw))) == next(iter(kw.values()))
    assert config_from_reference(
        dataclasses.asdict(JCfg(partial_fraction=0.5))).partial_fraction == 0.5
    p, b, budgets = inst
    src = tpf.host_array_source(p, b, budgets, CHUNK)
    with pytest.raises(ValueError, match="cd_mode='sync'"):
        tpf.solve_streaming_host(src, SolverConfig(cd_mode="cyclic"), device="cpu")
    with pytest.raises(ValueError, match="bucketed"):
        tpf.solve_streaming_host(src, SolverConfig(reduce="exact"), device="cpu")
    with pytest.raises(ValueError, match="metrics_every"):
        tpf.solve_streaming_host(src, SolverConfig(record_history=True),
                                 device="cpu")
    res = tpf.solve_streaming_host(
        src, SolverConfig(max_iters=3, record_history=True, metrics_every=2,
                          stream_finalize="legacy", kernel_tile=TILE), device="cpu")
    assert res.history["lam"].shape == (3, K) and res.fin_hist is None
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        tpf.solve_streaming_host(src, device="cpu", mesh=object())
    with pytest.raises(SystemExit, match="chunk-size"):
        tlaunch.main(["--streaming", "--device", "cpu"])
