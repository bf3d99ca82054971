"""The port's device-streamed solve, legacy finalize and sampled history
against the JAX reference's, on the same NumPy bytes.

Within the port, bitwise: ``solve_streaming`` over ``array_source`` ==
``solve_streaming_host`` over ``host_array_source`` of the same rows
(fused and legacy finalize, SCD and DD, the sampled history), screened ==
unscreened, and (lam, iters) == the resident chunked ``solve``. The
source is read iters + 1 times (fused) and iters + 3 times (legacy).
Against the reference: the legacy pieces on the reference's own edges
(the removable histogram bitwise on dyadic inputs and to rtol 1e-5 on
random ones, tau bitwise on the same histogram); the whole solve on a
dyadic instance (lam and the history's lam bitwise, iterations equal,
r, primal, dual and the history's sums rtol 1e-5, tau within one edge of
the legacy ladder); decisions equal row for row at the same (lam, tau).
The port's legacy ladder differs from ``jnp.linspace`` in the last bits
(ROADMAP C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import chunked as jchunked  # noqa: E402
from repro.core import postprocess as jpost  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.core.types import SparseKP as JKP  # noqa: E402
from repro_torch.core import chunked as tchunked  # noqa: E402
from repro_torch.core import postprocess as tpost  # noqa: E402
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core.solver import solve  # noqa: E402
from repro_torch.core.types import SolverConfig, SparseKP  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import solve as tlaunch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N, K, Q, CHUNK = 1021, 10, 2, 256
FIELDS = ("lam", "r", "primal", "dual", "tau")


def _dyadic(n=N, k=K, seed=0, tightness=0.4):
    g = np.random.default_rng(seed)
    p = (g.integers(0, 64, (n, k)) / 64).astype(np.float32)
    b = (g.integers(1, 64, (n, k)) / 64).astype(np.float32)
    budgets = np.full((k,), tightness * n * Q * 0.5 / k, np.float32)
    return p, b, budgets


@pytest.fixture(scope="module")
def rows():
    return _dyadic()


def _kp(rows):
    return SparseKP(*(torch.tensor(a) for a in rows))


def _stream(rows, cfg, chunk=CHUNK, **kw):
    return tchunked.solve_streaming(tchunked.array_source(_kp(rows), chunk,
                                                          device="cpu"),
                                    cfg, q=Q, device="cpu", **kw)


def _host(rows, cfg, chunk=CHUNK, **kw):
    return tpf.solve_streaming_host(tpf.host_array_source(*rows, chunk), cfg,
                                    q=Q, device="cpu", **kw)


def _assert_same(a, b, hist=True):
    assert a.iters == b.iters
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if hist and a.fin_hist is not None:
        for x, y in zip(a.fin_hist, b.fin_hist):
            assert torch.equal(x, y)


def _cfg(**kw):
    return SolverConfig(**{"max_iters": 20, **kw})


# --------------------------------------------------------------------------
# The legacy §5.4 pieces.
# --------------------------------------------------------------------------

def test_profit_edges_float64_ladder():
    """The port's linear ladder is numpy's float64 linspace of the float32
    (lo, hi), cast: the same on every device, within an ulp or two of
    ``jnp.linspace``."""
    lo, hi = np.float32(0.0123), np.float32(7.77)
    got = tpost.profit_edges(lo, hi, 512).numpy()
    np.testing.assert_array_equal(
        got, np.linspace(float(lo), float(hi), 512).astype(np.float32))
    np.testing.assert_allclose(got, np.asarray(jpost.profit_edges(lo, hi, 512)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dyadic", [True, False])
def test_removable_hist_matches_reference(dyadic):
    """On the reference's own edges: bitwise on dyadic inputs, rtol 1e-5
    on random ones; seeded and chunked (a multiple of the tile) ==
    one pass, bitwise; tau on the same histogram bitwise."""
    g = np.random.default_rng(3)
    n = 1500
    if dyadic:
        pt = (g.integers(0, 512, n) / 64).astype(np.float32)
        cons = (g.integers(0, 64, (n, K)) / 64).astype(np.float32)
    else:
        pt = (g.random(n) * 8).astype(np.float32)
        cons = g.random((n, K)).astype(np.float32)
    edges = np.asarray(jpost.profit_edges(np.float32(0.5), np.float32(7.5), 512))
    want = np.asarray(jpost.removable_hist(jnp.asarray(pt), jnp.asarray(cons),
                                           jnp.asarray(edges)))
    tpt, tcons, tedges = torch.tensor(pt), torch.tensor(cons), torch.tensor(edges)
    got = tpost.removable_hist(tpt, tcons, tedges)
    if dyadic:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tile = tpost.removable_tile(K, 512)
    assert tile == 256
    part = tpost.removable_hist(tpt[:tile * 3], tcons[:tile * 3], tedges)
    part = tpost.removable_hist(tpt[tile * 3:], tcons[tile * 3:], tedges, init=part)
    assert torch.equal(part, got)
    r_total = torch.tensor(cons.sum(0))
    budgets = r_total * 0.7
    tau = tpost.threshold_from_removable_hist(got, tedges, r_total, budgets)
    jtau = jpost.threshold_from_removable_hist(
        jnp.asarray(got.numpy()), jnp.asarray(edges), jnp.asarray(r_total.numpy()),
        jnp.asarray(budgets.numpy()))
    assert float(tau) == float(jtau)
    assert float(tpost.threshold_from_removable_hist(
        got, tedges, r_total, r_total * 2)) == float("-inf")


def test_feasibility_threshold_bucketed_and_the_smem_limit():
    """The composed resident form against the reference's on dyadic rows
    (tau within one edge of the ladder), and the refusal where the run
    histograms cannot fit a block's shared memory."""
    g = np.random.default_rng(5)
    n = 800
    pt = (g.integers(1, 512, n) / 64).astype(np.float32)
    cons = (g.integers(0, 64, (n, 6)) / 64).astype(np.float32)
    r_total = cons.sum(0)
    budgets = (r_total * 0.8).astype(np.float32)
    got = tpost.feasibility_threshold_bucketed(
        torch.tensor(pt), torch.tensor(cons), torch.tensor(r_total),
        torch.tensor(budgets))
    want = jpost.feasibility_threshold_bucketed(
        jnp.asarray(pt), jnp.asarray(cons), jnp.asarray(r_total),
        jnp.asarray(budgets))
    step = (pt.max() - pt.min()) / 511
    assert abs(float(got) - float(want)) <= step * 1.0001
    assert tpost.removable_tile(53, 512) == 32
    with pytest.raises(ValueError, match="shared memory"):
        tpost.removable_tile(64, 512)


# --------------------------------------------------------------------------
# Device-streamed == host-fed == resident, within the port.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("finalize", ["fused", "legacy"])
@pytest.mark.parametrize("algo", ["scd", "dd"])
def test_streamed_equals_host_fed_bitwise(rows, finalize, algo):
    cfg = _cfg(algo=algo, stream_finalize=finalize, kernel_tile=128)
    a, b = _stream(rows, cfg), _host(rows, cfg)
    _assert_same(a, b)
    assert (a.fin_hist is None) == (finalize == "legacy")


def test_streamed_equals_resident_chunked(rows):
    """(lam, iters) of the SCD bucketed path equal the resident solve with
    chunk_size = the source's chunk (the map tile divides it); cyclic CD
    too."""
    for mode in ("sync", "cyclic"):
        cfg = _cfg(kernel_tile=128, cd_mode=mode, max_iters=6 if mode == "cyclic" else 20)
        a = _stream(rows, cfg)
        r = solve(_kp(rows), cfg.replace(chunk_size=CHUNK), q=Q, device="cpu")
        assert a.iters == r.iters
        assert torch.equal(a.lam, r.lam)


@pytest.mark.parametrize("finalize,extra", [("fused", 1), ("legacy", 3)])
def test_pass_counts(rows, finalize, extra):
    """A converged solve reads the source iters + 1 (fused) or iters + 3
    (legacy) times, device-streamed and host-fed."""
    cfg = _cfg(stream_finalize=finalize, kernel_tile=128)
    c = -(-N // CHUNK)
    src = tchunked.array_source(_kp(rows), CHUNK, device="cpu")
    calls = {"dev": 0, "host": 0}

    def count(fn, key):
        def wrapped(i):
            calls[key] += 1
            return fn(i)
        return wrapped

    a = tchunked.solve_streaming(src._replace(fn=count(src.fn, "dev")), cfg, q=Q,
                                 device="cpu")
    hsrc = tpf.host_array_source(*rows, CHUNK)
    b = tpf.solve_streaming_host(hsrc._replace(fn=count(hsrc.fn, "host")), cfg, q=Q,
                                 device="cpu")
    assert 0 < a.iters < cfg.max_iters
    assert calls["dev"] == calls["host"] == (a.iters + extra) * c
    _assert_same(a, b)


def test_screened_equals_unscreened_with_host_profile():
    """On the banded workload: screened == unscreened in every field,
    some iteration streams fewer chunks, and the per-iteration active
    counts and fallbacks are the host-fed screened solve's (whose profile
    adds a fallback's full pass to its epoch)."""
    src = tsynth.banded_host_chunk_source(7, 4000, 6, 250, q=2, tightness=0.08)
    p = np.concatenate([src.fn(i)[0] for i in range(16)])
    b = np.concatenate([src.fn(i)[1] for i in range(16)])
    kp = SparseKP(torch.tensor(p), torch.tensor(b), torch.tensor(src.budgets))
    cfg = SolverConfig(max_iters=30, bucket_half=12, kernel_tile=50)
    dsrc = tchunked.array_source(kp, 250, device="cpu")
    base = tchunked.solve_streaming(dsrc, cfg, q=2, device="cpu")
    scr = tchunked.solve_streaming(dsrc, cfg.replace(screening=True), q=2, device="cpu")
    _assert_same(base, scr)
    active = scr.screen["active_chunks"].numpy()
    live = active[active >= 0]
    assert len(live) == scr.iters and live.min() < 16 and scr.screen["resets"] == 0
    host = tpf.solve_streaming_host(src, cfg.replace(screening=True), q=2, device="cpu")
    _assert_same(scr, host)
    prof = host.screen["streamed_chunks"]
    assert scr.screen["fallbacks"] == host.screen["fallbacks"]
    assert len(prof) == len(live) and np.all((prof == live) | (prof == live + 16))
    assert int(prof.sum() - live.sum()) == 16 * host.screen["fallbacks"]


def test_presolve_streamed_equals_host_fed(rows):
    cfg = _cfg(kernel_tile=128, presolve_samples=300)
    _assert_same(_stream(rows, cfg), _host(rows, cfg))


# --------------------------------------------------------------------------
# The sampled history.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("finalize", ["fused", "legacy"])
def test_sampled_history_host_fed_equals_streamed_and_reference(rows, finalize):
    """Host-fed sampled rows == device-streamed rows bitwise (live, NaN and
    the frozen tail); against the reference's traced history on the same
    dyadic rows: lam bitwise, iterations equal, the sums rtol 1e-5, and
    tau within one edge of the legacy ladder."""
    cfg = _cfg(record_history=True, metrics_every=3, stream_finalize=finalize,
               kernel_tile=128)
    dev, host = _stream(rows, cfg), _host(rows, cfg)
    _assert_same(dev, host)
    assert sorted(dev.history) == ["dual", "gap", "lam", "max_violation", "primal"]
    for key in dev.history:
        assert dev.history[key].shape[0] == cfg.max_iters
        np.testing.assert_array_equal(dev.history[key].numpy(),
                                      host.history[key].numpy(), err_msg=key)
    p, b, budgets = rows
    jkp = JKP(jnp.asarray(p), jnp.asarray(b), jnp.asarray(budgets))
    ref = jchunked.solve_streaming(
        jchunked.array_source(jkp, CHUNK),
        JCfg(reduce="bucketed", max_iters=20, record_history=True, metrics_every=3,
             stream_finalize=finalize), q=Q)
    assert dev.iters == int(ref.iters)
    np.testing.assert_array_equal(dev.lam.numpy(), np.asarray(ref.lam))
    np.testing.assert_array_equal(dev.history["lam"].numpy(),
                                  np.asarray(ref.history["lam"]))
    for key in ("primal", "dual", "gap", "max_violation"):
        a, w = dev.history[key].numpy(), np.asarray(ref.history[key])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(w))
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-3, err_msg=key)
    for f in ("r", "primal", "dual"):
        np.testing.assert_allclose(getattr(dev, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5)
    if finalize == "fused":
        assert float(dev.tau) == float(ref.tau)
    else:
        # The legacy ladder spans the finalize's (lo, hi): one edge apart.
        src = tchunked.array_source(_kp(rows), CHUNK, device="cpu")
        lo, hi = tchunked._DeviceRunner(src, cfg, Q,
                                        torch.device("cpu")).metrics(dev.lam)[3:]
        assert abs(float(dev.tau) - float(ref.tau)) <= float(hi - lo) / 511


def test_sampled_history_slots_and_refusals(rows, tmp_path):
    """Slot partials of the sampled rows fold in slot order (2 slots: the
    rows' lam is the 2-slot trajectory's); history with checkpoint or
    resume, legacy with slots > 1, and history without metrics_every
    raise the reference's ValueErrors; mesh names A8."""
    cfg = _cfg(record_history=True, metrics_every=2, kernel_tile=128)
    two = _host(rows, cfg, slots=2)
    plain = _host(rows, cfg.replace(record_history=False), slots=2)
    _assert_same(two, plain)
    assert torch.equal(two.history["lam"][two.iters - 1], two.lam)
    assert torch.isfinite(two.history["primal"][0])
    with pytest.raises(ValueError, match="checkpoint/resume"):
        _host(rows, cfg.replace(checkpoint_every=2), checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="fused"):
        _host(rows, _cfg(stream_finalize="legacy"), slots=2)
    with pytest.raises(ValueError, match="metrics_every"):
        _stream(rows, _cfg(record_history=True))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        _stream(rows, _cfg(), mesh=object())


# --------------------------------------------------------------------------
# Decisions, the generated source, the launcher.
# --------------------------------------------------------------------------

def test_decisions_chunk_matches_reference(rows):
    """At the same (lam, tau), every chunk's decisions equal the
    reference's ``decisions_chunk`` row for row, ragged tail included."""
    res = _stream(rows, _cfg(kernel_tile=128))
    p, b, budgets = rows
    jsrc = jchunked.array_source(JKP(jnp.asarray(p), jnp.asarray(b),
                                     jnp.asarray(budgets)), CHUNK)
    src = tchunked.array_source(_kp(rows), CHUNK, device="cpu")
    tau = torch.tensor(np.float32(0.25))
    for t in (res.tau, tau):
        for i in range(-(-N // CHUNK)):
            x, valid = tchunked.decisions_chunk(src, res.lam, Q, i, tau=t)
            jx, jvalid = jchunked.decisions_chunk(jsrc, jnp.asarray(res.lam.numpy()),
                                                  Q, i, tau=jnp.asarray(t.numpy()))
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_sparse_chunk_source_is_pure_per_chunk():
    src = tsynth.sparse_chunk_source(5, 1000, 4, 256, q=2, tightness=0.3,
                                     device="cpu")
    late = src.fn(3)
    early = src.fn(0)
    again = src.fn(3)
    assert torch.equal(late[0], again[0]) and torch.equal(late[1], again[1])
    assert not torch.equal(early[0], late[0])
    assert torch.all(late[0][1000 - 768:] == 0) and torch.all(late[1][1000 - 768:] == 0)
    np.testing.assert_array_equal(src.budgets.numpy(),
                                  np.full((4,), 0.3 * 1000 * 2 * 0.5 / 4, np.float32))
    res = tchunked.solve_streaming(src, _cfg(), q=2, device="cpu")
    again = tchunked.solve_streaming(src, _cfg(), q=2, device="cpu")
    _assert_same(res, again)
    assert float(res.dual) >= float(res.primal)
    assert float(torch.max(res.r - src.budgets)) <= 1e-4 * float(src.budgets[0])


def test_launcher_streaming_and_legacy(capsys):
    tlaunch.main(["--streaming", "--chunk-size", "4096", "--n", "20000",
                  "--device", "cpu", "--max-iters", "20"])
    out = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines())
    assert int(out["n_users"]) == 20000 and int(out["iterations"]) > 0
    assert out["device"] == "cpu" and float(out["max_violation"]) <= 1e-4
    tlaunch.main(["--host-feed", "--stream-finalize", "legacy", "--chunk-size",
                  "4096", "--n", "20000", "--device", "cpu", "--max-iters", "20"])
    legacy = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines())
    tlaunch.main(["--host-feed", "--chunk-size", "4096", "--n", "20000",
                  "--device", "cpu", "--max-iters", "20"])
    fused = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines())
    assert legacy["iterations"] == fused["iterations"]
    assert legacy["dual"] == fused["dual"] and legacy["lam"] == fused["lam"]
    assert float(legacy["max_violation"]) <= 1e-4
    assert out["gap_negative"] == "False" and fused["gap_negative"] == "False"
    with pytest.raises(SystemExit):
        tlaunch.main(["--streaming", "--device", "cpu"])
    with pytest.raises(SystemExit, match="two different drivers"):
        tlaunch.main(["--streaming", "--host-feed", "--chunk-size", "4096",
                      "--n", "20000", "--device", "cpu"])


def test_launcher_flags_a_dual_below_a_feasible_primal(capsys, monkeypatch):
    """Weak duality puts the dual at or above the primal of a feasible
    solution; a run whose float32 sums break that prints
    ``gap_negative: True`` and exits non-zero."""
    def broken(*args, **kw):
        res = tchunked.StreamResult(
            lam=torch.ones(K), iters=1, r=torch.zeros(K),
            primal=torch.tensor(2.0), dual=torch.tensor(1.0),
            tau=torch.tensor(float("-inf")))
        return res

    monkeypatch.setattr(tlaunch, "solve_streaming", broken)
    with pytest.raises(SystemExit, match="float32 running sums"):
        tlaunch.main(["--streaming", "--chunk-size", "4096", "--n", "20000",
                      "--device", "cpu"])
    out = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines())
    assert out["gap_negative"] == "True" and float(out["duality_gap"]) == -1.0


def test_float32_seed_fold_bias_is_the_reference_s():
    """The N = 10^9 primal-above-dual, scaled down: the finalize folds each
    512-row tile's sum onto a float32 seed, in the reference's kernel as in
    the port's. Seeded at the size the running primal reaches near 10^9
    rows (a float32 step of 64), a few tiles of a dyadic chunk (every tile
    sum exact on both sides) fold to the same bits in both, and both land
    far from the exact sum: 0.5 % low here, where float32's own relative
    step is 6e-8."""
    from repro.kernels import scd_fused as jfused
    p, b, _ = _dyadic(n=16 * 512, seed=3)
    lam = np.full((K,), 0.5, np.float32)
    seed = np.array([8.0e8, 7.9e8], np.float32)
    ref = jfused.scd_finalize_hist(
        jnp.asarray(p), jnp.asarray(b), jnp.asarray(lam), jnp.zeros((1,)), Q,
        tile_n=512, interpret=True, with_hist=False,
        sums_init=jnp.asarray(seed))
    got = tops.scd_finalize_hist(
        torch.tensor(p), torch.tensor(b), torch.tensor(lam), None, Q,
        tile_n=512, with_hist=False, sums_init=torch.tensor(seed))
    for x, y in zip(ref[2:5], got[2:5]):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # The exact sum the tiles add: unseeded, every partial sum is exact.
    one = tops.scd_finalize_hist(
        torch.tensor(p), torch.tensor(b), torch.tensor(lam), None, Q,
        tile_n=512, with_hist=False)
    added = float(one[3])
    drift = (float(got[3]) - float(seed[0])) / added - 1.0
    assert abs(drift) > 1e-3, drift
