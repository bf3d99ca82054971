"""The port's active-set screening against the JAX reference's, same bytes.

Both packages' ``banded_host_chunk_source`` make the same numpy chunks
(checked here byte for byte); the shapes are the reference screening
bench's smoke point (``benchmarks/bench_screening.py``: K = 6, Q = 2,
tightness 0.08, band 0.05, ``bucket_half=12``, ``max_iters=30``, n =
4,000 in chunks of 250). Exact: the certificates (``chunk_bound``, its
plain version and the reference's jnp and interpret-mode Pallas
``screen_bound``: a max of correctly rounded divisions), the lowest
edges, the crossing guard, the streamed-chunk profile, the retired set,
and, within the port, screened == unscreened in every field. To
tolerance against the reference's screened solve: lam rtol 1e-5 / atol
1e-6, primal and dual 1e-5 relative (the histogram sums add in another
order), with equal iterations.
"""
import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import screening as jscr  # noqa: E402
from repro.core.bucketing import hist_crossings as j_hist_crossings  # noqa: E402
from repro.core.prefetch import solve_streaming_host as j_solve  # noqa: E402
from repro.core.types import SolverConfig as JCfg  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import screening as tscr  # noqa: E402
from repro_torch.core.prefetch import FeedStats, solve_streaming_host  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import solve as tlaunch  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N, K, CHUNK, Q, HALF, ITERS = 4000, 6, 250, 2, 12, 30
C = -(-N // CHUNK)
FIELDS = ("lam", "r", "primal", "dual", "tau")


def _cfg(screening=False, floor=0.5):
    # kernel_tile 50 divides the chunk and keeps the plain kernels' Python
    # row loop short; the reference's jnp path has no tiles.
    return SolverConfig(max_iters=ITERS, bucket_half=HALF, screening=screening,
                        screening_floor=floor, kernel_tile=50)


def _jcfg(screening=False, floor=0.5):
    return JCfg(reduce="bucketed", max_iters=ITERS, bucket_half=HALF,
                screening=screening, screening_floor=floor)


def _banded(seed, tightness=0.08, band=0.05, n=N):
    return tsynth.banded_host_chunk_source(seed, n, K, CHUNK, q=Q,
                                           tightness=tightness, band=band)


def _solve(src, cfg, **kw):
    return solve_streaming_host(src, cfg, q=Q, device="cpu", **kw)


def _assert_bitwise(a, b):
    assert a.iters == b.iters
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.fin_hist, b.fin_hist):
        assert torch.equal(x, y)


def _rows(n, seed):
    g = np.random.default_rng(seed)
    p = g.random((n, K)).astype(np.float32)
    b = g.uniform(-0.1, 1.0, (n, K)).astype(np.float32)
    b[::7] = 0.0                       # whole rows without a valid item
    b[:, 3] = 0.0                      # a whole column: the bound is -inf
    return p, b


@pytest.mark.parametrize("n", [250, 4099])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_bound_matches_reference(n, seed):
    p, b = _rows(n, seed)
    port = tscr.chunk_bound(torch.tensor(p), torch.tensor(b)).numpy()
    plain = ref.screen_bound_plain(torch.tensor(p), torch.tensor(b)).numpy()
    jp, jb = jnp.asarray(p), jnp.asarray(b)
    np.testing.assert_array_equal(port, plain)
    np.testing.assert_array_equal(port, np.asarray(jscr.chunk_bound(jp, jb)))
    np.testing.assert_array_equal(
        port, np.asarray(jops.screen_bound(jp, jb, tile_n=512, interpret=True)))
    assert port[3] == -np.inf and np.all(np.isfinite(np.delete(port, 3)))


@pytest.mark.parametrize("seed", [3, 11])
def test_banded_source_bytes(seed):
    n = N - 17                         # a ragged last chunk
    ours = _banded(seed, n=n)
    theirs = jsynth.banded_host_chunk_source(seed, n, K, CHUNK, q=Q,
                                             tightness=0.08, band=0.05)
    np.testing.assert_array_equal(ours.budgets, theirs.budgets)
    for i in (0, 1, 8, C - 1):
        for a, e in zip(ours.fn(i), theirs.fn(i)):
            assert a.dtype == e.dtype and np.array_equal(a, e)


def test_lowest_edges_and_crossing_guard_match_reference():
    cfg, jcfg = _cfg(True), _jcfg(True)
    lam_lo = np.array([0.0, 0.3, 0.45, 0.9, 1.7, 3.0], np.float32)
    np.testing.assert_array_equal(tscr.lowest_edges(lam_lo, cfg),
                                  jscr.lowest_edges(lam_lo, jcfg))
    g = np.random.default_rng(5)
    for _ in range(20):
        hist = (g.random((K, 2 * HALF + 2)) * (g.random((K, 2 * HALF + 2)) < 0.4)
                ).astype(np.float32)
        budgets = (g.random(K) * hist.sum(1) * 1.2).astype(np.float32)
        ours = tscr.crossing_trusted(torch.tensor(hist), torch.tensor(budgets))
        theirs = jscr.crossing_trusted(jnp.asarray(hist), jnp.asarray(budgets))
        assert bool(ours) == bool(theirs)
        _, _, in_bucket = j_hist_crossings(jnp.asarray(hist), jnp.asarray(budgets))
        assert bool(ours) == bool(np.all(np.asarray(in_bucket)[:, 1:].any(-1)))


@pytest.mark.parametrize("seed,tightness,band,floor", [
    (11, 0.08, 0.05, 0.5), (5, 0.1, 0.05, 0.5), (23, 0.05, 0.1, 0.25),
    (42, 0.12, 0.02, 0.9)])
def test_screened_equals_unscreened(seed, tightness, band, floor):
    src = _banded(seed, tightness, band)
    base = _solve(src, _cfg(False, floor))
    scr = _solve(src, _cfg(True, floor))
    _assert_bitwise(base, scr)
    assert base.screen is None and scr.screen is not None
    assert not scr.screen["active"].all(), "nothing retired: the check is vacuous"
    streamed = scr.screen["streamed_chunks"]
    assert streamed.shape == (scr.iters,) and streamed.min() < C


def test_screened_matches_reference():
    src = _banded(7)
    jsrc = jsynth.banded_host_chunk_source(7, N, K, CHUNK, q=Q, tightness=0.08,
                                           band=0.05)
    ours = _solve(src, _cfg(True))
    theirs = j_solve(jsrc, _jcfg(True), q=Q)
    assert ours.iters == int(theirs.iters)
    for key in ("streamed_chunks", "active", "bmax", "lam_lo"):
        np.testing.assert_array_equal(ours.screen[key], theirs.screen[key])
    for key in ("resets", "fallbacks", "seeded_active"):
        assert ours.screen[key] == theirs.screen[key]
    np.testing.assert_allclose(ours.lam.numpy(), np.asarray(theirs.lam),
                               rtol=1e-5, atol=1e-6)
    for f in ("primal", "dual"):
        np.testing.assert_allclose(float(getattr(ours, f)),
                                   float(getattr(theirs, f)), rtol=1e-5)


def test_retired_certificates_are_sound():
    """Every retired chunk's certificate clears the floor's lowest edge and
    is within one float32 step above the float64 max of its bytes."""
    src = _banded(11)
    cfg = _cfg(True)
    st = _solve(src, cfg).screen
    e0 = tscr.lowest_edges(st["lam_lo"], cfg)
    retired = np.flatnonzero(~st["active"])
    assert retired.size
    for i in retired:
        p, b = src.fn(int(i))
        with np.errstate(divide="ignore", invalid="ignore"):
            true64 = np.where(b > 0, p.astype(np.float64) / b, -np.inf).max(0)
        assert np.all(st["bmax"][i] <= e0)
        up = np.nextafter(st["bmax"][i], np.float32(np.inf)).astype(np.float64)
        assert np.all(up >= true64)


def test_uniform_source_never_retires():
    src = tsynth.sparse_host_chunk_source(3, N, K, CHUNK, q=Q, tightness=0.4)
    base = _solve(src, _cfg(False))
    scr = _solve(src, _cfg(True))
    _assert_bitwise(base, scr)
    assert scr.screen["active"].all()
    assert np.all(scr.screen["streamed_chunks"] == C)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_screen_init_warm_start(double_buffer):
    """Seeding from a finished solve's stats starts with its retired set;
    a chunk flagged as changed starts active with an unknown bound; the
    result stays bitwise the unscreened solve's."""
    src = _banded(11)
    base = _solve(src, _cfg(False))
    first = _solve(src, _cfg(True))
    changed = np.zeros(C, bool)
    changed[1] = True
    seed = dict(first.screen, changed=changed)
    stats = FeedStats()
    warm = _solve(src, _cfg(True), screen_init=seed,
                  double_buffer=double_buffer, stats=stats)
    _assert_bitwise(base, warm)
    want = int((first.screen["active"] | changed).sum())
    assert warm.screen["seeded_active"] == want < C
    assert warm.screen["streamed_chunks"][0] in (want, want + C)
    assert stats.epochs[0]["chunks"] == want
    assert np.isfinite(warm.screen["bmax"][1]).all()


def test_seeded_floor_never_lowers():
    cfg = _cfg(True)
    seed = {"active": np.array([False, True]), "bmax": np.zeros((2, 3), np.float32),
            "lam_lo": np.full((3,), 2.0, np.float32)}
    hs = tscr.HostScreen(2, 3, cfg, np.ones(3, np.float32), seed=seed)
    assert np.all(hs.lam_lo >= 2.0)
    assert not hs.begin_iter(np.ones(3, np.float32))
    assert hs.active.all() and hs.resets == 1


def test_screening_needs_sync_scd():
    src = _banded(11)
    for kw in ({"algo": "dd"}, {"cd_mode": "cyclic"}):
        with pytest.raises(ValueError, match="screening"):
            _solve(src, _cfg(True).replace(**kw))


def test_launcher_screening(capsys):
    tlaunch.main(["--n", "4096", "--max-iters", "3", "--host-feed",
                  "--chunk-size", "1024", "--screening", "--device", "cpu"])
    out = dict(line.split(": ", 1)
               for line in capsys.readouterr().out.strip().splitlines())
    counts = ast.literal_eval(out["screen_chunks_per_iter"])
    assert counts == [4] * int(out["iterations"])
    assert out["screen_resets"] == "0"
    with pytest.raises(SystemExit, match="--host-feed"):
        tlaunch.main(["--n", "4096", "--screening", "--device", "cpu"])


def test_ops_screen_bound_routes_cpu_to_plain():
    p, b = _rows(300, 9)
    got = ops.screen_bound(torch.tensor(p), torch.tensor(b))
    assert torch.equal(got, ref.screen_bound_plain(torch.tensor(p), torch.tensor(b)))


@pytest.mark.parametrize("fn", ["ops", "chunk_bound"])
def test_screen_bound_out_writes_the_view(fn):
    """``out=`` on the CPU: the plain result lands in the given (K,) view,
    which is returned; the buffer's other rows keep their bits."""
    p, b = _rows(4099, 13)
    pt, bt = torch.tensor(p), torch.tensor(b)
    buf = torch.full((5, K), float("inf"))
    buf[4] = -2.0
    call = ops.screen_bound if fn == "ops" else tscr.chunk_bound
    got = call(pt, bt, out=buf[2])
    assert got.data_ptr() == buf[2].data_ptr()
    assert torch.equal(buf[2], ref.screen_bound_plain(pt, bt))
    assert buf[2, 3] == float("-inf")
    assert torch.all(buf[[0, 1, 3]] == float("inf")) and torch.all(buf[4] == -2.0)


def test_screened_certificates_land_in_their_rows():
    """The screened solve writes each chunk's certificate into its own row:
    every chunk is noted in the first epoch, so ``bmax`` is the plain
    certificate of each chunk's bytes (the ragged last chunk's tail rows,
    p = b = 0, add only -inf). The solve also equals the unscreened one."""
    src = _banded(11, n=N - 17)
    scr = _solve(src, _cfg(True))
    for i in range(C):
        p, b = (torch.tensor(a) for a in src.fn(i))
        np.testing.assert_array_equal(scr.screen["bmax"][i],
                                      ref.screen_bound_plain(p, b).numpy())
    _assert_bitwise(_solve(src, _cfg(False)), scr)
