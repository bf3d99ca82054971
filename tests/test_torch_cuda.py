"""The port's CUDA kernels on the card (tests marked ``cuda``).

No JAX here: this file runs on a machine with the card and PyTorch only,
``python -m pytest tests/test_torch_cuda.py -m cuda``. Kernel against plain
version on the same CUDA tensors: bitwise on dyadic inputs; on random
inputs allclose (rtol 1e-5, atol 1e-5) with ``top`` exact; the histogram
kernels ``scd_fused_hist`` and ``bucket_hist`` and the finalize, whose plain
versions add in the kernels' order, and the elementwise ``scd_candidates``,
``screen_bound`` and ``adjusted_topc`` bitwise on any input (the finalize,
``scd_candidates`` and ``adjusted_topc`` at every K branch, q and tile;
``screen_bound`` also through ``out=``, and unaligned). The screened
host-fed solve on the card: bitwise the unscreened one and the CPU one,
with the same streamed-chunk profile; host-fed DD bitwise the resident
chunked DD. The resident solve on the card:
chunked == unchunked and repeated runs bitwise, and within tolerance of
the same solve on the CPU (lam rtol 1e-5 / atol 1e-6, iterations within
one, primal and dual 1e-5 relative): its sums run in another order there.
The device-streamed solve on the card: bitwise the host-fed solve of the
same bytes and the same streamed solve on the CPU (fused and legacy, SCD
and DD, the sampled history); the removable histogram bitwise its plain
version; the generated source byte-stable per chunk. Serving on the card:
generation records bitwise the CPU's, lookups equal ``decisions_chunk``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cuda import cuda_device  # noqa: E402,F401
from repro_torch.core import prefetch as tpf  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core.bucketing import make_edges  # noqa: E402
from repro_torch.core.instances import dense_instance, sparse_instance  # noqa: E402
from repro_torch.core.postprocess import profit_edges_fixed  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.core.sparse_scd import select_sparse  # noqa: E402
from repro_torch.data.synth import banded_host_chunk_source, sparse_host_chunk_source  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    adjusted_topc,
    bucket_hist,
    ops,
    ref,
    scd_candidates,
    scd_fused,
    screen_bound,
)
from repro_torch.kernels import _wrap  # noqa: E402


def _inst(n, k, seed, dyadic, device):
    g = np.random.default_rng(seed)
    if dyadic:
        p, b = g.integers(0, 64, (n, k)) / 64.0, g.integers(1, 64, (n, k)) / 64.0
        lam = g.integers(0, 12, (k,)) / 8.0
    else:
        p, b, lam = g.random((n, k)), g.uniform(0.05, 1.0, (n, k)), g.uniform(0, 1.5, k)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (p, b, lam))


def test_kernel_wrappers_refuse_cpu_tensors():
    p = torch.zeros((8, 4))
    lam = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scd_fused.scd_fused_hist(p, p, lam, torch.zeros((4, 3)), 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scd_fused.scd_finalize_hist(p, p, lam, torch.zeros(5), 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scd_candidates.scd_candidates(p, p, lam, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bucket_hist.bucket_hist(p, p, torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        screen_bound.screen_bound(p, p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adjusted_topc.adjusted_topc(p, p, lam, 1)


@pytest.mark.cuda
def test_ops_never_sends_cuda_tensors_to_plain(cuda_device, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "scd_fused_hist_plain", boom)
    monkeypatch.setattr(ref, "scd_finalize_plain", boom)
    monkeypatch.setattr(ref, "candidates_block", boom)
    monkeypatch.setattr(ref, "bucket_hist_plain", boom)
    monkeypatch.setattr(ref, "screen_bound_plain", boom)
    monkeypatch.setattr(ref, "adjusted_topc_plain", boom)
    p, b, lam = _inst(1024, 10, 1, False, cuda_device)
    edges = make_edges(lam, 1e-4, 1.6, 24)
    h, top = ops.scd_fused_hist(p, b, lam, edges, 1)
    out = ops.scd_finalize_hist(p, b, lam, profit_edges_fixed(device=cuda_device), 1)
    v1, v2 = ops.scd_candidates(p, b, lam, 1)
    h2 = ops.bucket_hist(v1, v2, edges)
    bound = ops.screen_bound(p, b)
    x, v = ops.adjusted_topc(p, b, lam, 1)
    torch.cuda.synchronize()
    assert h.is_cuda and top.is_cuda and out[0].is_cuda and v1.is_cuda and h2.is_cuda
    assert bound.is_cuda and x.is_cuda and v.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("dyadic", [False, True])
def test_kernels_match_plain_on_card(cuda_device, q, dyadic):
    p, b, lam = _inst(4099, 10, q, dyadic, cuda_device)
    edges = make_edges(lam, 1e-4, 1.6, 24)
    pedges = profit_edges_fixed(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(q)
    seeds = {"hist_init": torch.rand((10, 50), generator=g).to(cuda_device),
             "top_init": torch.full((10,), -1.0, device=cuda_device)}
    kh, kt = ops.scd_fused_hist(p, b, lam, edges, q, tile_n=512, **seeds)
    ph, pt = ref.scd_fused_hist_plain(p, b, lam, edges, q, tile_n=512, **seeds)
    kf = ops.scd_finalize_hist(p, b, lam, pedges, q, tile_n=512)
    pf = ref.scd_finalize_plain(p, b, lam, pedges, q, tile_n=512)
    torch.cuda.synchronize()
    assert torch.equal(kt, pt)
    assert float(kf[5]) == float(pf[5]) and float(kf[6]) == float(pf[6])
    pairs = [(kh, ph)] + list(zip(kf[:5], pf[:5]))
    for a, c in pairs:
        if dyadic:
            assert torch.equal(a, c)
        else:
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernels_run_to_run_bitwise(cuda_device):
    p, b, lam = _inst(65536 - 37, 10, 5, False, cuda_device)
    edges = make_edges(lam, 1e-4, 1.6, 24)
    pedges = profit_edges_fixed(device=cuda_device)
    a = ops.scd_fused_hist(p, b, lam, edges, 1)
    c = ops.scd_fused_hist(p, b, lam, edges, 1)
    fa = ops.scd_finalize_hist(p, b, lam, pedges, 1)
    fc = ops.scd_finalize_hist(p, b, lam, pedges, 1)
    for x, y in list(zip(a, c)) + list(zip(fa, fc)):
        assert torch.equal(x, y)


def _hist_inputs(n, seed, device):
    """Random rows, lam, edges and seeds for the histogram kernels."""
    p, b, lam = _inst(n, 10, seed, False, device)
    b[::7, 3] = 0.0
    edges = make_edges(lam, 1e-4, 1.6, 24)
    g = torch.Generator(device="cpu").manual_seed(seed)
    seeds = {"hist_init": torch.rand((10, 50), generator=g).to(device),
             "top_init": torch.full((10,), -1.0, device=device)}
    return p, b, lam, edges, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile", [(65536, None), (65536 - 37, None),
                                    (2_000_003, None), (10_000, 1000), (4099, 50),
                                    (1021, 4)],
                         ids=["chunk", "chunk-ragged", "resident-ragged", "tile1000",
                              "tile50", "tile4"])
def test_hist_kernels_bitwise_on_card(cuda_device, n, tile):
    """The new in-tile order: kernel == plain bitwise on random inputs at the
    default map tile (chunk and resident shapes) and at pinned ragged tiles."""
    p, b, lam, edges, seeds = _hist_inputs(n, n % 101, cuda_device)
    kw = {} if tile is None else {"tile_n": tile}
    for seeded in (False, True):
        s = seeds if seeded else {}
        kh, kt = ops.scd_fused_hist(p, b, lam, edges, 1, **kw, **s)
        ph, pt = ref.scd_fused_hist_plain(p, b, lam, edges, 1, **kw, **s)
        v1, v2 = ops.scd_candidates(p, b, lam, 2)
        init = seeds["hist_init"] if seeded else None
        kb = ops.bucket_hist(v1, v2, edges, **kw, hist_init=init)
        pb = ref.bucket_hist_plain(v1, v2, edges, **kw, hist_init=init)
        torch.cuda.synchronize()
        assert torch.equal(kh, ph) and torch.equal(kt, pt)
        assert torch.equal(kb, pb)


@pytest.mark.cuda
def test_hist_kernels_ties_on_edges_on_card(cuda_device):
    """Values on an edge go to the lower bucket (searchsorted-left) in the
    kernels' binary search, as in the plain versions' count of edges."""
    k = 4
    edges = torch.tensor([[0.5, 1.0, 1.5]] * k, device=cuda_device)
    vals = torch.tensor([0.5, 1.0, 1.5, 0.25, 1.75, 1.0], device=cuda_device)
    p = vals[:, None].repeat(1, k).contiguous()
    b = torch.ones_like(p)
    lam = torch.zeros(k, device=cuda_device)
    h, top = ops.scd_fused_hist(p, b, lam, edges, k, tile_n=4)
    hb = ops.bucket_hist(p, b, edges, tile_n=4)
    torch.cuda.synchronize()
    want = torch.tensor([2.0, 2.0, 1.0, 1.0], device=cuda_device)
    assert torch.equal(h[0], want) and torch.equal(hb[0], want)
    assert torch.equal(h, ref.scd_fused_hist_plain(p, b, lam, edges, k, tile_n=4)[0])
    assert torch.equal(top, torch.full((k,), 1.75, device=cuda_device))


@pytest.mark.cuda
def test_hist_kernels_one_launch_and_rerun_bitwise(cuda_device):
    p, b, lam, edges, seeds = _hist_inputs(300_000, 3, cuda_device)
    v1, v2 = ops.scd_candidates(p, b, lam, 1)
    ops.reset_launches()
    runs = [(ops.scd_fused_hist(p, b, lam, edges, 1, **seeds),
             ops.bucket_hist(v1, v2, edges, hist_init=seeds["hist_init"]))
            for _ in range(3)]
    assert ops.LAUNCHES["scd_fused_hist"] == 3 and ops.LAUNCHES["bucket_hist"] == 3
    for (h, t), hb in runs[1:]:
        assert torch.equal(h, runs[0][0][0]) and torch.equal(t, runs[0][0][1])
        assert torch.equal(hb, runs[0][1])


@pytest.mark.cuda
def test_hist_kernels_chunked_default_tile_bitwise(cuda_device):
    """Chunks of 65,536 rows (a multiple of MAP_TILE), seeded by the carry,
    equal one call over all rows, the ragged last chunk included."""
    n, c = 5 * 65536 + 4321, 65536
    p, b, lam, edges, _ = _hist_inputs(n, 9, cuda_device)
    h1, t1 = ops.scd_fused_hist(p, b, lam, edges, 1)
    h, t = None, None
    for s in range(0, n, c):
        h, t = ops.scd_fused_hist(p[s:s + c], b[s:s + c], lam, edges, 1,
                                  hist_init=h, top_init=t)
    assert torch.equal(h, h1) and torch.equal(t, t1)


@pytest.mark.cuda
def test_cuda_solve_matches_cpu(cuda_device):
    src = sparse_host_chunk_source(0, 20_000, 10, 4096)
    cfg = SolverConfig(max_iters=40, kernel_tile=512)
    gpu = tpf.solve_streaming_host(src, cfg, q=1, device=cuda_device)
    cpu = tpf.solve_streaming_host(src, cfg, q=1, device="cpu")
    np.testing.assert_allclose(gpu.lam.cpu().numpy(), cpu.lam.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert abs(gpu.iters - cpu.iters) <= 1
    np.testing.assert_allclose(float(gpu.primal), float(cpu.primal), rtol=1e-5)
    np.testing.assert_allclose(float(gpu.dual), float(cpu.dual), rtol=1e-5)
    assert float(gpu.tau) == float(cpu.tau)


# K at each compile-time branch of scd_candidates (KC = 8, 16, 64) and its
# edges, with every row width it stages differently: K odd, K = 2 mod 4, and
# K = 8, 16, 64 (swizzled 16-byte pieces).
CAND_K = [1, 8, 9, 10, 16, 17, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("q", ["0", "1", "3", "K"])
@pytest.mark.parametrize("k", CAND_K)
def test_scd_candidates_bitwise_on_card(cuda_device, k, q, dyadic):
    """n from one row to a chunk, ragged tiles included; p and b as given and
    as views one row in (unaligned 4-byte copies where K floats are not a
    multiple of 16 bytes); rows with b = 0, b < 0 and tied p - lam*b."""
    q = k if q == "K" else int(q)
    for n in (1, 255, 4099, 65536):
        p, b, lam = _branch_rows(n + 1, k, n + 3 * k + q, dyadic, cuda_device)
        b[2::11] = -b[2::11]
        for pp, bb in ((p[:n], b[:n]), (p[1:], b[1:])):
            kv1, kv2 = ops.scd_candidates(pp, bb, lam, q)
            pv1, pv2 = ref.candidates_block(pp, bb, lam, q)
            torch.cuda.synchronize()
            assert torch.equal(kv1, pv1) and torch.equal(kv2, pv2), (n, pp.data_ptr() % 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_bucket_hist_matches_plain_on_card(cuda_device, dyadic, seeded):
    p, b, lam = _inst(6007, 10, 2, dyadic, cuda_device)
    v1, v2 = ops.scd_candidates(p, b, lam, 2)
    edges = make_edges(lam, 1e-4, 1.6, 24)
    g = torch.Generator(device="cpu").manual_seed(3)
    init = (torch.randint(0, 256, (10, 50), generator=g) / 64.0).to(cuda_device) \
        if seeded else None
    kh = ops.bucket_hist(v1, v2, edges, tile_n=512, hist_init=init)
    ph = ref.bucket_hist_plain(v1, v2, edges, tile_n=512, hist_init=init)
    torch.cuda.synchronize()
    if dyadic:
        assert torch.equal(kh, ph)
    else:
        torch.testing.assert_close(kh, ph, rtol=1e-5, atol=1e-5)
    # Chunked with the seed == one call (chunk rows a multiple of the tile).
    h = None
    for s in range(0, v1.shape[0], 1024):
        h = ops.bucket_hist(v1[s:s + 1024], v2[s:s + 1024], edges, tile_n=512,
                            hist_init=init if h is None else h)
    assert torch.equal(h, kh)


def _same(a, b):
    return a.iters == b.iters and all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("lam", "x", "r", "primal", "dual"))


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["bucketed", "exact"])
def test_resident_sparse_solve_on_card(cuda_device, reduce):
    kp, q = sparse_instance(0, 40_000, 10, chunk=8192)
    cfg = SolverConfig(max_iters=40, kernel_tile=512, reduce=reduce)
    gpu = tsolver.solve(kp, cfg, q=q, device=cuda_device)
    again = tsolver.solve(kp, cfg, q=q, device=cuda_device)
    assert _same(gpu, again)
    if reduce == "bucketed":
        chunked = tsolver.solve(kp, cfg.replace(chunk_size=8192), q=q,
                                device=cuda_device)
        assert _same(gpu, chunked)
        host = tpf.solve_streaming_host(sparse_host_chunk_source(0, 40_000, 10, 8192),
                                        cfg, q=q, device=cuda_device)
        assert host.iters == gpu.iters and torch.equal(host.lam, gpu.lam)
    cpu = tsolver.solve(kp, cfg, q=q, device="cpu")
    np.testing.assert_allclose(gpu.lam.numpy(), cpu.lam.numpy(), rtol=1e-5, atol=1e-6)
    assert abs(gpu.iters - cpu.iters) <= 1
    np.testing.assert_allclose(float(gpu.primal), float(cpu.primal), rtol=1e-5)
    np.testing.assert_allclose(float(gpu.dual), float(cpu.dual), rtol=1e-5)


@pytest.mark.cuda
def test_resident_dense_solve_on_card(cuda_device):
    kp = dense_instance(0, 3000, 10, 10, local="C223", mixed_b=True)
    cfg = SolverConfig(max_iters=40, kernel_tile=512)
    gpu = tsolver.solve(kp, cfg, q=0, device=cuda_device)
    chunked = tsolver.solve(kp, cfg.replace(chunk_size=1024), q=0, device=cuda_device)
    assert _same(gpu, chunked)
    assert bool(torch.all(gpu.r <= kp.budgets)) and float(gpu.dual) >= float(gpu.primal)
    cpu = tsolver.solve(kp, cfg, q=0, device="cpu")
    np.testing.assert_allclose(gpu.lam.numpy(), cpu.lam.numpy(), rtol=1e-5, atol=1e-6)
    assert abs(gpu.iters - cpu.iters) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 10, 64])
@pytest.mark.parametrize("n", [1, 37, 4099, 65499, 65536])
def test_screen_bound_bitwise_on_card(cuda_device, n, k):
    """Aligned and one row in (unaligned where K floats are not a multiple
    of 16 bytes); returned and written through ``out=`` into the middle row
    of a (3, K) buffer whose other rows stay untouched; rows with b = 0 and
    b < 0, and a column with no b > 0 (-inf)."""
    p, b, _ = _inst(n + 1, k, n + k, False, cuda_device)
    b[::5] = 0.0
    b[1::9] = -b[1::9]
    if k > 1:
        b[:, k // 2] = 0.0
    buf = torch.full((3, k), 7.0, device=cuda_device)
    for pp, bb in ((p[:n], b[:n]), (p[1:], b[1:])):
        want = ref.screen_bound_plain(pp, bb)
        got = ops.screen_bound(pp, bb)
        out = ops.screen_bound(pp, bb, out=buf[1])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(buf[1], want)
        assert out.data_ptr() == buf[1].data_ptr()
        assert torch.all(buf[0] == 7.0) and torch.all(buf[2] == 7.0)
        if k > 1:
            assert got[k // 2] == float("-inf")


@pytest.mark.cuda
def test_screen_bound_no_valid_rows_and_repeats_on_card(cuda_device):
    """A chunk with no b > 0 gives -inf in every column; twenty calls in a
    row on one stream, alternating two grid sizes, each equal to the plain
    version, leave every ticket at zero."""
    p, b, _ = _inst(65536, 6, 5, False, cuda_device)
    none = ops.screen_bound(p, torch.zeros_like(b))
    assert torch.equal(none, torch.full((6,), float("-inf"), device=cuda_device))
    outs = torch.empty((20, 6), device=cuda_device)
    for i in range(20):
        rows = 65536 if i % 2 == 0 else 37
        ops.screen_bound(p[:rows], b[:rows], out=outs[i])
    torch.cuda.synchronize()
    assert torch.equal(outs[0::2], ref.screen_bound_plain(p, b).expand(10, 6))
    assert torch.equal(outs[1::2], ref.screen_bound_plain(p[:37], b[:37]).expand(10, 6))
    assert int(torch.count_nonzero(_wrap.tickets(p, 1))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 10])
@pytest.mark.parametrize("n", [4099, 65536])
def test_adjusted_topc_bitwise_on_card(cuda_device, n, q):
    p, b, lam = _inst(n, 10, n + q, False, cuda_device)
    b[::7, 3] = 0.0
    x, v = ops.adjusted_topc(p, b, lam, q)
    px, pv = ref.adjusted_topc_plain(p, b, lam, q)
    torch.cuda.synchronize()
    assert torch.equal(x, px) and torch.equal(v, pv)
    assert torch.equal(x, select_sparse(p, b, lam, q))


# K at each compile-time branch of the two redesigned kernels (KC = 8, 16,
# 64) and its edges; q from none to all K.
BRANCH_K = [1, 8, 9, 16, 17, 64]
QS = ["0", "1", "3", "K"]


def _branch_rows(n, k, seed, dyadic, device):
    """Rows with b = 0 (no valid item), and rows whose adjusted profits all
    tie (b = 0, equal p): the selection takes the lowest indices."""
    g = np.random.default_rng(seed)
    if dyadic:
        p, b = g.integers(0, 64, (n, k)) / 64.0, g.integers(0, 64, (n, k)) / 64.0
        lam = g.integers(0, 12, (k,)) / 8.0
    else:
        p, b, lam = g.random((n, k)), g.uniform(0.0, 1.0, (n, k)), g.uniform(0, 1.5, k)
    b[::7] = 0.0
    p[1::5] = p[1::5, :1]
    b[1::5] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (p, b, lam))


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("k", BRANCH_K)
def test_adjusted_topc_branches_bitwise_on_card(cuda_device, k, q, dyadic):
    """Every K branch, ragged n (256 m - 37, and n below one 256-row tile)."""
    q = k if q == "K" else int(q)
    for n in (256 * 16 - 37, 100):
        p, b, lam = _branch_rows(n, k, n + k + q, dyadic, cuda_device)
        x, v = ops.adjusted_topc(p, b, lam, q)
        px, pv = ref.adjusted_topc_plain(p, b, lam, q)
        torch.cuda.synchronize()
        assert x.dtype == torch.bool and v.dtype == torch.float32
        assert torch.equal(x, px) and torch.equal(v, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("tile", [128, 512, 1024])
@pytest.mark.parametrize("k", BRANCH_K)
def test_finalize_branches_bitwise_on_card(cuda_device, k, tile, q):
    """The finalize equals its plain version bit for bit at every K branch,
    tile, q, with and without the histograms, seeded and not, on random
    rows at a ragged n (3 tiles - 37) and dyadic rows at n below one tile."""
    q = k if q == "K" else int(q)
    pedges = profit_edges_fixed(device=cuda_device)
    if k * tile > 32768:            # its consumption tile alone exceeds shared memory
        p, b, lam = _branch_rows(tile, k, 0, False, cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            ops.scd_finalize_hist(p, b, lam, pedges, q, tile_n=tile)
        return
    g = np.random.default_rng(k * tile + q)
    for n, dyadic in ((3 * tile - 37, False), (tile // 2 + 3, True)):
        p, b, lam = _branch_rows(n, k, n + q, dyadic, cuda_device)
        for with_hist in (True, False):
            for seeded in (False, True):
                seeds = {}
                if seeded:
                    t = lambda *s: torch.tensor(g.random(s) * 4, dtype=torch.float32,  # noqa: E731
                                                device=cuda_device)
                    seeds = {"r_init": t(k), "sums_init": t(2) * 64,
                             "maxs_init": torch.tensor([0.5, -0.25], device=cuda_device)}
                    if with_hist:
                        seeds.update(cons_hist_init=t(k, 513), gain_hist_init=t(513))
                got = ops.scd_finalize_hist(p, b, lam, pedges, q, tile_n=tile,
                                            with_hist=with_hist, **seeds)
                want = ref.scd_finalize_plain(p, b, lam, pedges, q, tile_n=tile,
                                              with_hist=with_hist, **seeds)
                torch.cuda.synchronize()
                for a, c in zip(got, want):
                    assert (a is None and c is None) or torch.equal(a, c), \
                        (n, with_hist, seeded)


@pytest.mark.cuda
def test_finalize_passes_seeds_unpacked(cuda_device, monkeypatch):
    """The card's wrapper hands the seeds to the fold as they are."""
    def boom(*a, **kw):
        raise AssertionError("the card's finalize packed its seeds")

    monkeypatch.setattr(ref, "pack_finalize_init", boom)
    p, b, lam = _inst(4099, 10, 4, False, cuda_device)
    out = ops.scd_finalize_hist(p, b, lam, profit_edges_fixed(device=cuda_device), 1,
                                r_init=torch.ones(10, device=cuda_device))
    torch.cuda.synchronize()
    assert out[2].is_cuda


@pytest.mark.cuda
def test_screened_host_fed_on_card(cuda_device):
    src = banded_host_chunk_source(7, 65536, 6, 4096, q=2, tightness=0.08, band=0.05)
    cfg = SolverConfig(max_iters=30, bucket_half=12, kernel_tile=512)
    base = tpf.solve_streaming_host(src, cfg, q=2, device=cuda_device)
    ops.reset_launches()
    scr = tpf.solve_streaming_host(src, cfg.replace(screening=True), q=2,
                                   device=cuda_device)
    assert ops.LAUNCHES["screen_bound"] == 16
    assert ops.LAUNCHES["scd_fused_hist"] == int(scr.screen["streamed_chunks"].sum())
    assert scr.iters == base.iters and all(
        torch.equal(getattr(scr, f), getattr(base, f))
        for f in ("lam", "r", "primal", "dual", "tau"))
    assert scr.screen["streamed_chunks"].min() < 16
    cpu = tpf.solve_streaming_host(src, cfg.replace(screening=True), q=2, device="cpu")
    assert cpu.iters == scr.iters and torch.equal(cpu.lam, scr.lam)
    for key in ("streamed_chunks", "bmax", "active"):
        np.testing.assert_array_equal(cpu.screen[key], scr.screen[key])


@pytest.mark.cuda
def test_host_fed_dd_on_card(cuda_device):
    n, chunk = 40_000, 8192
    cfg = SolverConfig(algo="dd", max_iters=12)
    kp, q = sparse_instance(0, n, 10, chunk=chunk)
    resident = tsolver.solve(kp, cfg.replace(chunk_size=chunk), q=q, device=cuda_device)
    host = tpf.solve_streaming_host(sparse_host_chunk_source(0, n, 10, chunk), cfg, q=q,
                                    device=cuda_device)
    assert host.iters == resident.iters and torch.equal(host.lam, resident.lam)


def _same_result(a, b):
    return a.iters == b.iters and all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("lam", "r", "primal", "dual", "tau")) and all(
        torch.equal(x, y) for x, y in zip(a.fin_hist, b.fin_hist))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scd", "dd", "screened", "presolve"])
def test_slots_on_card_equal_cpu(cuda_device, case):
    """slots=4 over 10 chunks (3 columns, 2 inert chunk slots): the card's
    solve equals the CPU's in every field."""
    src = sparse_host_chunk_source(0, 40_000, 10, 4096)
    q, cfg = 1, SolverConfig(max_iters=40)
    if case == "dd":
        cfg = SolverConfig(algo="dd", max_iters=12)
    elif case == "presolve":
        cfg = cfg.replace(presolve_samples=8192)
    elif case == "screened":
        src = banded_host_chunk_source(7, 65536, 6, 4096, q=2, tightness=0.08, band=0.05)
        q, cfg = 2, SolverConfig(max_iters=30, bucket_half=12, screening=True)
    gpu = tpf.solve_streaming_host(src, cfg, q=q, slots=4, device=cuda_device)
    cpu = tpf.solve_streaming_host(src, cfg, q=q, slots=4, device="cpu")
    assert _same_result(gpu, cpu)
    if case == "screened":
        np.testing.assert_array_equal(gpu.screen["streamed_chunks"],
                                      cpu.screen["streamed_chunks"])
        assert gpu.screen["streamed_chunks"].min() < 16


class _Kill(Exception):
    pass


def _killing(src, after):
    calls = {"n": 0}
    inner = src.fn

    def fn(i):
        calls["n"] += 1
        if calls["n"] > after:
            raise _Kill()
        return inner(i)

    return src._replace(fn=fn)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["mid_iterate", "between_finalize_columns"])
def test_kill_and_resume_on_card(cuda_device, tmp_path, where):
    """A slots=4 solve on the card (10 chunks: 3 columns, 2 inert chunk
    slots), checkpointed every 2 iterations and columns, killed in process
    and resumed, equals the uninterrupted one."""
    src = sparse_host_chunk_source(0, 40_000, 10, 4096)
    cfg = SolverConfig(max_iters=40, checkpoint_every=2)
    base = tpf.solve_streaming_host(src, cfg, q=1, slots=4, device=cuda_device)
    # the fingerprint probe, 10 reads an epoch, then the finalize's columns
    # 0 (4 reads) and 1 (3 reads) and the first read of column 2, after
    # which the state at cursor 2 is saved
    kill_after = (1 + base.iters // 2 * 10 + 5 if where == "mid_iterate"
                  else 1 + base.iters * 10 + 8)
    with pytest.raises(_Kill):
        tpf.solve_streaming_host(_killing(src, kill_after), cfg, q=1, slots=4,
                                 device=cuda_device, checkpoint_dir=str(tmp_path))
    res = tpf.solve_streaming_host(src, cfg, q=1, device=cuda_device,
                                   resume_from=str(tmp_path))
    assert _same_result(res, base)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 4])
def test_chaos_on_card(cuda_device, slots):
    from repro_torch.core.faults import FaultPlan, faulty_source
    src = sparse_host_chunk_source(3, 40_000, 10, 4096)
    cfg = SolverConfig(max_iters=40)
    clean = tpf.solve_streaming_host(src, cfg, q=1, slots=slots, device=cuda_device)
    chaos = tpf.solve_streaming_host(
        faulty_source(src, FaultPlan(seed=0, drop=0.08, slow=0.05, slow_s=0.002,
                                     corrupt=0.04, offenders=(1,), offender_failures=2)),
        cfg.replace(fetch_retries=8, fetch_backoff=1e-4, fetch_backoff_cap=1e-3,
                    verify_refetch=True), q=1, slots=slots, device=cuda_device)
    assert _same_result(chaos, clean)


# --------------------------------------------------------------------------
# The device-streamed solve, the legacy finalize and the serving layer.
# --------------------------------------------------------------------------

def _rows_kp(n, k, seed, device):
    from repro_torch.core.types import SparseKP
    src = sparse_host_chunk_source(seed, n, k, 4096)
    p = np.concatenate([src.fn(i)[0] for i in range(-(-n // 4096))])[:n]
    b = np.concatenate([src.fn(i)[1] for i in range(-(-n // 4096))])[:n]
    return SparseKP(torch.tensor(p), torch.tensor(b), torch.tensor(src.budgets)), src


@pytest.mark.cuda
@pytest.mark.parametrize("finalize", ["fused", "legacy"])
@pytest.mark.parametrize("algo", ["scd", "dd"])
def test_streamed_on_card_equals_host_fed_and_cpu(cuda_device, finalize, algo):
    """``solve_streaming`` over ``array_source`` on the card == the host-fed
    solve of the same bytes on the card == the streamed solve on the CPU,
    bitwise (the sampled history too)."""
    from repro_torch.core.chunked import array_source, solve_streaming
    kp, _ = _rows_kp(40_000, 10, 2, "cpu")
    cfg = SolverConfig(max_iters=30, algo=algo, stream_finalize=finalize,
                       record_history=True, metrics_every=4)
    dev = solve_streaming(array_source(kp, 8192, device=cuda_device), cfg, q=1,
                          device=cuda_device)
    host = tpf.solve_streaming_host(
        tpf.host_array_source(kp.p.numpy(), kp.b.numpy(), kp.budgets.numpy(), 8192),
        cfg, q=1, device=cuda_device)
    cpu = solve_streaming(array_source(kp, 8192, device="cpu"), cfg, q=1, device="cpu")
    for other in (host, cpu):
        assert dev.iters == other.iters
        for f in ("lam", "r", "primal", "dual", "tau"):
            assert torch.equal(getattr(dev, f), getattr(other, f)), f
        for key in dev.history:
            np.testing.assert_array_equal(dev.history[key].numpy(),
                                          other.history[key].numpy())


@pytest.mark.cuda
def test_removable_hist_on_card_equals_plain(cuda_device):
    from repro_torch.core.postprocess import profit_edges, removable_hist
    g = np.random.default_rng(4)
    for k in (1, 8, 10, 16, 53):
        pt = torch.tensor(g.random(20_001).astype(np.float32) * 3)
        cons = torch.tensor(g.random((20_001, k)).astype(np.float32))
        edges = profit_edges(0.1, 2.9, 512)
        seed = torch.tensor(g.random((k, 513)).astype(np.float32))
        want = removable_hist(pt, cons, edges, init=seed)
        got = removable_hist(pt.to(cuda_device), cons.to(cuda_device),
                             edges.to(cuda_device), init=seed.to(cuda_device))
        assert torch.equal(got.cpu(), want), k


@pytest.mark.cuda
def test_generated_source_on_card(cuda_device):
    """Chunk i is the same bytes on every call, in any order; the streamed
    solve over it is feasible and repeats bitwise; screened == unscreened."""
    from repro_torch.core.chunked import solve_streaming
    from repro_torch.data.synth import sparse_chunk_source
    src = sparse_chunk_source(1, 300_000, 10, 65_536, device=cuda_device)
    a3, a0, b3 = src.fn(3), src.fn(0), src.fn(3)
    assert torch.equal(a3[0], b3[0]) and torch.equal(a3[1], b3[1])
    assert not torch.equal(a0[0], a3[0])
    assert torch.all(b3[0][300_000 - 3 * 65_536:] == 0)
    cfg = SolverConfig(max_iters=40)
    one = solve_streaming(src, cfg, q=1, device=cuda_device)
    two = solve_streaming(src, cfg.replace(screening=True), q=1, device=cuda_device)
    assert one.iters == two.iters
    for f in ("lam", "r", "primal", "dual", "tau"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    assert float(torch.max(one.r - src.budgets)) <= 1e-4 * float(src.budgets[0])


@pytest.mark.cuda
def test_serving_on_card_equals_cpu(cuda_device, tmp_path):
    """Generation records on the card == on the CPU, bitwise; lookups on
    the card equal ``decisions_chunk`` over the owning chunk."""
    from repro_torch.core.chunked import array_source, decisions_chunk
    from repro_torch.serve import RefreshEngine, WorkloadSpec, synthetic_source
    spec = WorkloadSpec(seed=3, n=40_000, k=8, chunk=4096, q=2, tightness=0.4)
    cfg = SolverConfig(max_iters=60, checkpoint_every=4)
    gens = {}
    for dev in (cuda_device, "cpu"):
        eng = RefreshEngine(tmp_path / str(dev), spec, cfg=cfg, device=dev, slots=2)
        gens[str(dev)] = [eng.refresh(budget_scale=s) for s in (1.0, 0.9)]
    for a, b in zip(*gens.values()):
        for f in ("lam", "tau", "iters", "r", "primal", "dual", "fingerprint"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), err_msg=f)
        for x, y in zip(a.fin_hist, b.fin_hist):
            np.testing.assert_array_equal(x, y)
    gen = gens[str(cuda_device)][1]
    svc = eng.decision_service(gen)
    card = RefreshEngine(tmp_path / str(cuda_device), spec, cfg=cfg,
                         device=cuda_device).decision_service(gen)
    users = np.random.default_rng(0).integers(0, spec.n, 500)
    src = synthetic_source(gen.spec)
    from repro_torch.core.types import SparseKP
    c = -(-spec.n // spec.chunk)
    kp = SparseKP(*(torch.tensor(np.concatenate([src.fn(i)[j] for i in range(c)])[:spec.n])
                    for j in (0, 1)), torch.tensor(src.budgets))
    asrc = array_source(kp, spec.chunk, device=cuda_device)
    want = np.concatenate([decisions_chunk(asrc, gen.lam, 2, i, tau=gen.tau)[0].cpu().numpy()
                           for i in range(c)])[:spec.n]
    np.testing.assert_array_equal(card.decide_batch(users), want[users])
    np.testing.assert_array_equal(svc.decide_batch(users), want[users])
