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
Operations on the card: a supervised solve SIGKILLed once publishes the
in-process record bitwise; a ``ReplicaServer`` answers like the in-process
``DecisionService``; ``env.worker_env(1)`` gives a child one card. A world
of two ranks on the one card (``launch.mesh``): bitwise the in-process
``slots=2`` host-fed solve; its device-streamed legacy finalize bitwise the
fused one in lam, iterations and dual (every field without the
projection); ``RefreshEngine(mesh=)`` over it bitwise the in-process
``slots=4`` engine on the card, cold, warm and screened delta. The LM
serving path: the knapsack-priced router through the two kernels bitwise
its plain version on the CPU (at moonshot's K = 64, jamba's K = 16 and
deepseek's K = 160); the two router kernels' wide instances (K = 65, 96,
160, 256) bitwise their plain versions, the four other kernels refusing
K = 65; smoke moonshot, gemma, mamba2, jamba, seamless and deepseek (also
with its router kept at 160 experts, top-6), prefill and decode, against
the CPU in float32 with TF32 off; the Mamba decode cache written
in place on the card. The LM training path: one smoke train step of the
same seven configs on the card against the CPU in float32 with TF32 off (the loss rtol 1e-5, each gradient within a
relative L2 error of 1e-4, ``grad_norm`` rtol 1e-5, the update from the
same gradients rtol 1e-6 of the leaf's largest element); a resumed run
and two runs from one seed bitwise on the card. The MoE forward over a
world of two ranks on the card (``models/sharding.py``, the a2a path,
``scd_route_shmap``, the steps under the batch binding) against a world of
two on the CPU, and training over it (the train step under the batch
binding, ``train(mesh=)`` saved and resumed bitwise on the card). Tensor
and sequence parallelism over a world of two on the card against one on
the CPU: moonshot's and gemma's steps, and deepseek's, mamba2's, jamba's
and seamless's (MLA, Mamba2, the hybrid, the encoder-decoder: prefill,
decode and train steps, also over a world of one in process).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_cuda import cuda_device, one_intra_op_thread  # noqa: E402,F401
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


# K above KMAX: the wide instances (KWIDE = 256) of the MoE router's two
# kernels, at deepseek-v2-236b's 160 experts and around it.
WIDE_K = [65, 96, 160, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("q", [1, 6])
@pytest.mark.parametrize("k", WIDE_K)
def test_router_kernels_wide_k_bitwise_on_card(cuda_device, k, q, dyadic):
    """``scd_fused_hist`` at the router's tile for K (``router_tile``: 128,
    64 or 32 rows) and ``adjusted_topc`` (128 or 64 rows a block), on rows
    with b = 0 and all-tied rows and on the router's b = 1, ragged n
    (4,096 - 37, and n below one tile): bitwise their plain versions."""
    from repro_torch.core.moe_router import router_tile
    for n in (4096 - 37, 50):
        p, b, lam = _branch_rows(n, k, n + k + q, dyadic, cuda_device)
        edges = make_edges(lam, 1e-4, 1.8, 16)
        tile = router_tile(k, edges.shape[-1])
        for bb in (b, torch.ones_like(b)):
            ops.reset_launches()
            h, top = ops.scd_fused_hist(p, bb, lam, edges, q, tile_n=tile)
            x, v = ops.adjusted_topc(p, bb, lam, q)
            ph, pt = ref.scd_fused_hist_plain(p, bb, lam, edges, q, tile_n=tile)
            px, pv = ref.adjusted_topc_plain(p, bb, lam, q)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["scd_fused_hist"] == ops.LAUNCHES["adjusted_topc"] == 1
            assert torch.equal(h, ph) and torch.equal(top, pt)
            assert torch.equal(x, px) and torch.equal(v, pv)
        assert int(torch.count_nonzero(_wrap.tickets(p, 1))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["scd_finalize_hist", "scd_candidates", "bucket_hist",
                                    "screen_bound"])
def test_narrow_kernels_refuse_wide_k(cuda_device, kernel):
    """The four kernels off the router's path keep K <= KMAX = 64: K = 65
    raises ``ValueError`` naming the ROADMAP item that would widen them,
    before any launch; the router's two refuse K = 257."""
    p, b, lam = _inst(100, 65, 1, False, cuda_device)
    calls = {
        "scd_finalize_hist": lambda: scd_fused.scd_finalize_hist(
            p, b, lam, profit_edges_fixed(device=cuda_device), 1),
        "scd_candidates": lambda: scd_candidates.scd_candidates(p, b, lam, 1),
        "bucket_hist": lambda: bucket_hist.bucket_hist(p, b, make_edges(lam, 1e-4, 1.6, 24)),
        "screen_bound": lambda: screen_bound.screen_bound(p, b)}
    ops.reset_launches()
    with pytest.raises(ValueError, match=r"K <= 64 .*ROADMAP B"):
        calls[kernel]()
    p2, b2, lam2 = _inst(100, 257, 2, False, cuda_device)
    with pytest.raises(ValueError, match=r"K <= 256"):
        scd_fused.scd_fused_hist(p2, b2, lam2, make_edges(lam2, 1e-4, 1.8, 16), 1, tile_n=32)
    with pytest.raises(ValueError, match=r"K <= 256"):
        adjusted_topc.adjusted_topc(p2, b2, lam2, 1)
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_hist_smem_bytes_mirror_equals_library(cuda_device):
    """``_wrap.hist_smem_bytes``, which picks the router's tile without the
    library, equals the library's ``hist_smem_bytes``."""
    from repro_torch.kernels import _build
    lib = _build.load()
    for k in (1, 10, 16, 64, 65, 160, 256):
        for e in (33, 50, 512):
            for tile in (1, 32, 64, 96, 128, 512, 8192):
                for fused in (0, 1):
                    assert lib.hist_smem_bytes(k, e, tile, fused) == \
                        _wrap.hist_smem_bytes(k, e, tile, bool(fused)), (k, e, tile, fused)


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


# --------------------------------------------------------------------------
# Operations: the supervisor, the front's replica and the worker environment.
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_supervised_solve_on_card_survives_a_kill(cuda_device, tmp_path):
    """A supervised solve whose worker (on the card) is SIGKILLed mid-solve
    publishes the in-process card solve's record, bitwise."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.supervisor import (ChaosSchedule, Supervisor,
                                               SupervisorConfig, run_solve_task)
    from repro_torch.serve import WorkloadSpec
    spec = WorkloadSpec(seed=3, n=65_536, k=8, chunk=4096, q=2, tightness=0.4)
    task = {"kind": "solve", "spec": spec.to_json(), "slots": 2, "device": "cuda",
            "cfg": dict(max_iters=60, checkpoint_every=2, bucket_half=16)}
    ref = run_solve_task(tmp_path / "ref", task)
    sup = Supervisor(tmp_path / "sup", task,
                     cfg=SupervisorConfig(ttl=5.0, poll=0.05, grace=300.0,
                                          max_restarts=3),
                     chaos=ChaosSchedule(events=(("kill", 40),)))
    out = sup.run()
    assert out["ok"] and out["kills_injected"] == 1 and out["crash_restarts"] == 1
    got = ckpt.restore_auto(tmp_path / "sup" / "result", 0)
    for f in ("lam", "tau", "iters", "r", "primal", "dual", "fin_ch", "fin_gh"):
        assert np.asarray(ref[f]).tobytes() == np.asarray(got[f]).tobytes(), f


@pytest.mark.cuda
def test_replica_server_on_card_answers_like_the_service(cuda_device, tmp_path):
    from repro_torch.serve import RefreshEngine, ReplicaClient, ReplicaServer, WorkloadSpec
    from repro_torch.serve.front import unpack_array
    spec = WorkloadSpec(seed=5, n=40_000, k=8, chunk=4096, q=2, tightness=0.4)
    eng = RefreshEngine(tmp_path, spec, cfg=SolverConfig(max_iters=60),
                        device=cuda_device)
    eng.refresh(budget_scale=1.0)
    gen = eng.refresh(budget_scale=0.9)
    rep = ReplicaServer(RefreshEngine.attach(tmp_path, device=cuda_device),
                        cache_chunks=16, poll_s=0.02)
    rc = ReplicaClient("127.0.0.1", rep.start())
    try:
        svc = eng.decision_service()
        users = np.random.default_rng(1).integers(0, spec.n, 300)
        for u in users[:20]:
            r = rc.call({"op": "lookup", "user": int(u)})
            want = svc.lookup(int(u))
            assert unpack_array(r["x"]).tobytes() == want.x.tobytes()
            assert r["gen"] == want.gen == gen.gen and not r["stale"]
        b = rc.call({"op": "decide_batch", "users": users.tolist()})
        x, stale, gens = svc.lookup_batch(users)
        assert unpack_array(b["x"]).tobytes() == x.tobytes()
        assert unpack_array(b["stale"]).tobytes() == stale.tobytes()
        assert unpack_array(b["gens"]).tobytes() == gens.tobytes()
    finally:
        rc.close()
        rep.stop()


@pytest.mark.cuda
def test_worker_env_child_sees_exactly_one_card(cuda_device):
    import subprocess
    import sys
    from repro_torch.launch import env
    wenv = env.worker_env(1, device="cuda")
    code = "import torch; print(torch.cuda.device_count(), torch.cuda.get_device_name(0))"
    out = subprocess.run([sys.executable, "-c", code], env=wenv, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, name = out.stdout.strip().split(" ", 1)
    assert count == "1" and name == torch.cuda.get_device_name(0)
    assert len(wenv[env.VISIBLE].split(",")) == 1


@pytest.mark.cuda
def test_world_of_two_on_the_card_equals_in_process_slots(cuda_device):
    """Two gloo ranks sharing the card (``launch.mesh``) feed one slot each:
    bitwise the in-process ``slots=2`` host-fed solve on the card."""
    import _torch_world as W
    from repro_torch.launch.mesh import run_local_world
    source, cfg = W.scenario("scd")
    want = tpf.solve_streaming_host(source, cfg, q=W.Q, slots=2, device=cuda_device)
    got = run_local_world(W.mesh_scenarios, 2, (["scd"],), {"slots": 2},
                          device="cuda", timeout=600)["scd"]
    assert got.iters == want.iters
    for f in ("lam", "r", "primal", "dual", "tau"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for x, y in zip(got.fin_hist, want.fin_hist):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_world_legacy_finalize_on_the_card(cuda_device):
    import _torch_world as W
    from repro_torch.launch.mesh import run_local_world
    kp = W.resident_kp(W.table_source(20 * W.CHUNK))
    out = run_local_world(W.legacy_finalize, 2,
                          (kp.p.numpy(), kp.b.numpy(), kp.budgets.numpy(), W.CHUNK,
                           W.Q, {"max_iters": 30, "kernel_tile": 256}),
                          device="cuda", timeout=600)
    fused, legacy = out[("fused", True)], out[("legacy", True)]
    assert fused.iters == legacy.iters
    assert torch.equal(fused.lam, legacy.lam) and torch.equal(fused.dual, legacy.dual)
    assert torch.equal(legacy.lam, out["sharded"].lam)
    f0, l0 = out[("fused", False)], out[("legacy", False)]
    for f in ("lam", "r", "primal", "dual", "tau"):
        assert torch.equal(getattr(f0, f).cpu(), getattr(l0, f).cpu()), f


@pytest.mark.cuda
def test_world_refresh_on_the_card_equals_in_process_slots(cuda_device, tmp_path):
    import _torch_world as W
    from repro_torch.launch.mesh import run_local_world
    roots = {name: str(tmp_path / f"world_{name}") for name in W.ENGINES}
    got = run_local_world(W.serve_world_generations, 2, (roots,), device="cuda",
                          timeout=600)
    for name in W.ENGINES:
        want = W.serve_generations(tmp_path / f"here_{name}", name, device=cuda_device)
        for a, b in zip(got[name], want):
            for f in ("lam", "tau", "iters", "r", "primal", "dual", "fingerprint"):
                assert np.asarray(getattr(a, f)).tobytes() == \
                    np.asarray(getattr(b, f)).tobytes(), (name, a.gen, f)
            for x, y in zip(a.fin_hist, b.fin_hist):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.fixture
def no_tf32():
    """Full float32 matrix products on the card (TF32 off), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,q", [(4096, 64, 6), (4096, 16, 2), (1000, 8, 2),
                                   (4096, 160, 6)])
def test_router_on_card_bitwise_plain(cuda_device, t, e, q):
    """The knapsack-priced router through ``scd_fused_hist`` (one launch an
    iteration) and ``adjusted_topc`` (one) on the card: every field bitwise
    the plain versions' on the CPU from the same probabilities (at K = 160
    through the wide instances)."""
    from repro_torch.core.moe_router import scd_route_probs
    g = np.random.default_rng(t + e)
    logits = g.standard_normal((t, e)) * 2 + g.standard_normal(e)   # uneven experts
    probs = torch.softmax(torch.tensor(logits, dtype=torch.float32), -1)
    want = scd_route_probs(probs, q=q, capacity_factor=1.25, iters=4)
    ops.reset_launches()
    got = scd_route_probs(probs.to(cuda_device), q=q, capacity_factor=1.25, iters=4)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["scd_fused_hist"] == 4 and ops.LAUNCHES["adjusted_topc"] == 1
    for f in ("combine", "mask", "lam", "load"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert float(want.lam.max()) > 0


LM_SMOKE_ARCHS = ["moonshot-v1-16b-a3b", "gemma-2b", "mamba2-370m", "jamba-v0.1-52b",
                  "seamless-m4t-medium", "deepseek-v2-236b", "deepseek-v2-236b@k160"]


def _smoke_cfg(name):
    """``smoke()`` of the arch; ``NAME@k160`` keeps its router at the full
    config's 160 experts and top-6 (the kernels' wide instances under the
    MLA model)."""
    import dataclasses
    from repro_torch.configs import registry
    arch, _, wide = name.partition("@")
    cfg = registry.get(arch).smoke()
    if wide:
        full = registry.get(arch).moe
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=full.n_experts,
                                                  topk=full.topk))
    return cfg
# The mixers' unscaled prefill logits reach ~15, and float32 rounding along
# jamba's 16 layers grows to a few 1e-6 of the residual stream: the
# reference's own eager and jitted prefills differ by up to 5.0e-5 there
# (ROADMAP C), so these archs' logits are held at atol 1e-4.
CARD_TOL = {"mamba2-370m": dict(rtol=1e-4, atol=1e-4),
            "jamba-v0.1-52b": dict(rtol=1e-4, atol=1e-4)}


def _moe_layers(cfg):
    """The layers whose FFN is routed (every one on moonshot, every other
    one on jamba)."""
    return cfg.ffn_pattern.count("moe") * cfg.n_periods if cfg.moe.n_experts else 0


def _smoke_inputs(cfg, seed):
    """Tokens (2, 64) and, for an encoder-decoder, frames (2, 32, d_model)."""
    g = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab, (2, 64)))}
    if cfg.kind == "encdec":
        batch["frames"] = torch.from_numpy(
            g.standard_normal((2, 32, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("name", LM_SMOKE_ARCHS)
def test_smoke_model_on_card_against_cpu(cuda_device, no_tf32, name):
    """Prefill (the SCD router on moonshot, jamba and deepseek) and four decode steps
    at ``smoke()`` in float32 on the card against the port on the CPU, from
    the same weights (and frames), with every cache leaf after them. rtol
    1e-4, atol 1e-5 (logits of mamba2 and jamba: ``CARD_TOL``): the card's
    matrix products sum in another order than the CPU's, the router's bits
    are the same."""
    from repro_torch.models import lm, model as M
    cfg = _smoke_cfg(name)
    cpu = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = lm.tree_map(lambda a: a.to(cuda_device), cpu)
    batch = _smoke_inputs(cfg, 1)
    toks = batch["tokens"]
    step = M.make_prefill_step(cfg)
    want = step(cpu, batch)
    ops.reset_launches()
    got = step(card, {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    if cfg.moe.router == "scd":
        assert ops.LAUNCHES["scd_fused_hist"] == cfg.moe.scd_iters * _moe_layers(cfg)
        assert ops.LAUNCHES["adjusted_topc"] == _moe_layers(cfg)
    tol = CARD_TOL.get(name, dict(rtol=1e-4, atol=1e-5))
    torch.testing.assert_close(got.cpu(), want, **tol)
    dstep = M.make_decode_step(cfg)
    frames = batch.get("frames")
    cc = M.init_cache(cfg, cpu, 2, 16, frames=frames)
    gc = M.init_cache(cfg, card, 2, 16,
                      frames=None if frames is None else frames.to(cuda_device))
    for t in range(4):
        wl, cc = dstep(cpu, cc, toks[:, t:t + 1], t)
        gl, gc = dstep(card, gc, toks[:, t:t + 1].to(cuda_device), t)
        torch.testing.assert_close(gl.cpu(), wl, **tol)
    got_l, want_l = lm.tree_leaves(gc), lm.tree_leaves(cc)
    assert len(got_l) == len(want_l)
    for x, y in zip(got_l, want_l):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_ssd_chunk_cumsum_on_card_bitwise_cpu(cuda_device):
    """The SSD's within-chunk cumsum (float64 in index order along a
    non-innermost axis, rounded once) and its backward: the same bits on
    the card as on the CPU, a lone column included."""
    from repro_torch.models.mamba2 import _chunk_cumsum
    g = np.random.default_rng(3)
    for shape in [(4, 4, 256, 128), (1, 1, 64, 1)]:
        x = torch.tensor(g.standard_normal(shape) * 30, dtype=torch.float32)
        w = torch.tensor(g.standard_normal(shape), dtype=torch.float32)
        outs = []
        for dev in ("cpu", cuda_device):
            xd = x.to(dev, copy=True).requires_grad_(True)
            y = _chunk_cumsum(xd)
            (y * w.to(dev)).sum().backward()
            outs.append((y.detach().cpu(), xd.grad.cpu()))
        (yc, gc), (yg, gg) = outs
        assert torch.equal(yc, yg) and torch.equal(gc, gg)


@pytest.mark.cuda
def test_mamba_decode_cache_in_place_on_card(cuda_device, no_tf32):
    """``decode_mamba`` on the card writes the conv window and SSM state
    into the cache it is given (the tensors keep their storage) and agrees
    with the CPU, step after step, from a random cache."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, model as M
    from repro_torch.models.mamba2 import decode_mamba, init_mamba_cache
    cfg = registry.get("mamba2-370m").smoke()
    cpu = lm.at(M.init(cfg, torch.Generator().manual_seed(0), device="cpu")["slots"][0], 0)
    card = lm.tree_map(lambda a: a.to(cuda_device), cpu["mixer"])
    g = torch.Generator().manual_seed(1)
    cc = lm.tree_map(lambda a: torch.randn(a.shape, generator=g),
                     init_mamba_cache(cfg, 2, torch.float32, "cpu"))
    gc = lm.tree_map(lambda a: a.to(cuda_device), cc)
    ptrs = {k: v.data_ptr() for k, v in gc.items()}
    for t in range(4):
        x = torch.randn((2, 1, cfg.d_model), generator=g)
        before = gc["ssm"].clone()
        wo, cc = decode_mamba(cpu["mixer"], cfg, x, cc, t)
        go, gc2 = decode_mamba(card, cfg, x.to(cuda_device), gc, t)
        assert gc2 is gc and {k: v.data_ptr() for k, v in gc.items()} == ptrs
        assert not torch.equal(gc["ssm"], before)
        torch.testing.assert_close(go.cpu(), wo, rtol=1e-4, atol=1e-5)
        for k in ("conv", "ssm"):
            torch.testing.assert_close(gc[k].cpu(), cc[k], rtol=1e-4, atol=1e-5)


def _loss_and_grads(params, cfg, batch):
    from repro_torch.models import lm, model as M
    from repro_torch.models.lm import tree_leaves
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = M.loss_fn(params, cfg, batch)
    loss.backward()
    grads = lm.tree_map(lambda p: p.grad, params)
    for p in tree_leaves(params):
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.cuda
@pytest.mark.parametrize("name", LM_SMOKE_ARCHS)
def test_smoke_train_step_on_card_against_cpu(cuda_device, no_tf32, name):
    """One train step at ``smoke()`` in float32 on the card against the
    port on the CPU, from the same weights and batch: the loss, every
    gradient, ``grad_norm``, and the update from the CPU's gradients."""
    from repro_torch.data.synth import lm_batch
    from repro_torch.models import lm, model as M
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    from repro_torch.models.lm import tree_leaves
    cfg = _smoke_cfg(name)
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    cpu = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = lm.tree_map(lambda a: a.to(cuda_device), cpu)
    batch = lm_batch(cfg, (2, 64), 0, seed=1, device="cpu")
    ops.reset_launches()
    gl, gg = _loss_and_grads(card, cfg, {k: v.to(cuda_device) for k, v in batch.items()})
    if cfg.moe.router == "scd":          # forward and remat recompute
        assert ops.LAUNCHES["scd_fused_hist"] == 2 * cfg.moe.scd_iters * _moe_layers(cfg)
        assert ops.LAUNCHES["adjusted_topc"] == 2 * _moe_layers(cfg)
    wl, wg = _loss_and_grads(cpu, cfg, batch)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    for g, w in zip(tree_leaves(gg), tree_leaves(wg)):
        if not w.any():
            assert not g.any()
        else:
            assert float((g.cpu() - w).norm() / w.norm()) <= 1e-4
    _, _, gm = apply_updates(card, lm.tree_map(lambda g: g.to(cuda_device), wg),
                             init_opt_state(card, opt_cfg), opt_cfg)
    _, _, wm = apply_updates(cpu, wg, init_opt_state(cpu, opt_cfg), opt_cfg)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]), rtol=1e-5)
    for a, w in zip(tree_leaves(card), tree_leaves(cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.cuda
def test_train_on_card_resumed_and_repeated_bitwise(cuda_device, tmp_path):
    """Moonshot at ``smoke()`` (its SCD router on the card, remat): 6 steps
    straight, again from the same seed, and 3 + a resume + 3, all bitwise
    in parameters and optimizer state."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.optim import OptConfig
    from repro_torch.models.lm import tree_leaves
    cfg = registry.get("moonshot-v1-16b-a3b").smoke()
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    kw = dict(seed=3, batch_shape=(2, 64), log_every=0, device=cuda_device)
    ops.reset_launches()
    full = train(cfg, opt_cfg, steps=6, **kw)
    assert ops.LAUNCHES["scd_fused_hist"] == 6 * 2 * cfg.moe.scd_iters * cfg.n_layers
    again = train(cfg, opt_cfg, steps=6, **kw)
    train(cfg, opt_cfg, steps=3, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    res = train(cfg, opt_cfg, steps=6, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    want = tree_leaves(full[:2])
    for other in (again, res):
        got = tree_leaves(other[:2])
        assert len(got) == len(want)
        assert all(a.device == b.device and torch.equal(a, b) for a, b in zip(got, want))
    assert res[2] == full[2][3:]


@pytest.fixture(scope="module")
def moe_worlds():
    """``tests/_torch_moe_world.port_cases`` over a world of 2 ranks on the
    card and a world of 2 on the CPU, side by side (None without a card)."""
    if not torch.cuda.is_available():
        return None
    import _torch_moe_world as W
    from repro_torch.launch.mesh import run_local_world, start_local_world
    cpu = start_local_world(W.port_cases, 2, device="cpu", timeout=600)
    try:
        card = run_local_world(W.port_cases, 2, device="cuda", timeout=600)
    finally:
        on_cpu = cpu.wait()
    return card, on_cpu


MOE_WORLD_KEYS = ["moe_seq", "moe_batch", "moe_seq_drop", "moe_batch_drop",
                  "route_smoke", "route_wide", "lam",
                  "prefill_moonshot-v1-16b-a3b", "decode_moonshot-v1-16b-a3b",
                  "prefill_deepseek-v2-236b", "decode_deepseek-v2-236b"]


@pytest.mark.cuda
@pytest.mark.parametrize("key", MOE_WORLD_KEYS)
def test_moe_world_on_card_against_cpu(cuda_device, moe_worlds, key):
    """The MoE forward over a world of 2 ranks sharing the card against a
    world of 2 on the CPU (smoke weights, float32, TF32 off): the world's
    lam from the same probabilities bitwise; the a2a path's outputs, its
    dropped pairs and zero rows, the router's masks and combine weights,
    the prefill and 4 decode steps under the batch binding within rtol
    1e-4, atol 1e-5 (the prefill's logits, |35| at most, atol 4e-5): the
    card's matrix products sum in another order than the CPU's."""
    card, cpu = moe_worlds
    if key == "lam":
        np.testing.assert_array_equal(card[key], cpu[key])
        return
    tol = dict(rtol=1e-4, atol=4e-5 if key.startswith("prefill") else 1e-5)
    if key.startswith("route"):
        np.testing.assert_array_equal(card[f"{key}_mask"], cpu[f"{key}_mask"])
        np.testing.assert_allclose(card[f"{key}_combine"], cpu[f"{key}_combine"], **tol)
        return
    np.testing.assert_allclose(card[key], cpu[key], **tol)
    if key.startswith("moe"):
        case = key[len("moe_"):]
        assert card[f"drops_{case}"] == cpu[f"drops_{case}"]
        np.testing.assert_array_equal(~card[key].any(-1), ~cpu[key].any(-1))


@pytest.fixture(scope="module")
def train_worlds(tmp_path_factory):
    """``tests/_torch_train_world.port_cases`` (the train cases and
    ``train(mesh=)`` saved and resumed) over a world of 2 ranks on the card
    and a world of 2 on the CPU, side by side (None without a card)."""
    if not torch.cuda.is_available():
        return None
    import _torch_train_world as W
    from repro_torch.launch.mesh import run_local_world, start_local_world
    d = tmp_path_factory.mktemp("train_worlds")
    cpu = start_local_world(W.port_cases, 2, (str(d / "cpu_full"), str(d / "cpu_saved")),
                            device="cpu", timeout=600)
    try:
        card = run_local_world(W.port_cases, 2, (str(d / "card_full"), str(d / "card_saved")),
                               device="cuda", timeout=600)
    finally:
        on_cpu = cpu.wait()
    return card, on_cpu


TRAIN_WORLD_CASES = ["moonshot", "moonshot_drop", "deepseek", "moonshot_compress"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_WORLD_CASES)
def test_train_world_on_card_against_cpu(cuda_device, train_worlds, case):
    """Training over a world of 2 ranks sharing the card against a world of
    2 on the CPU (smoke weights, float32, TF32 off; 3 steps under the batch
    binding): the losses and grad norms within rtol 1e-5, atol 1e-5, step
    1's gradients within a relative L2 error of 1e-4 of each leaf, the
    same pairs dropped. At capacity 0.3 step 1 only: there a top-k choice
    that the two devices' last bits flip after an update moves which pairs
    pass ``cap_send`` and ``cap_e`` (measured: step 2's loss 1e-3 apart)."""
    card, cpu = (w[case] for w in train_worlds)
    steps = 1 if case == "moonshot_drop" else len(cpu["loss"])
    np.testing.assert_allclose(card["loss"][:steps], cpu["loss"][:steps], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card["grad_norm"][:steps], cpu["grad_norm"][:steps], rtol=1e-5,
                               atol=1e-5)
    assert card["dropped"] == cpu["dropped"]
    assert len(card["grads"]) == len(cpu["grads"])
    for g, w in zip(card["grads"], cpu["grads"]):
        if not np.any(w):
            assert not np.any(g)
        else:
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


@pytest.mark.cuda
def test_train_world_resumed_bitwise_on_card(cuda_device, train_worlds):
    """``train(mesh=)`` on the card (weights drawn from the seed on the card:
    not the CPU's): a second run's first 2 losses bitwise the first's, the
    run resumed from step 2 bitwise the uninterrupted one."""
    card = train_worlds[0]["train"]
    assert card["saved"]["losses"] == card["full"]["losses"][:2]
    assert card["resumed"]["losses"] == card["full"]["losses"][2:]
    assert len(card["resumed"]["state"]) == len(card["full"]["state"])
    for a, b in zip(card["resumed"]["state"], card["full"]["state"]):
        np.testing.assert_array_equal(a, b)


# --- the dry-run's shapes and memory against the card ------------------------

def _meta_and_card(fn, *shapes_and_args):
    """``fn`` (a ``kernels.ops`` entry) on meta tensors and on CUDA tensors of
    the same shapes: (meta outputs, card outputs), flattened."""
    from torch.utils._pytree import tree_leaves

    def call(device):
        args = [torch.rand(a, device=device) if isinstance(a, tuple) else a
                for a in shapes_and_args]
        return tree_leaves(fn(*args))
    return call("meta"), call("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 64, 160])
def test_cost_output_shapes_equal_the_kernels_on_card(cuda_device, k):
    """``kernels.cost``'s outputs (the meta path of ``kernels.ops``) have the
    shapes and dtypes of the kernels' on the card, the ``KMAX`` instances at
    K = 10 and 64, the ``KWIDE`` ones of the router's two kernels at 160;
    the scratch sizes are the library's."""
    from repro_torch.kernels import _build, cost
    n, e, q = 5000, 33, 2
    pairs = [_meta_and_card(lambda p, b, lam, ed: ops.scd_fused_hist(
                 p, b, lam, torch.sort(ed, -1).values, q, tile_n=32),
                            (n, k), (n, k), (k,), (k, e)),
             _meta_and_card(lambda p, b, lam: ops.adjusted_topc(p, b, lam, q),
                            (n, k), (n, k), (k,))]
    if k <= _wrap.KMAX:
        pe = torch.sort(torch.rand(64)).values
        pairs += [
            _meta_and_card(lambda p, b, lam: ops.scd_finalize_hist(
                p, b, lam, pe.to(p.device), q, tile_n=256), (n, k), (n, k), (k,)),
            _meta_and_card(lambda p, b, lam: ops.scd_finalize_hist(
                p, b, lam, None, q, tile_n=256, with_hist=False), (n, k), (n, k), (k,)),
            _meta_and_card(lambda p, b, lam: ops.scd_candidates(p, b, lam, q),
                           (n, k), (n, k), (k,)),
            _meta_and_card(lambda v1, v2, ed: ops.bucket_hist(
                v1, v2, torch.sort(ed, -1).values, tile_n=256), (n, k), (n, k), (k, e)),
            _meta_and_card(lambda p, b: ops.screen_bound(p, b), (n, k), (n, k))]
    described = lambda outs: [None if a is None else (tuple(a.shape), a.dtype)  # noqa: E731
                              for a in outs]
    for meta, card in pairs:
        assert described(meta) == described(card)
    lib = _build.load()
    for tile in (32, 512, 1024, 8192):
        for fused in (0, 1):
            assert cost.hist_scratch(n, k, e, tile, fused) == lib.hist_scratch(n, k, e, tile,
                                                                               fused)
            assert _wrap.hist_smem_bytes(k, e, tile, fused) == lib.hist_smem_bytes(
                k, e, tile, fused)
    if k <= _wrap.KMAX:
        for ee in (0, 64, 512):
            assert cost.finalize_part_stride(k, ee) == lib.scd_finalize_part_stride(k, ee)
            for tile in (32, 128, 512, 1024):
                assert cost.finalize_smem_bytes(k, ee, tile) == \
                    lib.scd_finalize_smem_bytes(k, ee, tile)
    with pytest.raises(ValueError, match="shared memory"):      # refused on meta too
        ops.bucket_hist(*(torch.empty(s, device="meta") for s in ((n, 64), (n, 64),
                                                                  (64, 33))), tile_n=1024)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "gemma-2b"])
def test_dry_run_memory_against_the_card(cuda_device, name, kind):
    """At ``smoke()``: the dry-run's held bytes equal what the card holds for
    the cell (params, moments, caches, batch), and its peak is within 15 %
    of the held bytes plus what ``max_memory_allocated`` rose by over the
    step (run once before, so the card's one-time buffers are in place)."""
    from repro_torch.data.synth import lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import lm, model as M
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = registry_smoke(name)
    b, s = 4, 64
    rec = dryrun.account_cell(name, M.ShapeCell("smoke", s, b, kind), 1, cfg=cfg)
    assert rec["status"] == "ok", rec.get("error")
    params = M.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    batch = lm_batch(cfg, (b, s), 0, seed=1, device=cuda_device)
    held = [params]
    if kind == "train":
        opt = init_opt_state(params, OptConfig())
        step = M.make_train_step(cfg, OptConfig())
        run = lambda: step(params, opt, batch)  # noqa: E731
        held += [opt, batch]
    elif kind == "prefill":
        batch.pop("targets")
        step = M.make_prefill_step(cfg)
        run = lambda: step(params, batch)  # noqa: E731
        held.append(batch)
    else:
        with torch.no_grad():
            caches = M.init_cache(cfg, params, b, s)
        token = batch["tokens"][:, :1].clone()
        step = M.make_decode_step(cfg)
        run = lambda: step(params, caches, token, s - 1)  # noqa: E731
        held += [caches, token]
    with torch.set_grad_enabled(kind == "train"):
        run()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        run()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(cuda_device) - before
    card_held = dryrun.nbytes(held)
    assert rec["memory"]["held"] == card_held
    assert abs(rec["memory"]["peak"] - (card_held + rise)) <= 0.15 * (card_held + rise)


def registry_smoke(name):
    from repro_torch.configs import registry
    return registry.get(name).smoke()


@pytest.fixture(scope="module")
def tp_worlds():
    """``tests/_torch_tp_world.port_cases`` (moonshot's and gemma's smoke
    prefill and 6 decode steps under the production rules) over a world of
    2 ranks on the card and a world of 2 on the CPU, side by side (None
    without a card)."""
    if not torch.cuda.is_available():
        return None
    import _torch_tp_world as W
    from repro_torch.launch.mesh import run_local_world, start_local_world
    cpu = start_local_world(W.port_cases, 2, device="cpu", timeout=600)
    try:
        card = run_local_world(W.port_cases, 2, device="cuda", timeout=600)
    finally:
        on_cpu = cpu.wait()
    return card, on_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "gemma-2b"])
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_tp_world_on_card_against_cpu(cuda_device, tp_worlds, arch, what):
    """Tensor and sequence parallelism over a world of 2 ranks sharing the
    card against a world of 2 on the CPU (smoke weights, float32, TF32
    off): the prefill's logits within rtol 1e-4, atol 4e-5, the decode
    steps' (gemma's crossing its cache's block boundary) within rtol 1e-4,
    atol 1e-5, finite: the card's products sum in another order."""
    card, cpu = tp_worlds
    i = 0 if what == "prefill" else 1
    got, want = card[arch][i], cpu[arch][i]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=4e-5 if i == 0 else 1e-5)


@pytest.fixture(scope="module")
def tp_train_worlds():
    """``tests/_torch_tp_train.port_cases`` (moonshot's and gemma's smoke
    train steps under the production rules) over a world of 2 ranks on the
    card and a world of 2 on the CPU, side by side (None without a card)."""
    if not torch.cuda.is_available():
        return None
    import _torch_tp_train as W
    from repro_torch.launch.mesh import run_local_world, start_local_world
    cpu = start_local_world(W.port_cases, 2, device="cpu", timeout=600)
    try:
        card = run_local_world(W.port_cases, 2, device="cuda", timeout=600)
    finally:
        on_cpu = cpu.wait()
    return card, on_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "gemma-2b"])
def test_tp_train_world_on_card_against_cpu(cuda_device, tp_train_worlds, arch):
    """Training under tensor and sequence parallelism over a world of 2 ranks
    sharing the card against a world of 2 on the CPU (smoke weights,
    float32, TF32 off; 3 steps under the production rules): the losses and
    grad norms within rtol 1e-5, atol 1e-5, step 1's gradients within a
    relative L2 error of 1e-4 of each leaf, both ranks' losses and norms
    bitwise on the card."""
    card, cpu = (w[arch] for w in tp_train_worlds)
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(card["both"][0], card["both"][1])
    assert len(card["grads"]) == len(cpu["grads"])
    for g, w in zip(card["grads"], cpu["grads"]):
        if not np.any(w):
            assert not np.any(g)
        else:
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


MIXER_ARCHS = ("deepseek-v2-236b", "mamba2-370m", "jamba-v0.1-52b", "seamless-m4t-medium")
# jamba's 8 layers of smoke logits: phase 21's card-vs-CPU bar for them.
MIXER_ATOL = {"jamba-v0.1-52b": 1e-4}


def _mixers_close(card, cpu, arch):
    """The card's prefill and decode logits within rtol 1e-4 (atol 4e-5 and
    1e-5; jamba 1e-4) of the CPU's, finite; the losses and grad norms
    within rtol 1e-5, atol 1e-5."""
    for what, atol in (("prefill", 4e-5), ("decode", 1e-5)):
        got, want = card[what], cpu[what]
        assert got.shape == want.shape and np.isfinite(got).all(), what
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=MIXER_ATOL.get(arch, atol),
                                   err_msg=what)
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tp_mixer_worlds():
    """``tests/_torch_tp_mixers.port_cases`` (deepseek's, mamba2's, jamba's
    and seamless's smoke prefill, 6 decode steps and 2 train steps under
    the production rules) over a world of 2 ranks on the card and a world
    of 2 on the CPU, side by side (None without a card)."""
    if not torch.cuda.is_available():
        return None
    import _torch_tp_mixers as W
    from repro_torch.launch.mesh import run_local_world, start_local_world
    cpu = start_local_world(W.port_cases, 2, device="cpu", timeout=600)
    try:
        card = run_local_world(W.port_cases, 2, device="cuda", timeout=600)
    finally:
        on_cpu = cpu.wait()
    return card, on_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_tp_mixers_world_on_card_against_cpu(cuda_device, tp_mixer_worlds, arch):
    """MLA, Mamba2, the hybrid and the encoder-decoder under tensor and
    sequence parallelism over a world of 2 ranks sharing the card against a
    world of 2 on the CPU (smoke weights, float32, TF32 off):
    :func:`_mixers_close`, and both ranks' losses and norms bitwise on the
    card."""
    card, cpu = (w[arch] for w in tp_mixer_worlds)
    _mixers_close(card, cpu, arch)
    np.testing.assert_array_equal(card["both"][0], card["both"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_tp_mixers_world_of_one_on_card_equals_cpu(cuda_device, arch):
    """The same steps under the production rules over a world of one in this
    process, on the card against the CPU: :func:`_mixers_close`."""
    import _torch_tp_mixers as W
    from repro_torch.core.carry import params_from_reference
    from repro_torch.core.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, bs = W.smoke_cfg(arch), W.batches(arch)
    tree = W.smoke_trees((arch,))[arch]
    got = []
    for dev in (cuda_device, torch.device("cpu")):
        mesh = Mesh(0, 1, dev)
        pre, dec = W.run_steps(mesh, params_from_reference(tree, cfg, dev), cfg,
                               W._on(bs[0], dev))
        t = W.run_train(mesh, params_from_reference(tree, cfg, dev), cfg, bs)
        got.append({"prefill": pre, "decode": dec, "loss": t["loss"],
                    "grad_norm": t["grad_norm"]})
    _mixers_close(*got, arch)


FSDP_MODES = ("full", "zero1", "none", "fsdp_only", "dp_full")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FSDP_MODES)
def test_fsdp_world_of_one_on_card_equals_cpu(cuda_device, mode):
    """One train step of smoke moonshot laid out by ``mode`` under FSDP
    (``sharding.rules_for("fsdp", mode)``) over a world of one in this
    process on the card against the same on the CPU (float32, TF32 off,
    the weights drawn on the CPU): the loss and grad norm within rtol 1e-5,
    atol 1e-5, step 1's gradients within a relative L2 error of 1e-5."""
    import _torch_fsdp as W
    from repro_torch.core.mesh import Mesh
    from repro_torch.models import sharding as S
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = W.TW.smoke_trees((W.MOE_ARCH,))[W.MOE_ARCH]
    got = [W.run_case(Mesh(0, 1, dev), tree, W.MOE_ARCH, mode, S.rules_for("fsdp", mode),
                      W.batches(W.MOE_ARCH, 1))
           for dev in (cuda_device, torch.device("cpu"))]
    card, cpu = got
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"], rtol=1e-5, atol=1e-5)
    for g, w in zip(card["grads"], cpu["grads"]):
        assert np.linalg.norm(g - w) <= 1e-5 * max(np.linalg.norm(w), 1e-30)


@pytest.fixture(scope="module")
def fsdp_worlds():
    """``tests/_torch_fsdp.card_cases`` (smoke moonshot, one step in each
    ``fsdp_mode`` under FSDP) over a world of 2 ranks on the card and a
    world of 2 on the CPU, side by side (None without a card)."""
    if not torch.cuda.is_available():
        return None
    import _torch_fsdp as W
    from repro_torch.launch.mesh import run_local_world, start_local_world
    cpu = start_local_world(W.card_cases, 2, device="cpu", timeout=600)
    try:
        card = run_local_world(W.card_cases, 2, device="cuda", timeout=600)
    finally:
        on_cpu = cpu.wait()
    return card, on_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FSDP_MODES)
def test_fsdp_world_on_card_against_cpu(cuda_device, fsdp_worlds, mode):
    """FSDP over a world of 2 ranks sharing the card against a world of 2 on
    the CPU (smoke moonshot, float32, TF32 off, one step laid out by
    ``mode``): the loss and grad norm within rtol 1e-5, atol 1e-5, both
    ranks' bitwise on the card."""
    card, cpu = (w[mode] for w in fsdp_worlds)
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(card["both"][0], card["both"][1])
