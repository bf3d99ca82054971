"""The device-streamed legacy finalize over a world of ranks, and the
per-slot host sources, on the CPU.

A world of 2 gloo ranks runs ``solve_streaming(mesh=...)`` on the NumPy
rows of ``_torch_world.table_source`` (n = 20,480, K = 8, Q = 2, chunk
1,024, one shard of 10 chunks a rank), fused and legacy, with and without
the §5.4 projection, and ``solve_shard`` of the same rows (each rank's
shard is its streamed chunks, so the two group their sums alike). Held, as the
reference's ``tests/test_chunked.py::test_fused_finalize_sharded_subprocess``
holds its mesh: fused against legacy bitwise in lam, iterations and dual;
every field bitwise with ``postprocess=False``; lam and iterations bitwise
against the sharded resident solve. Against the reference's
``solve_streaming(mesh=...)`` legacy on 2 XLA host devices over the same
bytes (one subprocess, beside the world): iterations equal, lam rtol 1e-5
and r, primal, dual, tau rtol 1e-5 (ROADMAP C). And
``data.synth.sparse_host_shard_sources`` byte for byte the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_world as W  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
CFG_KW = {"max_iters": 30, "kernel_tile": 256}
N = 20 * W.CHUNK

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from repro.core.chunked import array_source, solve_streaming
from repro.core.types import SolverConfig, SparseKP
inp = np.load(sys.argv[1])
kp = SparseKP(*(jnp.asarray(inp[f]) for f in ("p", "b", "budgets")))
mesh = jax.make_mesh((2,), ("x",))
cfg = SolverConfig(max_iters=30, stream_finalize="legacy")
res = solve_streaming(array_source(kp, int(inp["chunk"])), cfg,
                      q=int(inp["q"]), mesh=mesh)
np.savez(sys.argv[2], **{f: np.asarray(getattr(res, f))
                        for f in ("lam", "iters", "r", "primal", "dual", "tau")})
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here too: the ranks run one each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 2 and the reference's subprocess, side by side."""
    d = tmp_path_factory.mktemp("legacy")
    kp = W.resident_kp(W.table_source(N))
    p, b, budgets = kp.p.numpy(), kp.b.numpy(), kp.budgets.numpy()
    np.savez(d / "in.npz", p=p, b=b, budgets=budgets, chunk=W.CHUNK, q=W.Q)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        world = tmesh.run_local_world(W.legacy_finalize, 2,
                                      (p, b, budgets, W.CHUNK, W.Q, CFG_KW),
                                      device="cpu", timeout=TIMEOUT)
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return {"world": world, "ref": dict(np.load(d / "out.npz"))}


def test_legacy_equals_fused_in_lam_iters_and_dual(runs):
    fused, legacy = runs["world"][("fused", True)], runs["world"][("legacy", True)]
    assert fused.iters == legacy.iters
    assert torch.equal(fused.lam, legacy.lam)
    assert torch.equal(fused.dual, legacy.dual)
    assert torch.all(legacy.r <= torch.as_tensor(W.table_source(N).budgets) * (1 + 1e-4))
    np.testing.assert_allclose(legacy.primal.numpy(), fused.primal.numpy(), rtol=1e-2)


def test_without_projection_every_field_bitwise(runs):
    fused, legacy = runs["world"][("fused", False)], runs["world"][("legacy", False)]
    assert fused.iters == legacy.iters
    for f in ("lam", "r", "primal", "dual", "tau"):
        assert torch.equal(getattr(fused, f), getattr(legacy, f)), f


def test_legacy_multipliers_equal_the_sharded_solve(runs):
    legacy, sharded = runs["world"][("legacy", True)], runs["world"]["sharded"]
    assert legacy.iters == sharded.iters
    assert torch.equal(legacy.lam, sharded.lam)


def test_legacy_world_matches_reference_mesh(runs):
    got, ref = runs["world"][("legacy", True)], runs["ref"]
    assert got.iters == int(ref["iters"])
    np.testing.assert_allclose(got.lam.numpy(), ref["lam"], rtol=1e-5, atol=1e-6)
    for f in ("r", "primal", "dual", "tau"):
        np.testing.assert_allclose(getattr(got, f).numpy(), ref[f], rtol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("n,slots", [(20_000, 4), (20_000, 3), (5_000, 8)])
def test_sparse_host_shard_sources_equal_reference(n, slots):
    kw = dict(q=2, tightness=0.4, b_high=0.5)
    ours = tsynth.sparse_host_shard_sources(7, n, 8, 1024, slots, **kw)
    theirs = jsynth.sparse_host_shard_sources(7, n, 8, 1024, slots, **kw)
    assert len(ours) == len(theirs) == slots
    chunks = -(-n // 1024)
    cps = -(-chunks // slots)
    for a, b in zip(ours, theirs):
        assert (a.n, a.k, a.chunk) == (b.n, b.k, b.chunk)
        assert np.asarray(a.budgets).tobytes() == np.asarray(b.budgets).tobytes()
        for j in range(cps):
            for x, y in zip(a.fn(j), b.fn(j)):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
