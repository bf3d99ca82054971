"""The port's ``solve_sharded`` over a world of 4 gloo ranks against the
reference's ``solve_sharded`` over 4 XLA host devices, on the same NumPy
instances.

The reference runs in one subprocess that sets ``XLA_FLAGS`` before JAX
starts (as ``tests/test_distributed_solver.py`` does) and writes every
scenario's result; the port's world of 4 runs beside it. Scenarios: the
sparse GKP (n = 20,000, K = 8, Q = 2) bucketed on dyadic and on random
rows, exact, DD, presolve and ``partial_fraction=0.75``, and the dense
C223 GKP (n = 512, M = 8, K = 4) bucketed. Held to the reference's own
tolerances: lam rtol 1e-5 with equal iterations, and bitwise on the
dyadic rows, where every histogram sum is exact; r, primal and dual rtol
1e-5 (not for the exact reduce, whose lam sits on a candidate's ratio, a
tie, so the reference's own test holds lam only); at most 0.1 % of the
decisions differ. ``partial_fraction=0.75``
scales each shard's histogram where the reference's default path scales
v2 per row, so it agrees in the last bits only (ROADMAP C).

Within the port, bitwise: the chunked sharded solve equals the unchunked
one (every field, x included), and a world of one equals ``solve``
(every field without the §5.4 projection, which is exact on one device
and bucketed across a mesh; lam, iterations and dual with it).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_world as W  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core.instances import dense_instance  # noqa: E402
from repro_torch.core.types import DenseKP, SolverConfig, SparseKP  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
TILE = 256
SCENARIOS = {
    "dyadic": ("dyadic", {}, W.Q),
    "random": ("random", {}, W.Q),
    "exact": ("random", {"reduce": "exact", "max_iters": 10, "postprocess": False}, W.Q),
    "dd": ("random", {"algo": "dd", "max_iters": 10}, W.Q),
    "presolve": ("random", {"presolve_samples": 600}, W.Q),
    "straggler": ("random", {"partial_fraction": 0.75}, W.Q),
    "dense": ("dense", {"max_iters": 15}, 0),
}
# The port only: chunked == unchunked at a tile that divides the chunk.
PORT_ONLY = {
    "tiled": ("random", {"kernel_tile": TILE}, W.Q),
    "chunked": ("random", {"kernel_tile": TILE, "chunk_size": 1024}, W.Q),
}

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from repro.core.solver import solve_sharded
from repro.core.types import DenseKP, SolverConfig, SparseKP
inp = np.load(sys.argv[1], allow_pickle=True)
scen = inp["scenarios"].item()
kps = {n: SparseKP(*(jnp.asarray(inp[f"{n}_{f}"]) for f in ("p", "b", "budgets")))
       for n in ("dyadic", "random")}
kps["dense"] = DenseKP(*(jnp.asarray(inp[f"dense_{f}"])
                         for f in ("p", "b", "budgets", "sets", "caps")))
mesh = jax.make_mesh((4,), ("x",))
out = {}
for name, (inst, kw, q) in scen.items():
    res = solve_sharded(kps[inst], mesh, SolverConfig(**kw), q=q)
    for f in ("lam", "x", "r", "primal", "dual", "iters"):
        out[f"{name}_{f}"] = np.asarray(getattr(res, f))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here too: the ranks run one each, and all of them
    share this host's cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instances():
    g = np.random.default_rng(3)
    p = (g.integers(0, 64, (W.N, W.K)) / 64).astype(np.float32)
    b = (g.integers(1, 64, (W.N, W.K)) / 64).astype(np.float32)
    budgets = np.full((W.K,), 0.4 * W.N * W.Q * 0.5 / W.K, np.float32)
    rp = g.random((W.N, W.K), np.float32)
    rb = g.uniform(0.05, 1.0, (W.N, W.K)).astype(np.float32)
    dense = dense_instance(6, 512, 8, 4, local="C223", tightness=0.25)
    return {"dyadic": SparseKP(*(torch.from_numpy(a) for a in (p, b, budgets))),
            "random": SparseKP(*(torch.from_numpy(a) for a in (rp, rb, budgets))),
            "dense": DenseKP(*(t.cpu() for t in dense))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's world of 4, side by side,
    then the world of one in this process."""
    d = tmp_path_factory.mktemp("sharded")
    inst = _instances()
    arrays = {f"{n}_{f}": getattr(inst[n], f).numpy()
              for n in inst for f in inst[n]._fields}
    np.savez(d / "in.npz", scenarios=np.array(SCENARIOS, dtype=object), **arrays)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = tmesh.run_local_world(W.sharded_scenarios, 4,
                                     (inst, {**SCENARIOS, **PORT_ONLY}),
                                     device="cpu", timeout=TIMEOUT)
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    one = tmesh.Mesh(0, 1, torch.device("cpu"))
    return {"inst": inst, "port": port, "ref": dict(np.load(d / "out.npz")),
            "one": one}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_matches_reference(runs, name):
    res, ref = runs["port"][name], runs["ref"]
    assert res.iters == int(ref[f"{name}_iters"])
    lam = ref[f"{name}_lam"]
    if name == "dyadic":
        np.testing.assert_array_equal(res.lam.numpy(), lam)
    else:
        np.testing.assert_allclose(res.lam.numpy(), lam, rtol=1e-5, atol=1e-6)
    # The exact reduce puts each lam_k on a candidate's ratio: that row's
    # adjusted profit is ~0, a tie either package may break (the reference's
    # own test holds lam only).
    for f in ("r", "primal", "dual") if name != "exact" else ():
        np.testing.assert_allclose(getattr(res, f).numpy(), ref[f"{name}_{f}"],
                                   rtol=1e-5, err_msg=f)
    assert res.x.shape == ref[f"{name}_x"].shape
    assert np.mean(res.x.numpy() != ref[f"{name}_x"]) <= 1e-3


def test_sharded_chunked_equals_unchunked_bitwise(runs):
    a, b = runs["port"]["tiled"], runs["port"]["chunked"]
    assert a.iters == b.iters
    for f in ("lam", "x", "r", "primal", "dual"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", ["random", "dense", "dd", "exact"])
def test_world_of_one_equals_solve(runs, name):
    inst, kw, q = SCENARIOS[name]
    kp = runs["inst"][inst]
    for post in (False, True):
        cfg = SolverConfig(**{**kw, "postprocess": post})
        a = tsolver.solve_sharded(kp, runs["one"], cfg, q=q)
        b = tsolver.solve(kp, cfg, q=q, device="cpu")
        assert a.iters == b.iters
        fields = ("lam", "x", "r", "primal", "dual") if not post else ("lam", "dual")
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (post, f)


def test_sharded_arguments_are_checked(runs):
    kp, one = runs["inst"]["random"], runs["one"]
    with pytest.raises(TypeError, match="Mesh"):
        tsolver.solve_sharded(kp, object())
    with pytest.raises(ValueError, match="flat"):
        tsolver.solve_sharded(kp, one, axes=("x",))
    with pytest.raises(ValueError, match="divide"):
        tsolver.solve_sharded(kp._replace(p=kp.p[:-1], b=kp.b[:-1]),
                              tmesh.Mesh(0, 3, torch.device("cpu")))
