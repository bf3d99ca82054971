"""The MoE forward over a world of ranks against the reference's mesh path,
on the CPU.

One world of 2 gloo ranks (``launch.mesh.run_local_world``) runs every case
of ``tests/_torch_moe_world.py`` twice; one reference subprocess runs the
same cases on a (1, 2) ("data", "model") mesh of 2 XLA host devices with
Auto axes. Both run on the same weights (each arch's ``smoke()`` init as
NumPy trees: the reference's arrays, carried into each rank through
``carry.params_from_reference``) and the same seeded NumPy inputs, held to rtol 1e-5, atol 1e-5 (the prefill's
logits, |35| at most, at atol 4e-5; see ``LOGITS_TOL``):

* ``moe_train`` at moonshot-v1-16b-a3b's ``smoke()``, tokens cut by
  sequence (``DEFAULT_RULES`` with batch on "data") and by batch, at the
  config's capacity factor and at 0.3, where ``cap_send`` and ``cap_e``
  drop pairs: the same rows come back zero;
* ``scd_route_shmap``: combine weights, and masks equal;
* ``make_prefill_step`` and 4 decode steps under the batch binding at
  moonshot's and deepseek-v2-236b's ``smoke()``.

Within the port: the two runs are bitwise equal; the world's lam from the
same probabilities is bitwise ``scd_route_probs``'s (4,096 x 64, q = 6:
the capacity 480 is exact at every world size, and the folded histograms
are counts); a world of one in this process equals the one-process
``moe_train`` and prefill within rtol 1e-5 and drops no pair. Not bitwise:
the world routes without the §5.4 projection, and its a2a sums k pairs
where the dense path sums E experts.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

import _torch_moe_world as W  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.moe_router import scd_route_probs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as M, moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = dict(rtol=1e-5, atol=1e-5)
# The steps' logits reach |35| at smoke(): the port's one-process prefill
# already differs from the reference's one-process prefill by up to 1.8e-5
# there (the same float32 operations summed in other orders, BLAS against
# XLA), so the prefill's logits over a world are held at atol 4e-5, about
# 1e-6 of their scale (measured: 1.5e-5 moonshot, 1.7e-5 deepseek; the
# decode steps' logits, |3.4| at most, 2.0e-6, held at TOL).
LOGITS_TOL = dict(rtol=1e-5, atol=4e-5)

REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import set_mesh, shard_map
from repro.configs import registry
from repro.core.moe_router import scd_route_shmap
from repro.models import model as RM, moe as Rmoe, sharding as S

wdir = sys.argv[1]
with open(os.path.join(wdir, "cases.pkl"), "rb") as f:
    c = pickle.load(f)
inp = dict(np.load(os.path.join(wdir, "in.npz")))
cfgs = {a: registry.get(a).smoke() for a in c["archs"]}
params = jax.tree.map(jnp.asarray, c["trees"])

mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
moe_p = jax.tree.map(lambda a: a[0], params[c["moe_arch"]]["slots"][0]["ffn"])
with set_mesh(mesh):
    for name, (rules, cf) in c["moe_cases"].items():
        cfg = cfgs[c["moe_arch"]]
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        S.set_rules(rules)
        out[f"moe_{name}"] = jax.jit(lambda p, x, cfg=cfg: Rmoe.moe_train(p, cfg, x))(
            moe_p, jnp.asarray(inp["moe_x"]))
        S.set_rules(None)
    for name, (_, _, q) in c["route_cases"].items():
        route = shard_map(lambda l, q=q: scd_route_shmap(l, q, 1.25, 4, "model"),
                          mesh=mesh, in_specs=P("model", None),
                          out_specs=(P("model", None), P("model", None)), check_vma=False)
        out[f"route_{name}_combine"], out[f"route_{name}_mask"] = jax.jit(route)(
            jnp.asarray(inp[f"route_{name}"]))
    toks = jnp.asarray(inp["tokens"], jnp.int32)
    for arch, cfg in cfgs.items():
        S.set_rules(c["batch_rules"])
        out[f"prefill_{arch}"] = jax.jit(
            lambda p, b, cfg=cfg: RM.make_prefill_step(cfg)(p, b))(params[arch], {"tokens": toks})
        caches = RM.init_cache(cfg, params[arch], toks.shape[0], c["cache_len"])
        step = jax.jit(lambda p, ca, t, pos, cfg=cfg: RM.make_decode_step(cfg)(p, ca, t, pos))
        logits = []
        for t in range(c["decode_steps"]):
            lg, caches = step(params[arch], caches, toks[:, t:t + 1], jnp.int32(t))
            logits.append(lg[:, 0])
        out[f"decode_{arch}"] = jnp.stack(logits)
        S.set_rules(None)
np.savez(os.path.join(wdir, "out.npz"), **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def inp():
    return W.inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inp):
    """The reference's subprocess and the port's world of 2, side by side."""
    d = tmp_path_factory.mktemp("moe_world")
    np.savez(d / "in.npz", **inp)
    trees = W.smoke_trees()
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"archs": W.ARCHS, "moe_arch": W.MOE_ARCH, "moe_cases": W.MOE_CASES,
                     "route_cases": W.ROUTE_CASES, "batch_rules": W.BATCH_RULES,
                     "cache_len": W.CACHE_LEN, "decode_steps": W.DECODE_STEPS,
                     "trees": trees}, f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = tmesh.run_local_world(W.world_cases, 2, (trees, inp), device="cpu",
                                     timeout=TIMEOUT)
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return {"port": port, "ref": dict(np.load(d / "out.npz"))}


@pytest.mark.parametrize("case", list(W.MOE_CASES))
def test_moe_train_matches_reference(runs, case):
    got, want = runs["port"][0][f"moe_{case}"], runs["ref"][f"moe_{case}"]
    np.testing.assert_allclose(got, want, **TOL)
    # a dropped token's output is zero on both sides: the same rows
    zero = ~got.any(-1)
    np.testing.assert_array_equal(zero, ~want.any(-1))
    send, at_expert = runs["port"][0][f"drops_{case}"]
    if case.endswith("_drop"):
        assert zero.sum() > 0 and send + at_expert > 0
    else:
        assert zero.sum() == 0


@pytest.mark.parametrize("case", list(W.ROUTE_CASES))
def test_route_shmap_matches_reference(runs, case):
    port, ref = runs["port"][0], runs["ref"]
    np.testing.assert_array_equal(port[f"route_{case}_mask"], ref[f"route_{case}_mask"])
    np.testing.assert_allclose(port[f"route_{case}_combine"], ref[f"route_{case}_combine"],
                               **TOL)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_steps_match_reference(runs, arch, what):
    got, want = runs["port"][0][f"{what}_{arch}"], runs["ref"][f"{what}_{arch}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(LOGITS_TOL if what == "prefill" else TOL))


def test_world_runs_bitwise(runs):
    first, second = runs["port"]
    assert first.keys() == second.keys()
    for key in first:
        np.testing.assert_array_equal(np.asarray(first[key]), np.asarray(second[key]),
                                      err_msg=key)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_comm_bytes_equal_the_dry_run(runs, arch, what):
    """Rank 0's bytes sent by kind in the prefill and in one decode step of
    the world of 2 equal the dry-run's account of the same cell on a
    ``DryMesh`` of 2, exactly."""
    b, s = W.PREFILL
    cell = M.ShapeCell("world", s if what == "prefill" else W.CACHE_LEN, b, what)
    rec = dryrun.account_cell(arch, cell, 2, cfg=W.smoke_cfg(arch))
    assert rec["status"] == "ok", rec.get("error")
    want = [rec["collectives"]["bytes"].get(k, 0) for k in W.COMM_KINDS]
    got = runs["port"][0][f"comm_{what}_{arch}"].tolist()
    assert got == want and sum(got) > 0


def test_world_lam_bitwise_one_process(runs, inp):
    t, e, q = W.LAM_SHAPE
    want = scd_route_probs(torch.from_numpy(inp["lam_probs"]), q=q, capacity_factor=1.25,
                           iters=4).lam
    assert float(want.max()) > 0                    # the capacity binds
    np.testing.assert_array_equal(runs["port"][0]["lam"], want.numpy())


@pytest.fixture(scope="module")
def one_process():
    """moonshot's smoke weights and a world of one here."""
    cfg = W.smoke_cfg(W.MOE_ARCH)
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, Mesh(0, 1, torch.device("cpu"))


@pytest.mark.parametrize("case", ["seq", "batch"])
def test_world_of_one_moe_train(one_process, inp, case):
    cfg, params, mesh = one_process
    p = W.moe_layer(params)
    got, drops = W.run_moe(mesh, p, inp, case)
    with torch.no_grad():
        want = moe.moe_train(p, cfg, torch.from_numpy(inp["moe_x"]))
    assert drops == [0, 0]
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_world_of_one_prefill(one_process, inp):
    cfg, params, mesh = one_process
    got, _ = W.run_steps(mesh, params, cfg, inp)
    with torch.no_grad():
        want = M.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(inp["tokens"])})
    np.testing.assert_allclose(got, want.numpy(), **TOL)
