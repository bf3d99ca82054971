"""FSDP over a world of ranks against the reference's mesh, on the CPU.

One world of 2 gloo ranks (``launch.mesh.run_local_world``) runs the cases
of ``tests/_torch_fsdp.py``; two reference subprocesses, one an arch
family (the MoE archs, gemma), run the reference's ``make_train_step``
body (``jax.value_and_grad(loss_fn)``, then ``apply_updates``, its
gradients returned), prefill and decode steps jitted under
``production_rules(False, mode)`` on a mesh of 2 XLA host devices with
Auto axes: the (2, 1) ("data", "model") mesh, where "batch" and "fsdp" are
on "data" (the port's ``sharding.FSDP_RULES`` and ``rules_for("fsdp",
mode)``), and for gemma also the (1, 2) mesh (``rules_for("production",
mode)``), with ``in_shardings`` from ``RM.shardings(cfg, cell, False)``.
Both start from the same weights (each arch's ``smoke()`` init as NumPy
trees, carried into each rank through ``carry.params_from_reference``)
and the same NumPy batches of 2 x 32 tokens. At the world tests' bars (losses and
``grad_norm`` rtol 1e-5, step 1's gradients relative L2 1e-4, the
parameters after step 1 as ``tests/test_torch_tp_train.py`` holds them):

* moonshot-v1-16b-a3b: 3 steps under "full", 1 under "zero1" (its moments
  cut by their first free dim); deepseek-v2-236b and jamba-v0.1-52b: 1
  step under "full". Their MoE routes each rank's rows over the world and
  runs every expert over a world of one, dropping past one rank's
  capacities, as the reference's does on its model axis of size 1;
* gemma-2b: 1 step in each of the five modes on (2, 1), and "fsdp_only",
  "dp_full" and "zero1" on (1, 2);
* mamba2-370m and seamless-m4t-medium: 1 step under "full" against the
  one-process port (their FFNs are dense: nothing is dropped);
* moonshot's and gemma's prefill (atol 4e-5) and 4 decode steps under
  "full".

Within the port: both ranks' losses and norms bitwise; ``train(mesh=,
rules="fsdp")`` twice bitwise, saved at step 2 and resumed bitwise; its
checkpoint the one-process layout byte for byte, restored at 1 and 2
ranks in process; the dry-run's account of a step equal to rank 0's held
and collective bytes; and the ``--rules fsdp --fsdp full`` CLI.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_fsdp as W  # noqa: E402
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import init_opt_state as r_init_opt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm, model as M, sharding as S  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
GRAD_REL_L2 = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=4e-5)     # as tests/test_torch_tp_world.py
CPU = torch.device("cpu")

REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import registry
from repro.models import model as RM, sharding as S
from repro.optim import OptConfig, apply_updates, init_opt_state

wdir, family = sys.argv[1], sys.argv[2]
with open(os.path.join(wdir, "cases.pkl"), "rb") as f:
    c = pickle.load(f)
opt = OptConfig(**c["opt"])
meshes = {"dp": jax.make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2),
          "tp": jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)}
leaves = lambda t: [np.asarray(a, np.float32) for a in jax.tree.leaves(t)]
named = lambda mesh, t: jax.tree.map(lambda q: NamedSharding(mesh, q), t,  # noqa: E731
                                     is_leaf=lambda q: isinstance(q, P))


def train(case):
    cfg = registry.get(case["arch"]).smoke().replace(fsdp_mode=case["mode"])
    mesh, batches = meshes[case["mesh"]], case["batches"]

    def step(p, s, b):
        loss, g = jax.value_and_grad(RM.loss_fn)(p, cfg, b)
        p, s, m = apply_updates(p, g, s, opt)
        return p, s, {"loss": loss, **m}, g

    with compat.set_mesh(mesh):
        S.set_rules(RM.production_rules(False, case["mode"]))
        try:
            p = jax.tree.map(jnp.asarray, c["trees"][case["arch"]])
            s = init_opt_state(p, opt)
            tokens = batches[0]["tokens"]
            cell = RM.ShapeCell("t", tokens.shape[1], tokens.shape[0], "train")
            ps, os_, bs = (named(mesh, t) for t in RM.shardings(cfg, cell, False))
            p, s = jax.device_put(p, ps), jax.device_put(s, os_)
            fn = jax.jit(step, in_shardings=(ps, os_, bs), out_shardings=(ps, os_, None, ps))
            got = {"loss": [], "grad_norm": []}
            for i, b in enumerate(batches):
                b = jax.device_put({k: jnp.asarray(v, jnp.int32) for k, v in b.items()}, bs)
                p, s, m, g = fn(p, s, b)
                got["loss"].append(float(m["loss"]))
                got["grad_norm"].append(float(m["grad_norm"]))
                if i == 0:
                    got["grads"], got["params1"] = leaves(g), leaves(p)
            return got
        finally:
            S.set_rules(None)


def forward(arch):
    cfg = registry.get(arch).smoke()
    toks = jnp.asarray(c["tokens"], jnp.int32)
    with compat.set_mesh(meshes["dp"]):
        S.set_rules(RM.production_rules(False, "full"))
        try:
            params = jax.tree.map(jnp.asarray, c["trees"][arch])
            pre = jax.jit(lambda p, b: RM.make_prefill_step(cfg)(p, b))(params,
                                                                        {"tokens": toks})
            caches = RM.init_cache(cfg, params, toks.shape[0], c["cache_len"])
            step = jax.jit(lambda p, ca, t, pos: RM.make_decode_step(cfg)(p, ca, t, pos))
            dec = []
            for t in range(c["decode_steps"]):
                lg, caches = step(params, caches, toks[:, t:t + 1], jnp.int32(t))
                dec.append(np.asarray(lg[:, 0]))
            return {"prefill": np.asarray(pre), "decode": np.stack(dec)}
        finally:
            S.set_rules(None)


out = {case["name"]: train(case) for case in c["cases"][family]}
out[f"forward_{c['forward'][family]}"] = forward(c["forward"][family])
with open(os.path.join(wdir, f"out_{family}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses, the port's world of 2 beside them, the
    one-process port on the same weights, and the CLI."""
    d = tmp_path_factory.mktemp("fsdp")
    trees = W.TW.smoke_trees(W.ARCHS)
    inp = W.inputs()
    families = {"moe": W.MOE_ARCH, "dense": W.DENSE_ARCH}
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"cases": W.reference_cases(), "opt": W.OPT, "trees": trees,
                     "tokens": inp["tokens"], "cache_len": W.CACHE_LEN,
                     "decode_steps": W.DECODE_STEPS, "forward": families}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(d), fam], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for fam in families]
    dirs = {k: str(d / k) for k in ("full", "saved")}
    try:
        cli = _cli_start(d / "cli")
        port = tmesh.run_local_world(W.world_cases, 2, (trees, inp, dirs), device="cpu",
                                     timeout=TIMEOUT)
        one = W.one_process(trees)
        cli_out = cli.communicate(timeout=TIMEOUT)
        errs = [ref.communicate(timeout=TIMEOUT)[1] for ref in refs]
    finally:
        for p in refs + [cli]:
            p.kill()
    want = {}
    for ref, err, fam in zip(refs, errs, families):
        assert ref.returncode == 0, err[-3000:]
        with open(d / f"out_{fam}.pkl", "rb") as f:
            want.update(pickle.load(f))
    return {"port": port, "ref": want, "one": one, "dirs": dirs, "trees": trees,
            "cli": (cli.returncode, *cli_out)}


def _cli_start(d):
    """``--world 2 --rules fsdp --fsdp full`` for 2 steps of smoke moonshot,
    started beside the world."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", W.MOE_ARCH,
            "--smoke", "--world", "2", "--rules", "fsdp", "--fsdp", "full", "--steps", "2",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(d), "--ckpt-every", "2",
            "--device", "cpu"]
    return subprocess.Popen(args, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grads_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if not np.any(w):
            assert not np.any(g), i
        else:
            assert _rel_l2(g, w) <= GRAD_REL_L2, (i, _rel_l2(g, w))


REF_CASES = [name for name, arch, *_ in W.train_cases() if arch not in W.ONE_ARCHS]
ONE_CASES = [name for name, arch, *_ in W.train_cases() if arch in W.ONE_ARCHS]


@pytest.mark.parametrize("case", REF_CASES)
def test_losses_and_norms_match_reference(runs, case):
    got, want = runs["port"][case], runs["ref"][case]
    assert len(got["loss"]) == len(want["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("case", REF_CASES)
def test_step_one_gradients_match_reference(runs, case):
    _grads_close(runs["port"][case]["grads"], runs["ref"][case]["grads"])


@functools.lru_cache(maxsize=None)
def _ref_apply():
    opt = ROptConfig(**W.OPT)
    return jax.jit(lambda p, g: radamw.apply_updates(p, g, r_init_opt(p, opt), opt))


@pytest.mark.parametrize("case", REF_CASES)
def test_step_one_parameters_match_reference(runs, case):
    """The world's parameters after step 1 against the reference's
    ``apply_updates`` from the same parameters, the world's gradients and a
    fresh state (``tests/test_torch_tp_train.py``'s bar)."""
    got = runs["port"][case]
    tree = runs["trees"][next(a for n, a, *_ in W.train_cases() if n == case)]
    grads = jax.tree.unflatten(jax.tree.structure(tree),
                               [g.astype(np.asarray(a).dtype)
                                for g, a in zip(got["grads"], jax.tree.leaves(tree))])
    want = _ref_apply()(tree, grads)[0]
    for g, w in zip(got["params1"], jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("case", ONE_CASES)
def test_dense_ffn_archs_match_one_process(runs, case):
    got, want = runs["port"][case], runs["one"][case.rsplit("_", 1)[0]]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    _grads_close(got["grads"], want["grads"])


@pytest.mark.parametrize("arch", [W.MOE_ARCH, W.DENSE_ARCH])
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_forward_matches_reference(runs, arch, what):
    got, want = runs["port"][f"forward_{arch}"][what], runs["ref"][f"forward_{arch}"][what]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **(LOGITS_TOL if what == "prefill" else TOL))


@pytest.mark.parametrize("case", REF_CASES + ONE_CASES)
def test_both_ranks_bitwise(runs, case):
    both = runs["port"][case]["both"]
    assert both.shape[0] == 2 and np.isfinite(both).all()
    np.testing.assert_array_equal(both[0], both[1])


def test_world_runs_bitwise(runs):
    """Two runs of ``train(mesh=, rules="fsdp")`` from one seed: the
    second's first 2 losses and its step-2 checkpoint bitwise the first's."""
    t = runs["port"]["train"]
    assert t["saved"]["losses"] == t["full"]["losses"][:W.SAVE_AT]
    step = f"step_{W.SAVE_AT:08d}"
    a, b = Path(runs["dirs"]["full"]) / step, Path(runs["dirs"]["saved"]) / step
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


def test_train_resumed_bitwise(runs):
    t = runs["port"]["train"]
    full, resumed = t["full"], t["resumed"]
    assert resumed["losses"] == full["losses"][W.SAVE_AT:]
    assert len(resumed["state"]) == len(full["state"])
    for a, b in zip(resumed["state"], full["state"]):
        np.testing.assert_array_equal(a, b)


def _like(cfg, mesh):
    meta = M.init(cfg, None, "meta")
    opt = OptConfig(**W.OPT)
    if mesh is None:
        return {"params": meta, "opt": M.init_opt(cfg, meta, opt)}
    with W.rules(S.FSDP_RULES, mesh):
        meta = M.shard_params(cfg, meta, mesh)
        return {"params": meta, "opt": M.init_opt(cfg, meta, opt, mesh)}


def test_world_checkpoint_is_the_one_process_layout(runs, tmp_path):
    """Restored whole (one process) and saved again by one process: the
    same files, byte for byte."""
    cfg = W.smoke_cfg(W.MOE_ARCH)
    src = Path(runs["dirs"]["saved"])
    back = ckpt.restore(src, W.SAVE_AT, _like(cfg, None), device_tree=CPU)
    ckpt.save(tmp_path, W.SAVE_AT, back)
    a, b = src / f"step_{W.SAVE_AT:08d}", tmp_path / f"step_{W.SAVE_AT:08d}"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


@pytest.mark.parametrize("mode", ["full", "zero1"])
@pytest.mark.parametrize("size", [1, 2])
def test_checkpoint_restores_at_each_size(runs, size, mode):
    """The state the world of 2 saved under "full", restored at ``size``
    ranks in this process (no collective) under FSDP laid out by ``mode``
    (the parameters' blocks, or under "zero1" whole parameters and the
    moments' blocks): each rank's blocks, joined, bitwise the saved
    leaves."""
    cfg = W.smoke_cfg(W.MOE_ARCH, mode)
    d = Path(runs["dirs"]["saved"]) / f"step_{W.SAVE_AT:08d}"
    per_rank, blocks = [], None
    for r in range(size):
        mesh = Mesh(r, size, CPU)
        like = _like(cfg, mesh)
        with W.rules(S.FSDP_RULES, mesh):
            blocks = M.param_blocks(cfg, like, mesh)
        per_rank.append(lm.tree_leaves(ckpt.restore(d.parent, W.SAVE_AT, like,
                                                    device_tree=CPU, blocks=blocks)))
    manifest = ckpt._read_manifest(d)["leaves"]
    assert len(per_rank[0]) == len(manifest) == len(blocks)
    n_cut = 0
    for i, (block, meta) in enumerate(zip(blocks, manifest)):
        if block is None:
            joined = per_rank[0][i]
            assert all(torch.equal(joined, leaves[i]) for leaves in per_rank)
        else:
            n_cut += 1
            joined = torch.cat([leaves[i] for leaves in per_rank], dim=block[0])
        saved = ckpt._place(ckpt._load_leaf(d, meta), meta, None)
        assert torch.equal(joined, saved), meta["path"]
    assert n_cut > 0


@pytest.mark.parametrize("arch", [W.MOE_ARCH, W.DENSE_ARCH])
def test_comm_bytes_and_held_equal_the_dry_run(runs, arch):
    """Rank 0's bytes sent by kind in a train step of the world of 2 under
    "full" (step 2: the forward's block gathers, the recompute's, the
    backward's reduce-scatters, the loss's and the norm's folds) and the
    bytes it held equal the dry-run's account of the same cell on a
    ``DryMesh`` of 2 under ``sharding.FSDP_RULES``, exactly."""
    cell = M.ShapeCell("world", W.BATCH[1], W.BATCH[0], "train")
    rec = dryrun.account_cell(arch, cell, 2, cfg=W.smoke_cfg(arch), rules=S.FSDP_RULES)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["rules"] == "fsdp"
    want = [rec["collectives"]["bytes"].get(k, 0) for k in W.COMM_KINDS]
    port = runs["port"][f"{arch}_full"]
    assert port["comm_step"].tolist() == want and want[3] > 0 and want[4] > 0
    assert port["held_step"] == rec["memory"]["held"]
    # the all-gathers are the stored blocks: each layer's twice (the forward
    # and the remat recompute gather at use), the embedding and head once
    cfg = W.smoke_cfg(arch)
    with W.rules(S.FSDP_RULES, Mesh(0, 2, CPU)):
        cut = M.shard_params(cfg, M.init(cfg, None, "meta"), Mesh(0, 2, CPU))
        blocks = M.param_blocks(cfg, cut, Mesh(0, 2, CPU))
    sent = sum(leaf.numel() * leaf.element_size() * (1 if path[0] in lm._TOP else 2)
               for (path, leaf), b in zip(lm.tree_leaves_with_paths(cut), blocks) if b)
    assert want[3] == sent


def test_cli_trains_under_fsdp(runs):
    code, out, err = runs["cli"]
    assert code == 0, out + err
    assert "done: first loss" in out
