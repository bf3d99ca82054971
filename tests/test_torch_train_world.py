"""Training over a world of ranks against the reference's mesh path, on the
CPU.

One world of 2 gloo ranks (``launch.mesh.run_local_world``) runs the cases
of ``tests/_torch_train_world.py``; one reference subprocess runs the same
cases on a (1, 2) ("data", "model") mesh of 2 XLA host devices with Auto
axes under the batch binding (``make_train_step``'s body, jitted, with
its gradients returned). Both start from the same weights (each arch's
``smoke()`` init as NumPy trees, carried into each rank through
``carry.params_from_reference``) and the same NumPy batches of 4 x 64
tokens:

* 3 train steps (AdamW, lr 1e-3, warmup 2) of moonshot-v1-16b-a3b at its
  capacity factor and at 0.3 (``cap_send`` and ``cap_e`` drop pairs), of
  deepseek-v2-236b, and of moonshot with ``compress_grads``: the losses
  and ``grad_norm`` within rtol 1e-5; step 1's gradients within a relative
  L2 error of 1e-4 of each leaf (a leaf the reference leaves at 0 is 0);
  the parameters after step 1 at ``test_torch_train.py``'s
  ``apply_updates`` bar (rtol 1e-6 of the element or of the leaf's largest
  element); AdamW's normalisation amplifies the last bits of tiny
  gradients, so later parameters are not held;
* one MoE layer (``moe_train``, tokens cut by sequence and by batch, at
  capacity 1.25 and 0.3): its output and the gradients of its input,
  router and experts within rtol 1e-5, atol 1e-5, and the dropped rows
  (zero in the output and in the input's gradient) equal.

Within the port: two runs bitwise; ``train(mesh=)`` saved at step 2 and
resumed to step 3 bitwise the uninterrupted run; the world's checkpoint
is a one-process save of the whole tree byte for byte, and restores at 1
and 4 ranks (each rank's blocks, joined, bitwise the saved leaves; no
collective); a one-process run resumed from it gives the world's step-3
loss within rtol 1e-5; a world of one in this process matches the
one-process step; the ``--world 2`` CLI killed by ``--simulate-failure-at``
and resumed.
"""
import functools
import os
import pickle
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

import _torch_moe_world as MW  # noqa: E402
import _torch_train_world as W  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import init_opt_state as r_init_opt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.carry import params_from_reference  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm, model as M, moe, sharding as S  # noqa: E402
from repro_torch.optim import OptConfig, apply_updates, init_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-4
CPU = torch.device("cpu")

REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.configs import registry
from repro.models import model as RM, moe as Rmoe, sharding as S
from repro.optim import OptConfig, apply_updates, init_opt_state

wdir, group = sys.argv[1], sys.argv[2].split(",")
with open(os.path.join(wdir, "cases.pkl"), "rb") as f:
    c = pickle.load(f)


def config(arch, cf):
    cfg = registry.get(arch).smoke()
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
leaves = lambda t: [np.asarray(a, np.float32) for a in jax.tree.leaves(t)]
with set_mesh(mesh):
    for name, case in c["cases"].items():
        if name not in group:
            continue
        cfg = config(case["arch"], case["capacity_factor"])
        opt = OptConfig(compress_grads=case["compress"], **c["opt"])
        S.set_rules(c["batch_rules"])

        def step(p, s, b, cfg=cfg, opt=opt):
            loss, g = jax.value_and_grad(RM.loss_fn)(p, cfg, b)
            p, s, m = apply_updates(p, g, s, opt)
            return p, s, {"loss": loss, **m}, g

        step = jax.jit(step)
        p = jax.tree.map(jnp.asarray, c["trees"][case["arch"]])
        s = init_opt_state(p, opt)
        got = {"loss": [], "grad_norm": []}
        for i, b in enumerate(case["batches"]):
            p, s, m, g = step(p, s, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                got["grads"], got["params1"] = leaves(g), leaves(p)
        out[name] = got
        S.set_rules(None)
    moe_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         c["trees"][c["moe_arch"]]["slots"][0]["ffn"])
    x, w = jnp.asarray(c["moe_x"]), jnp.asarray(c["cotangent"])
    for name, (rules, cf) in c["moe_cases"].items():
        if "moe" not in group:
            break
        cfg = config(c["moe_arch"], cf)
        S.set_rules(rules)
        fn = jax.jit(jax.value_and_grad(
            lambda p, x, cfg=cfg: (jnp.sum(Rmoe.moe_train(p, cfg, x) * w),
                                   Rmoe.moe_train(p, cfg, x)), argnums=(0, 1), has_aux=True))
        (_, y), (gp, gx) = fn(moe_p, x)
        out[f"moe_{name}"] = {"y": np.asarray(y), "dx": np.asarray(gx),
                              **{k: np.asarray(v) for k, v in gp.items()}}
        S.set_rules(None)
with open(os.path.join(wdir, f"out_{group[0]}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""
# The reference's cases in two processes, side by side (their compiles
# take most of the file's wall): moonshot's three, deepseek's and the MoE
# layer's.
REF_GROUPS = (("moonshot", "moonshot_drop", "moonshot_compress"), ("deepseek", "moe"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's world of 2, side by side;
    the world's checkpoint directories."""
    d = tmp_path_factory.mktemp("train_world")
    inp = MW.inputs()
    cotangent = np.random.default_rng(7).standard_normal(inp["moe_x"].shape).astype(np.float32)
    trees = MW.smoke_trees()
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"cases": W.reference_cases(), "opt": W.OPT, "trees": trees,
                     "batch_rules": S.BATCH_RULES, "moe_arch": W.MOE_ARCH,
                     "moe_cases": MW.MOE_CASES, "moe_x": inp["moe_x"],
                     "cotangent": cotangent}, f)
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d), ",".join(group)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for group in REF_GROUPS]
    dirs = {"full": str(d / "full"), "saved": str(d / "saved")}
    try:
        port = tmesh.run_local_world(W.world_cases, 2,
                                     (trees, inp, cotangent, dirs["full"], dirs["saved"]),
                                     device="cpu", timeout=TIMEOUT)
        cli = _cli_runs(d / "cli")
        errs = [ref.communicate(timeout=TIMEOUT)[1] for ref in refs]
    finally:
        for ref in refs:
            ref.kill()
    want = {}
    for ref, err, group in zip(refs, errs, REF_GROUPS):
        assert ref.returncode == 0, err[-3000:]
        with open(d / f"out_{group[0]}.pkl", "rb") as f:
            want.update(pickle.load(f))
    return {"port": port, "ref": want, "dirs": dirs, "trees": trees, "cli": cli}


def _cli_runs(d):
    """The ``--world 2`` CLI killed after step 3 (``--simulate-failure-at``)
    and rerun: each run's process and the newest step after it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", W.MOE_ARCH,
            "--smoke", "--world", "2", "--steps", "4", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(d), "--ckpt-every", "2", "--device", "cpu"]
    out = []
    for extra in (["--simulate-failure-at", "3"], []):
        proc = subprocess.run(args + extra, env=env, capture_output=True, text=True,
                              timeout=TIMEOUT)
        out.append((proc, ckpt.latest_step(d)))
    return out


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", list(W.CASES))
def test_losses_and_norms_match_reference(runs, case):
    got = runs["port"][case]
    want = runs["ref"][case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("case", list(W.CASES))
def test_step_one_gradients_match_reference(runs, case):
    got = runs["port"][case]
    want = runs["ref"][case]["grads"]
    assert len(got["grads"]) == len(want)
    for i, (g, w) in enumerate(zip(got["grads"], want)):
        assert g.shape == w.shape, i
        if not np.any(w):
            assert not np.any(g), i
        else:
            assert _rel_l2(g, w) <= GRAD_REL_L2, (i, _rel_l2(g, w))


@functools.lru_cache(maxsize=None)
def _ref_apply(case):
    """The reference's jitted ``apply_updates`` for the case's settings."""
    opt = ROptConfig(compress_grads=W.CASES[case][2], **W.OPT)
    return jax.jit(lambda p, g: radamw.apply_updates(p, g, r_init_opt(p, opt), opt))


@pytest.mark.parametrize("case", list(W.CASES))
def test_step_one_parameters_match_reference(runs, case):
    """The world's parameters after step 1 against the reference's
    ``apply_updates`` from the same parameters, the world's gradients and
    a fresh state, at ``test_torch_train.py``'s ``apply_updates`` bar:
    rtol 1e-6 of each element, or 1e-6 of the leaf's largest element.
    (From each side's own gradients the two differ where a gradient
    element is near AdamW's eps, and so do the reference's own mesh and
    one device.)"""
    got = runs["port"][case]
    tree = runs["trees"][W.CASES[case][0]]
    treedef = jax.tree.structure(tree)
    grads = jax.tree.unflatten(treedef, [g.astype(np.asarray(a).dtype) for g, a in
                                         zip(got["grads"], jax.tree.leaves(tree))])
    want = _ref_apply(case)(tree, grads)[0]
    for g, w in zip(got["params1"], jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("case", ["moonshot", "moonshot_drop", "deepseek"])
def test_comm_bytes_equal_the_dry_run(runs, case):
    """Rank 0's bytes sent by kind in a train step of the world of 2 (step 2)
    equal the dry-run's account of the same cell on a ``DryMesh`` of 2,
    exactly (dropped pairs change no buffer's size)."""
    from repro_torch.launch import dryrun

    cell = M.ShapeCell("world", W.BATCH[1], W.BATCH[0], "train")
    rec = dryrun.account_cell(W.CASES[case][0], cell, 2, cfg=W.case_cfg(case))
    assert rec["status"] == "ok", rec.get("error")
    want = [rec["collectives"]["bytes"].get(k, 0) for k in MW.COMM_KINDS]
    got = runs["port"][case]["comm_step"].tolist()
    assert got == want and sum(got) > 0


def test_pairs_drop_only_below_capacity(runs):
    port = runs["port"]
    assert sum(port["moonshot_drop"]["dropped"]) > 0
    assert port["moonshot"]["dropped"] == [0, 0]


@pytest.mark.parametrize("case", list(MW.MOE_CASES))
def test_moe_layer_gradients_match_reference(runs, case):
    got, want = runs["port"][f"moe_{case}"], runs["ref"][f"moe_{case}"]
    for key in ("y", "dx", "router", "wi", "wo"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    # a token whose pairs all dropped: zero output, zero gradient, both sides
    for key in ("y", "dx"):
        np.testing.assert_array_equal(~got[key].any(-1), ~want[key].any(-1))
    zero = ~got["y"].any(-1)
    if case.endswith("_drop"):
        assert zero.sum() > 0 and sum(got["dropped"]) > 0
    else:
        assert zero.sum() == 0 and got["dropped"] == [0, 0]


def test_world_runs_bitwise(runs):
    """Two runs of ``train(mesh=)`` from one seed: the second's first 2
    losses and its step-2 checkpoint bitwise the first's."""
    t = runs["port"]["train"]
    assert t["saved"]["losses"] == t["full"]["losses"][:W.SAVE_AT]
    step = f"step_{W.SAVE_AT:08d}"
    a, b = Path(runs["dirs"]["full"]) / step, Path(runs["dirs"]["saved"]) / step
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


def test_train_resumed_bitwise(runs):
    """``train(mesh=)`` resumed from step 2 to step 3 ends bitwise the
    uninterrupted run."""
    t = runs["port"]["train"]
    full, resumed = t["full"], t["resumed"]
    assert resumed["losses"] == full["losses"][W.SAVE_AT:]
    assert len(resumed["state"]) == len(full["state"])
    for a, b in zip(resumed["state"], full["state"]):
        np.testing.assert_array_equal(a, b)


def _like(cfg, mesh):
    meta = S.shard_experts(M.init(cfg, None, "meta"), mesh)
    return {"params": meta, "opt": init_opt_state(meta, OptConfig(**W.OPT))}


def test_world_checkpoint_is_the_one_process_layout(runs, tmp_path):
    """Restored whole (one process) and saved again by one process: the
    same files, byte for byte."""
    cfg = MW.smoke_cfg(W.MOE_ARCH)
    src = Path(runs["dirs"]["saved"])
    back = ckpt.restore(src, W.SAVE_AT, _like(cfg, None), device_tree=CPU)
    ckpt.save(tmp_path, W.SAVE_AT, back)
    a, b = src / f"step_{W.SAVE_AT:08d}", tmp_path / f"step_{W.SAVE_AT:08d}"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


@pytest.mark.parametrize("size", [1, 4])
def test_elastic_restore(runs, size):
    """The state the world of 2 saved, restored at ``size`` ranks in this
    process (no collective): each rank's blocks, joined, bitwise the saved
    leaves and the world's own state."""
    cfg = MW.smoke_cfg(W.MOE_ARCH)
    d = runs["dirs"]["saved"]
    per_rank = []
    for r in range(size):
        mesh = Mesh(r, size, CPU)
        like = _like(cfg, mesh)
        per_rank.append(ckpt.restore(d, W.SAVE_AT, like, device_tree=CPU,
                                     blocks=W.blocks(cfg, like, mesh)))
    axes = [None if b is None else b[0]
            for b in W.blocks(cfg, per_rank[0], Mesh(0, size, CPU))]
    manifest = ckpt._read_manifest(Path(d) / f"step_{W.SAVE_AT:08d}")["leaves"]
    leaves = [lm.tree_leaves(t) for t in per_rank]
    assert len(leaves[0]) == len(manifest) == len(axes)
    n_cut = 0
    for i, (ax, meta) in enumerate(zip(axes, manifest)):
        if ax is None:
            joined = leaves[0][i]
            assert all(torch.equal(joined, leaf[i]) for leaf in leaves)
        else:
            n_cut += 1
            assert leaves[0][i].shape[ax] * size == meta["shape"][ax]
            joined = torch.cat([leaf[i] for leaf in leaves], dim=ax)
        saved = ckpt._place(ckpt._load_leaf(Path(d) / f"step_{W.SAVE_AT:08d}", meta), meta,
                            None)
        assert torch.equal(joined, saved), meta["path"]
    assert n_cut > 0


def test_blocked_save_of_bf16_leaves(tmp_path):
    """A save through the blocked path (a world of one: every expert leaf
    one block) of a tree with bf16 leaves is byte for byte the plain save,
    and its expert leaves restore in halves, bitwise."""
    cfg = MW.smoke_cfg(W.MOE_ARCH).replace(param_dtype=torch.bfloat16)
    params = M.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    mesh = Mesh(0, 1, CPU)
    ckpt.save(tmp_path / "plain", 1, {"params": params})
    ckpt.save(tmp_path / "blocked", 1, {"params": params}, mesh=mesh,
              blocks=W.blocks(cfg, {"params": params}, mesh))
    a, b = tmp_path / "plain" / "step_00000001", tmp_path / "blocked" / "step_00000001"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    for f in a.iterdir():
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name
    halves = []
    for r in range(2):
        half = Mesh(r, 2, CPU)
        like = {"params": S.shard_experts(M.init(cfg, None, "meta"), half)}
        halves.append(ckpt.restore(b.parent, 1, like, device_tree=CPU,
                                   blocks=W.blocks(cfg, like, half)))
    for i, b in enumerate(W.blocks(cfg, {"params": params}, mesh)):
        ax = None if b is None else b[0]
        parts = [lm.tree_leaves(h)[i] for h in halves]
        want = lm.tree_leaves({"params": params})[i]
        got = parts[0] if ax is None else torch.cat(parts, dim=ax)
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_elastic_restore_refuses_uneven_blocks(runs):
    cfg = MW.smoke_cfg(W.MOE_ARCH)
    e = cfg.moe.n_experts
    with pytest.raises(ValueError, match=f"{e} experts do not split over a world of 3"):
        _like(cfg, Mesh(0, 3, CPU))
    like = _like(cfg, None)
    blocks = [None if b is None else (b[0], 0, 3)
              for b in W.blocks(cfg, like, Mesh(0, 1, CPU))]
    with pytest.raises(ValueError, match="do not split into 3 equal blocks"):
        ckpt.restore(runs["dirs"]["saved"], W.SAVE_AT, like, blocks=blocks)


def test_one_process_resumes_the_world_state(runs, tmp_path):
    """A one-process ``train()`` resumed from the world's step-2 state: its
    step-3 loss within rtol 1e-5 of the world's."""
    d = tmp_path / "ck"
    step = f"step_{W.SAVE_AT:08d}"
    shutil.copytree(Path(runs["dirs"]["saved"]) / step, d / step)
    _, _, losses = train(MW.smoke_cfg(W.MOE_ARCH), OptConfig(**W.OPT), W.STEPS,
                         ckpt_dir=str(d), seed=W.TRAIN_SEED, batch_shape=W.BATCH,
                         log_every=0, device="cpu")
    assert len(losses) == W.STEPS - W.SAVE_AT
    np.testing.assert_allclose(losses, runs["port"]["train"]["full"]["losses"][W.SAVE_AT:],
                               rtol=1e-5)


def test_world_of_one_matches_one_process(runs):
    """One train step over a world of one in this process (the a2a path,
    the router without the §5.4 projection) against the one-process step:
    loss and ``grad_norm`` within rtol 1e-5, each gradient within a
    relative L2 error of 1e-4; the world's update from the one-process
    gradients bitwise the one-process update."""
    cfg, opt = W.case_cfg("moonshot"), W.opt_cfg("moonshot")
    tree = runs["trees"][W.MOE_ARCH]
    batch = {k: torch.from_numpy(v) for k, v in W.batches("moonshot")[0].items()}
    out = []
    for mesh in (None, Mesh(0, 1, CPU)):
        params = params_from_reference(tree, cfg, CPU)
        S.set_rules(None if mesh is None else S.BATCH_RULES, mesh=mesh)
        try:
            loss, grads = M.loss_and_grads(params, cfg, batch)
            want = out[0][1] if out else grads
            _, _, m = apply_updates(params, want, init_opt_state(params, opt), opt, mesh=mesh,
                                    blocks=None if mesh is None else W.blocks(cfg, params, mesh))
        finally:
            S.set_rules(None)
        out.append((loss, grads, m, lm.tree_leaves(params)))
    (l1, g1, m1, p1), (l2, g2, m2, p2) = out
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for a, b in zip(lm.tree_leaves(g2), lm.tree_leaves(g1)):
        assert _rel_l2(a.numpy(), b.numpy()) <= GRAD_REL_L2
    assert torch.equal(m2["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(p2, p1))
    step = M.make_train_step(cfg, opt)
    norms = []
    for mesh in (None, Mesh(0, 1, CPU)):
        params = params_from_reference(tree, cfg, CPU)
        S.set_rules(None if mesh is None else S.BATCH_RULES, mesh=mesh)
        try:
            norms.append(float(step(params, init_opt_state(params, opt), batch)[2]["grad_norm"]))
        finally:
            S.set_rules(None)
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)


def test_recompute_replays_the_forward_rules_on_another_thread(runs):
    """On the card autograd runs the backward, and the remat recompute in it,
    on a thread of its own, where the (per-thread) rules are unset: the
    recompute runs under the forward's rules. A backward started on another
    thread gives the gradients of one on this thread, bit for bit, and the
    recompute counts no dropped pair."""
    cfg = MW.smoke_cfg(W.MOE_ARCH, 0.3)
    batch = {k: torch.from_numpy(v) for k, v in W.batches("moonshot_drop")[0].items()}
    mesh = Mesh(0, 1, CPU)
    out = []
    for threaded in (False, True):
        params = params_from_reference(runs["trees"][W.MOE_ARCH], cfg, CPU)
        for p in lm.tree_leaves(params):
            p.requires_grad_(True)
        moe.reset_dropped()
        S.set_rules(S.BATCH_RULES, mesh=mesh)
        try:
            loss = M.loss_fn(params, cfg, batch)
            forward = dict(moe.DROPPED)
            if threaded:
                t = threading.Thread(target=loss.backward)
                t.start()
                t.join(timeout=TIMEOUT)
                assert not t.is_alive()
            else:
                loss.backward()
        finally:
            S.set_rules(None)
        assert dict(moe.DROPPED) == forward and sum(forward.values()) > 0
        out.append([p.grad for p in lm.tree_leaves(params)])
    assert all(g is not None for g in out[1])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_what_takes_a_mesh_refuses_anything_else(tmp_path):
    cfg = MW.smoke_cfg(W.MOE_ARCH)
    with pytest.raises(TypeError, match="Mesh"):
        train(cfg, OptConfig(), 1, mesh=object(), device="cpu")
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ckpt.save(tmp_path, 1, {"p": params}, mesh="world")
    state = init_opt_state(params, OptConfig())
    with pytest.raises(TypeError, match="Mesh"):
        apply_updates(params, lm.tree_map(torch.zeros_like, params), state, OptConfig(),
                      mesh=2)


def test_world_cli_killed_and_resumed(runs):
    """``--world 2`` with ``--simulate-failure-at 3`` exits 42 with step 2
    saved; the rerun resumes from step 2 and finishes."""
    (first, after_first), (second, after_second) = runs["cli"]
    assert first.returncode == 42, first.stdout + first.stderr
    assert after_first == 2
    assert second.returncode == 0, second.stdout + second.stderr
    assert second.stdout.count("resumed from step 2") == 1
    assert "done" in second.stdout
    assert after_second == 4
