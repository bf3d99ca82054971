"""Training under tensor and sequence parallelism over a world of ranks
against the reference's mesh, on the CPU.

One world of 2 gloo ranks (``launch.mesh.run_local_world``) runs the cases
of ``tests/_torch_tp_train.py`` under ``sharding.PRODUCTION_RULES`` (the
reference's ``production_rules(False)``: "seq", "kv_seq", "heads",
"kv_heads", "ffn", "vocab" and "experts" on the world); two reference
subprocesses, one an arch, run the reference's ``make_train_step`` body
(``jax.value_and_grad(loss_fn)``, then ``apply_updates``, its gradients
returned) jitted on a (1, 2) ("data", "model") mesh of 2 XLA host devices
with Auto axes under the same rules and ``shardings(...)``. Both start
from the same weights (each arch's ``smoke()`` init as NumPy trees,
carried into each rank through ``carry.params_from_reference``) and the
same NumPy batches of 2 x 32 tokens:

* 3 train steps (AdamW, lr 1e-3, warmup 2) of moonshot-v1-16b-a3b (its 4
  heads and 4 KV heads, 8 experts under the SCD router, the vocab and the
  sequence split) and gemma-2b (4 q heads split over its one KV head, whose
  ``wk``/``wv`` stay whole; GeGLU columns; the tied vocab): the losses and
  ``grad_norm`` within rtol 1e-5, step 1's gradients within a relative L2
  error of 1e-4 of each leaf, the parameters after step 1 at
  ``test_torch_train.py``'s ``apply_updates`` bar;
* one step at 15 positions, which D = 2 does not divide: "seq" is dropped,
  the norms see every position and their gradients are already whole
  (folding them would double them). moonshot's MoE cannot split 15
  positions over "seq" in the reference, which runs it under the batch
  binding there: each rank routes one row, the same token blocks as the
  port's replicated MoE path.

Within the port: each name of ``TP_NAMES`` bound alone against the
one-process port (rtol 1e-5, relative L2 1e-4); both ranks' losses and
norms bitwise; ``train(mesh=, rules="production")`` twice bitwise, saved
at step 2 and resumed bitwise; its checkpoint the one-process layout byte
for byte, restored at 1 and 4 ranks in process; a one-process run resumed
from it, and the world resumed from a one-process checkpoint (elastic,
2 -> 1 and 1 -> 2); the bytes of each collective kind in a step and the
bytes held equal to the dry-run's account; and the ``--rules production``
CLI.
"""
import functools
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

import _torch_tp_train as W  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import init_opt_state as r_init_opt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm, model as M, sharding as S  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
GRAD_REL_L2 = 1e-4
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

wdir, arch = sys.argv[1], sys.argv[2]
with open(os.path.join(wdir, "cases.pkl"), "rb") as f:
    c = pickle.load(f)
case = c["cases"][arch]
cfg = registry.get(arch).smoke()
opt = OptConfig(**c["opt"])
mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
leaves = lambda t: [np.asarray(a, np.float32) for a in jax.tree.leaves(t)]


def step(p, s, b):
    loss, g = jax.value_and_grad(RM.loss_fn)(p, cfg, b)
    p, s, m = apply_updates(p, g, s, opt)
    return p, s, {"loss": loss, **m}, g


def run(batches, rules):
    S.set_rules(rules)
    try:
        p = jax.tree.map(jnp.asarray, c["trees"][arch])
        s = init_opt_state(p, opt)
        put = lambda x, spec: x  # noqa: E731
        if rules is None:
            fn = jax.jit(step)
        else:
            tokens = batches[0]["tokens"]
            cell = RM.ShapeCell("t", tokens.shape[1], tokens.shape[0], "train")
            ps, os_, bs = (jax.tree.map(lambda q: NamedSharding(mesh, q), t,
                                        is_leaf=lambda q: isinstance(q, P))
                           for t in RM.shardings(cfg, cell, False))
            put = jax.device_put
            p, s = put(p, ps), put(s, os_)
            fn = jax.jit(step, in_shardings=(ps, os_, bs), out_shardings=(ps, os_, None, ps))
        got = {"loss": [], "grad_norm": []}
        for i, b in enumerate(batches):
            b = {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}
            p, s, m, g = fn(p, s, b if rules is None else put(b, bs))
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                got["grads"], got["params1"] = leaves(g), leaves(p)
        return got
    finally:
        S.set_rules(None)


with compat.set_mesh(mesh):
    out = {arch: run(case["batches"], RM.production_rules(False)),
           f"odd_{arch}": run(case["odd"], case["odd_rules"] or RM.production_rules(False))}
with open(os.path.join(wdir, f"out_{arch}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses, the port's world of 2 beside them, the
    one-process port on the same weights, and the CLI."""
    d = tmp_path_factory.mktemp("tp_train")
    trees = W.TW.smoke_trees(W.ARCHS)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"cases": W.reference_cases(), "opt": W.OPT, "trees": trees}, f)
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d), arch],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for arch in W.ARCHS]
    dirs = {k: str(d / k) for k in ("full", "saved", "one")}
    try:
        # a one-process state at SAVE_AT, which the world resumes (1 -> 2)
        _, _, one_losses = train(W.smoke_cfg(W.DENSE_ARCH), OptConfig(**W.OPT), W.SAVE_AT,
                                 ckpt_dir=dirs["one"], ckpt_every=W.SAVE_AT,
                                 seed=W.TRAIN_SEED, batch_shape=W.BATCH, log_every=0,
                                 device="cpu")
        port = tmesh.run_local_world(W.world_cases, 2, (trees, dirs), device="cpu",
                                     timeout=TIMEOUT)
        one = W.one_process(trees)
        cli = _cli_run(d / "cli")
        errs = [ref.communicate(timeout=TIMEOUT)[1] for ref in refs]
    finally:
        for ref in refs:
            ref.kill()
    want = {}
    for ref, err, arch in zip(refs, errs, W.ARCHS):
        assert ref.returncode == 0, err[-3000:]
        with open(d / f"out_{arch}.pkl", "rb") as f:
            want.update(pickle.load(f))
    return {"port": port, "ref": want, "one": one, "dirs": dirs, "trees": trees,
            "cli": cli, "one_losses": one_losses}


def _cli_run(d):
    """``--world 2 --rules production`` for 2 steps of smoke gemma."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", W.DENSE_ARCH,
            "--smoke", "--world", "2", "--rules", "production", "--steps", "2",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(d), "--ckpt-every", "2",
            "--device", "cpu"]
    return subprocess.run(args, env=env, capture_output=True, text=True, timeout=TIMEOUT)


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


@pytest.mark.parametrize("case", [f"{p}{a}" for p in ("", "odd_") for a in W.ARCHS])
def test_losses_and_norms_match_reference(runs, case):
    got, want = runs["port"][case], runs["ref"][case]
    assert len(got["loss"]) == len(want["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("case", [f"{p}{a}" for p in ("", "odd_") for a in W.ARCHS])
def test_step_one_gradients_match_reference(runs, case):
    _grads_close(runs["port"][case]["grads"], runs["ref"][case]["grads"])


@functools.lru_cache(maxsize=None)
def _ref_apply():
    opt = ROptConfig(**W.OPT)
    return jax.jit(lambda p, g: radamw.apply_updates(p, g, r_init_opt(p, opt), opt))


@pytest.mark.parametrize("arch", W.ARCHS)
def test_step_one_parameters_match_reference(runs, arch):
    """The world's parameters after step 1 against the reference's
    ``apply_updates`` from the same parameters, the world's gradients and a
    fresh state: rtol 1e-6 of each element, or 1e-6 of the leaf's largest
    element (``tests/test_torch_train_world.py``'s bar)."""
    got = runs["port"][arch]
    tree = runs["trees"][arch]
    grads = jax.tree.unflatten(jax.tree.structure(tree),
                               [g.astype(np.asarray(a).dtype)
                                for g, a in zip(got["grads"], jax.tree.leaves(tree))])
    want = _ref_apply()(tree, grads)[0]
    for g, w in zip(got["params1"], jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("name", S.TP_NAMES)
def test_each_name_alone_matches_one_process(runs, arch, name):
    got, want = runs["port"][f"alone_{name}_{arch}"], runs["one"][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    _grads_close(got["grads"], want["grads"])


@pytest.mark.parametrize("case", [f"{p}{a}" for p in ("", "odd_") for a in W.ARCHS])
def test_both_ranks_bitwise(runs, case):
    """Both ranks' losses and grad norms, every step, bit for bit."""
    both = runs["port"][case]["both"]
    assert both.shape[0] == 2 and np.isfinite(both).all()
    np.testing.assert_array_equal(both[0], both[1])


def test_world_runs_bitwise(runs):
    """Two runs of ``train(mesh=, rules="production")`` from one seed: the
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
    if mesh is not None:
        with W.rules(W.PROD, mesh):
            meta = M.shard_params(cfg, meta, mesh)
    return {"params": meta, "opt": init_opt_state(meta, OptConfig(**W.OPT))}


def test_world_checkpoint_is_the_one_process_layout(runs, tmp_path):
    """Restored whole (one process) and saved again by one process: the
    same files, byte for byte."""
    cfg = W.smoke_cfg(W.DENSE_ARCH)
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
    process (no collective) under the production rules: each rank's
    blocks (heads, FFN columns, vocab rows; gemma's one KV head whole),
    joined, bitwise the saved leaves."""
    cfg = W.smoke_cfg(W.DENSE_ARCH)
    d = Path(runs["dirs"]["saved"]) / f"step_{W.SAVE_AT:08d}"
    per_rank, blocks = [], None
    for r in range(size):
        mesh = Mesh(r, size, CPU)
        like = _like(cfg, mesh)
        blocks = M.param_blocks(cfg, like, mesh, rules=W.PROD)
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
            assert per_rank[0][i].shape[block[0]] * size == meta["shape"][block[0]]
            joined = torch.cat([leaves[i] for leaves in per_rank], dim=block[0])
        saved = ckpt._place(ckpt._load_leaf(d, meta), meta, None)
        assert torch.equal(joined, saved), meta["path"]
    assert n_cut > 0


def test_one_process_resumes_the_world_state(runs, tmp_path):
    """A one-process ``train()`` resumed from the world's step-2 state
    (2 -> 1): its step-3 loss within rtol 1e-5 of the world's."""
    d = tmp_path / "ck"
    step = f"step_{W.SAVE_AT:08d}"
    shutil.copytree(Path(runs["dirs"]["saved"]) / step, d / step)
    _, _, losses = train(W.smoke_cfg(W.DENSE_ARCH), OptConfig(**W.OPT), W.STEPS,
                         ckpt_dir=str(d), seed=W.TRAIN_SEED, batch_shape=W.BATCH,
                         log_every=0, device="cpu")
    assert len(losses) == W.STEPS - W.SAVE_AT
    np.testing.assert_allclose(losses, runs["port"]["train"]["full"]["losses"][W.SAVE_AT:],
                               rtol=1e-5)


def test_world_resumes_a_one_process_state(runs):
    """The world of 2 resumed from a one-process step-2 state (1 -> 2): its
    step-3 loss within rtol 1e-5 of the world's own uninterrupted run, and
    the one process's first losses within rtol 1e-5 of the world's."""
    t = runs["port"]["train"]
    assert len(t["from_one"]["losses"]) == W.STEPS - W.SAVE_AT
    np.testing.assert_allclose(t["from_one"]["losses"], t["full"]["losses"][W.SAVE_AT:],
                               rtol=1e-5)
    np.testing.assert_allclose(runs["one_losses"], t["full"]["losses"][:W.SAVE_AT], rtol=1e-5)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_comm_bytes_and_held_equal_the_dry_run(runs, arch):
    """Rank 0's bytes sent by kind in a train step of the world of 2 (step 2:
    the forward's, the remat recompute's and the backward's collectives,
    the gradient fold and the norm's) and the bytes it held equal the
    dry-run's account of the same cell on a ``DryMesh`` of 2 under the
    production rules, exactly."""
    cell = M.ShapeCell("world", W.BATCH[1], W.BATCH[0], "train")
    rec = dryrun.account_cell(arch, cell, 2, cfg=W.smoke_cfg(arch), rules=S.PRODUCTION_RULES)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["rules"] == "production"
    want = [rec["collectives"]["bytes"].get(k, 0) for k in W.COMM_KINDS]
    port = runs["port"][arch]
    assert port["comm_step"].tolist() == want and sum(want) > 0
    assert port["held_step"] == rec["memory"]["held"]


def test_cli_trains_under_the_production_rules(runs):
    proc = runs["cli"]
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: first loss" in proc.stdout


def test_the_gradient_fold_knows_every_whole_leaf():
    """``model._whole_leaf_split`` classifies every leaf of the attention
    archs and of the MLA, Mamba2, hybrid and encoder-decoder archs (the
    attention's leaves by the heads, MLA's ``wq_a``/``wkv_a`` and norms
    too, the encoder-decoder's self and cross attention too; Mamba2's by
    its SSD heads, its whole ``in_proj`` and conv included; the router by
    the routed tokens; the rest by the residual) and refuses a leaf it does
    not know, such as a router bias or a mixer leaf outside the table."""
    from repro_torch.configs import registry
    ssm = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "out_proj")
    for arch in ("gemma-2b", "moonshot-v1-16b-a3b", "qwen3-4b", "yi-34b", "deepseek-v2-236b",
                 "mamba2-370m", "jamba-v0.1-52b", "seamless-m4t-medium"):
        params = M.init(registry.get(arch).smoke(), None, "meta")
        for path, _ in lm.tree_leaves_with_paths(params):
            split = M._whole_leaf_split(path)
            attn = any(k in path for k in ("mixer", "attn", "self", "cross"))
            want = ("ssm" if attn and (path[-1] in ssm or "out_norm" in path)
                    else "heads" if attn else "routed" if path[-1] == "router" else None)
            assert split == want, (arch, path)
    for path in (("slots", 0, "ffn", "router_bias"), ("slots", 0, "mixer", "sinks")):
        with pytest.raises(NotImplementedError, match="does not know the whole leaf"):
            M._whole_leaf_split(path)
