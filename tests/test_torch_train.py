"""The port's LM training path against the reference (``src/repro/optim``,
``models/lm.lm_loss``, ``models/model.make_train_step``,
``launch/train.py``, ``data/synth.py``) on the CPU, at ``smoke()`` size in
float32.

The reference draws its weights, batches and shards from ``jax.random``,
which torch cannot reproduce, so the parameters cross into the port
through ``carry.params_from_reference``, the optimizer state through
``carry.opt_state_from_reference``, and one numpy batch goes to both.
Tolerances: the loss within rtol 1e-5; each gradient leaf within a
relative L2 error of 1e-4 of the reference's (a leaf the reference's
gradient leaves at exactly 0 is 0 in the port too), ``grad_norm`` within
rtol 1e-5 (the same float32 operations summed in other orders, BLAS
against XLA); ``apply_updates`` from the same parameters, gradients and
state within rtol 1e-6 (of the leaf's largest element where XLA's FMA
in ``p - lr*delta`` meets a cancelling update);
five train steps' losses within rtol 1e-3. Within the port: remat against
no remat, a resumed run against an uninterrupted one and the sliced
in-place update against the whole-leaf one, bitwise.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401
jnp = jax.numpy

from repro.checkpoint import ckpt as rckpt  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.data import synth as rsynth  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import init_opt_state as r_init_opt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.paper_kp import KPWorkload  # noqa: E402
from repro_torch.core.carry import opt_state_from_reference, params_from_reference  # noqa: E402
from repro_torch.data.synth import kp_shard, lm_batch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm as Tlm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as Tmoe  # noqa: E402
from repro_torch.optim import OptConfig, OptState, apply_updates, init_opt_state  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_leaves_with_paths  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORTED = ["gemma-2b", "qwen3-4b", "starcoder2-3b", "yi-34b", "internvl2-26b",
          "moonshot-v1-16b-a3b", "mamba2-370m", "jamba-v0.1-52b", "seamless-m4t-medium",
          "deepseek-v2-236b"]
GRAD_REL_L2 = 1e-4


@functools.lru_cache(maxsize=None)
def _arch(name, dtype="float32"):
    """(reference cfg, port cfg, reference params as numpy) at smoke(); in
    bf16 the float32 tree rounded, the router kept in float32 as the
    reference's init keeps it."""
    rcfg, tcfg = rreg.get(name).smoke(), treg.get(name).smoke()
    if dtype == "bfloat16":
        rcfg = rcfg.replace(param_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(param_dtype=torch.bfloat16)
        rp = jax.tree_util.tree_map_with_path(
            lambda path, a: a if "router" in jax.tree_util.keystr(path)
            else np.asarray(jnp.asarray(a, jnp.bfloat16)), _arch(name)[2])
        return rcfg, tcfg, rp
    rp = jax.tree.map(np.asarray, RM.init(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tcfg, rp


def _port_params(name, dtype="float32"):
    """A fresh carried copy: the port updates its parameters in place."""
    _, tcfg, rp = _arch(name, dtype)
    return params_from_reference(rp, tcfg, "cpu")


def _batch(cfg, seed, b=2, s=64):
    """One numpy batch, as the reference's and as the port's."""
    g = np.random.default_rng(seed)
    arrs = {"tokens": g.integers(0, cfg.vocab, (b, s)),
            "targets": g.integers(0, cfg.vocab, (b, s))}
    if cfg.n_patches:
        arrs["patches"] = g.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        arrs["frames"] = g.standard_normal((b, 32, cfg.d_model)).astype(np.float32)
    return _both(arrs)


def _both(arrs):
    ref = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
           for k, v in arrs.items()}
    return ref, {k: torch.from_numpy(v) for k, v in arrs.items()}


def _np(t):
    return t.detach().float().numpy()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name):
    """The reference's jitted loss, gradients and ``apply_updates``'s
    ``grad_norm`` of them."""
    rcfg, _, _ = _arch(name)

    def fn(p, b):
        loss, g = jax.value_and_grad(RM.loss_fn)(p, rcfg, b)
        norm = radamw.apply_updates(p, g, r_init_opt(p, ROptConfig()),
                                    ROptConfig())[2]["grad_norm"]
        return loss, g, norm
    return jax.jit(fn)


@pytest.mark.parametrize("name", PORTED)
def test_loss_and_grads_match_reference(name):
    rcfg, tcfg, rp = _arch(name)
    rb, tb = _batch(rcfg, 11)
    want_loss, want_g, want_norm = _ref_value_and_grad(name)(rp, rb)

    tp = _port_params(name)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss = TM.loss_fn(tp, tcfg, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = [_np(p.grad) for p in tree_leaves(tp)]
    want = [np.asarray(g, np.float32) for g in jax.tree.leaves(want_g)]
    assert len(got) == len(want)
    for (path, _), g, w in zip(tree_leaves_with_paths(tp), got, want):
        assert g.shape == w.shape, path
        if not np.any(w):
            assert not np.any(g), path
        else:
            assert _rel_l2(g, w) <= GRAD_REL_L2, (path, _rel_l2(g, w))
    grads = Tlm.tree_map(lambda p: p.grad, tp)
    state = init_opt_state(tp, OptConfig())
    norm = apply_updates(tp, grads, state, OptConfig())[2]["grad_norm"]
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-5)


def _random_state(rng, params, compress):
    f32 = lambda p: rng.standard_normal(p.shape).astype(np.float32)  # noqa: E731
    mu = jax.tree.map(lambda p: f32(p) * 1e-3, params)
    nu = jax.tree.map(lambda p: np.abs(f32(p)) * 1e-5, params)
    err = jax.tree.map(lambda p: f32(p) * 1e-4, params) if compress else None
    return radamw.OptState(np.int32(3), mu, nu, err)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype,clipped", [("float32", False), ("bfloat16", False),
                                           ("float32", True)])
def test_apply_updates_matches_reference(compress, dtype, clipped):
    """From the same parameters, gradients and state (step 3, moments and
    error feedback nonzero): new parameters, mu, nu and err within rtol
    1e-6 of each element, or of the leaf's largest element where the
    element is far below it: XLA rounds ``p - lr*delta`` once (an FMA), so
    where the update cancels most of a parameter the two differ by an ulp
    of ``lr*delta``; likewise ``err = (g + err) - q*scale``, held on the
    scale of ``g + err``. ``grad_norm`` within rtol 1e-5: a float32 sum over
    every gradient, in an order XLA chooses. Clipped, the scale is ``clip /
    grad_norm``."""
    rcfg, tcfg, rp = _arch("moonshot-v1-16b-a3b", dtype)
    rng = np.random.default_rng(4)
    std = 3e-2 if clipped else 3e-5
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * std).astype(p.dtype), rp)
    state = _random_state(rng, rp, compress)
    rcfg_opt = ROptConfig(lr=1e-3, warmup=5, compress_grads=compress)
    want_p, want_s, want_m = jax.jit(lambda p, g, s: radamw.apply_updates(
        p, g, s, rcfg_opt))(rp, grads, state)

    tp = params_from_reference(rp, tcfg)
    tstate = opt_state_from_reference(state, tcfg)
    tgrads = params_from_reference(grads, tcfg)
    cfg_opt = OptConfig(lr=1e-3, warmup=5, compress_grads=compress)
    got_p, got_s, got_m = apply_updates(tp, tgrads, tstate, cfg_opt)
    assert (float(want_m["grad_norm"]) > cfg_opt.clip_norm) == clipped
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]), rtol=1e-7)
    assert int(got_s.step) == int(want_s.step) == 4
    assert got_s.step.dtype == torch.int32
    leaf_max = lambda tree: [float(np.abs(np.asarray(w, np.float32)).max())  # noqa: E731
                             for w in jax.tree.leaves(tree)]
    pairs = [(got_p, want_p, leaf_max(want_p)), (got_s.mu, want_s.mu, leaf_max(want_s.mu)),
             (got_s.nu, want_s.nu, leaf_max(want_s.nu))]
    if compress:
        # err = (g + err) - q*scale cancels (g + err): XLA's FMA rounds it
        # once, so its scale is that of g + err
        g_err = jax.tree.map(lambda g, e: np.abs(g.astype(np.float32)) + np.abs(e),
                             grads, state.err)
        pairs.append((got_s.err, want_s.err, leaf_max(g_err)))
    else:
        assert got_s.err is None and want_s.err is None
    for got, want, scales in pairs:
        for g, w, top in zip(tree_leaves(got), jax.tree.leaves(want), scales):
            assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=1e-6,
                                       atol=1e-6 * top)


@pytest.mark.parametrize("compress", [False, True])
def test_sliced_update_bitwise_whole_leaf(compress, monkeypatch):
    """The period-sliced in-place update equals the whole-leaf update bit
    for bit (clip scale 1 on both); the global norm within rtol 1e-6 of the
    whole-leaf sums."""
    _, tcfg, rp = _arch("moonshot-v1-16b-a3b", "bfloat16")
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3e-2).astype(p.dtype), rp)
    state = _random_state(rng, rp, compress)
    cfg_opt = OptConfig(lr=1e-3, warmup=5, clip_norm=1e9, compress_grads=compress)
    runs = []
    for whole in (False, True):
        if whole:
            monkeypatch.setattr(adamw, "_slices", lambda path, t: (t,))
        tp = params_from_reference(rp, tcfg)
        runs.append(apply_updates(tp, params_from_reference(grads, tcfg),
                                  opt_state_from_reference(state, tcfg), cfg_opt))
    (p1, s1, m1), (p2, s2, m2) = runs
    assert any(path[0] == "slots" and leaf.shape[0] == tcfg.n_periods
               for path, leaf in tree_leaves_with_paths(p1))
    for a, b in zip(tree_leaves([p1, s1.mu, s1.nu, s1.err]),
                    tree_leaves([p2, s2.mu, s2.nu, s2.err])):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-6)


def test_grad_compression_error_feedback():
    """int8 EF compression: biased per step, unbiased over steps (the error
    accumulator re-injects what quantisation dropped); the reference's
    test, on the port's ``compress_decompress``."""
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=(256,)) * 1e-3, dtype=torch.float32)
    err = torch.zeros_like(g)
    total_sent = torch.zeros_like(g)
    for _ in range(50):
        sent, err = adamw.compress_decompress(g, err)
        total_sent = total_sent + sent
    np.testing.assert_allclose(total_sent.numpy(), g.numpy() * 50, rtol=0.05, atol=1e-5)
    want = radamw.compress_decompress(jnp.asarray(g.numpy()), jnp.zeros(256, jnp.float32))
    got = adamw.compress_decompress(g, torch.zeros_like(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "gemma-2b"])
def test_remat_bitwise_and_masks_recomputed(name, monkeypatch):
    """``remat=True`` and ``remat=False`` give the same loss and gradients
    bit for bit; under the SCD router the backward's recompute routes every
    layer again, to the forward's masks."""
    _, tcfg, _ = _arch(name)
    _, tb = _batch(tcfg, 12)
    masks = []
    route = Tmoe._route

    def recording(*a, **kw):
        out = route(*a, **kw)
        masks.append(out[1].clone())
        return out

    monkeypatch.setattr(Tmoe, "_route", recording)
    runs = []
    for remat in (True, False):
        masks.clear()
        tp = _port_params(name)
        for p in tree_leaves(tp):
            p.requires_grad_(True)
        loss = TM.loss_fn(tp, tcfg.replace(remat=remat), tb)
        n_forward = len(masks)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in tree_leaves(tp)], list(masks), n_forward))
    (l1, g1, m1, f1), (l2, g2, m2, f2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    n = tcfg.n_layers if tcfg.moe.n_experts else 0
    assert (f1, len(m1), f2, len(m2)) == (n, 2 * n, n, n)
    # the backward recomputes the layers last to first
    assert all(torch.equal(a, b) for a, b in zip(m1[:n], m1[n:][::-1]))
    if n:
        assert tcfg.moe.router == "scd"


def test_trajectory_matches_reference():
    """Five train steps from carried parameters and the port's batches:
    the losses within rtol 1e-3 of the reference's jitted step's."""
    name = "moonshot-v1-16b-a3b"
    rcfg, tcfg, rp = _arch(name)
    rcfg_opt, cfg_opt = ROptConfig(lr=1e-3, warmup=2), OptConfig(lr=1e-3, warmup=2)
    rstep = jax.jit(RM.make_train_step(rcfg, rcfg_opt))
    tstep = TM.make_train_step(tcfg, cfg_opt)
    rs = r_init_opt(rp, rcfg_opt)
    tp, ts = _port_params(name), opt_state_from_reference(
        jax.tree.map(np.asarray, r_init_opt(rp, rcfg_opt)), tcfg)
    rl, tl = [], []
    for step in range(5):
        b = lm_batch(tcfg, (2, 64), step, seed=2, device="cpu")
        rb, tb = _both({k: v.numpy() for k, v in b.items()})
        rp, rs, rm = rstep(rp, rs, rb)
        tp, ts, tm = tstep(tp, ts, tb)
        rl.append(float(rm["loss"]))
        tl.append(float(tm["loss"]))
        assert all(p.grad is None for p in tree_leaves(tp))
    np.testing.assert_allclose(tl, rl, rtol=1e-3)
    assert int(ts.step) == 5


def test_train_loss_decreases():
    """End-to-end learnability: the loss on the synthetic stream drops (the
    reference's ``test_train_loss_decreases``, through the port's
    ``train()``)."""
    cfg = treg.get("starcoder2-3b").smoke()
    _, _, losses = train(cfg, OptConfig(lr=3e-3, warmup=5), steps=30,
                         batch_shape=(4, 64), log_every=0, seed=11, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restart_resume_bitwise(tmp_path, dtype):
    """Six steps straight against three, a restart and three more: the
    final parameters and optimizer state bit for bit, bf16 parameters
    through the checkpoint too."""
    cfg = treg.get("starcoder2-3b").smoke()
    if dtype == "bfloat16":
        cfg = cfg.replace(param_dtype=torch.bfloat16)
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    kw = dict(seed=3, batch_shape=(2, 64), log_every=0, device="cpu")
    p_full, o_full, l_full = train(cfg, opt_cfg, steps=6, **kw)
    d = tmp_path / "ck"
    train(cfg, opt_cfg, steps=3, ckpt_dir=str(d), ckpt_every=3, **kw)
    p_res, o_res, l_res = train(cfg, opt_cfg, steps=6, ckpt_dir=str(d), ckpt_every=3, **kw)
    assert l_res == l_full[3:]
    full, res = tree_leaves([p_full, o_full]), tree_leaves([p_res, o_res])
    assert len(full) == len(res)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(full, res))
    assert p_res["embed"]["e"].dtype == cfg.param_dtype
    assert ckpt.latest_step(d) == 6


def test_checkpoint_atomicity_ignores_torn_writes(tmp_path):
    params = TM.init(treg.get("gemma-2b").smoke(), torch.Generator().manual_seed(1), "cpu")
    ckpt.save(tmp_path, 1, {"p": params})
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "arr_00000.npy").write_bytes(b"torn")
    assert ckpt.latest_step(tmp_path) == 1
    ckpt.prune(tmp_path, keep=3)
    assert not (tmp_path / "step_00000002.tmp").exists()
    back = ckpt.restore(tmp_path, 1, {"p": params})
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves({"p": params})))


def test_checkpoint_across_packages(tmp_path):
    """A reference training checkpoint (params with bf16 leaves, and an
    OptState) restores through the port's ``restore`` to the same values
    and dtypes; the port's save of the same tree is the same bytes; a
    float32 one the port saved restores through the reference's."""
    rcfg, tcfg, rp = _arch("moonshot-v1-16b-a3b", "bfloat16")
    ropt = jax.tree.map(np.asarray, r_init_opt(rp, ROptConfig(compress_grads=True)))
    ropt = ropt._replace(step=np.int32(7), mu=jax.tree.map(lambda a: a + 0.5, ropt.mu))
    rckpt.save(tmp_path / "j", 7, {"params": rp, "opt": ropt})
    meta = TM.init(tcfg, None, "meta")
    like = {"params": meta, "opt": init_opt_state(meta, OptConfig(compress_grads=True))}
    back = ckpt.restore(tmp_path / "j", 7, like)
    want = {"params": params_from_reference(rp, tcfg), "opt": opt_state_from_reference(ropt, tcfg)}
    assert isinstance(back["opt"], OptState) and back["opt"].err is not None
    got_l, want_l = tree_leaves(back), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(jax.tree.leaves({"params": rp, "opt": ropt}))
    assert any(t.dtype == torch.bfloat16 for t in got_l)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got_l, want_l))
    assert back["opt"].step.dtype == torch.int32 and back["opt"].step.device.type == "cpu"

    ckpt.save(tmp_path / "t", 7, want)
    jd, td = tmp_path / "j" / "step_00000007", tmp_path / "t" / "step_00000007"
    assert sorted(p.name for p in jd.iterdir()) == sorted(p.name for p in td.iterdir())
    for f in jd.iterdir():
        assert f.read_bytes() == (td / f.name).read_bytes(), f.name

    _, tcfg32, rp32 = _arch("gemma-2b")
    tree = {"params": params_from_reference(rp32, tcfg32),
            "opt": init_opt_state(params_from_reference(rp32, tcfg32), OptConfig())}
    ckpt.save(tmp_path / "t32", 2, tree)
    rlike = jax.eval_shape(lambda: {"params": rp32, "opt": r_init_opt(rp32, ROptConfig())})
    rback = rckpt.restore(tmp_path / "t32", 2, rlike)
    for a, b in zip(jax.tree.leaves(rback), tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_opt_state_from_reference_checks_the_layout():
    rcfg, tcfg, rp = _arch("gemma-2b")
    state = jax.tree.map(np.asarray, r_init_opt(rp, ROptConfig()))
    got = opt_state_from_reference(state, tcfg)
    assert got.err is None and got.step.dtype == torch.int32
    bad = state._replace(mu={**state.mu, "final_norm": {"scale": np.zeros(3, np.float32)}})
    with pytest.raises(ValueError, match="mu/final_norm/scale"):
        opt_state_from_reference(bad, tcfg)
    with pytest.raises(ValueError, match="step"):
        opt_state_from_reference(state._replace(step=np.float32(0)), tcfg)


def test_lm_batch_deterministic_and_learnable():
    """A pure function of (seed, step) (the reference's
    ``test_data_determinism``); the clean targets are (7 t + 3) % vocab and
    10 % +- 2 % of 10^4 positions are flipped."""
    cfg = treg.get("qwen3-4b").smoke()
    b1 = lm_batch(cfg, (4, 64), step=17, seed=5, device="cpu")
    b2 = lm_batch(cfg, (4, 64), step=17, seed=5, device="cpu")
    b3 = lm_batch(cfg, (4, 64), step=18, seed=5, device="cpu")
    b4 = lm_batch(cfg, (4, 64), step=17, seed=6, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["targets"], b2["targets"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert not torch.equal(b1["tokens"], b4["tokens"])
    big = lm_batch(cfg, (10, 1000), step=0, seed=1, device="cpu")
    t, y = big["tokens"], big["targets"]
    clean = (t * 7 + 3) % cfg.vocab
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab
    assert 0.08 <= float((y != clean).float().mean()) <= 0.12
    # the same structure as the reference's batch
    ref = rsynth.lm_batch(rreg.get("internvl2-26b").smoke(), (2, 64), 0)
    got = lm_batch(treg.get("internvl2-26b").smoke(), (2, 64), 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert got["patches"].dtype == torch.float32 and float(got["patches"].std()) < 0.05


def test_kp_shard_per_seed_and_shard():
    w = KPWorkload("t", 40_000, 10, 1)
    a, q = kp_shard(w, 0, 4, seed=3, device="cpu")
    b, _ = kp_shard(w, 0, 4, seed=3, device="cpu")
    c, _ = kp_shard(w, 1, 4, seed=3, device="cpu")
    d, _ = kp_shard(w, 0, 4, seed=4, device="cpu")
    assert q == 1 and a.p.shape == (10_000, 10)
    assert torch.equal(a.p, b.p) and torch.equal(a.b, b.b)
    assert not torch.equal(a.p, c.p) and not torch.equal(a.p, d.p)
    ref, rq = rsynth.kp_shard(w, 0, 4, seed=3)
    assert rq == q
    np.testing.assert_array_equal(a.budgets.numpy(), np.asarray(ref.budgets))


def test_entry_points_need_the_card_or_cpu():
    cfg = treg.get("gemma-2b").smoke()
    with pytest.raises(TypeError, match="Mesh"):
        train(cfg, OptConfig(), 1, mesh=object(), device="cpu")
    if torch.cuda.is_available():
        return
    for call in (lambda: train(cfg, OptConfig(), 1),
                 lambda: lm_batch(cfg, (2, 8), 0),
                 lambda: kp_shard(KPWorkload("t", 100, 2, 1), 0, 1)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()


def test_failure_injection_subprocess(tmp_path):
    """Kill the trainer mid-run (``os._exit(42)``), relaunch, and see it
    resume from the checkpoint and finish (the reference's
    ``test_failure_injection_subprocess``, with ``--device cpu``)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma-2b",
            "--smoke", "--steps", "8", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    first = subprocess.run(args + ["--simulate-failure-at", "5"], env=env,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 42, first.stdout + first.stderr
    assert ckpt.latest_step(tmp_path) == 4
    second = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resumed from step 4" in second.stdout
    assert "done" in second.stdout
    assert ckpt.latest_step(tmp_path) == 8


def test_train_step_config_dataclass_fields_match_reference():
    """``OptConfig``'s fields and defaults equal the reference's."""
    assert dataclasses.asdict(OptConfig()) == dataclasses.asdict(ROptConfig())
    assert OptState._fields == radamw.OptState._fields


def _raises(fn):
    """The exception type ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "seamless-m4t-medium"])
@pytest.mark.parametrize("s", [4, 12, 16, 20])
def test_loss_refuses_a_text_the_chunk_does_not_divide(name, s):
    """With ``loss_chunk`` 8, the one-process loss (``lm.lm_nll`` for the
    LM, ``encdec.encdec_nll`` for the encoder-decoder) raises
    ``ValueError`` exactly where the reference's ``lm_loss`` (its
    assertion) and ``encdec_loss`` (its reshape) fail: a text of S
    positions that ``min(8, S)`` does not divide (12 and 20); elsewhere
    both return a loss, and the two agree within rtol 1e-5."""
    rcfg, tcfg, rp = _arch(name)
    rcfg, tcfg = rcfg.replace(loss_chunk=8), tcfg.replace(loss_chunk=8)
    g = np.random.default_rng(s)
    arrs = {"tokens": g.integers(0, tcfg.vocab, (2, s)),
            "targets": g.integers(0, tcfg.vocab, (2, s))}
    if tcfg.kind == "encdec":
        arrs["frames"] = g.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    rb, tb = _both(arrs)
    rparams = jax.tree.map(jnp.asarray, rp)
    got = {}
    ref = _raises(lambda: got.setdefault("ref", float(RM.loss_fn(rparams, rcfg, rb))))
    port = _raises(lambda: got.setdefault("port", float(TM.loss_fn(_port_params(name), tcfg,
                                                                  tb))))
    assert (ref is not None) == (s % min(8, s) != 0), ref
    assert port is (ValueError if ref is not None else None)
    if ref is None:
        np.testing.assert_allclose(got["port"], got["ref"], rtol=1e-5)
