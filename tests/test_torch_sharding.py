"""The port's logical-axis rules (``repro_torch.models.sharding``) against
the reference's (``src/repro/models/sharding.py``), and what they decide
over a world of ranks, on the CPU.

For the same rules, ``spec``, ``mesh_axis`` and ``axis_size`` agree with
the reference's, the port's world of one (``Mesh(0, 1)``) standing in for
the reference's active mesh (none here: every axis of size 1). Over larger
worlds (``Mesh`` objects of rank r of D, which no collective is asked of
here): the expert ranges, the batch rows, the refusals (``E % D``,
``B % D``, a mesh that is not a ``Mesh``, "batch" on the world without
"experts", an expert tree not cut to the rank, and what tensor and
sequence parallelism does not cover yet: a 2-D world), the MLA, Mamba2
and encoder-decoder archs' steps over a world of one under each name
alone against one process, the production rules' parameter
layout and blocks, FSDP's rule sets and layouts against the reference's
``production_rules`` and ``param_specs``, and the collectives at one rank
and on a ``DryMesh``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

from repro.models import sharding as R  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.moe_router import scd_route_shmap  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import lm, model as M, moe, sharding as S  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

CPU = torch.device("cpu")
BATCH = dict(S.DEFAULT_RULES, batch="model", seq=None, kv_seq=None, heads=None,
             kv_heads=None, ffn=None, vocab=None)
RULES = {"none": None, "default": S.DEFAULT_RULES,
         "seq": dict(S.DEFAULT_RULES, batch="data"), "batch": BATCH,
         "tuple": dict(BATCH, batch=("pod", "model"), experts=("model",)),
         "fsdp": S.FSDP_RULES, "dp_full": S.fsdp_rules("dp_full")}
NAMES = ["batch", "seq", "kv_seq", "heads", "kv_heads", "ffn", "experts", "vocab",
         "fsdp", "d_model", "state", None, "unknown"]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    S.set_rules(None)
    R.set_rules(None)


@pytest.fixture(scope="module")
def smoke():
    cfg = registry.get("moonshot-v1-16b-a3b").smoke()
    return cfg, M.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_default_rules_are_the_reference_s():
    assert S.DEFAULT_RULES == R.DEFAULT_RULES


@pytest.mark.parametrize("rules", list(RULES))
def test_rules_match_reference(rules):
    R.set_rules(RULES[rules])
    S.set_rules(RULES[rules], mesh=Mesh(0, 1, CPU))
    assert S.get_rules() == R.get_rules()
    assert S.spec(*NAMES) == tuple(R.spec(*NAMES))
    assert S.spec("batch", None) == tuple(R.spec("batch", None))
    for name in NAMES:
        assert S.mesh_axis(name) == R.mesh_axis(name), name
        assert S.axis_size(name) == R.axis_size(name), name


@pytest.mark.parametrize("rules", ["default", "tuple", "fsdp", "dp_full"])
def test_axis_size_is_the_world_where_bound_to_it(rules):
    S.set_rules(RULES[rules], mesh=Mesh(1, 4, CPU))
    for name in NAMES:
        assert S.axis_size(name) == (4 if S.on_world(name) else 1), name
    S.set_rules(RULES[rules])                               # no mesh: one process
    assert all(S.axis_size(name) == 1 for name in NAMES)


def test_constrain_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    S.set_rules(BATCH, mesh=Mesh(0, 1, CPU))
    assert S.constrain(x, "batch", None) is x
    S.set_rules(None)
    assert S.constrain(x, "batch", "vocab") is x


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("e", [8, 64, 160])
def test_expert_ranges(d, e):
    ranges = [S.expert_range(e, Mesh(r, d, CPU)) for r in range(d)]
    assert ranges == [(r * e // d, (r + 1) * e // d) for r in range(d)]
    assert ranges[0][0] == 0 and ranges[-1][1] == e
    assert all(hi - lo == e // d for lo, hi in ranges)


@pytest.mark.parametrize("e, d", [(8, 3), (64, 3), (160, 3), (8, 16)])
def test_experts_that_do_not_split_are_refused(e, d):
    with pytest.raises(ValueError, match="experts"):
        S.expert_range(e, Mesh(0, d, CPU))


def test_batch_rows_and_their_refusal(smoke):
    cfg, params = smoke
    assert [S.rank_rows(8, Mesh(r, 4, CPU)) for r in range(4)] == [(0, 2), (2, 4), (4, 6),
                                                                  (6, 8)]
    with pytest.raises(ValueError, match="batch rows"):
        S.rank_rows(5, Mesh(0, 2, CPU))
    S.set_rules(BATCH, mesh=Mesh(0, 2, CPU))
    with pytest.raises(ValueError, match="batch rows"):
        M.make_prefill_step(cfg)(params, {"tokens": torch.zeros((3, 8), dtype=torch.long)})
    with pytest.raises(ValueError, match="batch rows"):
        M.init_cache(cfg, params, 3, 16)


LABEL = "ROADMAP A10 item 5, second part"


# The archs whose mixers (MLA, Mamba2, the encoder-decoder) run under
# tensor and sequence parallelism since they left the refusals.
MIXER_ARCHS = ("deepseek-v2-236b", "mamba2-370m", "seamless-m4t-medium")


def _mixer_steps(arch, rules):
    """``arch``'s smoke prefill logits, one decode step's logits and one
    train step's loss and gradients from the seeded weights, under
    ``rules`` over a world of one (None: one process, no rules). "experts"
    is left off the world: the MoE's world path routes without the
    router's projection (``tests/test_torch_tp_mixers.py`` holds deepseek's
    against the reference's mesh)."""
    cfg = registry.get(arch).smoke()
    rules = None if rules is None else dict(rules, experts=None)
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = np.random.default_rng(1)
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (2, 8)))
    frames = (torch.from_numpy(g.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
              if cfg.kind == "encdec" else None)
    batch = {"tokens": toks, **({} if frames is None else {"frames": frames})}
    S.set_rules(rules, mesh=None if rules is None else Mesh(0, 1, CPU))
    try:
        with torch.no_grad():
            prefill = M.make_prefill_step(cfg)(params, batch)
            caches = M.init_cache(cfg, params, 2, 16, frames=frames)
            decode = M.make_decode_step(cfg)(params, caches, toks[:, :1], 0)[0]
        loss, grads = M.loss_and_grads(params, cfg, dict(batch, targets=toks))
    finally:
        S.set_rules(None)
    return [prefill, decode, loss, *lm.tree_leaves(grads)]


def _same_steps(got, want, arch):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{arch} {i}")


@pytest.mark.parametrize("name", S.TP_NAMES)
def test_unported_bindings_raise(smoke, name):
    """Each name of ``TP_NAMES`` bound alone (with "experts") runs a prefill,
    a decode and a train step, here over a world of one equal to the
    one-process steps (a world of 2: ``tests/test_torch_tp_world.py``,
    ``tests/test_torch_tp_train.py`` and ``tests/test_torch_tp_mixers.py``),
    the MLA, Mamba2 and encoder-decoder archs too; "fsdp" or "batch" on
    the world beside it (a 2-D world) raise ``NotImplementedError`` naming
    the label of what is not ported, for every step."""
    cfg, params = smoke
    rules = dict(S.PRODUCTION_RULES, **{n: None for n in S.TP_NAMES if n != name})
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        want = M.make_prefill_step(cfg)(params, {"tokens": toks})
        want_d = M.make_decode_step(cfg)(params, lm.init_cache(cfg, 2, 16, CPU),
                                         toks[:, :1], 0)[0]
        S.set_rules(rules, mesh=Mesh(0, 1, CPU))
        got = M.make_prefill_step(cfg)(params, {"tokens": toks})
        got_d = M.make_decode_step(cfg)(params, M.init_cache(cfg, params, 2, 16),
                                        toks[:, :1], 0)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), want_d.numpy(), rtol=1e-5, atol=1e-5)
    batch = {"tokens": toks, "targets": toks}
    # the train step runs under it: over a world of one, the one-process
    # loss and gradients (gemma's: the MoE's world path routes without the
    # router's projection, tests/test_torch_tp_train.py holds moonshot)
    dense = registry.get("gemma-2b").smoke()
    fresh = M.init(dense, torch.Generator().manual_seed(0), device="cpu")
    S.set_rules(None)
    want_l, want_g = M.loss_and_grads(fresh, dense, batch)
    S.set_rules(rules, mesh=Mesh(0, 1, CPU))
    got_l, got_g = M.loss_and_grads(fresh, dense, batch)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    for a, b in zip(lm.tree_leaves(got_g), lm.tree_leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    for bad in (dict(rules, fsdp="model"), dict(rules, batch="model")):
        S.set_rules(bad, mesh=Mesh(0, 1, CPU))
        with pytest.raises(NotImplementedError, match=LABEL):
            M.make_prefill_step(cfg)(params, {"tokens": toks})
        with pytest.raises(NotImplementedError, match=LABEL):
            M.make_train_step(cfg, OptConfig())(params, None, batch)
    for arch in MIXER_ARCHS:
        _same_steps(_mixer_steps(arch, rules), _mixer_steps(arch, None), arch)


def test_production_rules_are_the_reference_s():
    from repro.models import model as RM
    assert S.PRODUCTION_RULES == RM.production_rules(False) == M.production_rules(False)
    S.set_rules(S.PRODUCTION_RULES, mesh=Mesh(0, 2, CPU))
    R.set_rules(RM.production_rules(False))
    assert S.spec(*NAMES) == tuple(R.spec(*NAMES))
    assert [S.on_world(n) for n in S.TP_NAMES] == [True] * 6
    assert not S.on_world("batch") and S.on_world("experts")


FSDP_ARCHS = ["moonshot-v1-16b-a3b", "gemma-2b", "deepseek-v2-236b", "jamba-v0.1-52b",
              "mamba2-370m", "seamless-m4t-medium"]


@pytest.mark.parametrize("mode", S.FSDP_MODES)
def test_fsdp_rules_are_the_reference_s_on_its_data_axis(mode):
    """``sharding.fsdp_rules(mode)`` is the reference's ``production_rules(
    False, mode)`` with its "data" axis the world and its "model" axis of
    size 1 (:data:`UNIT`); ``rules_for`` gives it, and the production
    rules by mode on the world as "model"."""
    from repro.models import model as RM
    want = RM.production_rules(False, mode)
    on = {"data": S.WORLD, "model": S.UNIT}
    rename = lambda v: tuple(on.get(a, a) for a in v) if isinstance(v, tuple) else on.get(v, v)  # noqa: E731
    assert S.fsdp_rules(mode) == {k: rename(v) for k, v in want.items()}
    assert S.rules_for("fsdp", mode) == S.fsdp_rules(mode)
    assert S.rules_for("production", mode) == want == M.production_rules(False, mode)
    assert S.rules_for("batch", mode) == S.BATCH_RULES
    assert S.on_world("batch") is False
    S.set_rules(S.rules_for("fsdp", mode), mesh=Mesh(0, 2, CPU))
    assert S.on_world("batch") and S.on_world("fsdp") and not S.on_world("experts")
    assert S.mesh_axis("experts") == S.UNIT and S.refusal(S.get_rules()) is None


@pytest.mark.parametrize("arch,mesh,mode", [(a, "dp", m) for a in FSDP_ARCHS
                                             for m in S.FSDP_MODES]
                         + [(a, "tp", "dp_full") for a in FSDP_ARCHS]
                         + [(a, "tp", "fsdp_only") for a in FSDP_ARCHS[:2]])
def test_fsdp_layouts_are_the_reference_s(monkeypatch, arch, mesh, mode):
    """Each leaf's stored block (``model.param_specs``) and its moments'
    (``model.opt_specs``) on a world of 2: the dim that the reference's
    ``param_specs``/``opt_specs`` give its world axis on a ("data",
    "model") mesh of (2, 1) ("data" the world, ``rules_for("fsdp", mode)``)
    or (1, 2) ("model" the world, ``rules_for("production", mode)``), for
    every arch and mode (on (1, 2) the layouts that spread the weights; its
    "full", "zero1" and "none" keep the production layout)."""
    from repro.configs import registry as rreg
    from repro.models import model as RM
    sizes = {"pod": 1, "data": 2, "model": 1} if mesh == "dp" else \
        {"pod": 1, "data": 1, "model": 2}
    axis = "data" if mesh == "dp" else "model"
    monkeypatch.setattr(RM, "_axis_sizes", lambda: sizes)
    rcfg = rreg.get(arch).smoke().replace(fsdp_mode=mode)
    pshape = jax.eval_shape(lambda k: RM.init(rcfg, k), jax.ShapeDtypeStruct((2,), np.uint32))
    rps = RM.param_specs(rcfg, pshape)
    ros = RM.opt_specs(rcfg, rps, pshape).mu
    is_p = lambda q: isinstance(q, jax.sharding.PartitionSpec)  # noqa: E731

    def dims(specs):
        return [next((i for i, e in enumerate(sp)
                      if e == axis or (isinstance(e, tuple) and axis in e)), None)
                for sp in jax.tree.leaves(specs, is_leaf=is_p)]
    cfg = registry.get(arch).smoke().replace(fsdp_mode=mode)
    whole = M.init(cfg, None, "meta")
    S.set_rules(S.rules_for("fsdp" if mesh == "dp" else "production", mode),
                mesh=D.DryMesh(0, 2))
    assert S.refusal(S.get_rules()) is None
    ps = M.param_specs(cfg, whole)
    ms = M.opt_specs(cfg, ps, whole).mu
    paths = [path for path, _ in lm.tree_leaves_with_paths(whole)]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree
    got = [at(ps, path) for path in paths]
    assert got == dims(rps)
    assert [at(ms, path) for path in paths] == dims(ros)
    cut = M.shard_params(cfg, whole, D.DryMesh(0, 2))
    for path, d in zip(paths, got):
        a, b = at(whole, path), at(cut, path)
        assert b.shape[d] * 2 == a.shape[d] if d is not None else b.shape == a.shape, path


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "gemma-2b", "starcoder2-3b"])
def test_production_param_specs_follow_the_roles(arch):
    """Under the production rules on a world of 2 (a ``DryMesh``): ``wq``
    and the attention ``wo`` on heads, ``wk``/``wv`` on KV heads where 2
    divides them (else whole), a dense ``wi``/``wo`` on the FFN columns,
    the MoE's on experts, the embed and head on vocab; router and norms
    whole. The cut tree holds half of each split leaf."""
    cfg = registry.get(arch).smoke()
    whole = M.init(cfg, None, "meta")
    S.set_rules(S.PRODUCTION_RULES, mesh=D.DryMesh(0, 2))
    try:
        specs = M.param_specs(cfg, whole)
        cut = M.shard_params(cfg, whole, D.DryMesh(0, 2))
    finally:
        S.set_rules(None)
    att = specs["slots"][0]["mixer"]
    kv = 2 if cfg.n_kv_heads % 2 == 0 else None
    assert (att["wq"], att["wk"], att["wv"], att["wo"]) == (2, kv, kv, 1)
    ffn = specs["slots"][0]["ffn"]
    if cfg.moe.n_experts:
        assert (ffn["wi"], ffn["wo"], ffn["router"]) == (1, 1, None)
    else:
        assert (ffn["wi"], ffn["wo"]) == (3, 1)
    assert specs["embed"]["e"] == 0 and specs["final_norm"]["scale"] is None
    assert specs["slots"][0]["norm1"]["scale"] is None
    if "head" in specs:
        assert specs["head"]["e"] == 0
    for path, leaf in lm.tree_leaves_with_paths(whole):
        spec = specs
        for k in path:
            spec = spec[k]
        got = cut
        for k in path:
            got = got[k]
        want = list(leaf.shape)
        if spec is not None:
            want[spec] //= 2
        assert list(got.shape) == want, path


def test_all_gather_and_reduce_scatter_of_one_rank_and_on_paper():
    """At one rank both return their input and send nothing; on a
    ``DryMesh`` of 4 they give the joined and the block shape and count
    the bytes the rank sends (its block, its whole partial)."""
    mesh = Mesh(0, 1, CPU)
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert mesh.all_gather(t, 1) is t and mesh.reduce_scatter(t, 2) is t
    assert mesh.comm_bytes == {}
    dry = D.DryMesh(1, 4)
    meta = torch.empty((2, 3, 4), device="meta", dtype=torch.bfloat16)
    assert dry.all_gather(meta, 1).shape == (2, 12, 4)
    out = dry.reduce_scatter(meta, 2)
    assert out.shape == (2, 3, 1) and out.dtype == torch.bfloat16
    assert dry.comm_bytes == {"all_gather": 48, "reduce_scatter": 48}
    assert dry.comm_calls == {"all_gather": 1, "reduce_scatter": 1}
    with pytest.raises(ValueError, match="split"):
        dry.reduce_scatter(meta, 1)


def test_kv_split_by_heads_else_positions():
    """The KV cache splits by KV heads where D divides them, else by
    positions where "kv_seq" is bound (D must divide them), else not."""
    from repro_torch.models.attention import kv_split
    moon, gemma = (registry.get(a).smoke() for a in ("moonshot-v1-16b-a3b", "gemma-2b"))
    S.set_rules(S.PRODUCTION_RULES, mesh=Mesh(1, 2, CPU))
    assert kv_split(moon, 8) == ("heads", 2, 4)
    assert kv_split(gemma, 8) == ("seq", 4, 8)
    with pytest.raises(ValueError, match="positions"):
        kv_split(gemma, 7)
    assert lm.init_cache(gemma, 2, 8, "meta")["slots"][0]["k"].shape == (2, 2, 4, 1, gemma.hd)
    S.set_rules(dict(S.PRODUCTION_RULES, kv_seq=None), mesh=Mesh(1, 2, CPU))
    assert kv_split(gemma, 8) is None
    S.set_rules(S.PRODUCTION_RULES, mesh=Mesh(0, 1, CPU))
    assert kv_split(moon, 8) is None and kv_split(gemma, 8) is None


def test_a_mesh_must_be_a_mesh():
    with pytest.raises(TypeError, match="Mesh"):
        S.set_rules(BATCH, mesh="model")
    logits = torch.zeros((4, 8))
    for bad in (None, object()):
        with pytest.raises(TypeError, match="Mesh"):
            scd_route_shmap(logits, 2, 1.25, 4, bad)
    with pytest.raises(TypeError, match="Mesh"):
        S.expert_range(8, 2)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_shard_experts_cuts_the_expert_leaves(smoke, d):
    cfg, params = smoke
    e = cfg.moe.n_experts
    for r in range(d):
        lo, hi = S.expert_range(e, Mesh(r, d, CPU))
        cut = S.shard_experts(params, Mesh(r, d, CPU))
        for got, want in zip(cut["slots"], params["slots"]):
            for k in ("wi", "wo"):
                assert got["ffn"][k].shape[1] == e // d
                assert torch.equal(got["ffn"][k], want["ffn"][k][:, lo:hi])
        ids = {id(a) for a in lm.tree_leaves(params)}
        kept = [a for a in lm.tree_leaves(cut) if id(a) in ids]  # replicated
        assert len(kept) == len(lm.tree_leaves(params)) - 2 * len(params["slots"])
        assert cut["embed"]["e"] is params["embed"]["e"]
        assert cut["slots"][0]["ffn"]["router"] is params["slots"][0]["ffn"]["router"]
        bare = S.shard_experts(lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"]),
                               Mesh(r, d, CPU))
        assert torch.equal(bare["wo"], params["slots"][0]["ffn"]["wo"][0, lo:hi])


def test_moe_over_a_world_refuses_what_it_cannot_run(smoke):
    cfg, params = smoke
    p = lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"])
    x = torch.zeros((2, 4, cfg.d_model))
    S.set_rules(BATCH)                                      # experts bound, no mesh
    with pytest.raises(ValueError, match="carry no Mesh"):
        moe.moe_train(p, cfg, x)
    S.set_rules(BATCH, mesh=Mesh(0, 2, CPU))                # every expert kept
    with pytest.raises(ValueError, match="shard_experts"):
        moe.moe_train(p, cfg, x)
    # "experts" on an axis of size 1 (FSDP's): every expert on each rank, a
    # world of one for the experts, the decode dense over the rank's rows
    xr = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    S.set_rules(dict(BATCH, experts="data"), mesh=Mesh(0, 2, CPU))
    got = moe.moe_decode(p, cfg, xr)
    S.set_rules(None)
    torch.testing.assert_close(got, moe.moe_decode(p, cfg, xr), rtol=0, atol=0)
    S.set_rules(BATCH, mesh=Mesh(0, 1, CPU))                # gradients run through
    moe.moe_train(p, cfg, x.requires_grad_(True)).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_training_over_a_world_is_refused(smoke):
    """What a train step over a world still refuses: "fsdp" on the world
    beside a name of ``TP_NAMES`` or "experts", and "batch" on the world
    beside a name of ``TP_NAMES`` (a 2-D world) raise
    ``NotImplementedError`` naming ROADMAP A10 item 5's second part, and
    "batch" on the world needs "experts" bound (the batch binding, FSDP).
    The production rules' steps of the MLA, Mamba2 and encoder-decoder
    archs run: over a world of one, the one-process logits, loss and
    gradients. The production rules' train step, one with only "experts"
    on the world (every rank every row), and each ``fsdp_mode`` under the
    production rules and under FSDP (``sharding.rules_for``) run: over a
    world of one, the one-process loss (gemma's)."""
    cfg, params = smoke
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "targets": torch.zeros((2, 8), dtype=torch.long)}
    step = M.make_train_step(cfg, OptConfig())
    for rules in (dict(S.PRODUCTION_RULES, fsdp="model"),
                  dict(S.PRODUCTION_RULES, batch="model"), dict(BATCH, fsdp="model")):
        S.set_rules(rules, mesh=Mesh(0, 1, CPU))
        with pytest.raises(NotImplementedError, match=LABEL):
            step(params, None, batch)
    for arch in MIXER_ARCHS:
        _same_steps(_mixer_steps(arch, S.PRODUCTION_RULES), _mixer_steps(arch, None), arch)
    S.set_rules(dict(BATCH, experts=None), mesh=Mesh(0, 1, CPU))
    with pytest.raises(ValueError, match="batch binding"):
        step(params, None, batch)
    dense = registry.get("gemma-2b").smoke()
    fresh = M.init(dense, torch.Generator().manual_seed(0), device="cpu")
    S.set_rules(None)
    want = float(M.loss_and_grads(fresh, dense, batch)[0])
    for rules in (S.PRODUCTION_RULES, dict(BATCH, batch="data")):
        S.set_rules(rules, mesh=Mesh(0, 1, CPU))
        np.testing.assert_allclose(float(M.loss_and_grads(fresh, dense, batch)[0]), want,
                                   rtol=1e-6)
    for mode in S.FSDP_MODES:                 # the layouts that were refused run
        laid = dense.replace(fsdp_mode=mode)
        for name in ("production", "fsdp"):
            S.set_rules(S.rules_for(name, mode), mesh=Mesh(0, 1, CPU))
            np.testing.assert_allclose(float(M.loss_and_grads(fresh, laid, batch)[0]),
                                       want, rtol=1e-6)
    assert S.BATCH_RULES == BATCH


def test_all_to_all_of_one_rank_is_a_copy():
    mesh = Mesh(0, 1, CPU)
    t = torch.arange(12.0).reshape(1, 3, 4)
    out = mesh.all_to_all(t)
    assert torch.equal(out, t) and out.data_ptr() != t.data_ptr()
    assert mesh.comm_s == 0.0
    with pytest.raises(ValueError, match="rows"):
        mesh.all_to_all(t.reshape(3, 4))


def test_rules_carry_no_mesh_once_cleared():
    S.set_rules(BATCH, mesh=Mesh(0, 1, CPU))
    assert S.get_mesh() is not None
    S.set_rules(None, mesh=Mesh(0, 1, CPU))
    assert S.get_rules() is None and S.get_mesh() is None
    assert S.spec("batch") == () and S.mesh_axis("batch") is None


def test_logits_over_a_world_of_one_keep_every_row(smoke):
    cfg, params = smoke
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    S.set_rules(BATCH, mesh=Mesh(0, 1, CPU))
    with torch.no_grad():
        got = M.make_prefill_step(cfg)(params, {"tokens": toks})
    assert got.shape == (2, cfg.vocab) and bool(torch.isfinite(got).all())


def test_expert_axes_name_the_cut_leaves(smoke):
    """Under the batch binding ``param_blocks`` cuts each MoE's ``wi`` and
    ``wo`` (dim 1 stacked, dim 0 bare) in ``jax.tree.leaves`` order, through
    an optimizer state too, and nothing else; ``map_experts`` follows the
    same leaves."""
    from repro_torch.optim import init_opt_state
    cfg, params = smoke
    paths = [path for path, _ in lm.tree_leaves_with_paths(params)]
    want = [1 if path[-1] in ("wi", "wo") and path[-2] == "ffn" else None for path in paths]
    mesh = Mesh(1, 2, CPU)

    def axes(tree):
        return [None if b is None else b[0]
                for b in M.param_blocks(cfg, tree, mesh, rules=S.BATCH_RULES)]
    assert axes(params) == want and 1 in want
    bare = lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"])
    assert axes(bare) == [None, 0, 0]                       # router, wi, wo
    state = init_opt_state(params, OptConfig(compress_grads=True))
    assert axes(state) == [None] + want * 3                 # step, mu, nu, err
    seen = S.map_experts(lambda a, ax: ax, {"p": params, "none": None})
    assert seen["none"] is None and seen["p"]["slots"][0]["ffn"]["wo"] == 1
    assert seen["p"]["embed"]["e"] is None
    blocks = M.param_blocks(cfg, {"params": params}, mesh, rules=S.BATCH_RULES)
    assert blocks == [None if ax is None else (ax, 1, 2) for ax in want]
    assert M.param_blocks(cfg, params, None) == [None] * len(want)     # one process


def test_all_to_all_under_autograd_of_one_rank():
    """``core.mesh.all_to_all``: the exchange under autograd, whose backward
    is the exchange of the gradient (a copy at one rank); ``comm_split``
    stays empty without a collective."""
    from repro_torch.core.mesh import all_to_all
    mesh = Mesh(0, 1, CPU)
    t = torch.arange(12.0).reshape(1, 3, 4).requires_grad_(True)
    out = all_to_all(mesh, t)
    assert torch.equal(out, t) and out.grad_fn is not None
    (out * torch.arange(12.0).reshape(1, 3, 4)).sum().backward()
    assert torch.equal(t.grad, torch.arange(12.0).reshape(1, 3, 4))
    assert mesh.comm_s == 0.0 and mesh.comm_split == {}
