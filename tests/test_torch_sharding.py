"""The port's logical-axis rules (``repro_torch.models.sharding``) against
the reference's (``src/repro/models/sharding.py``), and what they decide
over a world of ranks, on the CPU.

For the same rules, ``spec``, ``mesh_axis`` and ``axis_size`` agree with
the reference's, the port's world of one (``Mesh(0, 1)``) standing in for
the reference's active mesh (none here: every axis of size 1). Over larger
worlds (``Mesh`` objects of rank r of D, which no collective is asked of
here): the expert ranges, the batch rows, the refusals (``E % D``,
``B % D``, the bindings the port has not implemented, a mesh that is not a
``Mesh``, a train step over a world under any binding but the batch
binding, an expert tree not cut to the rank).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import sharding as R  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.moe_router import scd_route_shmap  # noqa: E402
from repro_torch.models import lm, model as M, moe, sharding as S  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

CPU = torch.device("cpu")
BATCH = dict(S.DEFAULT_RULES, batch="model", seq=None, kv_seq=None, heads=None,
             kv_heads=None, ffn=None, vocab=None)
RULES = {"none": None, "default": S.DEFAULT_RULES,
         "seq": dict(S.DEFAULT_RULES, batch="data"), "batch": BATCH,
         "tuple": dict(BATCH, batch=("pod", "model"), experts=("model",))}
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


@pytest.mark.parametrize("rules", ["default", "tuple"])
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


@pytest.mark.parametrize("name", S.UNPORTED)
def test_unported_bindings_raise(smoke, name):
    cfg, params = smoke
    S.set_rules(dict(BATCH, **{name: "model"}), mesh=Mesh(0, 1, CPU))
    toks = torch.zeros((2, 8), dtype=torch.long)
    msg = "tensor and sequence parallelism over the world"
    with pytest.raises(NotImplementedError, match=msg):
        M.make_prefill_step(cfg)(params, {"tokens": toks})
    caches = lm.init_cache(cfg, 2, 16, CPU)
    with pytest.raises(NotImplementedError, match=msg):
        M.make_decode_step(cfg)(params, caches, toks[:, :1], 0)


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
    S.set_rules(dict(BATCH, experts="data"), mesh=Mesh(0, 1, CPU))
    with pytest.raises(ValueError, match="bound to the world"):
        moe.moe_decode(p, cfg, x[:, :1])
    S.set_rules(BATCH, mesh=Mesh(0, 1, CPU))                # gradients run through
    moe.moe_train(p, cfg, x.requires_grad_(True)).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_training_over_a_world_is_refused(smoke):
    """A train step over a world runs under the batch binding only: the
    unported bindings name ROADMAP A10, and "batch" and "experts" must be
    bound to the world."""
    cfg, params = smoke
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "targets": torch.zeros((2, 8), dtype=torch.long)}
    step = M.make_train_step(cfg, OptConfig())
    S.set_rules(dict(S.DEFAULT_RULES, batch="data"), mesh=Mesh(0, 1, CPU))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        step(params, None, batch)
    for rules in (dict(BATCH, batch="data"), dict(BATCH, experts=None)):
        S.set_rules(rules, mesh=Mesh(0, 1, CPU))
        with pytest.raises(ValueError, match="batch binding"):
            step(params, None, batch)
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
    """``expert_axes`` marks each MoE's ``wi`` and ``wo`` (dim 1 stacked,
    dim 0 bare) in ``jax.tree.leaves`` order, through an optimizer state
    too; ``map_experts`` and ``expert_blocks`` follow it."""
    from repro_torch.optim import init_opt_state
    cfg, params = smoke
    paths = [path for path, _ in lm.tree_leaves_with_paths(params)]
    want = [1 if path[-1] in ("wi", "wo") and path[-2] == "ffn" else None for path in paths]
    assert S.expert_axes(params) == want and 1 in want
    bare = lm.tree_map(lambda a: a[0], params["slots"][0]["ffn"])
    assert S.expert_axes(bare) == [None, 0, 0]              # router, wi, wo
    state = init_opt_state(params, OptConfig(compress_grads=True))
    assert S.expert_axes(state) == [None] + want * 3        # step, mu, nu, err
    seen = S.map_experts(lambda a, ax: ax, {"p": params, "none": None})
    assert seen["none"] is None and seen["p"]["slots"][0]["ffn"]["wo"] == 1
    assert seen["p"]["embed"]["e"] is None
    blocks = S.expert_blocks({"params": params}, Mesh(1, 2, CPU))
    assert blocks == [None if ax is None else (ax, 1, 2) for ax in want]
    assert S.expert_blocks(params, None) == [None] * len(want)     # one process: whole


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
