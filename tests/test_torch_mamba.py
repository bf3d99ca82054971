"""The port's Mamba2 SSD mixer (``repro_torch.models.mamba2``) against the
reference's (``src/repro/models/mamba2.py``) on the CPU, in float32.

The same numpy inputs and weights go to both. ``_ssd_chunked``,
``mamba_mixer`` and ``decode_mamba`` (its output and the cache after it)
are held at rtol 1e-4, atol 1e-5, the LM stack's bar
(``test_torch_models.py``): the same float32 operations, summed in other
orders. Within the port: the chunked scan against its own one-token
recurrence at the reference's decode-against-prefill bar (rtol 2e-2, atol
2e-3), the decode cache written in place (a hybrid's decode against its
forward at one and at two periods of jamba's pattern), gradients through
the masked decay finite where the unmasked exponents overflow, and a
mamba2 ``train()`` resumed from its checkpoint bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as rreg  # noqa: E402
from repro.models import mamba2 as Rm  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm as Tlm  # noqa: E402
from repro_torch.models import mamba2 as Tm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Smoke-size tensors gain nothing from threads, and the suite runs six
    workers on the host's cores: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(n_groups=1):
    """(reference, port) mamba2-370m smoke configs with ``n_groups``."""
    r, t = rreg.get("mamba2-370m").smoke(), treg.get("mamba2-370m").smoke()
    return (r.replace(mamba=dataclasses.replace(r.mamba, n_groups=n_groups)),
            t.replace(mamba=dataclasses.replace(t.mamba, n_groups=n_groups)))


def _mixer_params(rcfg, seed):
    """The reference's ``init_mamba`` as numpy, and as port tensors."""
    rp = jax.tree.map(np.asarray, Rm.init_mamba(jax.random.PRNGKey(seed), rcfg))
    return rp, Tlm.tree_map(lambda a: torch.from_numpy(a.copy()), rp)


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f32(b, s, h))).astype(np.float32)   # softplus: positive
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return f32(b, s, h, p), dt, a_log, f32(b, s, g, n), f32(b, s, g, n)


@pytest.mark.parametrize("s,chunk,g", [(24, 32, 1), (64, 16, 1), (64, 16, 2), (32, 32, 4)])
def test_ssd_chunked_matches_reference(s, chunk, g):
    """S below the chunk (one short chunk) and S a multiple of it; 1, 2 and
    4 groups sharing B and C over 4 heads."""
    arrs = _ssd_inputs(s + g, 2, s, 4, 8, g, 16)
    want = np.asarray(Rm._ssd_chunked(*map(jnp.asarray, arrs), chunk))
    got = Tm._ssd_chunked(*map(torch.from_numpy, arrs), chunk)
    assert got.shape == (2, s, 4, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ssd_rejects_a_ragged_chunk():
    arrs = _ssd_inputs(0, 1, 48, 4, 8, 1, 16)
    with pytest.raises(ValueError, match="multiple of the SSD chunk 32"):
        Tm._ssd_chunked(*map(torch.from_numpy, arrs), 32)


def test_chunk_cumsum_one_rounding_in_order():
    """The within-chunk cumsum: float64 in index order, rounded to float32
    once; a lone column too (which would take the 1-D scan on the card)."""
    rng = np.random.default_rng(1)
    for shape in [(2, 3, 64, 5), (1, 1, 64, 1)]:
        x = (rng.standard_normal(shape) * 30).astype(np.float32)
        want = np.cumsum(x.astype(np.float64), axis=2).astype(np.float32)
        got = Tm._chunk_cumsum(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_groups,s", [(1, 64), (2, 64), (1, 16)])
def test_mixer_matches_reference(n_groups, s):
    rcfg, tcfg = _cfgs(n_groups)
    rp, tp = _mixer_params(rcfg, 2)
    x = np.random.default_rng(3).standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: Rm.mamba_mixer(p, rcfg, x))(rp, jnp.asarray(x)))
    got = Tm.mamba_mixer(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_decode_and_cache_match_reference(n_groups):
    """Four decode steps from a random cache: each output, and the conv
    window and SSM state after each step, written into the port's cache in
    place."""
    rcfg, tcfg = _cfgs(n_groups)
    rp, tp = _mixer_params(rcfg, 4)
    rng = np.random.default_rng(5)
    rc = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                      Rm.init_mamba_cache(rcfg, 2, jnp.float32))
    tc = Tm.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in rc.items()}
    assert tc["ssm"].dtype == torch.float32
    tc["conv"].copy_(torch.from_numpy(rc["conv"]))
    tc["ssm"].copy_(torch.from_numpy(rc["ssm"]))
    conv, ssm = tc["conv"], tc["ssm"]
    step = jax.jit(lambda p, x, c: Rm.decode_mamba(p, rcfg, x, c, 0))
    for t in range(4):
        x = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
        want, rc = step(rp, jnp.asarray(x), rc)
        got, tc = Tm.decode_mamba(tp, tcfg, torch.from_numpy(x), tc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tc["conv"] is conv and tc["ssm"] is ssm
        np.testing.assert_allclose(conv.numpy(), np.asarray(rc["conv"]), **TOL)
        np.testing.assert_allclose(ssm.numpy(), np.asarray(rc["ssm"]), **TOL)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_chunked_scan_matches_its_recurrence(n_groups):
    """The port's chunked SSD (two chunks) against its own one-token decode
    from a zero cache, token by token."""
    rcfg, tcfg = _cfgs(n_groups)
    _, tp = _mixer_params(rcfg, 6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32))
    want = Tm.mamba_mixer(tp, tcfg, x)
    cache = Tm.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    got = torch.cat([Tm.decode_mamba(tp, tcfg, x[:, t:t + 1], cache, t)[0]
                     for t in range(64)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("periods", [1, 2])
def test_hybrid_decode_matches_forward_per_period(periods):
    """jamba at smoke() widths, cut to one period of its 8-slot pattern and
    at two: decode through the stacked caches (each period's Mamba state
    written in place through its view) reproduces the teacher-forced
    forward, the top-k router on both paths."""
    cfg = treg.get("jamba-v0.1-52b").smoke()
    cfg = cfg.replace(n_layers=8 * periods,
                      moe=dataclasses.replace(cfg.moe, router="topk"))
    params = TM.init(cfg, torch.Generator().manual_seed(periods), "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 16)))
    want = unembed(Tlm.head_params(params), Tlm.forward(params, cfg, toks))
    caches = TM.init_cache(cfg, params, 2, 16)
    assert caches["slots"][1]["ssm"].shape[0] == periods
    step = TM.make_decode_step(cfg)
    got = torch.stack([step(params, caches, toks[:, t:t + 1], t)[0][:, 0]
                       for t in range(16)], 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2, atol=2e-3)
    for i, slot in enumerate(cfg.pattern):
        if slot == "mamba":
            assert all(bool(caches["slots"][i]["ssm"][t].abs().amax() > 0)
                       for t in range(periods))


def test_init_matches_reference_layout_and_constants():
    """The seeded init: every leaf of the reference's shape and dtype (bf16
    parameters), ``a_log = log(linspace(1, 16, H))`` in every period as the
    reference computes it, ``d_skip`` ones, ``conv_b`` and ``dt_bias``
    zeros; the meta init the same layout."""
    for name in ("mamba2-370m", "jamba-v0.1-52b"):
        rcfg = rreg.get(name).smoke().replace(param_dtype=jnp.bfloat16)
        tcfg = treg.get(name).smoke().replace(param_dtype=torch.bfloat16)
        rp = jax.eval_shape(lambda k: RM.init(rcfg, k), jax.random.PRNGKey(0))
        tp = TM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
        meta = TM.init(tcfg, None, "meta")
        want = [(tuple(a.shape), a.dtype.name) for a in jax.tree.leaves(rp)]
        for tree in (tp, meta):
            assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                    for t in Tlm.tree_leaves(tree)] == want
        slot = 1 if name.startswith("jamba") else 0
        mx = tp["slots"][slot]["mixer"]
        nh = rcfg.mamba.n_heads(rcfg.d_model)
        a_log = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, nh)).astype(jnp.bfloat16))
        for t in range(tcfg.n_periods):
            assert np.array_equal(mx["a_log"][t].float().numpy(), a_log.astype(np.float32))
        assert bool((mx["d_skip"] == 1).all()) and not mx["conv_b"].any() \
            and not mx["dt_bias"].any()


def test_gradients_finite_where_the_upper_triangle_overflows():
    """One 64-token chunk at A = -16 with large steps: the masked upper
    triangle's exponents reach ~5e3 and would overflow to inf; masked
    before the ``exp``, every gradient is finite and equals the
    reference's within a relative L2 error of 1e-4."""
    h, p, n = 4, 8, 16
    xh, dt, _, b_, c_ = _ssd_inputs(9, 1, 64, h, p, 1, n)
    dt = dt * 4
    a_log = np.full(h, np.log(16.0), np.float32)

    def ref_loss(xh, dt, b_, c_):
        return (Rm._ssd_chunked(xh, dt, jnp.asarray(a_log), b_, c_, 64) ** 2).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (xh, dt, b_, c_)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (xh, dt, b_, c_)]
    (Tm._ssd_chunked(ts[0], ts[1], torch.from_numpy(a_log), ts[2], ts[3], 64) ** 2) \
        .sum().backward()
    assert float((dt * 16).sum(1).max()) > 1000
    for t, w in zip(ts, want):
        g, w = t.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


def test_train_resumed_bitwise(tmp_path):
    """mamba2-370m at smoke(), bf16 parameters: four steps straight against
    two, a restart from the checkpoint and two more, bit for bit."""
    cfg = treg.get("mamba2-370m").smoke().replace(param_dtype=torch.bfloat16)
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    kw = dict(seed=4, batch_shape=(2, 64), log_every=0, device="cpu")
    p_full, o_full, l_full = train(cfg, opt_cfg, steps=4, **kw)
    train(cfg, opt_cfg, steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    p_res, o_res, l_res = train(cfg, opt_cfg, steps=4, ckpt_dir=str(tmp_path),
                                ckpt_every=2, **kw)
    assert l_res == l_full[2:] and np.isfinite(l_full).all()
    full, res = Tlm.tree_leaves([p_full, o_full]), Tlm.tree_leaves([p_res, o_res])
    assert len(full) == len(res)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(full, res))
    assert p_res["slots"][0]["mixer"]["in_proj"].dtype == torch.bfloat16
