"""The port's MLA mixer (``repro_torch.models.attention``: ``init_mla``,
``mla_attention``, ``init_mla_cache``, ``decode_mla``) against the
reference's (``src/repro/models/attention.py``) on the CPU, at
deepseek-v2-236b's ``smoke()`` widths in float32.

The same numpy inputs and weights go to both. The prefill (S below and at
a multiple of ``attn_chunk``), the absorbed decode's output and the cache
it writes in place, from a random cache, are held at rtol 1e-5, atol
1e-5: the same float32 operations, summed in other orders (BLAS against
XLA). Gradients of a weighted sum of the prefill, with respect to the
input and every weight, within a relative L2 error of 1e-4 of
``jax.grad``'s. Within the port: decode steps from a zero cache against
the prefill's positions, and the parameter and cache layouts against the
reference's ``eval_shape``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401
jnp = jax.numpy

from repro.configs import registry as rreg  # noqa: E402
from repro.models import attention as Ra  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as Ta  # noqa: E402
from repro_torch.models import lm as Tlm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NAME = "deepseek-v2-236b"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-4


def _cfgs():
    return rreg.get(NAME).smoke(), treg.get(NAME).smoke()


def _params(rcfg, seed):
    """The reference's ``init_mla`` as numpy, and as port tensors."""
    rp = jax.tree.map(np.asarray, Ra.init_mla(jax.random.PRNGKey(seed), rcfg))
    return rp, Tlm.tree_map(lambda a: torch.from_numpy(a.copy()), rp)


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def test_smoke_widths_are_the_references():
    rcfg, tcfg = _cfgs()
    assert tcfg.use_mla and tcfg.mla.__dict__ == rcfg.mla.__dict__
    assert (tcfg.mla.kv_lora, tcfg.mla.q_lora, tcfg.mla.rope_head_dim,
            tcfg.mla.nope_head_dim, tcfg.mla.v_head_dim) == (64, 64, 16, 32, 32)
    assert tcfg.attn_chunk == 64 and tcfg.n_heads == 4


@pytest.mark.parametrize("s", [24, 64, 128])
def test_mla_attention_matches_reference(s):
    """S below ``attn_chunk`` (one short chunk), equal to it and two chunks."""
    rcfg, tcfg = _cfgs()
    rp, tp = _params(rcfg, 1)
    x = _x(s, 2, s, rcfg.d_model)
    pos = np.arange(s)
    want = np.asarray(jax.jit(lambda p, x: Ra.mla_attention(p, rcfg, x, jnp.asarray(pos)))(
        rp, jnp.asarray(x)))
    got = Ta.mla_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert got.shape == (2, s, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _random_cache(rcfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                        Ra.init_mla_cache(rcfg, b, s, jnp.float32))


def test_decode_mla_and_cache_match_reference():
    """Four steps from a random cache: each output, and the cache after each
    step, written into the port's cache tensors in place."""
    rcfg, tcfg = _cfgs()
    rp, tp = _params(rcfg, 2)
    rc = _random_cache(rcfg, 3, 2, 16)
    tc = {k: torch.from_numpy(v.copy()) for k, v in rc.items()}
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    step = jax.jit(lambda p, x, c, pos: Ra.decode_mla(p, rcfg, x, c, pos))
    for t, pos in enumerate((0, 3, 4, 15)):
        x = _x(10 + t, 2, 1, rcfg.d_model)
        want, rc = step(rp, jnp.asarray(x), rc, jnp.int32(pos))
        got, tc2 = Ta.decode_mla(tp, tcfg, torch.from_numpy(x), tc, pos)
        assert tc2 is tc and {k: v.data_ptr() for k, v in tc.items()} == ptrs
        assert got.shape == (2, 1, tcfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), **TOL)


def test_decode_steps_match_prefill():
    """Decode through a zero cache, token by token, reproduces the
    prefill's outputs at every position (the absorbed form against the
    decompressed one)."""
    rcfg, tcfg = _cfgs()
    _, tp = _params(rcfg, 4)
    s = 24
    x = torch.from_numpy(_x(5, 2, s, tcfg.d_model))
    want = Ta.mla_attention(tp, tcfg, x, torch.arange(s))
    cache = Ta.init_mla_cache(tcfg, 2, s, torch.float32, "cpu")
    got = torch.cat([Ta.decode_mla(tp, tcfg, x[:, t:t + 1], cache, t)[0]
                     for t in range(s)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_gradients_match_reference():
    """d/d(x, every weight) of sum(w * mla_attention(x)) against
    ``jax.grad``, each within a relative L2 error of 1e-4."""
    rcfg, tcfg = _cfgs()
    rp, tp = _params(rcfg, 6)
    s = 128
    x = _x(7, 2, s, rcfg.d_model)
    w = _x(8, 2, s, rcfg.d_model)
    pos = np.arange(s)

    def loss(p, x):
        return jnp.sum(Ra.mla_attention(p, rcfg, x, jnp.asarray(pos)) * jnp.asarray(w))
    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(rp, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = Tlm.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    (Ta.mla_attention(tp, tcfg, tx, torch.from_numpy(pos)) * torch.from_numpy(w)).sum() \
        .backward()
    pairs = [(tx.grad, want_x)] + list(zip((p.grad for p in leaves),
                                           jax.tree.leaves(want_p)))
    assert len(pairs) == 1 + len(jax.tree.leaves(rp))
    for g, r in pairs:
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        assert np.linalg.norm(g - r) <= GRAD_REL_L2 * np.linalg.norm(r)


def _layout(tree):
    return [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in jax.tree.leaves(tree)]


def _np_dtype(t):
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[t.dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_reference_eval_shape(dtype):
    """The mixer's and the whole model's parameter trees (stacked over
    periods, ``block0`` dense), and the caches: the same leaves, shapes and
    dtypes as the reference's ``eval_shape``, in ``jax.tree.leaves`` order."""
    rcfg, tcfg = _cfgs()
    rcfg = rcfg.replace(param_dtype=jnp.dtype(dtype), dtype=jnp.dtype(dtype))
    tcfg = tcfg.replace(param_dtype=getattr(torch, dtype), dtype=getattr(torch, dtype))
    key = jax.random.PRNGKey(0)

    def port(tree):
        return [(tuple(a.shape), _np_dtype(a)) for a in Tlm.tree_leaves(tree)]

    mixer = jax.eval_shape(lambda k: Ra.init_mla(k, rcfg), key)
    assert port(Ta.init_mla(None, tcfg, "meta")) == _layout(mixer)
    stacked = port(Ta.init_mla(None, tcfg, "meta", periods=3))
    assert stacked == [((3, *s), d) for s, d in _layout(mixer)]
    model = jax.eval_shape(lambda k: RM.init(rcfg, k), key)
    tp = TM.init(tcfg, None, device="meta")
    assert port(tp) == _layout(model)
    assert set(tp["block0"]["mixer"]) == set(tp["slots"][0]["mixer"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
    rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, None, 2, 16))
    tcache = TM.init_cache(tcfg, tp, 2, 16)
    assert port(tcache) == _layout(rcache)
    m = tcfg.mla
    assert tcache["slots"][0]["c_kv"].shape[-1] + tcache["slots"][0]["k_rope"].shape[-1] \
        == m.kv_lora + m.rope_head_dim
