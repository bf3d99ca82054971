"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference's (``src/repro/models/encdec.py``) on the CPU, at
seamless-m4t-medium's ``smoke()`` size in float32.

The reference's parameters cross into the port through
``carry.params_from_reference``; frames and tokens are the same numpy
arrays. ``encode``, ``decode_train``, cross attention, the cross-KV cache
and ``encdec_decode_step`` (logits and the self caches) are held at rtol
1e-4, atol 1e-5, the LM stack's bar (``test_torch_models.py``). Within
the port: remat against no remat bitwise, ``train()`` resumed from its
checkpoint bitwise with bf16 parameters, and ``serve_loop``'s refusal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as rreg  # noqa: E402
from repro.models import attention as Ra  # noqa: E402
from repro.models import encdec as Red  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.carry import params_from_reference  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import attention as Ta  # noqa: E402
from repro_torch.models import encdec as Ted  # noqa: E402
from repro_torch.models import lm as Tlm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NAME = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Smoke-size tensors gain nothing from threads, and the suite runs six
    workers on the host's cores: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _arch():
    rcfg, tcfg = rreg.get(NAME).smoke(), treg.get(NAME).smoke()
    rp = RM.init(rcfg, jax.random.PRNGKey(0))
    return rcfg, tcfg, rp, params_from_reference(jax.tree.map(np.asarray, rp), tcfg)


def _arrays(cfg, seed, b=2, f=32, s=48):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, f, cfg.d_model)).astype(np.float32),
            g.integers(0, cfg.vocab, (b, s)))


def test_tree_is_layer_stacked():
    _, tcfg, _, tp = _arch()
    assert sorted(tp) == ["dec", "embed", "enc", "enc_norm", "final_norm", "head"]
    assert tp["enc"]["attn"]["wq"].shape[0] == tcfg.n_enc_layers
    assert tp["dec"]["cross"]["wk"].shape[0] == tcfg.n_layers


def test_encode_and_decode_train_match_reference():
    rcfg, tcfg, rp, tp = _arch()
    frames, toks = _arrays(rcfg, 1)
    rmem = jax.jit(lambda p, f: Red.encode(p, rcfg, f))(rp, jnp.asarray(frames))
    tmem = Ted.encode(tp, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(rmem), **TOL)
    # the decoder from the same memory
    want = jax.jit(lambda p, t, m: Red.decode_train(p, rcfg, t, m))(
        rp, jnp.asarray(toks, jnp.int32), rmem)
    got = Ted.decode_train(tp, tcfg, torch.from_numpy(toks),
                           torch.from_numpy(np.asarray(rmem).copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="needs frames"):
        Ted.encode(tp, tcfg, None)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_reference(qk_norm):
    """``attention(kv=memory)``: no RoPE, ``qk_norm`` where the config has
    it, every memory position visible."""
    rcfg, tcfg = (c.replace(qk_norm=qk_norm) for c in _arch()[:2])
    rp = jax.tree.map(np.asarray, Ra.init_attn(jax.random.PRNGKey(3), rcfg))
    tp = Tlm.tree_map(lambda a: torch.from_numpy(a.copy()), rp)
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 24, rcfg.d_model)).astype(np.float32)
    mem = g.standard_normal((2, 40, rcfg.d_model)).astype(np.float32)
    want = Ra.attention(rp, rcfg, jnp.asarray(x), jnp.arange(24), causal=False,
                        kv=jnp.asarray(mem), kv_pos=jnp.arange(40))
    got = Ta.attention(tp, tcfg, torch.from_numpy(x), torch.arange(24), causal=False,
                       kv=torch.from_numpy(mem), kv_pos=torch.arange(40))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cache_and_decode_steps_match_reference():
    """The cross K/V computed once from the frames, then four decode steps:
    the logits, the self caches written in place, the cross K/V untouched."""
    rcfg, tcfg, rp, tp = _arch()
    frames, toks = _arrays(rcfg, 5)
    rc = RM.init_cache(rcfg, rp, 2, 16, frames=jnp.asarray(frames))
    tc = TM.init_cache(tcfg, tp, 2, 16, frames=torch.from_numpy(frames))
    for part in ("cross", "self"):
        for k in ("k", "v"):
            assert tuple(tc[part][k].shape) == rc[part][k].shape
            np.testing.assert_allclose(tc[part][k].numpy(), np.asarray(rc[part][k]), **TOL)
    cross_k, self_k = tc["cross"]["k"].clone(), tc["self"]["k"]
    rstep = jax.jit(RM.make_decode_step(rcfg))
    tstep = TM.make_decode_step(tcfg)
    for t, pos in enumerate((0, 1, 2, 7)):
        rl, rc = rstep(rp, rc, jnp.asarray(toks[:, t:t + 1], jnp.int32), jnp.int32(pos))
        tl, tc = tstep(tp, tc, torch.from_numpy(toks[:, t:t + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    assert tc["self"]["k"] is self_k and torch.equal(tc["cross"]["k"], cross_k)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["self"][k].numpy(), np.asarray(rc["self"][k]), **TOL)


def test_remat_bitwise():
    """``remat=True`` (each encoder and decoder layer recomputed in the
    backward) and ``remat=False``: the same loss and gradients bit for
    bit."""
    _, tcfg, _, _ = _arch()
    frames, toks = _arrays(tcfg, 6, s=32)
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, 1, axis=1))}
    runs = []
    for remat in (True, False):
        tp = TM.init(tcfg, torch.Generator().manual_seed(2), "cpu")
        for p in Tlm.tree_leaves(tp):
            p.requires_grad_(True)
        loss = TM.loss_fn(tp, tcfg.replace(remat=remat), batch)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in Tlm.tree_leaves(tp)]))
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_train_resumed_bitwise(tmp_path):
    """Four steps straight against two, a restart and two more, with bf16
    parameters: the nested "enc"/"dec" stacks and the optimizer state
    through the checkpoint bit for bit; ``lm_batch`` draws the frames."""
    cfg = treg.get(NAME).smoke().replace(param_dtype=torch.bfloat16)
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    kw = dict(seed=5, batch_shape=(2, 64), log_every=0, device="cpu")
    p_full, o_full, l_full = train(cfg, opt_cfg, steps=4, **kw)
    train(cfg, opt_cfg, steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    p_res, o_res, l_res = train(cfg, opt_cfg, steps=4, ckpt_dir=str(tmp_path),
                                ckpt_every=2, **kw)
    assert l_res == l_full[2:] and np.isfinite(l_full).all()
    full, res = Tlm.tree_leaves([p_full, o_full]), Tlm.tree_leaves([p_res, o_res])
    assert len(full) == len(res)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(full, res))
    assert p_res["dec"]["cross"]["wq"].dtype == torch.bfloat16
    assert o_res.mu["enc"]["ffn"]["wi"].shape[0] == cfg.n_enc_layers


def test_serve_loop_refuses_an_encoder_decoder():
    with pytest.raises(ValueError, match="cannot serve an encoder-decoder"):
        serve_loop(treg.get(NAME).smoke(), n_requests=2, device="cpu")
