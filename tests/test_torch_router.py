"""The port's knapsack-priced MoE router against the reference
(``src/repro/core/moe_router.py``) on the CPU.

The port's price iteration is ``kernels.ops.scd_fused_hist`` with b = 1
and its Alg-1 mask ``kernels.ops.adjusted_topc``; here their plain
versions run. With b = 1 every histogram mass is a count, exact in any
order, and ``p - lam*b`` rounds as ``probs - lam``. What differs from the
jitted reference: XLA contracts the threshold's ``hi - width * frac``
into an FMA (an ulp of lam wherever the product is inexact, which the
edge ladder's ``1e-4 * 1.8**i`` makes it on dyadic inputs too), and its
CPU ``exp`` differs from PyTorch's by an ulp on some entries, so
probabilities from the same logits may differ in the last bit. Hence:
from the same probabilities, every field bitwise the reference's own
arithmetic run op by op (``jax.disable_jit``), and lam to rtol 1e-5 of
the jitted reference with masks and loads equal; from logits, lam to
rtol 1e-5, masks and loads equal, combine weights to rtol 1e-6. The
router's properties are the reference's tests (``tests/test_models.py``), on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

from repro.core import moe_router as R  # noqa: E402
from repro_torch.core import moe_router as T  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


FIELDS = ("combine", "mask", "lam", "load")
CF = 0.8      # from given probabilities: a capacity that binds at every q


def _logits(seed, t=128, e=8, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((t, e)) * scale).astype(np.float32)


def _probs(seed, dyadic, t=128, e=8):
    g = np.random.default_rng(seed)
    if dyadic:
        return (g.integers(0, 64, (t, e)) / 256.0).astype(np.float32)
    return g.dirichlet(np.ones(e), t).astype(np.float32)


def _reference_from_probs(monkeypatch, probs, op_by_op, **kw):
    """The reference's ``scd_route`` body with its softmax replaced by the
    identity: the router from ``probs`` itself; ``op_by_op`` runs it under
    ``jax.disable_jit`` (no fused arithmetic)."""
    monkeypatch.setattr(jax.nn, "softmax", lambda x, axis=-1: x)
    if op_by_op:
        with jax.disable_jit():
            out = R.scd_route.__wrapped__(jnp.asarray(probs), **kw)
    else:
        out = R.scd_route.__wrapped__(jnp.asarray(probs), **kw)
    monkeypatch.undo()
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


@pytest.mark.parametrize("dyadic,q,seed", [(True, 1, 0), (True, 3, 1), (False, 1, 1),
                                           (False, 2, 0)])
def test_router_from_probs_bitwise_reference(monkeypatch, dyadic, q, seed):
    p = _probs(seed, dyadic)
    cap = np.full((8,), CF * q * 128 / 8, np.float32)
    ref = _reference_from_probs(monkeypatch, p, True, q=q, capacity_factor=CF, iters=4)
    lam = T._scd_prices(torch.from_numpy(p), torch.from_numpy(cap), q, 4, 16, 1e-4, 1.8)
    assert np.array_equal(lam.numpy(), ref["lam"])
    assert ref["lam"].max() > 0, "capacity binds: the prices moved"
    out = T.scd_route_probs(torch.from_numpy(p), q=q, capacity_factor=CF, iters=4)
    for f in FIELDS:
        assert np.array_equal(getattr(out, f).numpy(), ref[f]), f
    jit = _reference_from_probs(monkeypatch, p, False, q=q, capacity_factor=CF, iters=4)
    np.testing.assert_allclose(out.lam.numpy(), jit["lam"], rtol=1e-5, atol=0)
    assert np.array_equal(out.mask.numpy(), jit["mask"])
    assert np.array_equal(out.load.numpy(), jit["load"])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("q", [1, 2, 3])
def test_scd_route_matches_reference(seed, q):
    lg = _logits(seed)
    ref = R.scd_route(jnp.asarray(lg), q=q, capacity_factor=1.1, iters=4)
    out = T.scd_route(torch.from_numpy(lg), q=q, capacity_factor=1.1, iters=4)
    np.testing.assert_allclose(out.lam.numpy(), np.asarray(ref.lam), rtol=1e-5, atol=0)
    assert np.array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(out.load.numpy(), np.asarray(ref.load))
    np.testing.assert_allclose(out.combine.numpy(), np.asarray(ref.combine),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("q", [1, 2, 3])
def test_topk_route_matches_reference(seed, q):
    lg = _logits(100 + seed)
    ref = R.topk_route(jnp.asarray(lg), q=q)
    out = T.topk_route(torch.from_numpy(lg), q=q)
    for f in ("mask", "load", "lam"):
        assert np.array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f))), f
    np.testing.assert_allclose(out.combine.numpy(), np.asarray(ref.combine),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("q", [1, 2, 3])
def test_scd_router_capacity_property(seed, q):
    """Expert load never exceeds capacity; per-token choices never exceed
    Q; combine weights only on assigned experts."""
    t, e = 128, 8
    out = T.scd_route(torch.from_numpy(_logits(1000 + seed)), q=q,
                      capacity_factor=1.1, iters=4)
    cap = 1.1 * q * t / e
    assert torch.all(out.load <= cap + 1e-6)
    assert torch.all(out.mask.sum(1) <= q)
    assert torch.all((out.combine > 0) <= out.mask)


def test_scd_router_balances_better_than_topk():
    """Skewed logits: SCD pricing caps the hot expert; plain top-k
    overflows it."""
    t, e = 256, 8
    lg = np.random.default_rng(0).standard_normal((t, e)).astype(np.float32)
    lg[:, 0] += 4.0                          # everyone loves expert 0
    cap = 1.25 * 2 * t / e
    scd = T.scd_route(torch.from_numpy(lg), q=2, capacity_factor=1.25, iters=6)
    topk = T.topk_route(torch.from_numpy(lg), q=2)
    assert float(topk.load.max()) > cap
    assert float(scd.load.max()) <= cap + 1e-6
    assert float(scd.mask.sum()) >= 0.7 * float(topk.mask.sum())


def test_router_prices_carry_no_gradient():
    lg = torch.from_numpy(_logits(7)).requires_grad_(True)
    out = T.scd_route(lg, q=2)
    assert not out.lam.requires_grad and not out.mask.requires_grad
    out.combine.sum().backward()
    assert lg.grad is not None and torch.isfinite(lg.grad).all()


def test_scd_route_wide_matches_reference():
    """deepseek-v2-236b's router width: 1,024 tokens over 160 experts, q = 6
    (the kernels' wide instances on the card, the fused one at the tile
    ``router_tile`` picks, 64 rows), against the jitted reference at this
    file's bars: from logits, lam rtol 1e-5, masks and loads equal, combine
    weights rtol 1e-6."""
    t, e, q = 1024, 160, 6
    g = np.random.default_rng(160)
    lg = (g.standard_normal((t, e)) * 2 + g.standard_normal(e)).astype(np.float32)
    assert T.router_tile(e, 33) == 64
    ref = R.scd_route(jnp.asarray(lg), q=q, capacity_factor=1.25, iters=4)
    out = T.scd_route(torch.from_numpy(lg), q=q, capacity_factor=1.25, iters=4)
    assert float(np.asarray(ref.lam).max()) > 0, "capacity binds: the prices moved"
    np.testing.assert_allclose(out.lam.numpy(), np.asarray(ref.lam), rtol=1e-5, atol=0)
    assert np.array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(out.load.numpy(), np.asarray(ref.load))
    np.testing.assert_allclose(out.combine.numpy(), np.asarray(ref.combine),
                               rtol=1e-6, atol=0)
    assert float(out.load.max()) <= 1.25 * q * t / e + 1e-6
