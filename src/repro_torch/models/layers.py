"""Shared primitive layers: norms, RoPE, embeddings, gated MLPs.

Plain functions over explicit parameter dicts, under the reference's names
and layouts (``src/repro/models/layers.py``). ``init_*`` take an explicit
``torch.Generator``, device and, with ``periods``, build each leaf stacked
over the periods of a layer pattern (the reference's ``vmap``'d init) in
its stored dtype at once, drawing one period at a time. On the ``meta``
device they draw nothing: the tree's shapes and dtypes without memory (the
reference's ``jax.eval_shape`` of its init).

Over a world of ranks under tensor parallelism (``models/sharding.py``):
:func:`embed` and :func:`unembed` are vocab-parallel where given the
table's global row count (each rank's rows of ``e``), and :func:`mlp` is
column-parallel in ``wi`` and row-parallel in ``wo`` where given its
columns; the leaves may be whole or already cut to the rank's block
(:func:`rank_block`). The callers combine the partial results.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sharding


def _stacked(shape, dtype, device, periods):
    full = tuple(shape) if periods is None else (periods, *shape)
    return torch.empty(full, dtype=dtype, device=device)


def truncnorm(gen, shape, dtype, scale, device, periods=None):
    """N(0, 1) truncated to [-2, 2], times ``scale``, stored as ``dtype``.

    Each period is drawn in float32 (``trunc_normal_`` from ``gen``, which
    lies on ``device``) and cast into its slice of the stack, so the peak
    is the stack plus one period's float32 draw.
    """
    out = _stacked(shape, dtype, device, periods)
    if out.device.type == "meta":
        return out
    for part in ([out] if periods is None else out.unbind(0)):
        draw = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(draw.mul_(scale))
    return out


def ones(shape, dtype, device, periods=None):
    out = _stacked(shape, dtype, device, periods)
    return out if out.device.type == "meta" else out.fill_(1.0)


def zeros(shape, dtype, device, periods=None):
    out = _stacked(shape, dtype, device, periods)
    return out if out.device.type == "meta" else out.zero_()


def filled(values, dtype, device, periods=None):
    """``values`` (a float64 CPU tensor) rounded to float32, then to
    ``dtype`` (the reference computes them in float32), in every period of
    the stack."""
    out = _stacked(values.shape, dtype, device, periods)
    if out.device.type == "meta":
        return out
    return out.copy_(values.to(torch.float32).to(dtype).to(out.device))


# --- norms -----------------------------------------------------------------

def init_rms(d, dtype, device, periods=None):
    return {"scale": ones((d,), dtype, device, periods)}


def rms_norm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


# --- rotary embeddings -------------------------------------------------------

def rope(x, positions, theta):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device)
                     / half)
    ang = positions[..., None].float() * freq              # (..., S, half)
    if x.dim() > ang.dim():
        ang = ang[..., None, :]                            # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- dense / mlp -------------------------------------------------------------

def init_mlp(gen, d, f, dtype, device, periods=None):
    return {
        "wi": truncnorm(gen, (d, 2, f), dtype, d ** -0.5, device, periods),  # [gate, up]
        "wo": truncnorm(gen, (f, d), dtype, f ** -0.5, device, periods),
    }


def activation(gate, act):
    return F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")


def rank_block(w, dim, block, full):
    """``w``'s block ``(lo, hi)`` along ``dim``: ``w`` itself where it is
    already cut to it (``model.shard_params``), its slice where it is whole
    (``full`` long there)."""
    lo, hi = block
    if w.shape[dim] == full and hi - lo != full:
        return w.narrow(dim, lo, hi - lo)
    if w.shape[dim] != hi - lo:
        raise ValueError(f"a leaf of {tuple(w.shape)} is neither whole ({full}) nor "
                         f"this rank's block {block} along dim {dim}")
    return w


def mlp(p, x, act="silu", cols=None):
    """Gated MLP. ``cols``: ``(lo, hi, f)``, this rank's block of the ``f``
    hidden columns: ``wi``'s columns and ``wo``'s rows of it, whose product
    is this rank's partial of the output (summed over the ranks by the
    caller)."""
    wi, wo = p["wi"], p["wo"]
    if cols is not None:
        lo, hi, full = cols
        wi, wo = rank_block(wi, 2, (lo, hi), full), rank_block(wo, 0, (lo, hi), full)
    d, _, f = wi.shape
    h = (x @ wi.reshape(d, 2 * f).to(x.dtype)).unflatten(-1, (2, f))
    g = activation(h[..., 0, :], act)
    return (g * h[..., 1, :]) @ wo.to(x.dtype)


# --- embeddings --------------------------------------------------------------

def init_embed(gen, vocab, d, dtype, device):
    return {"e": truncnorm(gen, (vocab, d), dtype, 1.0, device)}


def embed(p, tokens, dtype, vocab=None):
    """The rows of ``e`` for ``tokens``, cast to ``dtype``. With ``vocab``
    (the table's global rows) where the rules split the vocab over the
    world: this rank's rows only, exact zeros for the tokens outside them,
    a partial that the caller sums over the ranks (one rank adds each
    row, every other an exact zero)."""
    e = p["e"]
    block = None if vocab is None else sharding.vocab_range(vocab)
    if block is None:
        # Index, then cast: the same values as the reference's
        # cast-then-index, without a table-sized copy per call.
        return e[tokens].to(dtype)
    e = rank_block(e, 0, block, vocab)
    local = tokens - block[0]
    inside = (local >= 0) & (local < e.shape[0])
    rows = e[local.clamp(0, e.shape[0] - 1)].to(dtype)
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=dtype,
                                                            device=rows.device))


def unembed(p, x, vocab=None):
    """Logits ``x @ e.T`` times d^-0.5 (which keeps logits O(1) at init for
    both tied and untied heads). With ``vocab`` where the rules split the
    vocab over the world: this rank's columns, then every rank's joined in
    rank order (``Mesh.all_gather``), the same bits on every rank."""
    d = x.shape[-1]
    block = None if vocab is None else sharding.vocab_range(vocab)
    if block is None:
        return (x @ p["e"].to(x.dtype).T) * d ** -0.5
    e = rank_block(p["e"], 0, block, vocab)
    return sharding.get_mesh().all_gather((x @ e.to(x.dtype).T) * d ** -0.5, -1)
