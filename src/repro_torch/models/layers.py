"""Shared primitive layers: norms, RoPE, embeddings, gated MLPs.

Plain functions over explicit parameter dicts, under the reference's names
and layouts (``src/repro/models/layers.py``). ``init_*`` take an explicit
``torch.Generator``, device and, with ``periods``, build each leaf stacked
over the periods of a layer pattern (the reference's ``vmap``'d init) in
its stored dtype at once, drawing one period at a time. On the ``meta``
device they draw nothing: the tree's shapes and dtypes without memory (the
reference's ``jax.eval_shape`` of its init).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def mlp(p, x, act="silu"):
    d, _, f = p["wi"].shape
    h = (x @ p["wi"].reshape(d, 2 * f).to(x.dtype)).unflatten(-1, (2, f))
    g = activation(h[..., 0, :], act)
    return (g * h[..., 1, :]) @ p["wo"].to(x.dtype)


# --- embeddings --------------------------------------------------------------

def init_embed(gen, vocab, d, dtype, device):
    return {"e": truncnorm(gen, (vocab, d), dtype, 1.0, device)}


def embed(p, tokens, dtype):
    # Index, then cast: the same values as the reference's cast-then-index,
    # without a table-sized copy per call.
    return p["e"][tokens].to(dtype)


def unembed(p, x):
    # d^-0.5 keeps logits O(1) at init for both tied and untied heads
    d = x.shape[-1]
    return (x @ p["e"].to(x.dtype).T) * d ** -0.5
