"""Mamba2 SSD (state-space duality) mixer: chunked prefill and train scan,
one-token decode (``src/repro/models/mamba2.py``).

Prefill and training run the SSD chunked algorithm (arXiv 2405.21060):
within a chunk the output is an attention-like quadratic form masked by
the decay kernel; across chunks a (H, hd, N) state is carried by an
ordered loop over the chunks. Decode keeps (conv window, SSM state) per
layer and writes the new ones into the cache it is given, in place (the
LM's decode walks the period stack through views of its caches).

The products are the reference's einsums, outside any kernel there too,
so ``torch.einsum`` computes them here. The within-chunk cumulative sum of
the decay exponents runs in float64 along a non-innermost axis, which the
card walks one element after another as the CPU does, and is rounded to
float32 once: the same bits on both devices and on every run, its
backward too (a float32 CUDA cumsum of a 1-D tensor is a look-back scan
whose grouping depends on timing).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import filled, init_rms, ones, rms_norm, truncnorm, zeros


def _dims(cfg):
    m = cfg.mamba
    return m, m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)


def init_mamba(gen, cfg, device, periods=None):
    m, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * m.n_groups * m.d_state
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        # order: [z (d_in), xBC (conv_dim), dt (nh)]
        "in_proj": truncnorm(gen, (d, 2 * d_in + 2 * m.n_groups * m.d_state + nh), dt,
                             d ** -0.5, device, periods),
        "conv_w": truncnorm(gen, (m.d_conv, conv_dim), dt, 0.2, device, periods),
        "conv_b": zeros((conv_dim,), dt, device, periods),
        "a_log": filled(torch.linspace(1.0, 16.0, nh, dtype=torch.float64).log(), dt,
                        device, periods),
        "d_skip": ones((nh,), dt, device, periods),
        "dt_bias": zeros((nh,), dt, device, periods),
        "out_norm": init_rms(d_in, dt, device, periods),
        "out_proj": truncnorm(gen, (d_in, d), dt, d_in ** -0.5, device, periods),
    }


def _split_proj(p, cfg, x):
    m, d_in, nh = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * m.n_groups * m.d_state, nh], -1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return z, xbc, dt                                       # dt: (B, S, H) float32


def _causal_conv(p, xbc):
    """Depthwise causal conv as shifted adds (the kernel is tiny), in the
    activation dtype, taps added in the reference's order."""
    kw = p["conv_w"].to(xbc.dtype)                          # (K, C)
    k, s = kw.shape[0], xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(k):
        shift = k - 1 - i
        out = out + F.pad(xbc, (0, 0, shift, 0))[:, :s] * kw[i]
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _chunk_cumsum(x):
    """Inclusive cumsum of (B, nc, q, H) float32 along the chunk axis 2, in
    float64 one element after another, rounded once (module docstring)."""
    if x.numel() == x.shape[2]:
        # a lone column would take the 1-D scan: add a zero one beside it
        return _chunk_cumsum(torch.cat([x, torch.zeros_like(x)], dim=3))[..., :1]
    return x.double().cumsum(2).float()


def _ssd_chunked(xh, dt, a_log, b_, c_, chunk):
    """SSD scan. xh: (B, S, H, P); dt: (B, S, H) float32; b_, c_: (B, S, G, N).

    Returns y: (B, S, H, P). G divides H (head h reads group h // (H / G)).
    """
    bsz, s, h, p_ = xh.shape
    g, n = b_.shape[2], b_.shape[3]
    rep = h // g
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {q}")
    nc = s // q
    a = -torch.exp(a_log.float())                           # (H,) negative
    dta = dt * a                                            # (B, S, H)

    xc = (xh * dt[..., None].to(xh.dtype)).reshape(bsz, nc, q, h, p_)
    bc = b_.reshape(bsz, nc, q, g, n)
    cc = c_.reshape(bsz, nc, q, g, n)
    seg = _chunk_cumsum(dta.reshape(bsz, nc, q, h))         # within-chunk cumsum

    # Intra-chunk (quadratic, causal, decay-masked):
    # L[i, j] = exp(seg_i - seg_j) for i >= j. Mask BEFORE exp: the upper
    # triangle has positive exponents whose inf would poison the gradient.
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # (B, nc, q, q, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    l_mask = torch.exp(torch.where(causal[:, :, None], li, -torch.inf))
    del li
    cb = torch.einsum("bcqgn,bckgn->bcqkg", cc, bc)         # (B, nc, q, q, G)
    # cb repeated over each group's heads, times the mask
    w = (cb[..., None] * l_mask.unflatten(-1, (g, rep))).flatten(-2)
    del l_mask
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w.to(xh.dtype), xc)
    del w

    # Chunk state: S_c = sum_j exp(seg_end - seg_j) B_j x_j^T
    decay_b = torch.exp(seg[:, :, -1:, :] - seg)            # (B, nc, q, H)
    xd = (xc * decay_b[..., None].to(xh.dtype)).unflatten(3, (g, rep))
    bx = torch.einsum("bcqgn,bcqgrp->bcgrpn", bc, xd).flatten(2, 3)   # (B, nc, H, P, N)

    # The states before each chunk, carried in chunk order in float32.
    chunk_decay = torch.exp(seg[:, :, -1, :])               # (B, nc, H)
    bx = bx.float()
    state = torch.zeros((bsz, h, p_, n), dtype=torch.float32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + bx[:, c]
    h_prevs = torch.stack(prevs, 1)                         # (B, nc, H, P, N)

    # Inter-chunk: y_j += C_j exp(seg_j) h_prev
    ch = cc.repeat_interleave(rep, dim=3)                   # (B, nc, q, H, N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           ch * torch.exp(seg)[..., None].to(ch.dtype),
                           h_prevs.to(ch.dtype))
    return (y_intra + y_inter).reshape(bsz, s, h, p_)


def _gated_out(p, cfg, y, z, x_dtype):
    y = rms_norm(p["out_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"].to(x_dtype)


def mamba_mixer(p, cfg, x):
    """Full-sequence SSD mixer. x: (B, S, D) -> (B, S, D)."""
    m, d_in, nh = _dims(cfg)
    gn = m.n_groups * m.d_state
    z, xbc, dt = _split_proj(p, cfg, x)
    xbc = _causal_conv(p, xbc)
    xh, b_, c_ = torch.split(xbc, [d_in, gn, gn], -1)
    bsz, s = x.shape[:2]
    xh = xh.reshape(bsz, s, nh, m.head_dim)
    b_ = b_.reshape(bsz, s, m.n_groups, m.d_state)
    c_ = c_.reshape(bsz, s, m.n_groups, m.d_state)
    y = _ssd_chunked(xh, dt, p["a_log"], b_, c_, m.chunk)
    y = y + xh * p["d_skip"].to(xh.dtype)[:, None]
    return _gated_out(p, cfg, y.reshape(bsz, s, d_in), z, x.dtype)


# --- decode ------------------------------------------------------------------

def init_mamba_cache(cfg, batch, dtype, device, periods=None):
    """The conv window in the activation dtype, the SSM state in float32."""
    m, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * m.n_groups * m.d_state
    lead = (batch,) if periods is None else (periods, batch)
    return {
        "conv": torch.zeros((*lead, m.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, nh, m.head_dim, m.d_state), dtype=torch.float32,
                           device=device),
    }


def decode_mamba(p, cfg, x, cache, pos):
    """One-token SSD step. x: (B, 1, D). Writes the new conv window and SSM
    state into ``cache`` in place and returns (out, cache)."""
    m, d_in, nh = _dims(cfg)
    gn = m.n_groups * m.d_state
    z, xbc, dt = _split_proj(p, cfg, x)                     # (B, 1, *)
    window = torch.cat([cache["conv"], xbc], dim=1)         # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xbc.dtype))
    conv_out = F.silu(conv_out + p["conv_b"].to(xbc.dtype))
    xh, b_, c_ = torch.split(conv_out, [d_in, gn, gn], -1)
    xh = xh.reshape(-1, nh, m.head_dim)
    rep = nh // m.n_groups
    bh = b_.reshape(-1, m.n_groups, m.d_state).repeat_interleave(rep, 1).float()  # (B, H, N)
    ch = c_.reshape(-1, m.n_groups, m.d_state).repeat_interleave(rep, 1).float()
    a = -torch.exp(p["a_log"].float())
    dt0 = dt[:, 0]                                          # (B, H)
    decay = torch.exp(dt0 * a)
    upd = (xh.float() * dt0[..., None])[..., None] * bh[:, :, None, :]   # (B, H, P, N)
    ssm = cache["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm, ch).to(x.dtype)
    y = y + xh * p["d_skip"].to(xh.dtype)[:, None]
    out = _gated_out(p, cfg, y.reshape(-1, 1, d_in), z, x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache
