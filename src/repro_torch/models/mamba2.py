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

Over a world of ranks where "heads" splits the SSD heads (the rules'
``head_range`` of them, :func:`ssm_heads`) each rank runs its heads: its
columns of z, x and dt and all of B and C from the fused ``in_proj`` and
conv, which every rank stores whole (with one group every head reads the
one B and C; ``models/model.layout``), its slices of the per-head leaves,
of ``out_norm`` and of ``out_proj``'s rows (whole, or cut by
``model.shard_params``). Its heads run over the whole sequence through
:func:`_ssd_chunked` unchanged: where "seq" splits the residual the
rank's block is all-gathered first, as the attention's is. The gated
RMSNorm spans ``d_inner``, so across the ranks: its sum of squares is the
ranks' partial sums folded in rank order (``core.mesh.fold_sum``), which
enters the rank's block through ``copy_in`` (its gradient is the ranks'
partials, folded). ``out_proj``'s partial is reduce-scattered to the
rank's block of the sequence, or folded whole (decode, or no "seq"). The
decode cache holds the rank's x channels and all of B and C in its conv
window, and its heads' SSM state. Without split heads and with "seq",
every rank runs every head over the gathered sequence and keeps its
block of the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.mesh import all_gather, copy_in, fold_sum, reduce_scatter
from . import sharding
from .layers import filled, init_rms, ones, rank_block, rms_norm, truncnorm, zeros


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


def ssm_heads(cfg):
    """``(lo, hi)``: the SSD heads this rank runs where "heads" splits them
    over the rules' world (``sharding.head_range``), else None."""
    return sharding.head_range(_dims(cfg)[2])


def _local(p, cfg):
    """(SSD heads, inner width, width of each of B and C) of the leaves
    ``p``: the whole mixer's, or a rank's (:func:`_rank_params`: its heads,
    all of B and C)."""
    m = cfg.mamba
    nh = p["a_log"].shape[-1]
    return nh, nh * m.head_dim, m.n_groups * m.d_state


def _rank_groups(cfg, heads):
    """``(lo, hi)``: the groups of B and C that the SSD heads ``heads``
    read, where those heads fill whole groups or sit in one (so that local
    head i reads local group i // (H_r / G_r), as :func:`_ssd_chunked`
    takes them); raises otherwise."""
    m, _, nh = _dims(cfg)
    rep = nh // m.n_groups
    lo, hi = heads[0] // rep, (heads[1] - 1) // rep + 1
    if (hi - lo) * rep != heads[1] - heads[0] and hi - lo != 1:
        raise ValueError(f"SSD heads {heads} straddle groups of {rep} heads: a rank's "
                         "heads must fill whole groups or sit in one")
    return lo, hi


def _rank_params(p, cfg, heads):
    """The mixer's leaves for the SSD heads ``heads``: the fused
    ``in_proj``'s columns of their z, x and dt and all of B and C, the
    conv's of their x and all of B and C (both stored whole), and the
    per-head leaves, ``out_norm`` and ``out_proj``'s rows sliced where
    whole or taken as cut (``layers.rank_block``)."""
    m, d_in, nh = _dims(cfg)
    gn = m.n_groups * m.d_state
    lo, hi = heads
    a, n = lo * m.head_dim, (hi - lo) * m.head_dim

    def take(w, runs):
        return torch.cat([w.narrow(-1, i, k) for i, k in runs], dim=-1)
    conv = [(a, n), (d_in, 2 * gn)]
    return {"in_proj": take(p["in_proj"], [(a, n), (d_in + a, n), (2 * d_in, 2 * gn),
                                           (2 * d_in + 2 * gn + lo, hi - lo)]),
            "conv_w": take(p["conv_w"], conv), "conv_b": take(p["conv_b"], conv),
            **{k: rank_block(p[k], 0, heads, nh) for k in ("a_log", "d_skip", "dt_bias")},
            "out_norm": {"scale": rank_block(p["out_norm"]["scale"], 0, (a, a + n), d_in)},
            "out_proj": rank_block(p["out_proj"], 0, (a, a + n), d_in)}


def _split_proj(p, cfg, x):
    nh, d_in, gn = _local(p, cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * gn, nh], -1)
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


def _gated_out(p, cfg, y, z, x_dtype, mesh=None):
    """The gated RMSNorm over ``d_inner``, then ``out_proj``. With ``mesh``
    (the SSD heads split) ``y`` and ``z`` are the rank's block of
    ``d_inner``: the sum of squares is folded over the ranks in rank order
    and enters the rank's block through ``copy_in`` (module docstring),
    and the product is the rank's partial of the output."""
    g = y * F.silu(z)
    if mesh is None:
        g = rms_norm(p["out_norm"], g, cfg.norm_eps)
    else:
        dt, g = g.dtype, g.float()
        ss = copy_in(mesh, fold_sum(mesh, g.square().sum(-1, keepdim=True)))
        g = g * torch.rsqrt(ss / _dims(cfg)[1] + cfg.norm_eps)
        g = (g * p["out_norm"]["scale"].float()).to(dt)
    return g @ p["out_proj"].to(x_dtype)


def _mix(p, cfg, x, heads=None, mesh=None):
    """The SSD mixer of the leaves ``p`` (the whole mixer's, or with
    ``heads`` and ``mesh`` the rank's, :func:`_rank_params`) over the
    whole sequence of ``x`` (B, S, D)."""
    m = cfg.mamba
    nh, d_in, gn = _local(p, cfg)
    z, xbc, dt = _split_proj(p, cfg, x)
    xbc = _causal_conv(p, xbc)
    xh, b_, c_ = torch.split(xbc, [d_in, gn, gn], -1)
    bsz, s = x.shape[:2]
    xh = xh.reshape(bsz, s, nh, m.head_dim)
    b_ = b_.reshape(bsz, s, m.n_groups, m.d_state)
    c_ = c_.reshape(bsz, s, m.n_groups, m.d_state)
    if heads is not None:
        lo, hi = _rank_groups(cfg, heads)
        b_, c_ = b_[:, :, lo:hi], c_[:, :, lo:hi]
    y = _ssd_chunked(xh, dt, p["a_log"], b_, c_, m.chunk)
    y = y + xh * p["d_skip"].to(xh.dtype)[:, None]
    return _gated_out(p, cfg, y.reshape(bsz, s, d_in), z, x.dtype, mesh)


def mamba_mixer(p, cfg, x, seq=None):
    """Full-sequence SSD mixer. x: (B, S, D) -> (B, S, D).

    Over a world (module docstring) ``seq`` is the whole sequence's length
    and ``x`` this rank's block of it where "seq" splits it; the output is
    the same block."""
    mesh = sharding.get_mesh()
    block = None if seq is None else sharding.seq_range(seq)
    heads = ssm_heads(cfg)
    if block is None and heads is None:
        return _mix(p, cfg, x)
    # the rank's heads (or its positions) make the joined x's gradient a
    # partial; a replicated x entering the rank's heads gets it folded
    xf = all_gather(mesh, x, 1) if block is not None else copy_in(mesh, x)
    if heads is None:                       # every head, the rank's positions
        return _mix(p, cfg, xf)[:, block[0]:block[1]]
    part = _mix(_rank_params(p, cfg, heads), cfg, xf, heads, mesh)
    return sharding.world_sum(part) if block is None else reduce_scatter(mesh, part, 1)


# --- decode ------------------------------------------------------------------

def init_mamba_cache(cfg, batch, dtype, device, periods=None):
    """The conv window in the activation dtype, the SSM state in float32;
    over a world where the SSD heads split, the rank's x channels with all
    of B and C, and its heads' state (:func:`ssm_heads`)."""
    m, d_in, nh = _dims(cfg)
    heads = ssm_heads(cfg)
    if heads is not None:
        nh = heads[1] - heads[0]
        d_in = nh * m.head_dim
    conv_dim = d_in + 2 * m.n_groups * m.d_state
    lead = (batch,) if periods is None else (periods, batch)
    return {
        "conv": torch.zeros((*lead, m.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, nh, m.head_dim, m.d_state), dtype=torch.float32,
                           device=device),
    }


def decode_mamba(p, cfg, x, cache, pos):
    """One-token SSD step. x: (B, 1, D). Writes the new conv window and SSM
    state into ``cache`` in place and returns (out, cache). Over a world
    where the SSD heads split, ``cache`` is the rank's and x the same on
    every rank: the rank's heads, ``out_proj``'s partials folded whole."""
    heads = ssm_heads(cfg)
    if heads is None:
        return _decode(p, cfg, x, cache), cache
    mesh = sharding.get_mesh()
    part = _decode(_rank_params(p, cfg, heads), cfg, x, cache, heads, mesh)
    return sharding.world_sum(part), cache


def _decode(p, cfg, x, cache, heads=None, mesh=None):
    """:func:`decode_mamba` of the leaves ``p`` (:func:`_mix`'s)."""
    m = cfg.mamba
    nh, d_in, gn = _local(p, cfg)
    z, xbc, dt = _split_proj(p, cfg, x)                     # (B, 1, *)
    window = torch.cat([cache["conv"], xbc], dim=1)         # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xbc.dtype))
    conv_out = F.silu(conv_out + p["conv_b"].to(xbc.dtype))
    xh, b_, c_ = torch.split(conv_out, [d_in, gn, gn], -1)
    xh = xh.reshape(-1, nh, m.head_dim)
    b_ = b_.reshape(-1, m.n_groups, m.d_state)
    c_ = c_.reshape(-1, m.n_groups, m.d_state)
    if heads is not None:
        lo, hi = _rank_groups(cfg, heads)
        b_, c_ = b_[:, lo:hi], c_[:, lo:hi]
    rep = nh // b_.shape[1]
    bh = b_.repeat_interleave(rep, 1).float()               # (B, H, N)
    ch = c_.repeat_interleave(rep, 1).float()
    a = -torch.exp(p["a_log"].float())
    dt0 = dt[:, 0]                                          # (B, H)
    decay = torch.exp(dt0 * a)
    upd = (xh.float() * dt0[..., None])[..., None] * bh[:, :, None, :]   # (B, H, P, N)
    ssm = cache["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm, ch).to(x.dtype)
    y = y + xh * p["d_skip"].to(xh.dtype)[:, None]
    out = _gated_out(p, cfg, y.reshape(-1, 1, d_in), z, x.dtype, mesh)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return out
