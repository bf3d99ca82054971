"""Attention mixers: GQA/MQA with RoPE and qk-norm, chunked-causal softmax,
sliding windows, cross attention, KV-cache decode, and DeepSeek-style MLA
(``src/repro/models/attention.py``).

Prefill runs the reference's online softmax over kv chunks, chunk by q
chunk, in float32 with its ``NEG_INF`` masking, so the port holds to its
arithmetic (no fused attention call: parity is held against these
operations). Decode consumes a (B, S_max, KV, hd) cache, writes the step's
k and v into it in place, and attends over the whole cache under the
causal mask.

MLA (DeepSeek-V2) compresses k and v into a low-rank ``c_kv`` per token
plus one headless RoPE key. Prefill decompresses them per head and runs
the same chunked softmax (v padded to the q/k head dim, sliced after).
Decode uses the absorbed form: scores and values go through the
compressed cache directly, so a token's cache is ``kv_lora + rope_hd``
values whatever the head count.

Over a world of ranks under tensor and sequence parallelism
(``models/sharding.py``):

* :func:`attention` takes this rank's block of the sequence where "seq"
  splits it and all-gathers the sequence on entry. Where "heads" (or
  "kv_heads") splits the heads, the rank runs its q heads against the KV
  heads they read (``wk``/``wv`` whole where the KV heads do not split),
  with RoPE at global positions and the causal softmax over the whole
  sequence, and its row-parallel ``wo`` partial is reduce-scattered to its
  sequence block (folded whole without "seq"). Without split heads the
  rank runs every head for its own positions' queries. The collectives
  are ``core.mesh``'s autograd functions (a replicated x enters the
  rank's heads through ``copy_in``), so training runs through them;
* the decode cache holds this rank's KV heads where "kv_heads" splits
  them, else its block of the positions where "kv_seq" does
  (:func:`kv_split`). :func:`decode_attention` runs the rank's heads
  against its cache heads and folds the ``wo`` partials; over a block of
  positions it runs flash-decoding: only the rank that owns ``pos``
  writes the step's k and v, q is gathered over the heads, each rank
  gives each head's partial maximum, sum of weights and weighted values
  over its positions, and the partials are combined under the exact
  maximum (``Mesh.amax``) and folded in rank order. A rank whose positions
  are all still empty gives a zero sum and no maximum;
* cross attention (:func:`_cross_world`) runs the rank's heads against the
  encoder's memory, which the encoder joins whole on every rank;
* MLA (:func:`mla_attention`, :func:`decode_mla`) runs the projections to
  its latents (``wq_a``, ``wkv_a`` and their norms, replicated) whole on
  every rank over the joined sequence, then the rank's heads of ``wq_b``,
  ``wk_b``, ``wv_b`` and ``wo`` ("heads", :func:`mla_heads`). Its headless
  latent cache is split by positions where "kv_seq" is on the world
  (:func:`mla_split`, as the reference's ``cache_specs`` splits it):
  flash-decoding through the absorbed scores.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.mesh import all_gather, copy_in, reduce_scatter
from . import sharding
from .layers import init_rms, rank_block, rms_norm, rope, truncnorm

NEG_INF = -2.0 ** 30


def init_attn(gen, cfg, device, periods=None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    p = {
        "wq": truncnorm(gen, (d, h, hd), dt, d ** -0.5, device, periods),
        "wk": truncnorm(gen, (d, kv, hd), dt, d ** -0.5, device, periods),
        "wv": truncnorm(gen, (d, kv, hd), dt, d ** -0.5, device, periods),
        "wo": truncnorm(gen, (h, hd, d), dt, (h * hd) ** -0.5, device, periods),
    }
    if cfg.qk_norm:
        p["qnorm"] = init_rms(hd, dt, device, periods)
        p["knorm"] = init_rms(hd, dt, device, periods)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk")."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).unflatten(-1, (h, k))


def _out(o, w):
    """einsum("bshk,hkd->bsd")."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.reshape(h * k, d).to(o.dtype)


def _qkv(p, cfg, x, positions):
    return (_q(p, cfg, x, positions, p["wq"]),
            *_kv(p, cfg, x, positions, p["wk"], p["wv"]))


def _q(p, cfg, x, positions, wq):
    q = _proj(x, wq)
    if cfg.qk_norm:
        q = rms_norm(p["qnorm"], q, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta)


def _kv(p, cfg, x, positions, wk, wv):
    k = _proj(x, wk)
    if cfg.qk_norm:
        k = rms_norm(p["knorm"], k, cfg.norm_eps)
    return rope(k, positions, cfg.rope_theta), _proj(x, wv)


def rank_heads(cfg):
    """``(q_lo, q_hi, kv_lo, kv_hi)``: the q heads this rank runs and the
    KV heads they read, where the rules split the heads over the world
    ("kv_heads" where D divides the KV heads, else "heads" where D divides
    the q heads); None otherwise."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    rep = h // kv
    block = sharding.kv_head_range(kv)
    if block is not None:
        return block[0] * rep, block[1] * rep, block[0], block[1]
    block = sharding.head_range(h)
    if block is None:
        return None
    lo, hi = block
    return lo, hi, lo // rep, (hi - 1) // rep + 1


def _rank_weights(p, cfg, heads, kv_whole=False):
    """(wq, wk, wv, wo) of this rank's heads (the KV heads all of them with
    ``kv_whole``)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    ql, qh, kl, kh = heads
    wk, wv = p["wk"], p["wv"]
    if not kv_whole:
        wk, wv = rank_block(wk, 1, (kl, kh), kv), rank_block(wv, 1, (kl, kh), kv)
    return (rank_block(p["wq"], 1, (ql, qh), h), wk, wv,
            rank_block(p["wo"], 0, (ql, qh), h))


def _grouped(k, cfg, heads):
    """The KV heads ``k`` (..., KV_r, hd) that this rank's q heads read, so
    that q head i reads KV head i // (H_r / KV_r): as they are where the
    rank's heads fill whole groups or sit in one, else one per q head."""
    ql, qh, kl, kh = heads
    rep = cfg.n_heads // cfg.n_kv_heads
    if (kh - kl) * rep == qh - ql or kh - kl == 1:
        return k
    idx = torch.arange(ql, qh, device=k.device) // rep - kl
    return k.index_select(-2, idx)


def _pick(s, c):
    """Largest divisor of s that is <= c (falls back to s itself)."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def _chunked_attention(q, k, v, q_pos, kv_pos, chunk, causal, window=0):
    """Online softmax over kv chunks, for each q chunk.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); positions give the mask.
    Returns (B, Sq, H, hd).
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    cq, ck = _pick(sq, chunk), _pick(skv, chunk)
    scale = hd ** -0.5
    # (b, g, r, s, hd) queries; (b, g, 1, hd, s) keys; (b, g, 1, s, hd) values
    qg = q.reshape(b, sq, kvh, rep, hd).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 3, 1).unsqueeze(2)
    vg = v.permute(0, 2, 1, 3).unsqueeze(2)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for i in range(0, sq, cq):
        qblk, qpos = qg[..., i:i + cq, :], q_pos[i:i + cq]
        m = torch.full((b, kvh, rep, cq), NEG_INF, **f32)
        l = torch.zeros((b, kvh, rep, cq), **f32)
        acc = torch.zeros((b, kvh, rep, cq, hd), **f32)
        for j in range(0, skv, ck):
            kpos = kv_pos[j:j + ck]
            s = (qblk @ kg[..., j:j + ck]) * scale         # (b, g, r, cq, ck)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s.float(), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(v.dtype) @ vg[..., j:j + ck, :]).float()
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.cat(outs, dim=3)                           # (b, g, r, sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attention(p, cfg, x, positions, causal=True, kv=None, kv_pos=None):
    """Full-sequence attention (prefill, training, encoder, cross).
    x: (B, S, D); positions (S,).

    kv: an optional (B, S_enc, D) encoder memory to attend to (cross
    attention, ``kv_pos`` its positions): no RoPE on q or k, ``qk_norm``
    where the config has it.

    Over a world under tensor and sequence parallelism, ``positions`` are
    the whole sequence's and ``x`` is this rank's block of it where "seq"
    splits it; the output is the same block (module docstring)."""
    mesh = sharding.get_mesh()
    if mesh is not None and mesh.size > 1:
        if kv is None:
            return _attention_world(p, cfg, x, positions, causal)
        return _cross_world(p, cfg, x, positions, kv, kv_pos, causal)
    if kv is not None:
        return _cross(p, cfg, x, kv, positions, kv_pos, causal)
    q, k, v = _qkv(p, cfg, x, positions)
    out = _chunked_attention(q, k, v, positions, positions, cfg.attn_chunk,
                             causal, cfg.window)
    return _out(out, p["wo"])


def _cross(p, cfg, x, kv, q_pos, kv_pos, causal, heads=None):
    """Cross attention of the queries of ``x`` at ``q_pos`` to the memory
    ``kv``, of every head or of the rank's ``heads`` (``rank_heads``'s:
    its q heads against the KV heads they read)."""
    wq, wk, wv, wo = ((p["wq"], p["wk"], p["wv"], p["wo"]) if heads is None
                      else _rank_weights(p, cfg, heads))
    q, k, v = _proj(x, wq), _proj(kv, wk), _proj(kv, wv)
    if cfg.qk_norm:
        q = rms_norm(p["qnorm"], q, cfg.norm_eps)
        k = rms_norm(p["knorm"], k, cfg.norm_eps)
    if heads is not None:
        k, v = _grouped(k, cfg, heads), _grouped(v, cfg, heads)
    out = _chunked_attention(q, k, v, q_pos, kv_pos, cfg.attn_chunk, causal, cfg.window)
    return _out(out, wo)


def _cross_world(p, cfg, x, positions, kv, kv_pos, causal):
    """:func:`attention`'s cross attention over the rules' world: ``kv``
    the encoder's memory whole on every rank (``encdec.encode`` joins it),
    ``x`` the rank's block of the decoder's sequence where "seq" splits
    it. The rank's heads (q and the KV heads they read) over the joined
    sequence, the ``wo`` partial reduce-scattered (folded whole without
    "seq"); without split heads every head for the rank's queries."""
    mesh = sharding.get_mesh()
    seq = sharding.seq_range(len(positions))
    heads = rank_heads(cfg)
    if heads is None:
        q_pos = positions if seq is None else positions[seq[0]:seq[1]]
        return _cross(p, cfg, x, kv, q_pos, kv_pos, causal)
    xf = all_gather(mesh, x, 1) if seq is not None else copy_in(mesh, x)
    part = _cross(p, cfg, xf, kv, positions, kv_pos, causal, heads)
    return sharding.world_sum(part) if seq is None else reduce_scatter(mesh, part, 1)


def _attention_world(p, cfg, x, positions, causal=True):
    """:func:`attention` (self-attention, causal or not: an encoder's is
    not) over the rules' world."""
    mesh = sharding.get_mesh()
    seq = sharding.seq_range(len(positions))
    heads = rank_heads(cfg)
    # the rank's users of the joined sequence (its heads, or its queries)
    # make its gradient a partial; a replicated x entering the rank's heads
    # gets its gradient folded (``core.mesh.copy_in``)
    xf = (all_gather(mesh, x, 1) if seq is not None
          else copy_in(mesh, x) if heads is not None else x)
    if heads is None:
        # every head, for this rank's positions' queries
        q_pos = positions if seq is None else positions[seq[0]:seq[1]]
        q = _q(p, cfg, x, q_pos, p["wq"])
        k, v = _kv(p, cfg, xf, positions, p["wk"], p["wv"])
        out = _chunked_attention(q, k, v, q_pos, positions, cfg.attn_chunk, causal,
                                 cfg.window)
        return _out(out, p["wo"])
    wq, wk, wv, wo = _rank_weights(p, cfg, heads)
    q = _q(p, cfg, xf, positions, wq)
    k, v = _kv(p, cfg, xf, positions, wk, wv)
    out = _chunked_attention(q, _grouped(k, cfg, heads), _grouped(v, cfg, heads),
                             positions, positions, cfg.attn_chunk, causal, cfg.window)
    part = _out(out, wo)                                   # (B, S, D) partial
    return sharding.world_sum(part) if seq is None else reduce_scatter(mesh, part, 1)


# --- decode ------------------------------------------------------------------

def kv_split(cfg, seq_len):
    """How this rank's KV cache of ``seq_len`` positions is cut over the
    rules' world: ``("heads", lo, hi)`` its KV heads where "kv_heads"
    splits them, else ``("seq", lo, hi)`` its positions where "kv_seq" is
    on a world of D > 1 (D must divide ``seq_len``), else None (whole). The
    reference decides between the two by a constant ``model_size`` of 16
    (``cache_specs``); the port by the world's size."""
    block = sharding.kv_head_range(cfg.n_kv_heads)
    if block is not None:
        return ("heads", *block)
    return mla_split(seq_len)


def mla_split(seq_len):
    """``("seq", lo, hi)``: this rank's positions of a cache of ``seq_len``
    where "kv_seq" is on a world of D > 1 (D must divide ``seq_len``), else
    None: MLA's headless latent cache, and an attention cache whose KV heads
    do not split (:func:`kv_split`)."""
    mesh = sharding.get_mesh()
    if mesh is None or mesh.size == 1 or not sharding.on_world("kv_seq"):
        return None
    if seq_len % mesh.size:
        raise ValueError(f"a cache of {seq_len} positions does not split over "
                         f"{mesh.size} ranks ('kv_seq' on the world)")
    n = seq_len // mesh.size
    return ("seq", mesh.rank * n, (mesh.rank + 1) * n)


def init_kv_cache(cfg, batch, seq_len, dtype, device, periods=None):
    """Zero k and v caches (B, S, KV, hd), this rank's block of them over a
    world (:func:`kv_split`)."""
    s, kv = seq_len, cfg.n_kv_heads
    split = kv_split(cfg, seq_len)
    if split is not None:
        n = split[2] - split[1]
        s, kv = (s, n) if split[0] == "heads" else (n, kv)
    shape = (batch, s, kv, cfg.hd)
    full = shape if periods is None else (periods, *shape)
    return {"k": torch.zeros(full, dtype=dtype, device=device),
            "v": torch.zeros(full, dtype=dtype, device=device)}


def _attend(q, k, v, kv_pos, pos, window):
    """One query against the cache: q (B, G, R, hd), k and v (B, S, G, hd);
    the softmax over the positions ``kv_pos <= pos`` (and the window)."""
    hd = q.shape[-1]
    s_ = (q @ k.permute(0, 2, 3, 1)) * hd ** -0.5          # (b, g, r, s)
    mask = kv_pos <= pos
    if window:
        mask &= kv_pos > pos - window
    w = torch.softmax(torch.where(mask, s_.float(), NEG_INF), dim=-1)
    return w.to(v.dtype) @ v.permute(0, 2, 1, 3)          # (b, g, r, hd)


def decode_attention(p, cfg, x, cache, pos):
    """One-token decode. x: (B, 1, D); pos: int, the cache index. Writes the
    step's k and v into ``cache`` in place and returns (out, cache).

    Over a world, ``cache`` is this rank's (:func:`kv_split`) and x the
    same on every rank (module docstring)."""
    mesh = sharding.get_mesh()
    if mesh is not None and mesh.size > 1:
        split = kv_split(cfg, cache["k"].shape[-3] * mesh.size)
        if split is not None and split[0] == "seq":
            return _decode_flash(p, cfg, x, cache, pos)
        if rank_heads(cfg) is not None:
            return _decode_heads(p, cfg, x, cache, pos, split)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)                   # (B, 1, H, hd)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    b, s, kvh, hd = cache["k"].shape
    rep = cfg.n_heads // kvh
    qg = q.reshape(b, kvh, rep, hd)
    o = _attend(qg, cache["k"], cache["v"], torch.arange(s, device=x.device), pos,
                cfg.window)
    return _out(o.reshape(b, 1, cfg.n_heads, hd), p["wo"]), cache


def _decode_heads(p, cfg, x, cache, pos, split):
    """Decode over the world with the heads split: this rank's q heads
    against the KV heads they read, from its cache heads (``split``) or a
    whole cache that every rank writes; the ``wo`` partials folded."""
    heads = rank_heads(cfg)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    wq, wk, wv, wo = _rank_weights(p, cfg, heads, kv_whole=split is None)
    q = _q(p, cfg, x, positions, wq)                       # (B, 1, H_r, hd)
    k, v = _kv(p, cfg, x, positions, wk, wv)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    ck, cv = cache["k"], cache["v"]
    if split is None:                                       # whole: the heads read
        ck, cv = ck[:, :, heads[2]:heads[3]], cv[:, :, heads[2]:heads[3]]
    ck, cv = _grouped(ck, cfg, heads), _grouped(cv, cfg, heads)
    b, s, g, hd = ck.shape
    h_r = heads[1] - heads[0]
    o = _attend(q.reshape(b, g, h_r // g, hd), ck, cv, torch.arange(s, device=x.device),
                pos, cfg.window)
    return sharding.world_sum(_out(o.reshape(b, 1, h_r, hd), wo)), cache


def _decode_flash(p, cfg, x, cache, pos):
    """Decode over the world with the cache split by positions (module
    docstring: flash-decoding, its partials folded in rank order)."""
    mesh = sharding.get_mesh()
    heads = rank_heads(cfg)
    b, s_r, g, hd = cache["k"].shape
    lo = mesh.rank * s_r
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    if lo <= pos < lo + s_r:                                # this rank owns pos
        k, v = _kv(p, cfg, x, positions, p["wk"], p["wv"])
        cache["k"][:, pos - lo] = k[:, 0]
        cache["v"][:, pos - lo] = v[:, 0]
    h = cfg.n_heads
    if heads is None:
        q = _q(p, cfg, x, positions, p["wq"])               # (B, 1, H, hd)
    else:
        q = mesh.all_gather(_q(p, cfg, x, positions, rank_block(p["wq"], 1, heads[:2], h)),
                            2)
    f32 = dict(dtype=torch.float32, device=x.device)
    if lo <= pos and not (cfg.window and lo + s_r - 1 <= pos - cfg.window):
        kv_pos = lo + torch.arange(s_r, device=x.device)
        mask = kv_pos <= pos
        if cfg.window:
            mask &= kv_pos > pos - cfg.window
        s_ = (q.reshape(b, g, h // g, hd) @ cache["k"].permute(0, 2, 3, 1)) * hd ** -0.5
        s_ = torch.where(mask, s_.float(), float("-inf"))
        m_r = s_.amax(-1)                                   # (b, g, r)
        w = torch.exp(s_ - m_r[..., None])                  # masked: exactly 0
        l_r = w.sum(-1)
        o_r = (w.to(cache["v"].dtype) @ cache["v"].permute(0, 2, 1, 3)).float()
    else:                                                   # no position yet
        m_r = torch.full((b, g, h // g), float("-inf"), **f32)
        l_r = torch.zeros((b, g, h // g), **f32)
        o_r = torch.zeros((b, g, h // g, hd), **f32)
    m = mesh.amax(m_r).to(x.device)                         # finite: the owner's
    scale = torch.where(torch.isinf(m_r), 0.0, torch.exp(m_r - m))
    l_r, o_r = (l_r * scale).reshape(b, h), (o_r * scale[..., None]).reshape(b, h, hd)
    if heads is None:
        o = sharding.world_sum(o_r) / sharding.world_sum(l_r)[..., None]
        return _out(o.to(x.dtype)[:, None], p["wo"]), cache
    o = mesh.reduce_scatter(o_r, 1) / mesh.reduce_scatter(l_r, 1)[..., None]
    wo = rank_block(p["wo"], 0, heads[:2], h)
    return sharding.world_sum(_out(o.to(x.dtype)[:, None], wo)), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV and a decoupled RoPE head.
# ---------------------------------------------------------------------------

def init_mla(gen, cfg, device, periods=None):
    d, h, m, dt = cfg.d_model, cfg.n_heads, cfg.mla, cfg.param_dtype
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        # q path (low rank)
        "wq_a": truncnorm(gen, (d, m.q_lora), dt, d ** -0.5, device, periods),
        "q_norm": init_rms(m.q_lora, dt, device, periods),
        "wq_b": truncnorm(gen, (m.q_lora, h, qd), dt, m.q_lora ** -0.5, device, periods),
        # kv path: the compressed c_kv and the shared rope key
        "wkv_a": truncnorm(gen, (d, m.kv_lora + m.rope_head_dim), dt, d ** -0.5, device,
                           periods),
        "kv_norm": init_rms(m.kv_lora, dt, device, periods),
        "wk_b": truncnorm(gen, (m.kv_lora, h, m.nope_head_dim), dt, m.kv_lora ** -0.5,
                          device, periods),
        "wv_b": truncnorm(gen, (m.kv_lora, h, m.v_head_dim), dt, m.kv_lora ** -0.5,
                          device, periods),
        "wo": truncnorm(gen, (h, m.v_head_dim, d), dt, (h * m.v_head_dim) ** -0.5,
                        device, periods),
    }


def mla_heads(cfg):
    """``(lo, hi)``: the MLA heads this rank runs where "heads" splits them
    over the rules' world (``sharding.head_range``), else None."""
    return sharding.head_range(cfg.n_heads)


def _mla_weights(p, cfg, heads):
    """(wq_b, wk_b, wv_b, wo) of the heads ``heads`` (all of them: None)."""
    if heads is None:
        return p["wq_b"], p["wk_b"], p["wv_b"], p["wo"]
    h = cfg.n_heads
    return (*(rank_block(p[k], 1, heads, h) for k in ("wq_b", "wk_b", "wv_b")),
            rank_block(p["wo"], 0, heads, h))


def _mla_q(p, cfg, x, positions, wq_b):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)) of the heads of
    ``wq_b``, the rope rotated; ``wq_a`` and its norm whole."""
    m = cfg.mla
    ql = rms_norm(p["q_norm"], x @ p["wq_a"].to(x.dtype), cfg.norm_eps)
    q_nope, q_rope = _proj(ql, wq_b).split([m.nope_head_dim, m.rope_head_dim], -1)
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(p, cfg, x, positions):
    """(c_kv (B, S, kv_lora), k_rope (B, S, rope)), the rope rotated."""
    m = cfg.mla
    c_kv, k_rope = (x @ p["wkv_a"].to(x.dtype)).split([m.kv_lora, m.rope_head_dim], -1)
    c_kv = rms_norm(p["kv_norm"], c_kv, cfg.norm_eps)
    # the headless shared rope key, through a singleton head axis
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_core(p, cfg, xq, xkv, q_pos, positions, weights):
    """MLA's queries of ``xq`` at ``q_pos`` against the keys and values of
    ``xkv`` at ``positions``, through ``weights`` (:func:`_mla_weights`'s,
    of some heads): k and v decompressed per head, the chunked softmax at
    the q/k head dim (scale (nope + rope)^-0.5), ``wo``'s product."""
    m = cfg.mla
    wq_b, wk_b, wv_b, wo = weights
    q_nope, q_rope = _mla_q(p, cfg, xq, q_pos, wq_b)
    c_kv, k_rope = _mla_kv(p, cfg, xkv, positions)
    k_nope, v = _proj(c_kv, wk_b), _proj(c_kv, wv_b)
    k_rope_h = k_rope[:, :, None, :].expand(-1, -1, wk_b.shape[1], -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    # v padded to the q/k head dim for the shared chunked softmax, sliced after
    out = _chunked_attention(q, k, F.pad(v, (0, q.shape[-1] - v.shape[-1])),
                             q_pos, positions, cfg.attn_chunk, True, cfg.window)
    return _out(out[..., :m.v_head_dim], wo)


def mla_attention(p, cfg, x, positions):
    """Prefill and training MLA (:func:`_mla_core`). Over a world under
    tensor and sequence parallelism, ``positions`` are the whole
    sequence's and ``x`` this rank's block of it where "seq" splits it
    (the output is the same block): the joined sequence through the
    replicated ``wq_a``/``wkv_a`` and their norms, then the rank's heads of
    ``wq_b``/``wk_b``/``wv_b``/``wo``, whose partial is reduce-scattered
    (folded whole without "seq"), as :func:`_attention_world` does; without
    split heads every head for the rank's positions' queries."""
    mesh = sharding.get_mesh()
    seq = sharding.seq_range(len(positions))
    heads = mla_heads(cfg)
    if seq is None and heads is None:
        return _mla_core(p, cfg, x, x, positions, positions, _mla_weights(p, cfg, None))
    xf = all_gather(mesh, x, 1) if seq is not None else copy_in(mesh, x)
    if heads is None:
        q_pos = positions[seq[0]:seq[1]]
        return _mla_core(p, cfg, x, xf, q_pos, positions, _mla_weights(p, cfg, None))
    part = _mla_core(p, cfg, xf, xf, positions, positions, _mla_weights(p, cfg, heads))
    return sharding.world_sum(part) if seq is None else reduce_scatter(mesh, part, 1)


def init_mla_cache(cfg, batch, seq_len, dtype, device, periods=None):
    """Zero ``c_kv`` and ``k_rope`` caches (B, S, *), this rank's block of
    the positions over a world where "kv_seq" is on it (:func:`mla_split`)."""
    m = cfg.mla
    split = mla_split(seq_len)
    s = seq_len if split is None else split[2] - split[1]
    lead = (batch, s) if periods is None else (periods, batch, s)
    return {"c_kv": torch.zeros((*lead, m.kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, m.rope_head_dim), dtype=dtype, device=device)}


def _mla_absorbed_q(p, cfg, x, positions, heads):
    """The step's absorbed queries of the heads ``heads``: (q_abs (B, H_r,
    kv_lora), q_rope (B, H_r, rope)), ``W_uk`` absorbed into q."""
    wq_b, wk_b, _, _ = _mla_weights(p, cfg, heads)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, wq_b)
    # (H, B, nope) @ (H, nope, L) -> (B, H, L)
    q_abs = (q_nope[:, 0].transpose(0, 1) @ wk_b.to(x.dtype).permute(1, 2, 0)).transpose(0, 1)
    return q_abs, q_rope[:, 0]


def _mla_out(p, cfg, ctx, heads, dtype):
    """``W_uv`` and ``wo`` of the heads ``heads`` on ``ctx`` (B, H_r, L)."""
    _, _, wv_b, wo = _mla_weights(p, cfg, heads)
    # W_uv: (H, B, L) @ (H, L, v) -> (B, H, v)
    o = (ctx.transpose(0, 1) @ wv_b.to(dtype).transpose(0, 1)).transpose(0, 1)
    return _out(o[:, None], wo)


def decode_mla(p, cfg, x, cache, pos):
    """Absorbed-form MLA decode. x: (B, 1, D); pos: int, the cache index.
    Writes the step's c_kv and k_rope into ``cache`` in place; scores and
    values go through the compressed cache. Returns (out, cache).

    Over a world ``cache`` is this rank's (:func:`mla_split`) and x the
    same on every rank: where the heads split, the rank's heads run
    against a whole cache that every rank writes and the ``wo`` partials
    are folded; over a block of positions it runs flash-decoding as
    :func:`_decode_flash` does (:func:`_decode_mla_flash`)."""
    m = cfg.mla
    mesh = sharding.get_mesh()
    heads = mla_heads(cfg)
    if mesh is not None and mesh.size > 1 and \
            mla_split(cache["c_kv"].shape[-2] * mesh.size) is not None:
        return _decode_mla_flash(p, cfg, x, cache, pos, heads, mesh)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q_abs, q_rope = _mla_absorbed_q(p, cfg, x, positions, heads)
    c_kv, k_rope = _mla_kv(p, cfg, x, positions)
    cache["c_kv"][:, pos] = c_kv[:, 0]
    cache["k_rope"][:, pos] = k_rope[:, 0]
    ckv = cache["c_kv"]                                   # (B, S, L)
    s_c = q_abs @ ckv.transpose(1, 2)                     # (B, H, S)
    s_r = q_rope @ cache["k_rope"].transpose(1, 2)
    s = (s_c + s_r) * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    kv_pos = torch.arange(ckv.shape[1], device=x.device)
    w = torch.softmax(torch.where(kv_pos <= pos, s.float(), NEG_INF), dim=-1)
    ctx = w.to(x.dtype) @ ckv                             # (B, H, L)
    out = _mla_out(p, cfg, ctx, heads, x.dtype)
    return (out if heads is None else sharding.world_sum(out)), cache


def _decode_mla_flash(p, cfg, x, cache, pos, heads, mesh):
    """:func:`decode_mla` over the world with the latent cache split by
    positions: only the rank that owns ``pos`` writes the step's latent;
    the absorbed queries are gathered over the heads where they split; each
    rank gives each head's partial maximum, sum of weights and weighted
    latent over its positions; the partials are combined under the exact
    maximum (``Mesh.amax``), reduce-scattered to the rank's heads (folded
    whole without split heads) in rank order, and ``W_uv`` and ``wo`` of
    the rank's heads run on the result, their partials folded."""
    m = cfg.mla
    b, s_r, _ = cache["c_kv"].shape
    lo = mesh.rank * s_r
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    if lo <= pos < lo + s_r:                                # this rank owns pos
        c_kv, k_rope = _mla_kv(p, cfg, x, positions)
        cache["c_kv"][:, pos - lo] = c_kv[:, 0]
        cache["k_rope"][:, pos - lo] = k_rope[:, 0]
    q_abs, q_rope = _mla_absorbed_q(p, cfg, x, positions, heads)
    if heads is not None:                                   # every head's
        q_abs, q_rope = mesh.all_gather(q_abs, 1), mesh.all_gather(q_rope, 1)
    h = q_abs.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    if lo <= pos:
        ckv = cache["c_kv"]
        s_ = ((q_abs @ ckv.transpose(1, 2) + q_rope @ cache["k_rope"].transpose(1, 2))
              * (m.nope_head_dim + m.rope_head_dim) ** -0.5)
        kv_pos = lo + torch.arange(s_r, device=x.device)
        s_ = torch.where(kv_pos <= pos, s_.float(), float("-inf"))
        m_r = s_.amax(-1)                                   # (B, H)
        w = torch.exp(s_ - m_r[..., None])                  # masked: exactly 0
        l_r = w.sum(-1)
        ctx_r = (w.to(ckv.dtype) @ ckv).float()             # (B, H, L)
    else:                                                   # no position yet
        m_r = torch.full((b, h), float("-inf"), **f32)
        l_r = torch.zeros((b, h), **f32)
        ctx_r = torch.zeros((b, h, m.kv_lora), **f32)
    mx = mesh.amax(m_r).to(x.device)                        # finite: the owner's
    scale = torch.where(torch.isinf(m_r), 0.0, torch.exp(m_r - mx))
    l_r, ctx_r = l_r * scale, ctx_r * scale[..., None]
    if heads is None:
        ctx = sharding.world_sum(ctx_r) / sharding.world_sum(l_r)[..., None]
        return _mla_out(p, cfg, ctx.to(x.dtype), None, x.dtype), cache
    ctx = mesh.reduce_scatter(ctx_r, 1) / mesh.reduce_scatter(l_r, 1)[..., None]
    return sharding.world_sum(_mla_out(p, cfg, ctx.to(x.dtype), heads, x.dtype)), cache
