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
(``models/sharding.py``; GQA, MQA and MHA only):

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
  are all still empty gives a zero sum and no maximum.
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
    if kv is None and mesh is not None and mesh.size > 1:
        return _attention_world(p, cfg, x, positions, causal)
    if kv is None:
        q, k, v = _qkv(p, cfg, x, positions)
        kv_pos = positions
    else:
        q, k, v = _proj(x, p["wq"]), _proj(kv, p["wk"]), _proj(kv, p["wv"])
        if cfg.qk_norm:
            q = rms_norm(p["qnorm"], q, cfg.norm_eps)
            k = rms_norm(p["knorm"], k, cfg.norm_eps)
    out = _chunked_attention(q, k, v, positions, kv_pos, cfg.attn_chunk,
                             causal, cfg.window)
    return _out(out, p["wo"])


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


def _mla_qc(p, cfg, x, positions):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), c_kv (B, S, kv_lora),
    k_rope (B, S, rope)), both ropes rotated."""
    m = cfg.mla
    ql = rms_norm(p["q_norm"], x @ p["wq_a"].to(x.dtype), cfg.norm_eps)
    q_nope, q_rope = _proj(ql, p["wq_b"]).split([m.nope_head_dim, m.rope_head_dim], -1)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ p["wkv_a"].to(x.dtype)).split([m.kv_lora, m.rope_head_dim], -1)
    c_kv = rms_norm(p["kv_norm"], c_kv, cfg.norm_eps)
    # the headless shared rope key, through a singleton head axis
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(p, cfg, x, positions):
    """Prefill and training MLA: k and v decompressed per head, the chunked
    softmax at the q/k head dim (scale (nope + rope)^-0.5)."""
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, cfg, x, positions)
    k_nope, v = _proj(c_kv, p["wk_b"]), _proj(c_kv, p["wv_b"])
    k_rope_h = k_rope[:, :, None, :].expand(-1, -1, cfg.n_heads, -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    # v padded to the q/k head dim for the shared chunked softmax, sliced after
    out = _chunked_attention(q, k, F.pad(v, (0, q.shape[-1] - v.shape[-1])),
                             positions, positions, cfg.attn_chunk, True, cfg.window)
    return _out(out[..., :m.v_head_dim], p["wo"])


def init_mla_cache(cfg, batch, seq_len, dtype, device, periods=None):
    m = cfg.mla
    lead = (batch, seq_len) if periods is None else (periods, batch, seq_len)
    return {"c_kv": torch.zeros((*lead, m.kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, m.rope_head_dim), dtype=dtype, device=device)}


def decode_mla(p, cfg, x, cache, pos):
    """Absorbed-form MLA decode. x: (B, 1, D); pos: int, the cache index.
    Writes the step's c_kv and k_rope into ``cache`` in place; scores and
    values go through the compressed cache. Returns (out, cache)."""
    m = cfg.mla
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, cfg, x, positions)
    cache["c_kv"][:, pos] = c_kv[:, 0]
    cache["k_rope"][:, pos] = k_rope[:, 0]
    ckv = cache["c_kv"]                                   # (B, S, L)
    # W_uk absorbed into q: (H, B, nope) @ (H, nope, L) -> (B, H, L)
    wk = p["wk_b"].to(x.dtype).permute(1, 2, 0)
    q_abs = (q_nope[:, 0].transpose(0, 1) @ wk).transpose(0, 1)
    s_c = q_abs @ ckv.transpose(1, 2)                     # (B, H, S)
    s_r = q_rope[:, 0] @ cache["k_rope"].transpose(1, 2)
    s = (s_c + s_r) * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    kv_pos = torch.arange(ckv.shape[1], device=x.device)
    w = torch.softmax(torch.where(kv_pos <= pos, s.float(), NEG_INF), dim=-1)
    ctx = w.to(x.dtype) @ ckv                             # (B, H, L)
    # W_uv: (H, B, L) @ (H, L, v) -> (B, H, v)
    o = (ctx.transpose(0, 1) @ p["wv_b"].to(x.dtype).transpose(0, 1)).transpose(0, 1)
    return _out(o[:, None], p["wo"]), cache
