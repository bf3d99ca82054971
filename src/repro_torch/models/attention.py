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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import init_rms, rms_norm, rope, truncnorm

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
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(p["qnorm"], q, cfg.norm_eps)
        k = rms_norm(p["knorm"], k, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


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
    where the config has it."""
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


# --- decode ------------------------------------------------------------------

def init_kv_cache(cfg, batch, seq_len, dtype, device, periods=None):
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd)
    full = shape if periods is None else (periods, *shape)
    return {"k": torch.zeros(full, dtype=dtype, device=device),
            "v": torch.zeros(full, dtype=dtype, device=device)}


def decode_attention(p, cfg, x, cache, pos):
    """One-token decode. x: (B, 1, D); pos: int, the cache index. Writes the
    step's k and v into ``cache`` in place and returns (out, cache)."""
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)                   # (B, 1, H, hd)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    b, s, kvh, hd = cache["k"].shape
    rep = cfg.n_heads // kvh
    qg = q.reshape(b, kvh, rep, hd)
    s_ = (qg @ cache["k"].permute(0, 2, 3, 1)) * hd ** -0.5  # (b, g, r, s)
    kv_pos = torch.arange(s, device=x.device)
    mask = kv_pos <= pos
    if cfg.window:
        mask &= kv_pos > pos - cfg.window
    s_ = torch.where(mask, s_.float(), NEG_INF)
    w = torch.softmax(s_, dim=-1)
    o = w.to(cache["v"].dtype) @ cache["v"].permute(0, 2, 1, 3)  # (b, g, r, hd)
    return _out(o.reshape(b, 1, cfg.n_heads, hd), p["wo"]), cache


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
