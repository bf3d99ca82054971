"""Transformer blocks assembled from a (mixer, ffn) pattern slot
(``src/repro/models/blocks.py``).

A block is pre-norm residual: x += mixer(norm(x)); x += ffn(norm(x)).
Mixers: ``attn`` (GQA/MQA), ``mla`` (an ``attn`` slot of a config with
``use_mla``) and ``mamba``; FFNs: ``dense``, ``moe`` (with shared experts)
and ``none``. The same block code serves prefill and training (full
sequence) and decode (one token against the block's cache, updated in
place).
"""
from __future__ import annotations

from .attention import (attention, decode_attention, decode_mla, init_attn,
                        init_kv_cache, init_mla, init_mla_cache, mla_attention)
from .layers import init_mlp, init_rms, mlp, rms_norm
from .mamba2 import decode_mamba, init_mamba, init_mamba_cache, mamba_mixer
from .moe import init_moe, moe_decode, moe_train

_INIT = {"attn": init_attn, "mla": init_mla, "mamba": init_mamba}
_DECODE = {"attn": decode_attention, "mla": decode_mla, "mamba": decode_mamba}


def mixer_kind(cfg, slot: str) -> str:
    """The slot's mixer kind; raises ``ValueError`` for an unknown one."""
    kind = "mla" if slot == "attn" and cfg.use_mla else slot
    if kind not in _INIT:
        raise ValueError(kind)
    return kind


def init_block(gen, cfg, slot: str, ffn: str, device, periods=None):
    dt = cfg.param_dtype
    p = {"norm1": init_rms(cfg.d_model, dt, device, periods),
         "mixer": _INIT[mixer_kind(cfg, slot)](gen, cfg, device, periods)}
    if ffn != "none":
        p["norm2"] = init_rms(cfg.d_model, dt, device, periods)
    if ffn == "dense":
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device, periods)
    elif ffn == "moe":
        p["ffn"] = init_moe(gen, cfg, device, periods)
        if cfg.moe.n_shared:
            p["shared"] = init_mlp(gen, cfg.d_model, cfg.moe.n_shared * cfg.moe.d_ff,
                                   dt, device, periods)
    return p


def _apply_ffn(p, cfg, x, ffn, decode=False):
    if ffn == "none":
        return x
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    if ffn == "dense":
        out = mlp(p["ffn"], h, cfg.act)
    else:
        out = (moe_decode if decode else moe_train)(p["ffn"], cfg, h, cfg.act)
        if "shared" in p:
            out = out + mlp(p["shared"], h, cfg.act)
    return x + out


def block_apply(p, cfg, x, positions, slot: str, ffn: str):
    """Full-sequence block (prefill, training)."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    kind = mixer_kind(cfg, slot)
    if kind == "attn":
        mx = attention(p["mixer"], cfg, h, positions, causal=True)
    elif kind == "mla":
        mx = mla_attention(p["mixer"], cfg, h, positions)
    else:
        mx = mamba_mixer(p["mixer"], cfg, h)
    return _apply_ffn(p, cfg, x + mx, ffn)


def init_block_cache(cfg, slot: str, batch, seq_len, dtype, device, periods=None):
    kind = mixer_kind(cfg, slot)
    if kind == "attn":
        return init_kv_cache(cfg, batch, seq_len, dtype, device, periods)
    if kind == "mla":
        return init_mla_cache(cfg, batch, seq_len, dtype, device, periods)
    return init_mamba_cache(cfg, batch, dtype, device, periods)


def block_decode(p, cfg, x, cache, pos, slot: str, ffn: str):
    """One-token block step; returns (x, cache), the cache updated in place."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    mx, cache = _DECODE[mixer_kind(cfg, slot)](p["mixer"], cfg, h, cache, pos)
    return _apply_ffn(p, cfg, x + mx, ffn, decode=True), cache
