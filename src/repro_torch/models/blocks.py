"""Transformer blocks assembled from a (mixer, ffn) pattern slot
(``src/repro/models/blocks.py``).

A block is pre-norm residual: x += mixer(norm(x)); x += ffn(norm(x)).
The port runs the ``attn`` mixer with ``dense``, ``moe`` (with shared
experts) and ``none`` FFNs; the same block code serves prefill (full
sequence) and decode (one token against the block's cache, updated in
place). The ``mla`` and ``mamba`` mixers wait for their slice.
"""
from __future__ import annotations

from .attention import attention, decode_attention, init_attn, init_kv_cache
from .layers import init_mlp, init_rms, mlp, rms_norm
from .moe import init_moe, moe_decode, moe_train

_DEFERRED = {
    "mla": "the MLA mixer (src/repro/models/attention.py:183-265)",
    "mamba": "the Mamba2 mixer (src/repro/models/mamba2.py)",
}


def mixer_kind(cfg, slot: str) -> str:
    if slot == "attn" and cfg.use_mla:
        return "mla"
    return slot


def check_mixer(cfg, slot: str) -> str:
    """The slot's mixer kind; raises ``NotImplementedError`` for the mixers
    the port has not reached yet."""
    kind = mixer_kind(cfg, slot)
    if kind in _DEFERRED:
        raise NotImplementedError(
            f"{cfg.name}: {_DEFERRED[kind]} is not ported yet; it comes with "
            "ROADMAP A10's next slice (Mamba2, MLA, encoder-decoder)")
    if kind != "attn":
        raise ValueError(kind)
    return kind


def init_block(gen, cfg, slot: str, ffn: str, device, periods=None):
    check_mixer(cfg, slot)
    dt = cfg.param_dtype
    p = {"norm1": init_rms(cfg.d_model, dt, device, periods),
         "mixer": init_attn(gen, cfg, device, periods)}
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
    """Full-sequence block (prefill)."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attention(p["mixer"], cfg, h, positions, causal=True)
    return _apply_ffn(p, cfg, x, ffn)


def init_block_cache(cfg, slot: str, batch, seq_len, dtype, device, periods=None):
    check_mixer(cfg, slot)
    return init_kv_cache(cfg, batch, seq_len, dtype, device, periods)


def block_decode(p, cfg, x, cache, pos, slot: str, ffn: str):
    """One-token block step; returns (x, cache), the cache updated in place."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    mx, cache = decode_attention(p["mixer"], cfg, h, cache, pos)
    return _apply_ffn(p, cfg, x + mx, ffn, decode=True), cache
