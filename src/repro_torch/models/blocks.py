"""Transformer blocks assembled from a (mixer, ffn) pattern slot
(``src/repro/models/blocks.py``).

A block is pre-norm residual: x += mixer(norm(x)); x += ffn(norm(x)).
The port runs the ``attn`` and ``mamba`` mixers with ``dense``, ``moe``
(with shared experts) and ``none`` FFNs; the same block code serves
prefill and training (full sequence) and decode (one token against the
block's cache, updated in place). The ``mla`` mixer waits for its slice.
"""
from __future__ import annotations

from .attention import attention, decode_attention, init_attn, init_kv_cache
from .layers import init_mlp, init_rms, mlp, rms_norm
from .mamba2 import decode_mamba, init_mamba, init_mamba_cache, mamba_mixer
from .moe import init_moe, moe_decode, moe_train

_DEFERRED = {
    "mla": ("the MLA mixer (src/repro/models/attention.py:183-265) is not ported "
            "yet; it comes with ROADMAP A10's next slice, beside scd_fused_hist and "
            "adjusted_topc widened to K = 160 experts (their CUDA kernels take "
            "K <= 64, KMAX in kernels/csrc/scd_common.cuh)"),
}


def mixer_kind(cfg, slot: str) -> str:
    if slot == "attn" and cfg.use_mla:
        return "mla"
    return slot


def check_mixer(cfg, slot: str) -> str:
    """The slot's mixer kind; raises ``NotImplementedError`` for the mixer
    the port has not reached yet."""
    kind = mixer_kind(cfg, slot)
    if kind in _DEFERRED:
        raise NotImplementedError(f"{cfg.name}: {_DEFERRED[kind]}")
    if kind not in ("attn", "mamba"):
        raise ValueError(kind)
    return kind


def init_block(gen, cfg, slot: str, ffn: str, device, periods=None):
    kind = check_mixer(cfg, slot)
    dt = cfg.param_dtype
    init_mixer = init_attn if kind == "attn" else init_mamba
    p = {"norm1": init_rms(cfg.d_model, dt, device, periods),
         "mixer": init_mixer(gen, cfg, device, periods)}
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
    if mixer_kind(cfg, slot) == "attn":
        mx = attention(p["mixer"], cfg, h, positions, causal=True)
    else:
        mx = mamba_mixer(p["mixer"], cfg, h)
    return _apply_ffn(p, cfg, x + mx, ffn)


def init_block_cache(cfg, slot: str, batch, seq_len, dtype, device, periods=None):
    if check_mixer(cfg, slot) == "attn":
        return init_kv_cache(cfg, batch, seq_len, dtype, device, periods)
    return init_mamba_cache(cfg, batch, dtype, device, periods)


def block_decode(p, cfg, x, cache, pos, slot: str, ffn: str):
    """One-token block step; returns (x, cache), the cache updated in place."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    decode = decode_attention if mixer_kind(cfg, slot) == "attn" else decode_mamba
    mx, cache = decode(p["mixer"], cfg, h, cache, pos)
    return _apply_ffn(p, cfg, x + mx, ffn, decode=True), cache
