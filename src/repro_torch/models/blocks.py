"""Transformer blocks assembled from a (mixer, ffn) pattern slot
(``src/repro/models/blocks.py``).

A block is pre-norm residual: x += mixer(norm(x)); x += ffn(norm(x)).
Mixers: ``attn`` (GQA/MQA), ``mla`` (an ``attn`` slot of a config with
``use_mla``) and ``mamba``; FFNs: ``dense``, ``moe`` (with shared experts)
and ``none``. The same block code serves prefill and training (full
sequence) and decode (one token against the block's cache, updated in
place).

Over a world under tensor and sequence parallelism the residual stream of
a prefill stays split by sequence between blocks where "seq" splits it
(Megatron-style): the attention and a dense FFN split by "ffn" all-gather
it on entry and reduce-scatter their row-parallel partials back to the
rank's block (without "seq" they fold them whole); the MoE routes the
rank's block through its all-to-all path; MLA and Mamba2 all-gather the
sequence and reduce-scatter their partials as the attention does
(``attention.mla_attention``, ``mamba2.mamba_mixer``). A decode step's x
is the same on every rank, and the partials are folded whole. The
collectives are ``core.mesh``'s autograd functions (a replicated h enters
the rank's FFN columns through ``copy_in``), so the train step's backward
runs through them.
"""
from __future__ import annotations

from ..core.mesh import all_gather, copy_in, reduce_scatter
from . import sharding
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


def dense_ffn(p, cfg, h, d_ff, seq_split=False):
    """A dense FFN of ``d_ff`` columns; over a world where "ffn" splits
    them, column- then row-parallel, its partials reduce-scattered to the
    rank's sequence block (``seq_split``) or folded whole."""
    cols = sharding.ffn_range(d_ff)
    if cols is None:
        return mlp(p, h, cfg.act)
    mesh = sharding.get_mesh()
    part = mlp(p, all_gather(mesh, h, 1) if seq_split else copy_in(mesh, h), cfg.act,
               cols=(*cols, d_ff))
    return reduce_scatter(mesh, part, 1) if seq_split else sharding.world_sum(part)


def _apply_ffn(p, cfg, x, ffn, decode=False, seq_split=False):
    if ffn == "none":
        return x
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    if ffn == "dense":
        out = dense_ffn(p["ffn"], cfg, h, cfg.d_ff, seq_split)
    else:
        if decode:
            out = moe_decode(p["ffn"], cfg, h, cfg.act)
        else:
            out = moe_train(p["ffn"], cfg, h, cfg.act, replicated=not seq_split and (
                sharding.get_mesh() is not None and not sharding.on_world("batch")))
        if "shared" in p:
            out = out + dense_ffn(p["shared"], cfg, h, cfg.moe.n_shared * cfg.moe.d_ff,
                                  seq_split)
    return x + out


def block_apply(p, cfg, x, positions, slot: str, ffn: str):
    """Full-sequence block (prefill, training). Over a world, ``x`` is this
    rank's block of the sequence where "seq" splits ``positions``."""
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    kind = mixer_kind(cfg, slot)
    if kind == "attn":
        mx = attention(p["mixer"], cfg, h, positions, causal=True)
    elif kind == "mla":
        mx = mla_attention(p["mixer"], cfg, h, positions)
    else:
        mx = mamba_mixer(p["mixer"], cfg, h, len(positions))
    return _apply_ffn(p, cfg, x + mx, ffn,
                      seq_split=sharding.seq_range(len(positions)) is not None)


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
