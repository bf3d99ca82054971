"""Encoder-decoder transformer, the seamless-m4t family
(``src/repro/models/encdec.py``).

Encoder: bidirectional attention over stubbed modality frame embeddings.
Decoder: causal self-attention and cross-attention to the encoder memory.
Both stacks hold their layers stacked along a leading axis ("enc" and
"dec"), walked by a Python loop through views as ``lm.py`` walks its
periods, each layer under ``torch.utils.checkpoint`` with ``cfg.remat``
and gradients on. Decode caches the self-attention KV per layer, updated
in place; the cross KV is computed once from the encoder memory and stays
as it is across steps.

Under FSDP each layer gathers its stored blocks at use by the step's
plan (``plan=``, ``models/model.gather_plan``), inside the function that
``remat`` checkpoints, and the embedding and head tables are gathered
once a step (``lm.gather``, ``lm.gather_top``).
"""
from __future__ import annotations

import torch

from .attention import _out, _proj, attention, decode_attention, init_attn, init_kv_cache
from .layers import embed, init_embed, init_mlp, init_rms, mlp, rms_norm, unembed
from . import sharding
from .lm import (at, check_chunks, chunked_nll, gather, gather_top, gathering, mean_nll, part,
                 remat)


def _init_enc_layers(gen, cfg, device, n):
    dt = cfg.param_dtype
    return {
        "norm1": init_rms(cfg.d_model, dt, device, n),
        "attn": init_attn(gen, cfg, device, n),
        "norm2": init_rms(cfg.d_model, dt, device, n),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device, n),
    }


def _init_dec_layers(gen, cfg, device, n):
    dt = cfg.param_dtype
    return {
        "norm1": init_rms(cfg.d_model, dt, device, n),
        "self": init_attn(gen, cfg, device, n),
        "norm_x": init_rms(cfg.d_model, dt, device, n),
        "cross": init_attn(gen, cfg, device, n),
        "norm2": init_rms(cfg.d_model, dt, device, n),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device, n),
    }


def init_encdec(gen, cfg, device):
    """Parameter tree; "enc" and "dec" hold their layers stacked."""
    dt = cfg.param_dtype
    return {
        "embed": init_embed(gen, cfg.vocab, cfg.d_model, dt, device),
        "enc": _init_enc_layers(gen, cfg, device, cfg.n_enc_layers),
        "enc_norm": init_rms(cfg.d_model, dt, device),
        "dec": _init_dec_layers(gen, cfg, device, cfg.n_layers),
        "final_norm": init_rms(cfg.d_model, dt, device),
        "head": init_embed(gen, cfg.vocab, cfg.d_model, dt, device),
    }


def _n_layers(stack):
    return stack["norm1"]["scale"].shape[0]


def _enc_layer(p, cfg, x, positions):
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attention(p["attn"], cfg, h, positions, causal=False)
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h, cfg.act)


def _dec_layer(p, cfg, x, positions, memory, mem_pos):
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attention(p["self"], cfg, h, positions, causal=True)
    h = rms_norm(p["norm_x"], x, cfg.norm_eps)
    x = x + attention(p["cross"], cfg, h, positions, causal=False,
                      kv=memory, kv_pos=mem_pos)
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h, cfg.act)


def encode(params, cfg, frames, plan=None):
    """frames: (B, F, D) stubbed modality embeddings -> encoder memory;
    ``plan``: what to gather at use (``lm.forward``)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs frames (B, F, d_model)")
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = frames.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    layer = remat(gathering(_enc_layer, mesh), cfg)
    for t in range(_n_layers(params["enc"])):
        x = layer(at(params["enc"], t), part(plan, "enc"), cfg, x, pos)
    return rms_norm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(params, cfg, tokens, memory, plan=None):
    """Teacher-forced decoder hidden states (B, S, D)."""
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = embed(params["embed"], tokens, cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    mem_pos = torch.arange(memory.shape[1], device=x.device)
    layer = remat(gathering(_dec_layer, mesh), cfg)
    for t in range(_n_layers(params["dec"])):
        x = layer(at(params["dec"], t), part(plan, "dec"), cfg, x, pos, memory, mem_pos)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def encdec_nll(params, cfg, frames, tokens, targets, mask=None, plan=None):
    """(summed CE, token count) of the teacher-forced decoder, chunked as
    ``lm.lm_nll``; a text length that ``min(cfg.loss_chunk, S)`` does not
    divide raises ``ValueError`` (``lm.check_chunks``)."""
    check_chunks(cfg, targets.shape[1])
    params = gather_top(params, plan)
    memory = encode(params, cfg, frames, plan)
    h = decode_train(params, cfg, tokens, memory, plan)
    return chunked_nll(params["head"]["e"], h, targets, mask, cfg.loss_chunk)


def encdec_loss(params, cfg, frames, tokens, targets, mask=None):
    """Mean CE of the teacher-forced decoder, chunked as ``lm.lm_loss``."""
    return mean_nll(*encdec_nll(params, cfg, frames, tokens, targets, mask))


# --- decode ------------------------------------------------------------------

def init_encdec_cache(params, cfg, frames, batch, seq_len, plan=None):
    """{"cross": the K/V of the encoder memory per decoder layer, "self":
    zero KV caches per layer}, each stacked over the layers; ``plan``: what
    to gather at use (``lm.forward``)."""
    memory = encode(params, cfg, frames, plan)
    mesh = sharding.get_mesh()
    nl = _n_layers(params["dec"])
    ks, vs = [], []
    for t in range(nl):
        c = gather(at(params["dec"], t)["cross"], part(part(plan, "dec"), "cross"), mesh)
        ks.append(_proj(memory, c["wk"]))
        vs.append(_proj(memory, c["wv"]))
    cross = {"k": torch.stack(ks), "v": torch.stack(vs)}
    self_cache = init_kv_cache(cfg, batch, seq_len, cfg.dtype, memory.device, periods=nl)
    return {"cross": cross, "self": self_cache}


def _cross_decode(p, cfg, h, xc):
    """One query against the cached cross K/V: scores in the activation
    dtype, the softmax in float32."""
    q = _proj(h, p["wq"])                                   # (B, 1, H, hd)
    b, _, kvh, hd = xc["k"].shape
    qg = q.reshape(b, kvh, cfg.n_heads // kvh, hd)
    s_ = (qg @ xc["k"].permute(0, 2, 3, 1)) * hd ** -0.5   # (b, g, r, S_enc)
    w = torch.softmax(s_.float(), dim=-1)
    o = w.to(xc["v"].dtype) @ xc["v"].permute(0, 2, 1, 3)  # (b, g, r, hd)
    return _out(o.reshape(b, 1, cfg.n_heads, hd), p["wo"])


def encdec_decode_step(params, cfg, caches, token, pos, plan=None):
    """One decoder step. token: (B, 1) int; pos: int cache index. Returns
    (logits (B, 1, V), caches), the self caches updated in place; each
    layer's stored blocks gathered at use by ``plan``."""
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = embed(params["embed"], token, cfg.dtype)
    for t in range(_n_layers(params["dec"])):
        p = gather(at(params["dec"], t), part(plan, "dec"), mesh)
        sc, xc = at(caches["self"], t), at(caches["cross"], t)
        h = rms_norm(p["norm1"], x, cfg.norm_eps)
        x = x + decode_attention(p["self"], cfg, h, sc, pos)[0]
        h = rms_norm(p["norm_x"], x, cfg.norm_eps)
        x = x + _cross_decode(p["cross"], cfg, h, xc)
        h = rms_norm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp(p["ffn"], h, cfg.act)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["head"], x), caches
