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

Under tensor and sequence parallelism (``models/sharding.py``) both
stacks run as ``lm.py``'s blocks do: where "seq" splits the frames (the
tokens) the encoder's (decoder's) residual is the rank's block of them,
the attention takes the rank's heads (``attention.attention``) and the
FFN its columns (``blocks.dense_ffn``), and the embedding, the logits
and the loss are vocab-parallel (``lm._embedded``, ``lm.prefill_logits``,
``lm.nll_of``). The encoder's memory is joined whole on every rank
(:func:`encode`) for the cross attention of the rank's heads; the decode
caches hold the rank's KV heads of the self and cross K/V.
"""
from __future__ import annotations

import torch

from ..core.mesh import all_gather, copy_in
from .attention import (_grouped, _out, _proj, _rank_weights, attention, decode_attention,
                        init_attn, init_kv_cache, rank_heads)
from .blocks import dense_ffn
from .layers import embed, init_embed, init_mlp, init_rms, rms_norm, unembed
from . import sharding
from .lm import (_embedded, at, check_chunks, gather, gather_top, gathering, mean_nll, nll_of,
                 part, prefill_logits, remat)


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


def _split(positions):
    """Whether "seq" splits a sequence of ``positions`` over the world."""
    return sharding.seq_range(len(positions)) is not None


def _enc_layer(p, cfg, x, positions):
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attention(p["attn"], cfg, h, positions, causal=False)
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + dense_ffn(p["ffn"], cfg, h, cfg.d_ff, _split(positions))


def _dec_layer(p, cfg, x, positions, memory, mem_pos):
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attention(p["self"], cfg, h, positions, causal=True)
    h = rms_norm(p["norm_x"], x, cfg.norm_eps)
    x = x + attention(p["cross"], cfg, h, positions, causal=False,
                      kv=memory, kv_pos=mem_pos)
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + dense_ffn(p["ffn"], cfg, h, cfg.d_ff, _split(positions))


def encode(params, cfg, frames, plan=None, seq=None):
    """frames: (B, F, D) stubbed modality embeddings -> encoder memory;
    ``plan``: what to gather at use (``lm.forward``).

    Over a world the memory is whole on every rank: the encoder runs the
    rank's block of the frames where "seq" splits them, and the blocks are
    joined (``core.mesh.all_gather``). Where the decoder's use of it is the
    rank's own (its heads split, or "seq" splits the decoder's ``seq``
    positions) the memory's gradient is each rank's partial: the join's
    backward folds the ranks' (a replicated memory enters through
    ``copy_in``); otherwise it is whole on every rank."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs frames (B, F, d_model)")
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = frames.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    block = sharding.seq_range(x.shape[1])
    if block is not None:
        x = x[:, block[0]:block[1]]
    layer = remat(gathering(_enc_layer, mesh), cfg)
    for t in range(_n_layers(params["enc"])):
        x = layer(at(params["enc"], t), part(plan, "enc"), cfg, x, pos)
    x = rms_norm(params["enc_norm"], x, cfg.norm_eps)
    if mesh is None or mesh.size == 1:
        return x
    own = rank_heads(cfg) is not None or (seq is not None and sharding.seq_range(seq) is not None)
    if block is not None:
        return all_gather(mesh, x, 1, whole=not own)
    return copy_in(mesh, x) if own else x


def decode_train(params, cfg, tokens, memory, plan=None):
    """Teacher-forced decoder hidden states (B, S, D); over a world, the
    rank's block of the sequence where "seq" splits it."""
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = _embedded(params, cfg, tokens, None)
    pos = torch.arange(tokens.shape[1], device=x.device)
    mem_pos = torch.arange(memory.shape[1], device=x.device)
    layer = remat(gathering(_dec_layer, mesh), cfg)
    for t in range(_n_layers(params["dec"])):
        x = layer(at(params["dec"], t), part(plan, "dec"), cfg, x, pos, memory, mem_pos)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def encdec_prefill(params, cfg, frames, tokens, plan=None):
    """(B, V) logits of the last position of the teacher-forced decoder
    (``lm.prefill_logits``: over a world the same bits on every rank)."""
    memory = encode(params, cfg, frames, plan, seq=tokens.shape[1])
    h = decode_train(params, cfg, tokens, memory, plan)
    return prefill_logits(params, cfg, h, tokens.shape[1])


def encdec_nll(params, cfg, frames, tokens, targets, mask=None, plan=None):
    """(summed CE, token count) of the teacher-forced decoder, chunked as
    ``lm.lm_nll`` (over a world as there, ``lm.nll_of``); a text length
    that ``min(cfg.loss_chunk, S)`` does not divide raises ``ValueError``
    (``lm.check_chunks``)."""
    check_chunks(cfg, targets.shape[1])
    params = gather_top(params, plan)
    memory = encode(params, cfg, frames, plan, seq=tokens.shape[1])
    h = decode_train(params, cfg, tokens, memory, plan)
    return nll_of(params["head"]["e"], h, cfg, targets, mask)


def encdec_loss(params, cfg, frames, tokens, targets, mask=None):
    """Mean CE of the teacher-forced decoder, chunked as ``lm.lm_loss``."""
    return mean_nll(*encdec_nll(params, cfg, frames, tokens, targets, mask))


# --- decode ------------------------------------------------------------------

def init_encdec_cache(params, cfg, frames, batch, seq_len, plan=None):
    """{"cross": the K/V of the encoder memory per decoder layer, "self":
    zero KV caches per layer}, each stacked over the layers; ``plan``: what
    to gather at use (``lm.forward``). Over a world, the KV heads that the
    rank's heads read (``attention.rank_heads``) of each."""
    memory = encode(params, cfg, frames, plan)
    mesh = sharding.get_mesh()
    heads = rank_heads(cfg)
    nl = _n_layers(params["dec"])
    ks, vs = [], []
    for t in range(nl):
        c = gather(at(params["dec"], t)["cross"], part(part(plan, "dec"), "cross"), mesh)
        _, wk, wv, _ = ((c["wq"], c["wk"], c["wv"], c["wo"]) if heads is None
                        else _rank_weights(c, cfg, heads))
        ks.append(_proj(memory, wk))
        vs.append(_proj(memory, wv))
    cross = {"k": torch.stack(ks), "v": torch.stack(vs)}
    self_cache = init_kv_cache(cfg, batch, seq_len, cfg.dtype, memory.device, periods=nl)
    return {"cross": cross, "self": self_cache}


def _cross_decode(p, cfg, h, xc):
    """One query against the cached cross K/V: scores in the activation
    dtype, the softmax in float32. Over a world where the heads split, the
    rank's q heads against its cached KV heads, the ``wo`` partials
    folded."""
    heads = rank_heads(cfg)
    wq, _, _, wo = ((p["wq"], p["wk"], p["wv"], p["wo"]) if heads is None
                    else _rank_weights(p, cfg, heads, kv_whole=True))
    k, v = xc["k"], xc["v"]
    if heads is not None:
        k, v = _grouped(k, cfg, heads), _grouped(v, cfg, heads)
    q = _proj(h, wq)                                        # (B, 1, H_r, hd)
    b, _, kvh, hd = k.shape
    h_r = q.shape[2]
    qg = q.reshape(b, kvh, h_r // kvh, hd)
    s_ = (qg @ k.permute(0, 2, 3, 1)) * hd ** -0.5          # (b, g, r, S_enc)
    w = torch.softmax(s_.float(), dim=-1)
    o = w.to(v.dtype) @ v.permute(0, 2, 1, 3)               # (b, g, r, hd)
    out = _out(o.reshape(b, 1, h_r, hd), wo)
    return out if heads is None else sharding.world_sum(out)


def encdec_decode_step(params, cfg, caches, token, pos, plan=None):
    """One decoder step. token: (B, 1) int; pos: int cache index. Returns
    (logits (B, 1, V), caches), the self caches updated in place; each
    layer's stored blocks gathered at use by ``plan``. Over a world x is
    the same on every rank and the logits are joined over the vocab."""
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = embed(params["embed"], token, cfg.dtype, vocab=cfg.vocab)
    if sharding.vocab_range(cfg.vocab) is not None:
        x = sharding.world_sum(x)
    for t in range(_n_layers(params["dec"])):
        p = gather(at(params["dec"], t), part(plan, "dec"), mesh)
        sc, xc = at(caches["self"], t), at(caches["cross"], t)
        h = rms_norm(p["norm1"], x, cfg.norm_eps)
        x = x + decode_attention(p["self"], cfg, h, sc, pos)[0]
        h = rms_norm(p["norm_x"], x, cfg.norm_eps)
        x = x + _cross_decode(p["cross"], cfg, h, xc)
        h = rms_norm(p["norm2"], x, cfg.norm_eps)
        x = x + dense_ffn(p["ffn"], cfg, h, cfg.d_ff)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["head"], x, vocab=cfg.vocab), caches
