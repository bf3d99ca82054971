"""Decoder-only LM: embed -> pattern-stacked blocks -> norm -> chunked loss
(``src/repro/models/lm.py``).

Layer stacking: each pattern slot's parameters are stacked along a leading
period axis, as the reference stacks them for its ``lax.scan``; here a
Python loop walks the periods through views of the stack. Decode caches
are stacked the same way and updated in place through those views.

Remat: with ``cfg.remat`` and gradients on, each block runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps
``block_apply`` in ``jax.checkpoint``: the backward recomputes the block,
the MoE router's two kernels included, from its saved input. The kernels
are deterministic, so the recomputed routing masks are the forward's.

The LM head never materialises (B, S, V) logits: ``lm_loss`` projects one
chunk of ``cfg.loss_chunk`` positions at a time, each chunk under
``checkpoint`` so that at most one chunk's logits are alive, forward or
backward (the reference scans the chunks with ``lax.scan``).

Multimodal stubs: "vision" models take precomputed patch embeddings
concatenated in front of the token embeddings (``extra_embeds``); the loss
is masked to text positions.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .blocks import block_apply, block_decode, init_block, init_block_cache
from .layers import embed, init_embed, init_rms, rms_norm, unembed


def _slot_ffns(cfg):
    return tuple(cfg.ffn_pattern)


def tree_map(fn, tree):
    """``fn`` of every leaf of a parameter or cache tree, same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves_with_paths(tree, path=()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in the order
    of ``jax.tree.leaves``: dict keys sorted, lists in order, no leaf for
    ``None``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def at(tree, i):
    """Period ``i`` of a stacked tree: the same nesting, each leaf a view."""
    return tree_map(lambda a: a[i], tree)


def init_lm(gen, cfg, device):
    """Parameter tree. Block slot s params are stacked over periods."""
    dt = cfg.param_dtype
    params = {
        "embed": init_embed(gen, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": init_rms(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_embed(gen, cfg.vocab, cfg.d_model, dt, device)
    if cfg.first_dense_ff:
        cfg0 = cfg.replace(d_ff=cfg.first_dense_ff)
        params["block0"] = init_block(gen, cfg0, cfg.pattern[0], "dense", device)
    params["slots"] = [
        init_block(gen, cfg, slot, ffn, device, periods=cfg.n_periods)
        for slot, ffn in zip(cfg.pattern, _slot_ffns(cfg))
    ]
    return params


def _n_periods(params):
    return params["slots"][0]["norm1"]["scale"].shape[0]


def _block(cfg):
    """``block_apply``, recomputed in the backward under ``cfg.remat``."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda *a: checkpoint(block_apply, *a, use_reentrant=False)
    return block_apply


def forward(params, cfg, tokens, extra_embeds=None):
    """Hidden states (B, S_total, D). extra_embeds: (B, P, D) modality stub
    prepended before the token embeddings."""
    x = embed(params["embed"], tokens, cfg.dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cfg.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    block = _block(cfg)
    if params.get("block0") is not None:
        cfg0 = cfg.replace(d_ff=cfg.first_dense_ff or cfg.d_ff)
        x = block(params["block0"], cfg0, x, positions, cfg.pattern[0], "dense")
    ffns = _slot_ffns(cfg)
    for t in range(_n_periods(params)):
        slot_params = at(params["slots"], t)
        for i, (slot, ffn) in enumerate(zip(cfg.pattern, ffns)):
            x = block(slot_params[i], cfg, x, positions, slot, ffn)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def head_params(params):
    return params.get("head", params["embed"])


def _chunk_nll(e, h, targets, mask, softcap):
    """Summed masked cross-entropy of one chunk: h (B, c, D) -> ()."""
    logits = unembed({"e": e}, h)                           # (B, c, V)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum()


def lm_loss(params, cfg, tokens, targets, mask=None, extra_embeds=None):
    """Mean CE, chunked over the sequence. targets: (B, S) int; mask (B, S).

    The chunks' sums are added to a float32 carry in chunk order, then
    divided by ``max(sum(mask), 1)``."""
    h = forward(params, cfg, tokens, extra_embeds)
    if extra_embeds is not None:
        h = h[:, extra_embeds.shape[1]:]                    # text positions only
    s = h.shape[1]
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    mask = torch.ones(targets.shape, dtype=torch.float32, device=h.device) \
        if mask is None else mask
    e = head_params(params)["e"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(0, s, c):
        args = (e, h[:, j:j + c], targets[:, j:j + c], mask[:, j:j + c], cfg.logit_softcap)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total / torch.clamp_min(mask.sum(), 1.0)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, seq_len, device, dtype=None):
    """Per-layer caches, stacked per slot like the params."""
    dtype = dtype or cfg.dtype
    caches = {"slots": [init_block_cache(cfg, s, batch, seq_len, dtype, device,
                                         periods=cfg.n_periods)
                        for s in cfg.pattern]}
    if cfg.first_dense_ff:
        caches["block0"] = init_block_cache(cfg, cfg.pattern[0], batch, seq_len,
                                            dtype, device)
    return caches


def decode_step(params, cfg, caches, token, pos):
    """One decode step. token: (B, 1) int; pos: int cache index.
    Returns (logits (B, 1, V), caches), the caches updated in place."""
    x = embed(params["embed"], token, cfg.dtype)
    if caches.get("block0") is not None:
        cfg0 = cfg.replace(d_ff=cfg.first_dense_ff or cfg.d_ff)
        x, _ = block_decode(params["block0"], cfg0, x, caches["block0"], pos,
                            cfg.pattern[0], "dense")
    ffns = _slot_ffns(cfg)
    for t in range(_n_periods(params)):
        slot_params, slot_caches = at(params["slots"], t), at(caches["slots"], t)
        for i, (slot, ffn) in enumerate(zip(cfg.pattern, ffns)):
            x, _ = block_decode(slot_params[i], cfg, x, slot_caches[i], pos, slot, ffn)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(head_params(params), x)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, caches
