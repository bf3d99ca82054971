"""Decoder-only LM: embed -> pattern-stacked blocks -> norm -> chunked loss
(``src/repro/models/lm.py``).

Layer stacking: each pattern slot's parameters are stacked along a leading
period axis, as the reference stacks them for its ``lax.scan``; here a
Python loop walks the periods through views of the stack. Decode caches
(KV caches of attention slots, conv windows and SSM states of Mamba
slots) are stacked the same way and updated in place through those views,
so a hybrid pattern needs nothing of its own here.

Remat: with ``cfg.remat`` and gradients on, each block runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps
``block_apply`` in ``jax.checkpoint``: the backward recomputes the block,
the MoE router's two kernels included, from its saved input. The kernels
are deterministic, so the recomputed routing masks are the forward's.
Over a world of ranks the recompute runs the block's collectives again
(the all-to-alls, the router's folds), at the same point of every rank's
backward.

The LM head never materialises (B, S, V) logits: ``lm_loss`` projects one
chunk of ``cfg.loss_chunk`` positions at a time, each chunk under
``checkpoint`` so that at most one chunk's logits are alive, forward or
backward (the reference scans the chunks with ``lax.scan``).

Multimodal stubs: "vision" models take precomputed patch embeddings
concatenated in front of the token embeddings (``extra_embeds``); the loss
is masked to text positions.

Over a world under tensor and sequence parallelism (``models/sharding.py``)
:func:`forward` returns this rank's block of the sequence where "seq"
splits it (the embeddings summed over the vocab's ranks and
reduce-scattered to the block, the final norm on the block),
:func:`prefill_logits` takes the last position from the last rank's block
and gathers the vocab's columns, so every rank returns the same (B, V)
bits, and :func:`decode_step` runs x the same on every rank (the
reference's ``constrain(x, "batch", None, None)``); :func:`init_cache`
allocates this rank's block of each KV cache (``attention.kv_split``).
:func:`lm_nll` is the reference's ``constrain(logits, "batch", None,
"vocab")``: the final hidden states all-gathered over "seq" once, each
rank's vocab block of the logits chunk by chunk, and the logsumexp over
the vocab's ranks in float32 (the exact maximum through ``Mesh.amax``,
the sums of exponentials and the gold logit, which one rank holds, folded
in rank order), so every rank has the same total and count; without
"vocab" each rank takes the loss of its own block of positions and the
blocks' sums are folded. The collectives are ``core.mesh``'s autograd functions, so
the train step's backward runs through them.

Under FSDP (``sharding.FSDP_RULES``, and the "fsdp_only" and "dp_full"
layouts) a rank stores blocks of leaves that it uses whole; the steps
pass the plan of what to gather (``plan=``, ``models/model.gather_plan``).
Each block gathers its layer's leaves
(:func:`gather`, ``core.mesh.all_gather``) inside the function that
:func:`remat` checkpoints, so at most one block's whole weights are alive
and the backward's recompute gathers them again; the gather's backward
reduce-scatters each leaf's gradient to the rank's block (or keeps the
rank's block where the gradient is whole on every rank). The embedding
and head tables are gathered once a step (:func:`gather_top`), not once a
loss chunk.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core.mesh import all_gather, copy_in, fold_sum, reduce_scatter
from .blocks import block_apply, block_decode, init_block, init_block_cache
from .layers import embed, init_embed, init_rms, rank_block, rms_norm, unembed
from . import sharding
from .moe import uncounted


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


# The tables outside the stacked layers, gathered once a step (the final
# norms' scales are never stored cut: the reference gives them no FSDP
# entry).
_TOP = ("embed", "head")


def gather(tree, plan, mesh):
    """``tree`` (a parameter subtree) with each leaf that ``plan`` (its
    part of ``model.gather_plan``'s) names gathered whole along its dim
    over ``mesh`` (``core.mesh.all_gather``: the gradient reduce-scattered
    where the plan marks it partial, else the rank's block of it kept); a
    leaf already whole is kept. ``tree`` itself where ``plan`` is None. The
    mesh is an argument: the backward's recompute runs on autograd's
    thread, where the rules are unset."""
    if plan is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather(v, plan.get(k), mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v, plan[i] if i < len(plan) else None, mesh)
                for i, v in enumerate(tree)]
    dim, n, partial = plan
    if tree.shape[dim] == n:
        return tree
    return all_gather(mesh, tree, dim, whole=not partial)


def part(plan, key):
    """``plan[key]``, or None (nothing of it gathered)."""
    if plan is None:
        return None
    if isinstance(plan, list):
        return plan[key] if key < len(plan) else None
    return plan.get(key)


def gather_top(params, plan):
    """``params`` with the embedding and head tables gathered by ``plan``
    (:func:`gather` over the rules' mesh); ``params`` itself where ``plan``
    is None. Gathering an already gathered tree gathers nothing."""
    if plan is None:
        return params
    mesh = sharding.get_mesh()
    return {k: gather(v, plan.get(k), mesh) if k in _TOP else v for k, v in params.items()}


def gathering(fn, mesh):
    """``fn(p, *args)`` as ``g(p, plan, *args)``: ``p`` gathered by
    ``plan`` first (:func:`gather`), so that under :func:`remat` the
    gather is recomputed with the block."""
    def run(p, plan, *args):
        return fn(gather(p, plan, mesh), *args)
    return run


def _replayed(fn):
    """``fn`` as ``checkpoint`` calls it: the first call is the forward; a
    later one is the backward's recompute, which runs under the sharding
    rules (and ``Mesh``) the forward saw, counting no dropped MoE pair
    again (``moe.uncounted``). The rules are per thread, and on the card
    autograd runs the backward on a thread of its own."""
    seen = []

    def run(*args):
        if not seen:
            seen.append((sharding.get_rules(), sharding.get_mesh()))
            return fn(*args)
        now = (sharding.get_rules(), sharding.get_mesh())
        sharding.set_rules(seen[0][0], mesh=seen[0][1])
        try:
            with uncounted():
                return fn(*args)
        finally:
            sharding.set_rules(now[0], mesh=now[1])
    return run


def remat(fn, cfg):
    """``fn``, recomputed in the backward under ``cfg.remat`` (when
    gradients are on), under the forward's rules (:func:`_replayed`)."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda *a: checkpoint(_replayed(fn), *a, use_reentrant=False)
    return fn


def _embedded(params, cfg, tokens, extra_embeds):
    """The embeddings (B, S_total, D), patches first; over a world, this
    rank's block of the sequence where "seq" splits it. Where "vocab"
    splits the table each rank's lookup is a partial (zeros outside its
    rows; rank 0's carries the patches), and the partials' sum is exact:
    one term of each is not zero."""
    x = embed(params["embed"], tokens, cfg.dtype, vocab=cfg.vocab)
    by_vocab = sharding.vocab_range(cfg.vocab) is not None
    if extra_embeds is not None:
        pre = extra_embeds.to(cfg.dtype)
        if by_vocab and sharding.get_mesh().rank:
            pre = torch.zeros_like(pre)
        x = torch.cat([pre, x], dim=1)
    seq = sharding.seq_range(x.shape[1])
    if by_vocab:
        return (sharding.world_sum(x) if seq is None
                else reduce_scatter(sharding.get_mesh(), x, 1))
    return x if seq is None else x[:, seq[0]:seq[1]]


def forward(params, cfg, tokens, extra_embeds=None, plan=None):
    """Hidden states (B, S_total, D). extra_embeds: (B, P, D) modality stub
    prepended before the token embeddings. Over a world, this rank's block
    of the sequence where "seq" splits it; each block's stored blocks are
    gathered at use by ``plan`` (module docstring)."""
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = _embedded(params, cfg, tokens, extra_embeds)
    s = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    positions = torch.arange(s, device=x.device)
    block = remat(gathering(block_apply, mesh), cfg)
    if params.get("block0") is not None:
        cfg0 = cfg.replace(d_ff=cfg.first_dense_ff or cfg.d_ff)
        x = block(params["block0"], part(plan, "block0"), cfg0, x, positions,
                  cfg.pattern[0], "dense")
    ffns, slots = _slot_ffns(cfg), part(plan, "slots")
    for t in range(_n_periods(params)):
        slot_params = at(params["slots"], t)
        for i, (slot, ffn) in enumerate(zip(cfg.pattern, ffns)):
            x = block(slot_params[i], part(slots, i), cfg, x, positions, slot, ffn)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def head_params(params):
    return params.get("head", params["embed"])


def prefill_logits(params, cfg, h, seq_len):
    """(B, V) logits of the last position of ``h`` (:func:`forward`'s, of a
    sequence of ``seq_len``). Over a world the last position is the last
    rank's where "seq" splits the sequence, and each rank's block of the
    vocab's columns is joined in rank order: every rank returns the same
    bits."""
    mesh = sharding.get_mesh()
    last = h[:, -1]
    if sharding.seq_range(seq_len) is not None:
        last = mesh.all_gather(h[:, -1:], 1)[:, -1]
    e = head_params(params)["e"]
    block = sharding.vocab_range(cfg.vocab)
    if block is None:
        return last @ e.to(last.dtype).T
    return mesh.all_gather(last @ rank_block(e, 0, block, cfg.vocab).to(last.dtype).T, -1)


def _chunk_nll(e, h, targets, mask, softcap):
    """Summed masked cross-entropy of one chunk: h (B, c, D) -> ()."""
    logits = unembed({"e": e}, h)                           # (B, c, V)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum()


def chunked_nll(e, h, targets, mask, chunk, softcap=0.0, vocab_block=None):
    """(summed CE, token count) of hidden states ``h`` (B, S, D) against the
    head ``e``, ``chunk`` positions at a time. targets: (B, S) int; mask
    (B, S) or None (every position counts). ``vocab_block``: ``(mesh,
    lo)`` where ``e`` is this rank's rows ``lo ..`` of the head and ``h``
    the same on every rank: each chunk's logsumexp over the vocab's ranks
    (:func:`_chunk_nll_world`), every rank the same total and count.

    The chunks' sums are added to a float32 carry in chunk order (the last
    chunk may be short); the count is ``sum(mask)`` in float32."""
    s = h.shape[1]
    c = max(min(chunk, s), 1)
    mask = torch.ones(targets.shape, dtype=torch.float32, device=h.device) \
        if mask is None else mask
    fn, world = (_chunk_nll, ()) if vocab_block is None else (_chunk_nll_world, vocab_block)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(0, s, c):
        args = (e, h[:, j:j + c], targets[:, j:j + c], mask[:, j:j + c], softcap, *world)
        if torch.is_grad_enabled():
            total = total + checkpoint(fn, *args, use_reentrant=False)
        else:
            total = total + fn(*args)
    return total, mask.sum()


def mean_nll(total, count):
    """The mean CE: ``total / max(count, 1)``."""
    return total / torch.clamp_min(count, 1.0)


def _chunk_nll_world(e, h, targets, mask, softcap, mesh, lo):
    """:func:`_chunk_nll` where this rank holds rows ``lo ..`` of the head
    ``e`` (its vocab block): its block of the logits (B, c, V / D), the
    softcap on the block, and the logsumexp over the ranks in float32: the
    exact maximum (``Mesh.amax``, off the gradient: the logsumexp does not
    depend on it), the blocks' sums of exponentials folded in rank order,
    and the gold logit from the rank that holds the target (exact zeros
    elsewhere). Takes the mesh as an argument: the backward's recompute
    runs on autograd's thread, where the rules are unset."""
    logits = (h @ e.to(h.dtype).T) * h.shape[-1] ** -0.5    # (B, c, V / D)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.float()
    m = mesh.amax(logits.detach().amax(-1)).to(logits.device)
    lse = m + torch.log(fold_sum(mesh, torch.exp(logits - m[..., None]).sum(-1)))
    local = targets.long() - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = fold_sum(mesh, torch.where(inside, gold, 0.0))
    return ((lse - gold) * mask).sum()


def check_chunks(cfg, s: int):
    """Raise ``ValueError`` where ``min(cfg.loss_chunk, s)`` does not divide
    the text length ``s`` of the whole sequence, as the reference's
    ``lm_loss`` (its assertion) and ``encdec_loss`` (its reshape) fail
    there. A rank's block of the positions may be ragged: the check is of
    the global length."""
    c = min(cfg.loss_chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"{cfg.name}: a text of {s} positions does not split into loss "
                         f"chunks of {c} (loss_chunk {cfg.loss_chunk})")


def lm_nll(params, cfg, tokens, targets, mask=None, extra_embeds=None, plan=None):
    """(summed CE, token count), chunked over the sequence
    (:func:`chunked_nll`). targets: (B, S) int; mask (B, S).

    Over a world under tensor and sequence parallelism (module docstring):
    where "vocab" splits the head each rank computes its block of the
    logits (:func:`chunked_nll`'s ``vocab_block``) for every position (the
    rank's block of the hidden states all-gathered once where "seq" splits
    the sequence); where only "seq" splits, each rank computes the loss of
    its own block of the text positions, and the sums and counts are folded
    over the ranks. Every rank returns the same total and count. ``plan``:
    what to gather at use (:func:`forward`).

    A text length that ``min(cfg.loss_chunk, S)`` does not divide raises
    ``ValueError`` (:func:`check_chunks`)."""
    check_chunks(cfg, targets.shape[1])
    npre = 0 if extra_embeds is None else extra_embeds.shape[1]
    params = gather_top(params, plan)
    h = forward(params, cfg, tokens, extra_embeds, plan)
    return nll_of(head_params(params)["e"], h, cfg, targets, mask, npre, cfg.logit_softcap)


def nll_of(e, h, cfg, targets, mask=None, npre=0, softcap=0.0):
    """(summed CE, token count) of the final hidden states ``h`` (B, npre +
    S, D; over a world the rank's block of the positions where "seq" splits
    them) against the head ``e`` (the rank's vocab rows where "vocab"
    splits it), the first ``npre`` positions (patches) out of the loss:
    :func:`lm_nll`'s tail, which ``encdec.encdec_nll`` shares."""
    mesh = sharding.get_mesh()
    seq = sharding.seq_range(targets.shape[1] + npre)
    vocab = sharding.vocab_range(cfg.vocab)
    if mesh is None or mesh.size == 1 or (seq is None and vocab is None):
        return chunked_nll(e, h[:, npre:], targets, mask, cfg.loss_chunk, softcap)
    if vocab is None:                                       # the rank's positions
        lo, hi = seq
        a, b = max(lo, npre) - npre, hi - npre              # its text positions
        if b <= a:          # none: a zero on h's graph keeps the backward's collectives
            zero = h[:, :0].float().sum()
            return fold_sum(mesh, zero), fold_sum(mesh, zero.detach())
        total, count = chunked_nll(e, h[:, a + npre - lo:], targets[:, a:b],
                                   None if mask is None else mask[:, a:b],
                                   cfg.loss_chunk, softcap)
        return fold_sum(mesh, total), fold_sum(mesh, count)
    # every position on every rank: the gradient of a block is reduce-
    # scattered back; a replicated h enters the rank's vocab block
    h = all_gather(mesh, h, 1) if seq is not None else copy_in(mesh, h)
    return chunked_nll(rank_block(e, 0, vocab, cfg.vocab), h[:, npre:], targets, mask,
                       cfg.loss_chunk, softcap, vocab_block=(mesh, vocab[0]))


def lm_loss(params, cfg, tokens, targets, mask=None, extra_embeds=None):
    """Mean CE, chunked over the sequence (:func:`lm_nll` over
    :func:`mean_nll`). targets: (B, S) int; mask (B, S)."""
    return mean_nll(*lm_nll(params, cfg, tokens, targets, mask, extra_embeds))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, seq_len, device, dtype=None):
    """Per-layer caches, stacked per slot like the params; over a world,
    this rank's block of each KV cache (``attention.kv_split``)."""
    dtype = dtype or cfg.dtype
    caches = {"slots": [init_block_cache(cfg, s, batch, seq_len, dtype, device,
                                         periods=cfg.n_periods)
                        for s in cfg.pattern]}
    if cfg.first_dense_ff:
        caches["block0"] = init_block_cache(cfg, cfg.pattern[0], batch, seq_len,
                                            dtype, device)
    return caches


def decode_step(params, cfg, caches, token, pos, plan=None):
    """One decode step. token: (B, 1) int; pos: int cache index.
    Returns (logits (B, 1, V), caches), the caches updated in place; each
    layer's stored blocks gathered at use by ``plan`` (:func:`forward`)."""
    mesh = sharding.get_mesh()
    params = gather_top(params, plan)
    x = embed(params["embed"], token, cfg.dtype, vocab=cfg.vocab)
    if sharding.vocab_range(cfg.vocab) is not None:
        x = sharding.world_sum(x)
    if caches.get("block0") is not None:
        cfg0 = cfg.replace(d_ff=cfg.first_dense_ff or cfg.d_ff)
        x, _ = block_decode(gather(params["block0"], part(plan, "block0"), mesh), cfg0, x,
                            caches["block0"], pos, cfg.pattern[0], "dense")
    ffns, slots = _slot_ffns(cfg), part(plan, "slots")
    for t in range(_n_periods(params)):
        slot_params, slot_caches = at(params["slots"], t), at(caches["slots"], t)
        for i, (slot, ffn) in enumerate(zip(cfg.pattern, ffns)):
            x, _ = block_decode(gather(slot_params[i], part(slots, i), mesh), cfg, x,
                                slot_caches[i], pos, slot, ffn)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(head_params(params), x, vocab=cfg.vocab)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, caches
