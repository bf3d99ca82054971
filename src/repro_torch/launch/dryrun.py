"""The dry-run: what each (arch, shape cell, world size) costs one rank,
accounted on the ``meta`` device (``src/repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --world 8
    python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape train_4k --batch 1 --layers 1
    python -m repro_torch.launch.dryrun --all --out reports/dryrun_torch.json
    python -m repro_torch.launch.dryrun --paper-kp billion --streaming --world 8

The reference lowers each cell on 512 fake XLA devices and reads XLA's
memory and cost analyses. The port runs its own steps (the train, prefill
and decode steps of ``models/model.py``; the solvers' per-chunk steps) on
the ``meta`` device, where a tensor has a shape and a dtype and no data,
under four counters:

* ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs the matrix
  products execute (2 a multiply-add);
* :class:`LiveBytes`, a dispatch mode that tracks the storages alive: the
  bytes held and the peak;
* ``kernels.cost.recording``: each hand-written kernel's launches, bytes,
  operations and bound (``kernels.ops`` sends a meta tensor to the
  kernel's shape path);
* a ``core.mesh.DryMesh``, rank 0 of a world of D with no process group:
  the bytes each collective sends.

The dry-run runs on the ``meta`` device on any machine and touches no
card: that is what it is, not a fallback. Over a world of D > 1 the rank
runs under ``sharding.BATCH_RULES`` (its B / D rows, its E / D experts),
as ``launch/train.py`` and the serving worlds run, or with ``--rules
production`` under ``sharding.PRODUCTION_RULES`` (tensor and sequence
parallelism: its blocks of the heads, FFN columns, vocab, experts and
caches, every row; the prefill, decode and train cells of every arch), or
with ``--rules fsdp``
under ``sharding.FSDP_RULES`` (FSDP: its rows and its stored blocks,
each block's leaves gathered at use and their gradients reduce-scattered,
the recompute's gathers counted too; every arch); ``--fsdp MODE`` lays
the config out by the reference's ``fsdp_mode``. D = 1 is one process
with no rules. A train cell's backward runs through ``core.mesh``'s autograd
collectives, so its account counts the backward's collectives too. The memory is the
rank's: its tree (the leaves :func:`models.model.param_specs` splits, cut),
AdamW's moments, its caches, the global batch it is given, and the peak of
what the step allocates on top (on the card's caching allocator,
``max_memory_allocated``, which the on-card smoke holds it against); the
collectives' bytes come from the ``DryMesh`` (``gather``, ``all_to_all``,
``reduce``, ``all_gather``, ``reduce_scatter``).

The probe (the reference's ``_probe_block``, for the opposite reason: XLA
counts a loop body once, eager meta walks every Python loop) runs a
prefill or decode step with the stacked layers cut to one period and to
two (views into the whole tree, which stays held) and scales the second's
extra by the periods: total = one + (n_periods - 1) (two - one), for the
FLOPs, the kernels' work, the collective bytes and the peak. The peak is
not additive, but without gradients a period leaves nothing alive behind
it but its output, so two - one is what each period adds to it (nothing
but its cut of the held tree, which is counted whole). A train step runs
every layer: its peak lies in the backward, where each stacked leaf's
gradient and the full-size buffers that autograd adds a period's
gradient through grow with the depth while remat's saved block inputs
shrink, and which of those terms is largest moves with the depth (at
``smoke()``, moonshot's peak grew by 3.7, 2.0, 2.0, 3.7 and 4.1 MB a
period from 1 to 6 periods), so no two depths extrapolate it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves as _flat
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import registry
from ..configs.paper_kp import WORKLOADS
from ..core.chunked import (ChunkSource, apply_chunk_accumulate, fin_zeros,
                            finalize_chunk_accumulate, removable_chunk_accumulate,
                            stream_solve_fn)
from ..core.bucketing import make_edges, ordered_colsum
from ..core.mesh import DryMesh
from ..core.solver import _map_tile, scd_chunk_accumulate
from ..core.types import SolverConfig
from ..kernels import cost, ops
from ..models import lm, model as M, sharding
from ..optim import OptConfig

WORLDS = (1, 2, 4, 8)          # --all: one card up to one HGX node
HBM_80GB = 80e9
META = torch.device("meta")


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive, and their peak: every storage an op
    inside makes, and those given to :meth:`hold`, counted once while some
    tensor holds it (views share their base's). A storage's death is seen
    through a finalizer on its Python object; the peak is read after each
    op, its inputs still alive, as the card's allocator holds them while
    the op's outputs are allocated.

    Some ops of a backward are counted as the card runs them, not as they
    run here. Under any Python dispatch mode, this one included, autograd
    takes the out-of-place variant where it writes into a buffer of its own
    in place on the card: the engine's sum of two gradients of one input
    (``add``), and the backward formulas of ``gather`` (``scatter_add``
    into fresh zeros) and of indexing (``index_put``, ``index_add``). So the
    peak of such an op (:meth:`_in_place_on_card`) is settled at the next
    op: without its output's bytes where its first input died at once (it
    was autograd's own buffer, written in place on the card), with them
    where that input lives on."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._bytes = {}
        self._pending = None

    def _track(self, t):
        s = t.untyped_storage()
        key = s._cdata
        if key not in self._bytes:
            self._bytes[key] = s.nbytes()
            self.live += self._bytes[key]
            weakref.finalize(s, self._free, key)

    def _free(self, key):
        self.live -= self._bytes.pop(key)

    def hold(self, tree):
        """Count the tensors of ``tree`` (made outside) as held."""
        self._settle()
        for t in lm.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.peak = max(self.peak, self.live)

    # The out-of-place ops that autograd runs in place on the card
    # (class docstring).
    _ON_CARD_IN_PLACE = (torch.ops.aten.add.Tensor, torch.ops.aten.scatter_add.default,
                         torch.ops.aten.index_put.default, torch.ops.aten.index_add.default)

    @classmethod
    def _in_place_on_card(cls, func, args, out):
        """Whether the op is one of ``_ON_CARD_IN_PLACE`` inside a backward,
        with gradients off, writing a tensor of its first input's shape and
        dtype, that input dense and its storage's only tenant (for ``add``,
        the engine's sum: both inputs of that shape)."""
        if (func not in cls._ON_CARD_IN_PLACE or torch._C._current_graph_task_id() == -1
                or torch.is_grad_enabled() or not isinstance(out, torch.Tensor)):
            return False
        first = args[0]
        same = args[:2] if func is torch.ops.aten.add.Tensor else args[:1]
        return (isinstance(first, torch.Tensor) and first.is_contiguous()
                and first.untyped_storage().nbytes() == out.untyped_storage().nbytes()
                and all(isinstance(a, torch.Tensor) and a.shape == out.shape
                        and a.dtype == out.dtype for a in same))

    def _settle(self):
        """Close an op left pending: its first input's storage gone means
        autograd held it alone, and writes it in place on the card."""
        if self._pending is not None:
            key, live, added = self._pending
            self._pending = None
            self.peak = max(self.peak, live - added if key not in self._bytes else live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._settle()
        out = func(*args, **(kwargs or {}))
        for t in _flat(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        if self._in_place_on_card(func, args, out):
            self._pending = (args[0].untyped_storage()._cdata, self.live,
                             out.untyped_storage().nbytes())
        else:
            self.peak = max(self.peak, self.live)
        return out

    def __exit__(self, *exc):
        self._settle()
        return super().__exit__(*exc)


def nbytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in lm.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def n_leaves(tree) -> int:
    return sum(t.numel() for t in lm.tree_leaves(tree) if isinstance(t, torch.Tensor))


def active_params(cfg, n_params: int) -> int:
    """Active (per-token) parameters: the total less the routed experts a
    token does not reach (``benchmarks/roofline.py``'s convention, its
    first-dense-layer count included)."""
    m = cfg.moe
    if not m.n_experts:
        return n_params
    per_expert = cfg.d_model * 2 * m.d_ff + m.d_ff * cfg.d_model
    n_moe = sum(1 for i in range(cfg.n_layers)
                if cfg.ffn_pattern[i % len(cfg.ffn_pattern)] == "moe")
    if cfg.first_dense_ff:
        n_moe -= 1 if cfg.ffn_pattern[0] == "moe" else 0
    inactive = n_moe * m.n_experts * per_expert * (1.0 - m.topk / m.n_experts)
    return int(n_params - inactive)


def model_flops(cfg, cell, n_params, world):
    """The useful FLOPs of a rank's step (attention excluded): 6, 2 and 2 x
    N_active x tokens for train, prefill and decode (one token a row)."""
    na = active_params(cfg, n_params)
    tokens = cell.global_batch * (1 if cell.kind == "decode"
                                  else M._text_len(cfg, cell.seq_len))
    return (6.0 if cell.kind == "train" else 2.0) * na * tokens / world


# --------------------------------------------------------------------------
# One run on meta under the counters, and the probe's scaling
# --------------------------------------------------------------------------

def _counted(fn, held, mesh):
    """Run ``fn()`` under the counters with ``held`` counted as held:
    {flops, peak, kernels, comm_bytes, comm_calls}."""
    tracker = LiveBytes()
    tracker.hold(held)
    b0 = dict(mesh.comm_bytes) if mesh is not None else {}
    c0 = dict(mesh.comm_calls) if mesh is not None else {}
    with cost.recording() as rec, FlopCounterMode(display=False) as fc, tracker:
        fn()
    diff = lambda now, was: {k: v - was.get(k, 0) for k, v in now.items()  # noqa: E731
                             if v - was.get(k, 0)}
    return {"flops": fc.get_total_flops(), "peak": tracker.peak,
            "kernels": cost.summary(rec),
            "comm_bytes": diff(mesh.comm_bytes, b0) if mesh is not None else {},
            "comm_calls": diff(mesh.comm_calls, c0) if mesh is not None else {}}


def _scale(one, two, n):
    """one + (n - 1) (two - one), through nested dicts of numbers."""
    if isinstance(one, dict) or isinstance(two, dict):
        one, two = one or {}, two or {}
        return {k: _scale(one.get(k, 0), two.get(k, 0), n) for k in {**one, **two}}
    out = one + (n - 1) * (two - one)
    return round(out, 9) if isinstance(out, float) else out


def _stacks(cfg):
    """(the stacked parameter keys, the stacked cache keys, their periods)
    of a probe, or None where the layers are not one repeated period (an
    encoder-decoder with other encoder and decoder depths)."""
    if cfg.kind == "encdec":
        if cfg.n_enc_layers != cfg.n_layers:
            return None
        return ("enc", "dec"), ("self", "cross"), cfg.n_layers
    return ("slots",), ("slots",), cfg.n_periods


def _cut_periods(tree, keys, k):
    """``tree`` with its stacked subtrees ``keys`` cut to their first ``k``
    periods (views)."""
    if tree is None or k is None:
        return tree
    return {key: lm.tree_map(lambda a: a[:k], v) if key in keys else v
            for key, v in tree.items()}


def _step(cfg, cell, params, opt, inputs, k, keys, ckeys):
    """The cell's step on meta with the stacks cut to ``k`` periods (None:
    whole), as a thunk."""
    p = _cut_periods(params, keys, k)
    if cell.kind == "train":
        o = opt._replace(mu=_cut_periods(opt.mu, keys, k), nu=_cut_periods(opt.nu, keys, k))
        step = M.make_train_step(cfg, OptConfig())
        return lambda: step(p, o, inputs)
    if cell.kind == "prefill":
        step = M.make_prefill_step(cfg)
        return lambda: _no_grad(step, p, inputs)
    caches = _cut_periods(inputs["caches"], ckeys, k)
    step = M.make_decode_step(cfg)
    return lambda: _no_grad(step, p, caches, inputs["token"], inputs["pos"])


def _no_grad(fn, *args):
    with torch.no_grad():
        return fn(*args)


def world_skip(cfg, cell, world, rules):
    """Why a world of ``world`` ranks cannot run the cell under ``rules``,
    or None: a refused binding (``model.check_rules``), a batch (where
    "batch" is on the world) or an expert count (where "experts" is) that
    the world does not divide."""
    M.check_rules(rules)
    if world > 1 and sharding.binds(rules, "batch") and cell.global_batch % world:
        return f"global batch {cell.global_batch} does not split over {world} ranks"
    if (world > 1 and cfg.moe.n_experts and sharding.binds(rules, "experts")
            and cfg.moe.n_experts % world):
        return f"{cfg.moe.n_experts} experts do not split over {world} ranks"
    return None


def account_cell(arch, shape, world, probe=True, router=None, batch=None, cfg=None,
                 rules=None):
    """One rank's account of one cell (the reference's ``lower_cell``).

    ``shape``: a name of ``model.SHAPES`` or a ``ShapeCell``; ``world``: D;
    ``probe``: scale one period of a prefill or decode step (a train step
    runs whole; module docstring); ``router``, ``batch``: override the
    config's router and the cell's global batch; ``cfg``: the config to
    run (default ``registry.get(arch)``, e.g. a cut one, or one laid out
    by another ``fsdp_mode``); ``rules``: the rules over a world of D > 1,
    a dict or a name of ``sharding.RULES`` ("batch", "production", "fsdp"),
    which ``sharding.rules_for`` gives for the config's ``fsdp_mode``, as
    ``launch/train.train`` takes them (default the batch binding; D = 1
    runs one process with none). Returns a dict:
    ``status`` "ok", "skipped" (with ``reason``: the cell, a refused
    binding, or a batch or expert count that D does not divide) or "error";
    ``n_params``, ``n_active``; ``memory`` (per rank, bytes: ``params``,
    ``opt``, ``grads``, ``caches``, ``batch``, ``held``, ``peak``,
    ``fits_80gb``); ``flops_executed``, ``model_flops``; ``kernels`` (per
    kernel: launches, bytes, ops, bound_ms); ``collectives`` (bytes and
    counts by kind); ``probe`` (its periods, or None: the whole run);
    ``account_s``."""
    t0 = time.perf_counter()
    cfg = registry.get(arch) if cfg is None else cfg
    if router:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router=router))
    cell = M.SHAPES[shape] if isinstance(shape, str) else shape
    if batch:
        cell = dataclasses.replace(cell, global_batch=batch)
    if world == 1:
        rules = None
    elif rules is None or isinstance(rules, str):
        rules = sharding.rules_for(rules or "batch", cfg.fsdp_mode)
    rec = {"arch": arch, "shape": cell.name, "world": world, "kind": cell.kind,
           "global_batch": cell.global_batch, "seq_len": cell.seq_len,
           "router": cfg.moe.router if cfg.moe.n_experts else None,
           "rules": next((k for k in RULES if sharding.rules_for(k, cfg.fsdp_mode) == rules),
                         rules),
           "fsdp_mode": cfg.fsdp_mode}
    try:
        reason = M.cell_applicable(cfg, cell) or world_skip(cfg, cell, world, rules)
    except NotImplementedError as e:
        reason = str(e)
    if reason:
        return {**rec, "status": "skipped", "reason": reason}
    mesh = DryMesh(0, world) if world > 1 else None
    sharding.set_rules(rules, mesh=mesh)
    try:
        rec.update(_account(cfg, cell, world, probe, mesh), status="ok")
    except Exception as e:  # noqa: BLE001 - a cell's fault is its record's
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        sharding.set_rules(None)
    rec["account_s"] = round(time.perf_counter() - t0, 3)
    return rec


def _account(cfg, cell, world, probe, mesh):
    whole = M.init(cfg, None, "meta")
    n_params = n_leaves(whole)
    # the rank's tree: its blocks of the expert leaves, copied as
    # ``sharding.shard_experts`` copies them (the whole tree is freed)
    params = (lm.tree_map(torch.clone, M.cut(whole, M.param_specs(cfg, whole), mesh))
              if mesh is not None else whole)
    del whole
    inputs = M.input_specs(cfg, cell, params)
    opt = M.init_opt(cfg, params, OptConfig(), mesh) if cell.kind == "train" else None
    held = [params, opt, inputs]
    stacks = _stacks(cfg)
    keys, ckeys, n = stacks if stacks else ((), (), 1)
    if probe and stacks and n >= 2 and cell.kind != "train":
        runs = [_counted(_step(cfg, cell, params, opt, inputs, k, keys, ckeys), held, mesh)
                for k in (1, 2)]
        run = _scale(runs[0], runs[1], n)
        probed = {"n_periods": n, "periods_run": [1, 2]}
    else:
        run = _counted(_step(cfg, cell, params, opt, inputs, None, keys, ckeys), held, mesh)
        probed = None
    pb = nbytes(params)
    caches = inputs.get("caches") if cell.kind == "decode" else None
    batch = {k: v for k, v in inputs.items() if k != "caches"}
    mem = {"params": pb, "opt": nbytes(opt), "grads": pb if cell.kind == "train" else 0,
           "caches": nbytes(caches), "batch": nbytes(batch)}
    mem["held"] = nbytes(held)
    mem["peak"] = run["peak"]
    mem["fits_80gb"] = mem["peak"] < HBM_80GB
    kernels = {k: dict(v, bound_ms=round(v["bound_ms"], 6)) for k, v in run["kernels"].items()}
    return {"n_params": n_params, "n_active": active_params(cfg, n_params),
            "n_params_rank": n_leaves(params), "memory": mem,
            "flops_executed": run["flops"],
            "model_flops": model_flops(cfg, cell, n_params, world),
            "kernels": kernels,
            "collectives": {"bytes": run["comm_bytes"], "counts": run["comm_calls"],
                            "total_bytes": sum(run["comm_bytes"].values())},
            "probe": probed}


# --------------------------------------------------------------------------
# The paper's workload
# --------------------------------------------------------------------------

def meta_chunk_source(n, k, chunk, q=1, tightness=0.5, b_high=1.0, rows=None):
    """``data.synth.sparse_chunk_source`` on meta: the same shapes, budgets
    and allocations (p, then b drawn and scaled; past n, the ragged tail's
    two ``where`` copies against ``rows``, the source's arange), no
    values."""
    budgets = torch.full((k,), tightness * n * q * (b_high / 2.0) / k, dtype=torch.float32)
    rows = torch.arange(chunk, device=META) if rows is None else rows

    def fn(i):
        p = torch.rand((chunk, k), device=META)
        b = torch.rand((chunk, k), device=META) * b_high
        if (i + 1) * chunk > n:
            live = ((i * chunk + rows) < n)[:, None]
            p, b = torch.where(live, p, 0.0), torch.where(live, b, 0.0)
        return p, b
    return ChunkSource(n=n, k=k, chunk=chunk, budgets=budgets, fn=fn)


def _partials(mesh, gathers=(), reduces=()):
    """Count the folds' collectives on ``mesh``: one gather of each shape of
    ``gathers`` and one maximum (or minimum) of each of ``reduces``, of
    float32 partials."""
    if mesh is not None:
        for s in gathers:
            mesh.gather(torch.empty(s, device=META))
        for s in reduces:
            mesh.amax(torch.empty(s, device=META))


def account_paper_kp(workload, world=1, reduce="bucketed", algo="scd", chunk_size=None,
                     streaming=False, stream_finalize="fused", iters=2):
    """One rank's account of the paper's sparse GKP over ``world`` ranks
    (the reference's ``lower_paper_kp``): ``iters`` iterations and the
    finalize. ``workload``: a name of ``configs.paper_kp.WORKLOADS`` or a
    ``KPWorkload``.

    ``streaming``: the device-streamed driver as ``chunked.stream_solve_fn``
    builds it (the program ``solve_streaming`` runs): one chunk step of
    each pass kind on meta, its launches and work scaled by the chunks a
    rank streams (``rt.cps``); its state (the carries, a chunk and the
    step's transients) is O(chunk x K), whatever N is. Otherwise the
    resident solve: the rank's N / D rows of p and b (8 N K / D bytes) and
    the per-iteration map over them (``solver._scd_step_fused``, its
    chunked loop with ``chunk_size``, or the exact reduce's candidates; DD
    ``adjusted_topc``), and the final primal. ``partials`` are the bytes
    this rank gathers for the folds per iteration and per finalize."""
    t0 = time.perf_counter()
    wl = WORKLOADS[workload] if isinstance(workload, str) else workload
    k, q = wl.k, wl.q
    n = wl.n_users if streaming else (wl.n_users // world) * world
    cfg = SolverConfig(algo=algo, reduce=reduce, max_iters=iters,
                       stream_finalize=stream_finalize)
    mesh = DryMesh(0, world) if world > 1 else None
    rec = {"workload": wl.name, "n_users": n, "k": k, "q": q, "algo": algo,
           "reduce": reduce, "iters": iters, "streaming": streaming, "world": world,
           "stream_finalize": stream_finalize if streaming else None}
    lam = torch.empty((k,), device=META)
    edges = make_edges(torch.ones((k,)), cfg.bucket_delta, cfg.bucket_growth,
                       cfg.bucket_half).to(META)
    e = edges.shape[-1]
    if streaming:
        if reduce != "bucketed" and algo == "scd":
            raise ValueError("--streaming runs the bucketed reduce only "
                             "(solve_streaming cannot stream the exact reduce)")
        chunk = chunk_size or 65536
        rows = torch.arange(chunk, device=META)
        rt, _ = stream_solve_fn(meta_chunk_source(n, k, chunk, q, wl.tightness, rows=rows),
                                cfg, q, mesh=mesh, device="meta")
        # The rank's last two chunks (the instance's ragged tail last, on the
        # last rank) through the driver's own loop (``PassRunner._run_epoch``),
        # which holds a chunk while it draws the next.
        last = [(rt.s0, j) for j in range(max(rt.cps - 2, 0), rt.cps)]
        pedges = rt.pedges.to(META)
        nb = pedges.shape[0] + 1

        def epoch(step, carry):
            return rt._run_epoch(lambda c, p_c, b_c, item: step(p_c, b_c, c), carry,
                                 "dryrun", last)

        def iterate():
            if algo == "dd":
                return epoch(lambda p_c, b_c, r: r + ordered_colsum(
                    ops.adjusted_topc(p_c, b_c, lam, q)[1]), torch.zeros((k,), device=META))
            carry = (torch.zeros((k, e + 1), device=META),
                     torch.full((k,), float("-inf"), device=META))
            return epoch(lambda p_c, b_c, c: scd_chunk_accumulate(p_c, b_c, lam, edges, q, cfg,
                                                                  *c), carry)

        def finalize():
            if stream_finalize == "fused":
                return epoch(lambda p_c, b_c, c: finalize_chunk_accumulate(
                    p_c, b_c, lam, q, cfg, c, pedges), fin_zeros(k, nb, cfg.postprocess, META))
            # legacy: the metrics pass, the removable histogram against the
            # (lo, hi) ladder, and the pass that applies tau
            carry = epoch(lambda p_c, b_c, c: finalize_chunk_accumulate(p_c, b_c, lam, q, cfg, c),
                          fin_zeros(k, 0, False, META))
            ladder = torch.empty((cfg.profit_buckets,), device=META)
            hist = epoch(lambda p_c, b_c, h: removable_chunk_accumulate(p_c, b_c, lam, q, ladder,
                                                                        h),
                         torch.zeros((k, cfg.profit_buckets + 1), device=META))
            tau = torch.empty((), device=META)
            return carry, hist, epoch(lambda p_c, b_c, c: apply_chunk_accumulate(
                p_c, b_c, lam, q, tau, c), carry[:2])

        per_iter = _counted(iterate, [rows], None)
        per_fin = _counted(finalize, [rows], None)
        reps = rt.cps / len(last)
        spd = rt.spd
        if algo == "dd":
            _partials(mesh, [(spd, k)])                      # r
        else:
            _partials(mesh, [(spd, k, e + 1)], [(k,)])       # hist; top
        it_comm = dict(mesh.comm_bytes) if mesh else {}
        if stream_finalize == "fused":                       # r, primal, dual, the hists
            _partials(mesh, [(spd, k), (spd,), (spd,), (spd, k, nb), (spd, nb)])
        else:                                                # metrics, hist, apply
            _partials(mesh, [(spd, k), (spd,), (spd,), (1, k, cfg.profit_buckets + 1),
                             (1, k), (1,)], [(), ()])
        resident = 0
        state_bytes = max(per_iter["peak"], per_fin["peak"])
        rec.update(chunk_size=chunk, chunks=rt.c, chunks_per_rank=rt.cps)
    else:
        n_loc = n // world
        p = torch.empty((n_loc, k), device=META)
        b = torch.empty((n_loc, k), device=META)
        if chunk_size:
            cfg = cfg.replace(chunk_size=chunk_size)

        def iterate():
            if algo == "dd":
                ordered_colsum(ops.adjusted_topc(p, b, lam, q)[1])
            elif reduce == "exact":
                v1, v2 = ops.scd_candidates(p, b, lam, q)
                _partials(mesh, [tuple(v1.shape), tuple(v2.shape)])
            elif chunk_size:
                hist = torch.zeros((k, e + 1), device=META)
                top = torch.full((k,), float("-inf"), device=META)
                for s in range(0, n_loc, chunk_size):
                    m = min(chunk_size, n_loc - s)
                    pc, bc = p[s:s + m], b[s:s + m]
                    if m < chunk_size:
                        pc = torch.cat([pc, pc.new_zeros((chunk_size - m, k))])
                        bc = torch.cat([bc, bc.new_zeros((chunk_size - m, k))])
                    hist, top = scd_chunk_accumulate(pc, bc, lam, edges, q, cfg, hist, top)
            else:
                ops.scd_fused_hist(p, b, lam, edges, q, tile_n=_map_tile(cfg))

        def finalize():
            x, cons = ops.adjusted_topc(p, b, lam, q)
            torch.sum(cons, dim=0)
            torch.sum(torch.where(x, p, 0.0))

        per_iter = _counted(iterate, [p, b], mesh)
        per_fin = _counted(finalize, [p, b], mesh)
        reps = 1
        if algo == "dd":
            _partials(mesh, [(k,)])                          # r
        elif reduce == "bucketed":
            _partials(mesh, [(k, e + 1)], [(k,)])            # hist; top
        it_comm = dict(mesh.comm_bytes) if mesh else {}
        _partials(mesh, [(k,), (), ()])                      # r, primal, dual
        resident = nbytes([p, b])
        state_bytes = max(per_iter["peak"], per_fin["peak"]) - resident
    fin_comm = {kk: v - it_comm.get(kk, 0) for kk, v in (mesh.comm_bytes if mesh else {}).items()}

    def scaled(run, times):
        return {name: {"launches": round(v["launches"] * times),
                       "bytes": round(v["bytes"] * times), "ops": round(v["ops"] * times),
                       "bound_ms": round(v["bound_ms"] * times, 6)}
                for name, v in run["kernels"].items()}

    rec.update(
        status="ok",
        memory={"resident": resident, "state": state_bytes, "peak": resident + state_bytes,
                "fits_80gb": resident + state_bytes < HBM_80GB},
        per_iteration={"kernels": scaled(per_iter, reps),
                       "partials_bytes": sum(it_comm.values())},
        per_finalize={"kernels": scaled(per_fin, reps),
                      "partials_bytes": sum(fin_comm.values())},
        account_s=round(time.perf_counter() - t0, 3))
    total = {}
    for part, times in (("per_iteration", iters), ("per_finalize", 1)):
        for name, v in rec[part]["kernels"].items():
            t = total.setdefault(name, {"launches": 0, "bytes": 0, "ops": 0, "bound_ms": 0.0})
            for key in t:
                t[key] += v[key] * times
    rec["kernels"] = total
    return rec


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

RULES = sharding.RULES


def _print(r):
    print(json.dumps({k: v for k, v in r.items() if k != "traceback"}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=registry.names())
    ap.add_argument("--shape", choices=list(M.SHAPES))
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the world (D); the rank accounted is rank 0")
    ap.add_argument("--all", action="store_true",
                    help=f"every arch x shape x world of {WORLDS}")
    ap.add_argument("--paper-kp", choices=list(WORKLOADS))
    ap.add_argument("--reduce", choices=["bucketed", "exact"], default="bucketed")
    ap.add_argument("--algo", choices=["scd", "dd"], default="scd")
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--streaming", action="store_true",
                    help="paper-kp: the device-streamed driver (state flat in N)")
    ap.add_argument("--stream-finalize", choices=["fused", "legacy"], default="fused")
    ap.add_argument("--no-probe", action="store_true",
                    help="run every layer (no per-period probe)")
    ap.add_argument("--router", choices=["topk", "scd"])
    ap.add_argument("--fsdp", choices=list(sharding.FSDP_MODES), default=None,
                    help="lay each config out by the reference's fsdp_mode, under the "
                         "mode's rules (sharding.rules_for)")
    ap.add_argument("--rules", choices=list(RULES), default="batch",
                    help="the rules over a world of D > 1: the batch binding "
                         "(sharding.BATCH_RULES), the reference's production rules "
                         "(sharding.PRODUCTION_RULES: tensor and sequence parallelism) "
                         "or FSDP (sharding.FSDP_RULES: the reference's (D, 1) mesh)")
    ap.add_argument("--batch", type=int, default=None, help="override the cell's global batch")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers (a multiple of its pattern), "
                         "as the on-card smoke cuts its cells")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def laid_out(cfg):
        return cfg.replace(fsdp_mode=args.fsdp) if args.fsdp else cfg

    results = []
    if args.paper_kp:
        r = account_paper_kp(args.paper_kp, args.world, args.reduce, args.algo,
                             args.chunk_size, args.streaming, args.stream_finalize)
        print(json.dumps(r, indent=2))
        results.append(r)
    elif args.all:
        for arch in registry.names():
            for shape in M.SHAPES:
                for world in WORLDS:
                    r = account_cell(arch, shape, world, probe=not args.no_probe,
                                     router=args.router, batch=args.batch,
                                     cfg=laid_out(registry.get(arch)), rules=args.rules)
                    _print(r)
                    results.append(r)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all, or --paper-kp)")
        cfg = laid_out(registry.get(args.arch))
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        r = account_cell(args.arch, args.shape, args.world, probe=not args.no_probe,
                         router=args.router, batch=args.batch, cfg=cfg,
                         rules=args.rules)
        _print(r)
        results.append(r)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = all(r["status"] in ("ok", "skipped") for r in results)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
