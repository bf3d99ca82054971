"""The port's dry-run (``launch/dryrun.py``) against real runs on the CPU and
against the reference's parameter counts.

* ``n_params`` of every arch at full width equals the reference's
  ``jax.eval_shape(init)`` leaf sum, exactly;
* at ``smoke()`` (jamba's cut to one period of its pattern), every arch's
  held bytes (params, AdamW's moments, the caches, the batch) equal the
  ``nbytes`` of a real CPU init, its AdamW state, its caches and its
  batch, exactly;
* ``FlopCounterMode`` on meta equals the same counter over a real CPU run
  of the prefill, the train step and the decode step, exactly, and so do
  the live-bytes tracker's peak and the kernels' launches (on the CPU the
  ``kernels.ops`` calls, counted by wrapping them here); the tracker's peak
  equals a hand-counted toy program's on both devices;
* the probe (one period and two, scaled) equals the whole run for the
  FLOPs, the launches, the collective bytes and the peak, at smoke depths
  2 and 4, over one process and a world of 2;
* paper-KP: the streamed state is the same at N = 10^7 and 10^9 (chunk
  65,536), the resident bytes are 8 N K / D, and the launches a pass
  equal a small host-fed and device-streamed CPU solve's;
* FSDP's cells (``--rules fsdp``, ``--fsdp``, a config laid out for
  FSDP) accounted; the refusals (a 2-D world, a world that does not
  divide the batch or the experts), the cells that the production rules
  account (train cells, and the MLA, Mamba2 and encoder-decoder archs'),
  and the CLI, ``--rules production`` too.

The collective bytes of real worlds of 2 are held to the dry-run's in
``test_torch_moe_world.py``, ``test_torch_train_world.py`` and (under the
production rules) ``test_torch_tp_world.py``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_cuda import one_intra_op_thread  # noqa: E402,F401

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.chunked import solve_streaming  # noqa: E402
from repro_torch.core.prefetch import solve_streaming_host  # noqa: E402
from repro_torch.core.types import SolverConfig  # noqa: E402
from repro_torch.data.synth import lm_batch, sparse_chunk_source, sparse_host_chunk_source  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import lm, model as M, sharding  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FLOP_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-236b", "jamba-v0.1-52b",
              "seamless-m4t-medium")
B, S = 2, 64                         # the smoke cells: B x S tokens, caches of S
KERNELS = ("scd_fused_hist", "scd_finalize_hist", "scd_candidates", "bucket_hist",
           "screen_bound", "adjusted_topc")


def cell(kind, b=B, s=S):
    return M.ShapeCell(f"smoke_{kind}", s, b, kind)


@pytest.mark.parametrize("arch", registry.names())
def test_n_params_equal_the_reference(arch):
    cfg = rregistry.get(arch)
    shapes = jax.eval_shape(lambda k: RM.init(cfg, k),
                            jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    want = sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(shapes))
    rec = D.account_cell(arch, cell("decode", b=8), 8)     # full width, a short cell
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_params"] == want


def _real(cfg, kind):
    """A real CPU cell at smoke(): (params, opt or None, inputs) as the
    port's callers make them."""
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_opt_state(params, OptConfig()) if kind == "train" else None
    batch = lm_batch(cfg, (B, S), 0, seed=1, device="cpu")
    if kind == "prefill":
        batch.pop("targets")
    if kind != "decode":
        return params, opt, batch
    frames = lm_batch(cfg, (B, S), 0, seed=1, device="cpu").get("frames")
    with torch.no_grad():
        caches = M.init_cache(cfg, params, B, S, frames=frames)
    return params, opt, {"caches": caches, "token": batch["tokens"][:, :1].clone(),
                         "pos": S - 1}


def _check_held(rec, cfg, kind, real):
    params, opt, inputs = real
    mem = rec["memory"]
    assert mem["params"] == D.nbytes(params)
    assert mem["opt"] == D.nbytes(opt)
    assert mem["caches"] == D.nbytes(inputs.get("caches") if kind == "decode" else None)
    assert mem["batch"] == D.nbytes({k: v for k, v in inputs.items() if k != "caches"})
    assert mem["held"] == D.nbytes([params, opt, inputs])
    assert mem["peak"] > mem["held"]


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", [a for a in registry.names() if a not in FLOP_ARCHS])
def test_held_bytes_equal_a_real_cpu_cell(arch, kind):
    """The other archs here; the FLOP_ARCHS' in the next test (a prefill
    holds a subset of a train step's)."""
    cfg = registry.get(arch).smoke()
    rec = D.account_cell(arch, cell(kind), 1, cfg=cfg)
    assert rec["status"] == "ok", rec.get("error")
    _check_held(rec, cfg, kind, _real(cfg, kind))


def _counting_ops(monkeypatch):
    """Count the ``kernels.ops`` calls of a CPU run by name."""
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)
    return calls


def _flop_cfg(arch):
    """smoke(); jamba's cut to one period of its 8-slot pattern (every
    mixer and FFN kind of it, half its 16 layers) for the test's time."""
    cfg = registry.get(arch).smoke()
    return cfg.replace(n_layers=len(cfg.pattern)) if len(cfg.pattern) > 1 else cfg


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_meta_counts_equal_a_real_cpu_run(arch, kind, monkeypatch):
    """The meta run takes the CPU run's path: the same matrix products
    (FLOPs), the same live storages (the tracker's peak) and the same
    kernel calls; and it holds what the CPU cell holds."""
    cfg = _flop_cfg(arch)
    rec = D.account_cell(arch, cell(kind), 1, cfg=cfg, probe=False)
    assert rec["status"] == "ok", rec.get("error")
    params, opt, inputs = real = _real(cfg, kind)
    _check_held(rec, cfg, kind, real)
    calls = _counting_ops(monkeypatch)
    thunk = D._step(cfg, cell(kind), params, opt, inputs, None, (), ())
    tracker = D.LiveBytes()
    tracker.hold([params, opt, inputs])
    with FlopCounterMode(display=False) as fc, tracker:
        thunk()
    assert rec["flops_executed"] == fc.get_total_flops() > 0
    assert rec["memory"]["peak"] == tracker.peak
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == \
        {k: v for k, v in calls.items() if v}


def _toy(device):
    """A program whose live bytes peak at a hand-counted 14,004."""
    a = torch.empty(1000, dtype=torch.float32, device=device)      # 4,000
    b = a * 2                                                       # 8,000
    del a                                                           # 4,000
    c = torch.empty(250, dtype=torch.float64, device=device)       # 6,000
    v = b.view(2, 500)                                              # a view: 6,000
    e = torch.cat([b, v.flatten()])                                 # 14,000
    return e.sum(), c                                               # 14,004


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_tracker_counts_a_toy_program_by_hand(device):
    tracker = D.LiveBytes()
    with tracker:
        out = _toy(device)
    assert tracker.peak == 14_004
    del out


@pytest.mark.parametrize("arch,kind,depth,world", [
    *[("moonshot-v1-16b-a3b", "prefill", d, w) for d in (2, 4) for w in (1, 2)],
    ("moonshot-v1-16b-a3b", "decode", 2, 2), ("moonshot-v1-16b-a3b", "decode", 4, 1),
    ("deepseek-v2-236b", "prefill", 4, 2), ("deepseek-v2-236b", "decode", 4, 1)])
def test_probe_equals_the_whole_run(arch, kind, depth, world):
    """deepseek's dense block0 stands outside the periods, as the embedding
    and the head do."""
    cfg = registry.get(arch).smoke().replace(n_layers=depth)
    probe = D.account_cell(arch, cell(kind, b=4), world, cfg=cfg, probe=True)
    whole = D.account_cell(arch, cell(kind, b=4), world, cfg=cfg, probe=False)
    assert probe["probe"] == {"n_periods": depth, "periods_run": [1, 2]}
    assert whole["probe"] is None
    for key in ("flops_executed", "kernels", "collectives", "memory"):
        assert probe[key] == whole[key], key
    assert bool(probe["kernels"]) == (kind == "prefill")
    assert (probe["collectives"]["total_bytes"] > 0) == (world > 1)


def test_train_runs_every_layer():
    arch = "moonshot-v1-16b-a3b"
    cfg = registry.get(arch).smoke().replace(n_layers=4)
    rec = D.account_cell(arch, cell("train", b=4), 2, cfg=cfg, probe=True)
    assert rec["status"] == "ok" and rec["probe"] is None
    assert rec["kernels"]["scd_fused_hist"]["launches"] == 2 * 4 * cfg.moe.scd_iters


def test_world_cuts_the_experts_and_the_rows():
    arch = "moonshot-v1-16b-a3b"
    cfg = registry.get(arch).smoke()
    one = D.account_cell(arch, cell("decode", b=4), 1, cfg=cfg)
    two = D.account_cell(arch, cell("decode", b=4), 2, cfg=cfg)
    whole = M.init(cfg, None, "meta")
    mesh = D.DryMesh(1, 2)
    sharding.set_rules(sharding.BATCH_RULES, mesh=mesh)
    try:
        specs = M.param_specs(cfg, whole)
        bspecs = M.batch_specs(cfg, cell("decode", b=4))
    finally:
        sharding.set_rules(None)
    cut = M.cut(whole, specs, mesh)
    want = sharding.shard_experts(whole, mesh)
    assert [tuple(a.shape) for a in lm.tree_leaves(cut)] == \
        [tuple(a.shape) for a in lm.tree_leaves(want)]
    assert bspecs["token"] == 0
    assert one["n_params"] == two["n_params"] and two["n_params_rank"] < one["n_params"]
    assert two["memory"]["caches"] * 2 == one["memory"]["caches"]


def test_meta_launch_refused_as_the_card_refuses():
    """The shape path refuses what the card's wrappers refuse: K above a
    kernel's bound, a block's shared memory above the card's, a finalize
    tile above 1,024."""
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="K <= 64"):
        ops.scd_candidates(meta(64, 65), meta(64, 65), meta(65), 1)
    with pytest.raises(ValueError, match="shared memory"):
        ops.bucket_hist(meta(4096, 64), meta(4096, 64), meta(64, 33), tile_n=1024)
    with pytest.raises(ValueError, match="tile_n"):
        ops.scd_finalize_hist(meta(4096, 10), meta(4096, 10), meta(10), meta(64), 1,
                              tile_n=2048)
    h, top = ops.scd_fused_hist(meta(4096, 160), meta(4096, 160), meta(160), meta(160, 33),
                                6, tile_n=64)
    assert h.shape == (160, 34) and top.shape == (160,)


def test_sanitize_drops_a_split_that_does_not_divide():
    assert M.sanitize(0, (6, 4), 4) is None
    assert M.sanitize(1, (6, 4), 4) == 1
    assert M.sanitize(None, (8,), 2) is None


@pytest.mark.parametrize("reason,kw", [
    ("not split", dict(world=3)),                           # batch 4, 8 experts
    ("not ported", dict(world=2, rules=dict(sharding.BATCH_RULES, heads="model"))),
    ("2-D world", dict(world=2, rules=dict(sharding.BATCH_RULES, fsdp="model"))),
    ("not ported", dict(world=2, rules=dict(sharding.PRODUCTION_RULES, batch="model"),
                        kind="train")),
])
def test_refusals_are_skipped_with_the_reason(reason, kw):
    """Skipped with the reason: a batch or expert count that the world does
    not divide, "batch" and a name of ``TP_NAMES`` both on the world (a 2-D
    world, a prefill and a train cell), and "fsdp" on the world beside
    "experts" (a 2-D world too: FSDP binds the experts to an axis of size
    1, ``sharding.FSDP_RULES``)."""
    arch, kw = "moonshot-v1-16b-a3b", dict(kw)
    cfg = registry.get(arch).smoke().replace(fsdp_mode=kw.pop("fsdp_mode", "full"))
    rec = D.account_cell(arch, cell(kw.pop("kind", "prefill"), b=4), cfg=cfg, **kw)
    assert rec["status"] == "skipped" and reason in rec["reason"], rec
    if reason != "not split":
        assert "ROADMAP A10 item 5, second part" in rec["reason"]


@pytest.mark.parametrize("rules,mode", [
    ("fsdp", "full"), ("fsdp", "zero1"),
    (M.production_rules(True, "fsdp_only"), "fsdp_only"),
])
def test_fsdp_layouts_are_accounted(rules, mode):
    """A train cell under FSDP (the rules the reference's (D, 1) mesh maps
    to, its "zero1" layout, and ``production_rules(True, "fsdp_only")``
    with a config laid out by it, which were skipped as unported) is
    accounted: a rank of 2 holds about half the tree ("full", "fsdp_only")
    or of AdamW's moments ("zero1"), and sends the block gathers and the
    gradients' reduce-scatters."""
    arch = "moonshot-v1-16b-a3b"
    cfg = registry.get(arch).smoke().replace(fsdp_mode=mode)
    rules = sharding.rules_for(rules, mode) if isinstance(rules, str) else rules
    one = D.account_cell(arch, cell("train", b=4), 1, cfg=cfg)
    two = D.account_cell(arch, cell("train", b=4), 2, cfg=cfg, rules=rules)
    assert two["status"] == "ok", two.get("error")
    assert two["fsdp_mode"] == mode
    held = two["memory"]["opt"] if mode == "zero1" else two["memory"]["params"]
    assert held < 0.6 * (one["memory"]["opt"] if mode == "zero1" else one["memory"]["params"])
    for kind in ("all_gather", "gather"):
        assert two["collectives"]["bytes"][kind] > 0, kind
    assert two["flops_executed"] > 0 and two["memory"]["fits_80gb"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mamba2-370m", "seamless-m4t-medium"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_production_rules_skip_the_mixers_not_covered(arch, kind):
    """The MLA, Mamba2 and encoder-decoder archs' cells, which the production
    rules skipped with the refusal before those mixers were ported, are
    accounted: a rank of 2 holds less of the tree than one process and
    sends all-gathers and reduce-scatters (a real world of 2's bytes equal
    the account exactly: ``tests/test_torch_tp_mixers.py``)."""
    cfg = registry.get(arch).smoke()
    one = D.account_cell(arch, cell(kind, b=4), 1, cfg=cfg)
    rec = D.account_cell(arch, cell(kind, b=4), 2, cfg=cfg, rules=sharding.PRODUCTION_RULES)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["params"] < one["memory"]["params"]
    for name in ("all_gather", "reduce_scatter"):
        assert rec["collectives"]["bytes"][name] > 0, name


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "gemma-2b"])
def test_production_rules_account_train_cells(arch):
    """A train cell under the production rules (and under the rules of
    ``production_rules(True, "fsdp_only")`` with a config laid out as one
    process, ``fsdp_mode`` "full": the vocab and experts split, the heads
    and FFN columns whole) is accounted: a rank of 2 holds about half the
    tree and AdamW's moments of one process (less under the second), and
    sends all-gathers, reduce-scatters, the loss's maxima and the gradient
    folds."""
    cfg = registry.get(arch).smoke()
    one = D.account_cell(arch, cell("train", b=4), 1, cfg=cfg)
    for rules, share in ((sharding.PRODUCTION_RULES, 0.6),
                         (M.production_rules(True, "fsdp_only"), 0.95)):
        two = D.account_cell(arch, cell("train", b=4), 2, cfg=cfg, rules=rules)
        assert two["status"] == "ok", two.get("error")
        assert two["n_params_rank"] < share * one["n_params"]
        assert two["memory"]["opt"] < share * one["memory"]["opt"]
        for kind in ("all_gather", "reduce_scatter", "reduce", "gather"):
            assert two["collectives"]["bytes"][kind] > 0, kind
        assert two["flops_executed"] > 0 and two["memory"]["fits_80gb"]


@pytest.mark.parametrize("case", ["gather", "index", "sum"])
def test_live_bytes_counts_autograds_buffers_as_written_in_place(case):
    """Under a Python dispatch mode (the tracker is one) autograd writes its
    own buffers out of place: the backward of ``gather`` (``scatter_add``
    into fresh zeros) and of indexing (``index_put``), and the engine's sum
    of two gradients of one input (``add``). Without a mode, as on the
    card, it writes them in place; the tracker counts them so: a leaf of N
    floats gathered or indexed at one entry peaks at two leaves' bytes (the
    leaf and the zeros its gradient is scattered into), and ``(y * y)``
    with ``y = 2x`` at four (x, y and the two gradients of y, summed in
    place), not three and five."""
    n = 1 << 20
    x = torch.zeros(n, requires_grad=True)
    idx = torch.tensor([[3]])
    tracker = D.LiveBytes()
    tracker.hold(x)
    with tracker:
        if case == "gather":
            loss, leaves = torch.gather(x[None], 1, idx).sum(), 2
        elif case == "index":
            loss, leaves = x[idx[0]].sum(), 2
        else:
            y = x * 2.0
            loss, leaves = (y * y).sum(), 4
        loss.backward()
    got = tracker.peak / (4 * n)
    assert leaves <= got < leaves + 0.5, got


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_production_rules_split_every_rank_s_share(kind):
    """Under the production rules a rank of 2 holds about half the tree and
    half the caches of one process, every row, and sends all-gathers and
    reduce-scatters; the probe equals the whole run."""
    arch = "gemma-2b"
    cfg = registry.get(arch).smoke()
    one = D.account_cell(arch, cell(kind, b=4), 1, cfg=cfg)
    two = D.account_cell(arch, cell(kind, b=4), 2, cfg=cfg, rules=sharding.PRODUCTION_RULES)
    whole = D.account_cell(arch, cell(kind, b=4), 2, cfg=cfg, rules=sharding.PRODUCTION_RULES,
                           probe=False)
    assert two["status"] == "ok" and two["rules"] == "production"
    assert 0.5 < two["n_params_rank"] / one["n_params"] < 0.6
    assert two["memory"]["caches"] * 2 == one["memory"]["caches"]
    assert two["memory"]["batch"] == one["memory"]["batch"]
    assert {"all_gather", "reduce_scatter"} <= set(two["collectives"]["bytes"])
    for key in ("flops_executed", "collectives", "memory"):
        assert two[key] == whole[key], key


def test_long_cell_of_a_full_attention_arch_is_skipped():
    rec = D.account_cell("gemma-2b", "long_500k", 1)
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


def test_streamed_state_is_flat_in_n():
    table1 = D.WORKLOADS["table1"]
    a, b = (D.account_paper_kp(dataclasses.replace(table1, n_users=n), 1, streaming=True,
                               chunk_size=65536) for n in (10 ** 7, 10 ** 9))
    assert a["memory"]["state"] == b["memory"]["state"] > 0
    assert a["memory"]["resident"] == b["memory"]["resident"] == 0
    assert (a["chunks_per_rank"], b["chunks_per_rank"]) == (-(-10 ** 7 // 65536),
                                                            -(-10 ** 9 // 65536))
    per = b["per_iteration"]["kernels"]["scd_fused_hist"]["launches"]
    assert per == b["chunks"] == b["chunks_per_rank"]


@pytest.mark.parametrize("world", [1, 2, 8])
def test_resident_bytes_are_8_n_k_over_d(world):
    rec = D.account_paper_kp("table1", world)
    n, k = rec["n_users"], rec["k"]
    assert rec["memory"]["resident"] == 8 * n * k // world
    assert (rec["per_iteration"]["partials_bytes"] > 0) == (world > 1)


@pytest.mark.parametrize("host_fed,finalize", [(False, "fused"), (True, "fused"),
                                               (False, "legacy")])
def test_paper_kp_launches_equal_a_small_cpu_solve(host_fed, finalize, monkeypatch):
    """A pass's launches on meta times the chunks equal the kernel calls of
    a small CPU solve: iterations x chunks of the map, chunks (legacy: one
    histogram and two greedy passes a chunk) of the finalize."""
    n, k, chunk = 5 * 4096 + 100, 10, 4096
    cfg = SolverConfig(max_iters=3, stream_finalize=finalize)
    calls = _counting_ops(monkeypatch)
    if host_fed:
        res = solve_streaming_host(sparse_host_chunk_source(0, n, k, chunk, q=1), cfg,
                                   q=1, device="cpu")
    else:
        res = solve_streaming(sparse_chunk_source(0, n, k, chunk, q=1, device="cpu"), cfg,
                              q=1, device="cpu")
    monkeypatch.undo()
    wl = dataclasses.replace(D.WORKLOADS["table1"], n_users=n)
    rec = D.account_paper_kp(wl, 1, streaming=True, chunk_size=chunk,
                             stream_finalize=finalize, iters=res.iters)
    got = {name: v["launches"] for name, v in rec["kernels"].items()}
    assert got == {name: v for name, v in calls.items() if v}


def test_cli_cell_and_fsdp_refusal(tmp_path):
    out = tmp_path / "r.json"
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "rc = 0\n"
            "try:\n runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
            "except SystemExit as e:\n rc = e.code\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro'"
            " for m in sys.modules), 'jax imported'\n"
            "sys.exit(rc)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-c", code, "dryrun", "--arch", "mamba2-370m", "--shape",
            "decode_32k", "--no-probe", "--out", str(out)]
    p = subprocess.run(args, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    rec, = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["flops_executed"] > 0
    assert rec["memory"]["fits_80gb"]
    # FSDP ran refused before it was ported: now the cell is accounted
    fsdp = tmp_path / "f.json"
    assert D.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--world", "2",
                   "--rules", "fsdp", "--fsdp", "full", "--out", str(fsdp)]) == 0
    rec, = json.loads(fsdp.read_text())
    assert rec["status"] == "ok" and rec["rules"] == "fsdp" and rec["fsdp_mode"] == "full"
    assert rec["collectives"]["bytes"]["all_gather"] > 0


def test_cli_production_rules(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert D.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--world", "2",
                   "--rules", "production", "--layers", "2", "--out", str(out)]) == 0
    rec, = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["rules"] == "production"
    assert rec["collectives"]["bytes"]["reduce_scatter"] > 0
    capsys.readouterr()
    assert D.main(["--arch", "gemma-2b", "--shape", "train_4k", "--world", "2",
                   "--rules", "production", "--layers", "2", "--batch", "4"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["status"] == "ok" and rec["collectives"]["bytes"]["reduce_scatter"] > 0
    capsys.readouterr()
    assert D.main(["--arch", "mamba2-370m", "--shape", "train_4k", "--world", "2",
                   "--rules", "production", "--layers", "2", "--batch", "4"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["status"] == "ok" and rec["collectives"]["bytes"]["reduce_scatter"] > 0
