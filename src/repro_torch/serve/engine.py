"""Generation-based refresh engine: the solver as a daily-called service.

The reference's ``serve/engine.py`` under the same names, over the port's
host-fed driver: on one device (``device=``), or over a world of ranks
(``mesh=``, a ``core.mesh.Mesh``) where the reference takes a mesh of
devices. The on-disk layout and the two publication steps are the
reference's.

Over a world every rank constructs the engine and makes the same calls.
Each refresh is one ``solve_streaming_host(mesh=...)``, and the bits
depend on ``slots``, never on the world's size: a world of D at
``slots=S`` publishes the record of the one-process ``slots=S`` engine.
Rank 0 alone writes (``spec.json``, the record, the ``LIVE.json`` flip,
``prune`` and the discard of a pending generation; the solve's
checkpoints too), between barriers: every rank reads the root's state
after a barrier and before rank 0 writes, and no rank returns from a
refresh before its record is live. The one exception is ``FAILED.json``:
the rank whose fetch exhausted its retries writes it.

The paper's deployment claim (§6) is not a single solve — "the system
has been deployed to production and called on a daily basis": budgets
and traffic shift between calls, and each day's solve starts from
yesterday's prices rather than cold. This module strings the repo's
existing ingredients (host-fed streaming over virtual slots, ``lam0`` warm starts,
checkpoint/resume) into that production shape.

A **generation** is one immutable published solve of one immutable
workload. The :class:`RefreshEngine` owns a root directory of them:

    <root>/LIVE.json                     atomic live-generation pointer
    <root>/gen_000007/
        spec.json                        the workload + refresh intent
                                         (written BEFORE solving — the
                                         durable record a resumed
                                         process replays from)
        ckpt/                            solver resume states
                                         (core/prefetch.py protocol)
        record/step_00000000/            the published Generation payload

``refresh(**deltas)`` derives the next workload spec from the live one
(budget scaling, traffic/seed churn, chunk-count growth — any
:class:`WorkloadSpec` field), re-solves it with
:func:`repro_torch.core.prefetch.solve_streaming_host` **warm-started from
the live generation's multipliers**, and publishes a constant-size
:class:`Generation` record (lam, tau, finalize histograms, solver
fingerprint — never the O(n) decisions). Publication is two atomic
steps: the record is a ``ckpt.save`` (rename-published), and the LIVE
pointer is a ``ckpt.write_json`` flip — a reader holding the pointer
therefore never observes a half-published solve; it sees the previous
generation until the instant the new one is complete on disk.

Preemption safety falls out of the solver's own resume protocol: the refresh checkpoints into the generation's ``ckpt/``
directory, and because ``spec.json`` records the workload and warm
start *before* the solve begins, a killed refresh is re-entrant —
calling ``refresh`` again (or :meth:`RefreshEngine.recover`) resumes
the pending generation mid-solve and publishes a record bitwise
identical to the uninterrupted one (the solver's fingerprint check
refuses a drifted spec or warm start). A crash *between* the record
save and the pointer flip is likewise recovered: the completed record
is found and only the flip is replayed.

Lookups against the live generation never materialise O(n) state — see
:class:`repro_torch.serve.decisions.DecisionService`.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
import shutil
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint import ckpt
from ..core.faults import ChunkFetchError, policy_from_cfg
from ..core.mesh import check_mesh
from ..obs import null_obs
from ..core.prefetch import (
    HostChunkSource,
    chunk_hashes,
    solve_streaming_host,
    source_fingerprint,
)
from ..core.types import SolverConfig

__all__ = ["WorkloadSpec", "Generation", "RefreshEngine",
           "synthetic_source", "synthetic_chunk_diff",
           "content_chunk_diff"]

_POINTER = "LIVE.json"
_FAILED = "FAILED.json"
_RECORD_STEP = 0
_GEN_RE = re.compile(r"gen_(\d+)")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One generation's workload identity (JSON-serialisable, hashable).

    The engine is generic over what these fields *mean*: its
    ``make_source`` callback turns a spec into the
    :class:`~repro_torch.core.prefetch.HostChunkSource` to solve. The default
    (:func:`synthetic_source`) reads them as the §6 synthetic workload;
    the marketing example reads ``budget_scale``/``seed`` against its
    own fixed user base. Refresh deltas are just field replacements:
    ``budget_scale`` models the paper's daily budget shifts, ``seed``
    traffic churn (a different user population), ``n`` traffic growth
    (more chunks), all three composable.
    """

    seed: int
    n: int
    k: int
    chunk: int
    q: int = 1
    tightness: float = 0.5
    budget_scale: float = 1.0
    # Ratio-banded workload knob (data.synth.banded_host_chunk_source):
    # 0 keeps the uniform §6 generator; > 0 draws cold cohorts' profits
    # from [0, band) — the structure active-set screening retires.
    band: float = 0.0

    def replace(self, **kw) -> "WorkloadSpec":
        """A copy with the given fields replaced (the refresh delta)."""
        return dataclasses.replace(self, **kw)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "WorkloadSpec":
        return cls(**d)


def synthetic_source(spec: WorkloadSpec) -> HostChunkSource:
    """Default workload factory: the §6 sparse instance, budget-scaled.

    ``data.synth.sparse_host_chunk_source`` keyed on ``(seed, chunk
    index)`` — restart-deterministic as checkpoint/resume requires —
    with the generator's tightness-scaled budgets multiplied by
    ``spec.budget_scale`` (the daily-refresh knob). The scale is applied
    as a single f32 multiply so the same spec always produces the same
    budget bytes (the solver fingerprint hashes them).
    """
    from ..data.synth import banded_host_chunk_source, sparse_host_chunk_source

    if spec.band > 0:
        src = banded_host_chunk_source(spec.seed, spec.n, spec.k, spec.chunk,
                                       q=spec.q, tightness=spec.tightness,
                                       band=spec.band)
    else:
        src = sparse_host_chunk_source(spec.seed, spec.n, spec.k, spec.chunk,
                                       q=spec.q, tightness=spec.tightness)
    budgets = (src.budgets * np.float32(spec.budget_scale)).astype(np.float32)
    return src._replace(budgets=budgets)


def synthetic_chunk_diff(old: WorkloadSpec, new: WorkloadSpec):
    """Which chunks' *bytes* differ between two synthetic specs.

    The delta-refresh contract: returns a (c_new,) bool
    mask — True where chunk i of the new workload is NOT byte-identical
    to chunk i of the old one — or None when nothing can be inherited
    (every chunk changed). For the ``data.synth`` generators a chunk is
    a pure function of ``(seed, i, chunk, k, band)`` plus the row-live
    mask from ``n``:

    * ``seed``/``k``/``chunk``/``band`` differ -> None (new instance);
    * ``n`` differs -> chunk i unchanged iff fully live under *both*
      (``(i+1)*chunk <= min(n_old, n_new)``) — the ragged frontier and
      everything past it is conservatively marked changed;
    * ``q``/``tightness``/``budget_scale`` touch only the budgets, never
      the chunk bytes -> zero changed chunks.
    """
    if (old.seed, old.k, old.chunk, old.band) != \
            (new.seed, new.k, new.chunk, new.band):
        return None
    c_new = -(-new.n // new.chunk)
    if old.n == new.n:
        return np.zeros((c_new,), bool)
    idx = np.arange(c_new)
    return ~((idx + 1) * new.chunk <= min(old.n, new.n))


def content_chunk_diff(make_source):
    """A ``chunk_diff`` for *real* (non-generator) sources, by content.

    The synthetic diff above reasons about generator parameters; a
    file-backed workload (``memmap_source`` over yesterday's and today's
    extracts) has no closed form — but it has bytes. The returned
    callable hashes every chunk of both specs' sources
    (:func:`repro_torch.core.prefetch.chunk_hashes`, sha256 over the exact
    f32 payload) and marks chunk i changed iff its digests differ;
    chunks past the old source's end are changed by definition. Layout
    changes (``k``/``chunk``) return None — nothing is inheritable when
    chunk boundaries moved. The two full hashing scans are sequential
    O(n·K) *reads* (no solve, no device work): worth it exactly when the
    day-over-day delta is sparse, which is the delta-refresh premise.

        engine = RefreshEngine(root, spec, make_source=my_memmap_factory,
                               chunk_diff=content_chunk_diff(my_memmap_factory))
    """
    def diff(old: WorkloadSpec, new: WorkloadSpec):
        if (old.k, old.chunk) != (new.k, new.chunk):
            return None
        old_h = chunk_hashes(make_source(old))
        new_h = chunk_hashes(make_source(new))
        m = min(len(old_h), len(new_h))
        changed = np.ones((len(new_h),), bool)
        changed[:m] = ~(old_h[:m] == new_h[:m]).all(axis=1)
        return changed

    return diff


class Generation(NamedTuple):
    """One published solve: everything lookups need, nothing O(n).

    ``lam``/``tau`` are the multipliers and §5.4 removal threshold that
    define the primal decisions (regenerate any row with
    ``chunked.decisions_rows``); ``fin_hist`` the fused-finalize
    removable histograms (None when ``cfg.postprocess`` was off);
    ``fingerprint`` the solver's resume-state identity hash of
    (source, cfg, q, lam0) — the proof of *which* solve this record
    publishes. ``warm`` records whether the refresh started from the
    parent's multipliers.
    """

    gen: int
    spec: WorkloadSpec
    lam: np.ndarray        # (K,)
    tau: np.ndarray        # ()
    iters: int
    r: np.ndarray          # (K,) post-projection consumption
    primal: np.ndarray     # ()
    dual: np.ndarray       # ()
    fin_hist: Optional[tuple]   # (cons_hist (K, E+1), gain_hist (E+1,))
    fingerprint: np.ndarray     # (8,) uint8
    warm: bool
    path: str              # this generation's directory


class RefreshEngine:
    """Immutable-generation refresh driver over one root directory.

    ``make_source`` maps a :class:`WorkloadSpec` to the
    :class:`~repro_torch.core.prefetch.HostChunkSource` to solve (default:
    the §6 synthetic workload). ``cfg``/``device``/``mesh``/``slots`` are
    passed straight to :func:`~repro_torch.core.prefetch.solve_streaming_host`
    (the card unless ``device="cpu"``; a ``mesh``, on every rank of its
    world, replaces ``device`` with ``mesh.device`` and sets ``slots`` to
    its size by default; anything but a ``core.mesh.Mesh`` raises
    ``TypeError``); give
    ``cfg.checkpoint_every`` a value to make in-flight refreshes
    preemption-safe (the engine supplies the per-generation checkpoint
    directory either way). Engines are cheap handles: any number of
    processes may *read* (``live()``, ``generation()``) concurrently
    with one writer running ``refresh``.
    """

    def __init__(self, root, base_spec: WorkloadSpec,
                 make_source: Callable[[WorkloadSpec],
                                       HostChunkSource] = synthetic_source,
                 cfg: SolverConfig = SolverConfig(), mesh=None,
                 slots: Optional[int] = None, keep: Optional[int] = None,
                 chunk_diff: Optional[Callable] = None, obs=None,
                 device="cuda"):
        self.mesh = check_mesh(mesh)
        self.root = pathlib.Path(root)
        self.base_spec = base_spec
        self.make_source = make_source
        self.cfg = cfg
        self.device = mesh.device if mesh is not None else device
        self.slots = slots
        # Over a world, rank 0 is the one writer of the root.
        self.writer = mesh is None or mesh.rank == 0
        # Observability bundle (repro_torch.obs.Obs). Default: the shared
        # no-op. The tracer threads into the solver (refresh spans ride
        # next to solve.iterate/finalize in one journal) and into every
        # DecisionService this engine hands out. Never part of the spec
        # or the solver fingerprint — a traced refresh publishes the
        # bitwise-identical record.
        self.obs = null_obs() if obs is None else obs
        # Delta-refresh hook: (parent_spec, new_spec) -> changed-chunk
        # mask (None = everything changed). Only meaningful with
        # cfg.screening; defaults to the synthetic generators' diff when
        # the engine also uses the synthetic source factory — a custom
        # make_source must bring its own diff (or refresh solves cold).
        if chunk_diff is None and make_source is synthetic_source:
            chunk_diff = synthetic_chunk_diff
        self.chunk_diff = chunk_diff
        # Generation retention (the serving mirror of cfg.checkpoint_keep):
        # every successful refresh sweeps all but the newest `keep`
        # generations — never the live or pending one. None disables the
        # automatic sweep; prune() can still be called explicitly.
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1 (got {keep}): retaining "
                             "zero generations would delete the live one")
        self.keep = keep

    @classmethod
    def attach(cls, root, timeout: float = 0.0, poll_s: float = 0.05,
               **kw) -> "RefreshEngine":
        """An engine over an *existing* root, spec taken from the live
        generation.

        The replica-process entry point (``launch/front.py --replica``
        over :class:`~repro_torch.serve.front.ReplicaServer`): a
        serving replica knows only the generation root it shares with
        the refresh writer, not the workload that seeded it — the live
        generation's spec IS the base spec. Waits up to ``timeout``
        seconds for a first generation to be published (a replica may
        boot while gen 0 is still solving), then raises the usual "run
        refresh() first" error. ``kw`` forwards to the constructor
        (``make_source``, ``cfg``, ``keep``...).
        """
        import time

        probe = cls(root, base_spec=None, **kw)
        deadline = time.monotonic() + timeout
        while True:
            live = probe.live()
            if live is not None:
                probe.base_spec = live.spec
                return probe
            if time.monotonic() >= deadline:
                raise ValueError(
                    f"no live generation under {root} to attach to — "
                    "run refresh() there first (or raise the attach "
                    "timeout past the first publication)")
            time.sleep(poll_s)

    def _sync(self):
        """A barrier of the world (nothing on one process)."""
        if self.mesh is not None:
            self.mesh.barrier()

    # -- directory layout ---------------------------------------------------

    def _gen_dir(self, gen_id: int) -> pathlib.Path:
        return self.root / f"gen_{gen_id:06d}"

    def live_gen_id(self) -> Optional[int]:
        """The published pointer, or None before the first generation."""
        ptr = ckpt.read_json(self.root, _POINTER)
        return None if ptr is None else int(ptr["gen"])

    def live(self) -> Optional[Generation]:
        """The live generation record (constant-size read), or None."""
        gen_id = self.live_gen_id()
        return None if gen_id is None else self.generation(gen_id)

    def generation(self, gen_id: int) -> Generation:
        """Load one published generation's record by id."""
        gdir = self._gen_dir(gen_id)
        meta = ckpt.read_json(gdir, "spec.json")
        if meta is None:
            raise ValueError(
                f"generation {gen_id} has no spec.json under {gdir} — it "
                "was never started in this root")
        state = ckpt.restore_auto(gdir / "record", _RECORD_STEP)
        fin_hist = None
        if "fin_ch" in state:
            fin_hist = (np.asarray(state["fin_ch"]),
                        np.asarray(state["fin_gh"]))
        return Generation(
            gen=gen_id,
            spec=WorkloadSpec.from_json(meta["spec"]),
            lam=np.asarray(state["lam"]),
            tau=np.asarray(state["tau"]),
            iters=int(np.asarray(state["iters"])),
            r=np.asarray(state["r"]),
            primal=np.asarray(state["primal"]),
            dual=np.asarray(state["dual"]),
            fin_hist=fin_hist,
            fingerprint=np.asarray(state["fingerprint"]),
            warm=bool(np.asarray(state["warm"])),
            path=str(gdir),
        )

    def _pending(self):
        """(gen_id, meta) of a started-but-unpublished generation, or None.

        A generation is pending when its ``spec.json`` exists but the
        LIVE pointer has not reached it. At most one can exist: refresh
        always works on ``live + 1``.
        """
        nxt = (self.live_gen_id() + 1) if self.live_gen_id() is not None \
            else 0
        meta = ckpt.read_json(self._gen_dir(nxt), "spec.json")
        return None if meta is None else (nxt, meta)

    # -- the refresh itself -------------------------------------------------

    def refresh(self, *, warm: bool = True, **deltas) -> Generation:
        """Solve the next generation and atomically publish it.

        ``deltas`` are :class:`WorkloadSpec` field replacements against
        the live generation's spec (the first refresh starts from
        ``base_spec``); ``warm`` starts the solve from the live
        multipliers (the production default — the whole point of the
        daily-call shape) instead of the all-ones cold start.

        Re-entrant under preemption: if a previous call was killed
        mid-solve, the next call with the *same* requested spec resumes
        it from the generation's checkpoint directory and publishes the
        bitwise-identical record; a different spec raises (finish or
        discard the pending generation first — two concurrent intents
        for the same generation id cannot both be honoured).
        """
        self._sync()
        live = self.live()
        spec = (live.spec if live is not None else self.base_spec).replace(
            **deltas)
        gen_id = live.gen + 1 if live is not None else 0
        warm = bool(warm and live is not None)   # effective: gen 0 is cold
        pending = self._pending()
        self._sync()             # every rank has read before rank 0 writes
        if pending is not None:
            pend_id, meta = pending
            pend_spec = WorkloadSpec.from_json(meta["spec"])
            if pend_spec != spec or bool(meta["warm"]) != warm:
                raise ValueError(
                    f"generation {pend_id} is already pending with spec "
                    f"{pend_spec} (warm={meta['warm']}) but this refresh "
                    f"asked for {spec} (warm={warm}); resume the pending "
                    "refresh by repeating its deltas (or recover()), or "
                    f"delete {self._gen_dir(pend_id)} to discard it")
            return self._run(pend_id, pend_spec, bool(meta["warm"]), live)
        return self._run(gen_id, spec, warm, live)

    def recover(self) -> Optional[Generation]:
        """Finish a preempted refresh, if any; None when nothing pends.

        Replays the pending generation from its durable intent record:
        resumes the solve from its checkpoints (or, when the crash fell
        between the record save and the pointer flip, just flips the
        pointer). The published record is bitwise the one the killed
        process would have produced.
        """
        self._sync()
        pending = self._pending()
        parent = self.live()
        self._sync()
        if pending is None:
            return None
        gen_id, meta = pending
        spec = WorkloadSpec.from_json(meta["spec"])
        return self._run(gen_id, spec, bool(meta["warm"]), parent)

    def _parent_screen(self, parent: Generation) -> Optional[dict]:
        """The parent generation's screening artifacts, or None when the
        parent was solved unscreened (or predates screening)."""
        state = ckpt.restore_auto(pathlib.Path(parent.path) / "record",
                                  _RECORD_STEP)
        if "screen_active" not in state:
            return None
        return {"active": np.asarray(state["screen_active"]).astype(bool),
                "bmax": np.asarray(state["screen_bmax"], np.float32),
                "lam_lo": np.asarray(state["screen_lam_lo"], np.float32)}

    def _run(self, gen_id: int, spec: WorkloadSpec, warm: bool,
             parent: Optional[Generation]) -> Generation:
        gdir = self._gen_dir(gen_id)
        ckdir = gdir / "ckpt"
        record_done = ckpt.latest_step(gdir / "record") is not None
        source, lam0 = None, None
        if not record_done:
            # Validate the refresh and construct its source BEFORE the
            # intent becomes durable: an invalid call (bad deltas, a
            # make_source that rejects the spec) must fail with nothing
            # pending on disk, or it would wedge every later refresh
            # behind a pending generation that can never complete.
            if warm and parent is not None:
                if parent.spec.k != spec.k:
                    raise ValueError(
                        f"cannot warm-start across a knapsack-count "
                        f"change (K {parent.spec.k} -> {spec.k}); pass "
                        "warm=False")
                lam0 = torch.as_tensor(np.asarray(parent.lam), dtype=self.cfg.dtype)
            source = self.make_source(spec)
        # Durable intent, written before any solve work: the record a
        # killed refresh is replayed from. Idempotent on resume.
        if self.writer:
            ckpt.write_json(gdir, "spec.json", {
                "gen": gen_id,
                "spec": spec.to_json(),
                "warm": bool(warm and parent is not None),
                "parent": None if parent is None else parent.gen,
            })

        if not record_done:
            # Delta refresh: seed the new solve's active set from the
            # parent generation's published screening certificates —
            # unchanged chunks start retired (never re-streamed unless
            # the trajectory demands a fallback pass), changed chunks
            # start active with unknown bounds. Recomputed identically
            # on every re-entry (the parent record is immutable), so a
            # resumed refresh still publishes the bitwise record.
            screen_init = None
            if (self.cfg.screening and parent is not None
                    and self.chunk_diff is not None):
                seed_state = self._parent_screen(parent)
                changed = self.chunk_diff(parent.spec, spec)
                if seed_state is not None and changed is not None:
                    seed_state["changed"] = np.asarray(changed, bool)
                    screen_init = seed_state
            try:
                res = solve_streaming_host(
                    source, self.cfg, q=spec.q, lam0=lam0, device=self.device,
                    mesh=self.mesh, slots=self.slots,
                    checkpoint_dir=str(ckdir), resume_from=str(ckdir),
                    screen_init=screen_init, tracer=self.obs.tracer)
            except ChunkFetchError as e:
                # Failure containment: the solve exhausted its retry
                # budget. LIVE.json is untouched (readers keep serving
                # the previous generation); the pending directory is
                # stamped with the failure so operators — and recover()
                # — can see what died and re-drive or discard it. Over a
                # world the stamp is written by the rank that raised
                # (the owner of the chunk): the other ranks see their
                # collective fail, not this error, and write nothing.
                ckpt.write_json(gdir, _FAILED, {
                    "gen": gen_id,
                    "error": str(e),
                    "chunk": e.chunk,
                    "attempts": len(e.history),
                    "history": [[a, err, slept]
                                for a, err, slept in e.history],
                })
                raise
        if not record_done and self.writer:
            record = {
                "iters": np.int32(res.iters),
                "warm": np.int32(lam0 is not None),
                "lam": res.lam.numpy(),
                "tau": res.tau.numpy(),
                "r": res.r.numpy(),
                "primal": res.primal.numpy(),
                "dual": res.dual.numpy(),
                "fingerprint": source_fingerprint(
                    source, self.cfg, spec.q,
                    None if lam0 is None else lam0.numpy()),
            }
            if res.fin_hist is not None:
                record["fin_ch"] = res.fin_hist[0].numpy()
                record["fin_gh"] = res.fin_hist[1].numpy()
            if res.screen is not None:
                # The screening artifacts the NEXT generation's delta
                # refresh inherits (bool stored as uint8 for the
                # checkpoint codec), plus the streamed-chunk counts for
                # observability/benchmarks.
                record["screen_active"] = np.asarray(
                    res.screen["active"], np.uint8)
                record["screen_bmax"] = np.asarray(res.screen["bmax"])
                record["screen_lam_lo"] = np.asarray(res.screen["lam_lo"])
                record["screen_streamed"] = np.asarray(
                    res.screen["streamed_chunks"], np.int64)
            # Publication step 1: the record lands atomically...
            tracer = self.obs.tracer
            if tracer.enabled:
                with tracer.span("refresh.publish", gen=gen_id,
                                 step="record"):
                    ckpt.save(gdir / "record", _RECORD_STEP, record)
            else:
                ckpt.save(gdir / "record", _RECORD_STEP, record)
        if self.writer:
            self._publish(gdir, gen_id)
        self._sync()             # no rank returns before the flip
        return self.generation(gen_id)

    def _publish(self, gdir: pathlib.Path, gen_id: int):
        """The writer's end of a refresh whose record is saved: clear a
        failure stamp, flip the pointer, sweep old generations."""
        # A re-driven refresh that succeeded clears any failure stamp a
        # previous attempt left: the generation is healthy now.
        failed = gdir / _FAILED
        if failed.exists():
            failed.unlink()
        # ...step 2: the pointer flip makes it live. A crash between the
        # two leaves a complete record that recover()/refresh() re-flips.
        tracer = self.obs.tracer
        if tracer.enabled:
            with tracer.span("refresh.publish", gen=gen_id, step="pointer"):
                ckpt.write_json(self.root, _POINTER, {"gen": gen_id})
        else:
            ckpt.write_json(self.root, _POINTER, {"gen": gen_id})
        if self.keep is not None:
            self._remove(self._prunable(self.keep))

    # -- failure surface + generation GC ------------------------------------

    def failed(self) -> Optional[dict]:
        """The pending generation's failure stamp, or None.

        A refresh whose solve exhausted its retry budget leaves the
        LIVE pointer untouched and writes ``FAILED.json`` (error, chunk,
        attempt counters) into the pending directory; this surfaces it.
        ``recover()`` / ``refresh()`` with the same deltas re-drive the
        generation (transient outages heal), clearing the stamp on
        success; ``discard_pending()`` throws the intent away instead.
        """
        pending = self._pending()
        if pending is None:
            return None
        return ckpt.read_json(self._gen_dir(pending[0]), _FAILED)

    def discard_pending(self) -> Optional[int]:
        """Delete a pending (unpublished) generation; returns its id.

        The explicit give-up path for a pending refresh that can never
        complete (e.g. its source is permanently gone): removes the
        intent, checkpoints and failure stamp so the next refresh can
        claim the generation id afresh. Published generations are never
        touched. None when nothing pends. Over a world every rank returns
        the same id, and rank 0 deletes.
        """
        self._sync()
        pending = self._pending()
        self._sync()
        if pending is None:
            return None
        gen_id = pending[0]
        if self.writer:
            shutil.rmtree(self._gen_dir(gen_id))
        self._sync()
        return gen_id

    def generation_ids(self) -> list:
        """Ids of every generation directory under the root, sorted."""
        if not self.root.exists():
            return []
        return sorted(int(m.group(1)) for p in self.root.iterdir()
                      if (m := _GEN_RE.fullmatch(p.name)))

    def prune(self, keep: Optional[int] = None) -> list:
        """Delete all but the newest ``keep`` generations; returns the ids
        removed.

        The serving twin of ``ckpt.prune`` (``cfg.checkpoint_keep``):
        bounds the root's disk footprint under daily refresh churn. The
        **live** generation and a **pending** one (live + 1 with a
        durable intent) are never deleted, whatever ``keep`` says — the
        pointer must always resolve and an in-flight refresh must keep
        its resume states. Readers of *older* generations race this
        sweep by design; they must treat a vanished generation as "the
        pointer moved on" and re-resolve (DecisionService lookups are
        unaffected — they hold the record in memory). Over a world every
        rank returns the same ids, and rank 0 deletes.
        """
        keep = self.keep if keep is None else keep
        if keep is None or keep < 1:
            raise ValueError(f"prune needs keep >= 1, got {keep}")
        self._sync()
        removed = self._prunable(keep)
        self._sync()
        if self.writer:
            self._remove(removed)
        self._sync()
        return removed

    def _prunable(self, keep: int) -> list:
        """The generation ids a sweep to ``keep`` would delete."""
        gens = self.generation_ids()
        live = self.live_gen_id()
        protected = set()
        if live is not None:
            protected.add(live)
        pending = self._pending()
        if pending is not None:
            protected.add(pending[0])
        survivors = set(gens[-keep:]) | protected
        return [g for g in gens if g not in survivors]

    def _remove(self, gen_ids):
        for g in gen_ids:
            shutil.rmtree(self._gen_dir(g))

    # -- lookups ------------------------------------------------------------

    def decision_service(self, generation: Optional[Generation] = None,
                         cache_chunks: int = 16, fallback: bool = True):
        """A DecisionService over ``generation`` (default: the live one).

        The service inherits the engine cfg's fetch fault policy (its
        chunk regenerations retry like the solver's ingest does), and —
        with ``fallback`` (default) — is armed with the previous
        published generation for degraded serving: a lookup whose chunk
        regeneration exhausts its retries answers from the previous
        generation with an explicit ``stale=True`` flag instead of
        failing the query. No previous generation (gen 0, or pruned):
        no fallback.

        The service's :meth:`~repro_torch.serve.decisions.DecisionService.
        health` also reports this root's supervision status: a supervisor
        (:class:`~repro_torch.launch.supervisor.Supervisor`) publishes
        ``SUPERVISOR.json`` into the same root, and the service surfaces it.
        Its chunk fills run on the engine's device.
        """
        from .decisions import DecisionService

        gen = self.live() if generation is None else generation
        if gen is None:
            raise ValueError("no live generation to serve lookups from — "
                             "run refresh() first")
        fb = None
        if fallback and gen.gen > 0:
            try:
                prev = self.generation(gen.gen - 1)
                fb = (self.make_source(prev.spec), prev)
            except (ValueError, OSError):
                fb = None               # pruned or damaged: degrade without
        return DecisionService(self.make_source(gen.spec), gen,
                               cache_chunks=cache_chunks,
                               fault_policy=policy_from_cfg(self.cfg),
                               verify=self.cfg.verify_refetch,
                               fallback=fb, supervisor_root=self.root,
                               tracer=self.obs.tracer, device=self.device)
