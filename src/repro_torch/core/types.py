"""Problem containers and the solver configuration, under the reference's
names.

* ``DenseKP`` — the general GKP: N users x M items, K global knapsacks,
  dense costs ``b[i, j, k]`` and laminar local constraints given as
  boolean index-set masks.
* ``SparseKP`` — the Section 5.1 sparse form: M == K, item j consumes only
  knapsack j (costs stored as the diagonal ``b[i, k]``), at most Q items
  per user.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class LaminarSets(NamedTuple):
    """Hierarchical local constraints (Definition 2.1).

    ``sets`` (L, M) bool, row l the index set S_l, in topological (leaf ->
    root) order; ``caps`` (L,) int, the C_l.
    """

    sets: torch.Tensor
    caps: torch.Tensor


class DenseKP(NamedTuple):
    """General GKP shard: ``p`` (n, M) profits, ``b`` (n, M, K) costs,
    ``budgets`` (K,), plus laminar local constraints ``sets`` (L, M) bool
    and ``caps`` (L,) int."""

    p: torch.Tensor
    b: torch.Tensor
    budgets: torch.Tensor
    sets: torch.Tensor
    caps: torch.Tensor


class SparseKP(NamedTuple):
    """Section 5.1 sparse GKP shard: item j consumes only knapsack j.

    ``p`` (n, K) profits, ``b`` (n, K) diagonal costs, ``budgets`` (K,).
    The local constraint (at most Q items per user) travels separately.
    """

    p: torch.Tensor
    b: torch.Tensor
    budgets: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration, read by the resident ``solver.solve``
    and the host-fed ``prefetch.solve_streaming_host``.

    There is no ``use_kernels`` switch: the device of the tensors picks
    the implementation. On a CUDA tensor every map step launches the
    hand-written kernels of ``kernels/csrc/``; on a CPU tensor it runs
    their plain PyTorch versions (``kernels/ref.py``), which have the same
    tile structure and addition order.

    The checks that only the streaming drivers make live in
    ``chunked._validate_stream_cfg``, as in the reference.
    """

    algo: str = "scd"
    # §4.3.2: sync CD updates every lam_k from one map pass; cyclic CD
    # sweeps the coordinates one at a time (K passes per iteration).
    cd_mode: str = "sync"
    reduce: str = "bucketed"
    max_iters: int = 32
    tol: float = 1e-3
    # Reversal damping of the SCD step (see solver.damped_multiplier_step).
    cd_damping: float = 0.5
    # Resident solve: stream the per-iteration map over user chunks of
    # this size (None: the whole shard at once). See core/solver.py.
    chunk_size: Optional[int] = None
    # User-axis tile of the kernels; when set it pins every kernel's tile
    # (None: kernels.ops.MAP_TILE for the histogram map, kernels.ops.pick_tile
    # for the finalize). Chunked and unchunked accumulations are bitwise
    # equal when both run the same tile decomposition (chunk rows a multiple
    # of the tile).
    kernel_tile: Optional[int] = None
    # DD (Alg 2) learning rate.
    dd_lr: float = 1e-3
    # §5.2 bucket ladder: edges at lam_t +/- delta * growth**i, i < half.
    bucket_half: int = 24
    bucket_delta: float = 1e-4
    bucket_growth: float = 1.6
    # §5.3 presolve on the first presolve_samples users (0 disables).
    presolve_samples: int = 0
    # Straggler mitigation over a mesh (or virtual slots): proceed with the
    # first partial_fraction of the shards, their map results scaled by
    # 1 / fraction (1.0: every shard).
    partial_fraction: float = 1.0
    # Resident solve: record (lam, primal, dual, gap, max_violation) after
    # every iteration, over a fixed max_iters loop with converged
    # iterations frozen.
    record_history: bool = False
    # §5.4 fixed geometric group-profit ladder of the fused finalize.
    profit_buckets: int = 512
    profit_ladder_lo: float = 1e-6
    profit_ladder_hi: float = 1e6
    postprocess: bool = True
    # Streaming finalize: "fused" (one pass, fixed geometric ladder) or
    # "legacy" (metrics, removable histogram against the (lo, hi) ladder,
    # apply: three passes).
    stream_finalize: str = "fused"
    # Host-fed solve: safe lambda-interval active-set screening
    # (core/screening.py), bitwise the unscreened solve; each epoch
    # certifies multipliers down to lam * screening_floor, and an escape
    # below the floor reactivates every chunk.
    screening: bool = False
    screening_floor: float = 0.5
    # Host-fed solve: write the constant-size resume state every this-many
    # iterations, and every this-many chunk columns of the fused finalize,
    # into the call's checkpoint directory (0 disables); keep the newest
    # checkpoint_keep states (>= 1).
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    # Host-fed solve, fault layer (core/faults.py): retry a failed chunk
    # fetch up to fetch_retries times under a capped exponential backoff
    # with deterministic jitter, bound each fetch by fetch_timeout seconds
    # (0: unbounded), and with verify_refetch read every chunk twice and
    # require equal bytes. Retries re-run only the fetch, so the solve
    # keeps its bits.
    fetch_retries: int = 0
    fetch_backoff: float = 0.05
    fetch_backoff_growth: float = 2.0
    fetch_backoff_cap: float = 2.0
    fetch_jitter: float = 0.25
    fetch_timeout: float = 0.0
    verify_refetch: bool = False
    # Streaming solves with record_history: one metrics pass every this
    # many iterations (0: no sampling, so record_history is refused there).
    metrics_every: int = 0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        checks = [
            (self.algo in ("scd", "dd"),
             f"algo must be 'scd' or 'dd', got {self.algo!r}"),
            (self.cd_mode in ("sync", "cyclic"),
             f"cd_mode must be 'sync' or 'cyclic', got {self.cd_mode!r}"),
            (self.reduce in ("bucketed", "exact"),
             f"reduce must be 'bucketed' or 'exact', got {self.reduce!r}"),
            (self.dtype == torch.float32,
             f"dtype must be torch.float32, got {self.dtype}"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    def replace(self, **kw) -> "SolverConfig":
        """Functional update: a copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)


def disjoint_partition_sets(group_sizes, caps, m=None):
    """LaminarSets for disjoint groups of consecutive items."""
    total = int(sum(group_sizes))
    m = total if m is None else m
    rows, start = [], 0
    for g in group_sizes:
        row = torch.zeros((m,), dtype=torch.bool)
        row[start:start + g] = True
        rows.append(row)
        start += g
    return LaminarSets(torch.stack(rows), torch.tensor(caps, dtype=torch.int32))


def cardinality_set(m, cap):
    """Single local constraint: choose at most ``cap`` of the m items."""
    return LaminarSets(torch.ones((1, m), dtype=torch.bool),
                       torch.tensor([cap], dtype=torch.int32))


def hierarchy_from_lists(index_lists, caps, m):
    """LaminarSets from explicit index lists, topologically sorted.

    Raises ValueError if the family is not laminar (Definition 2.1).
    """
    sets = [frozenset(s) for s in index_lists]
    for a in sets:
        for b in sets:
            if (a & b) and not (a <= b or b <= a):
                raise ValueError("local constraint family is not laminar")
    order = sorted(range(len(sets)), key=lambda i: len(sets[i]))
    rows = torch.zeros((len(sets), m), dtype=torch.bool)
    for r, i in enumerate(order):
        rows[r, sorted(sets[i])] = True
    return LaminarSets(rows, torch.tensor([caps[i] for i in order],
                                          dtype=torch.int32))
