"""Solver configuration and instance container (the fields the host-fed
sync-SCD bucketed path reads, under the reference's names)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


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
    """Static configuration of the host-fed streaming solve.

    There is no ``use_kernels`` switch: the device of the tensors picks
    the implementation. On a CUDA tensor every per-chunk step launches the
    hand-written kernels of ``kernels/csrc/``; on a CPU tensor it runs
    their plain PyTorch versions (``kernels/ref.py``), which have the same
    tile structure and addition order. The plain versions serve the CPU
    tests and the on-card comparison, and nothing on the card's main path.

    Options of the reference that this package does not carry yet raise
    ``NotImplementedError`` naming the ROADMAP item that ports them.
    """

    algo: str = "scd"
    cd_mode: str = "sync"
    reduce: str = "bucketed"
    max_iters: int = 32
    tol: float = 1e-3
    # Reversal damping of the sync-CD step (see solver.damped_multiplier_step).
    cd_damping: float = 0.5
    # User-axis tile of the kernels (None: kernels.ops.pick_tile). Chunked
    # and unchunked accumulations are bitwise equal when both run the
    # same tile decomposition (chunk size a multiple of the tile).
    kernel_tile: Optional[int] = None
    # §5.2 bucket ladder: edges at lam_t +/- delta * growth**i, i < half.
    bucket_half: int = 24
    bucket_delta: float = 1e-4
    bucket_growth: float = 1.6
    presolve_samples: int = 0
    # §5.4 fixed geometric group-profit ladder of the fused finalize.
    profit_buckets: int = 512
    profit_ladder_lo: float = 1e-6
    profit_ladder_hi: float = 1e6
    postprocess: bool = True
    stream_finalize: str = "fused"
    # Reference options not ported yet; any value but the default raises.
    record_history: bool = False
    metrics_every: int = 0
    checkpoint_every: int = 0
    fetch_retries: int = 0
    screening: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        unported = [
            (self.algo == "dd", "algo='dd' (DD, Alg 2): ROADMAP A2"),
            (self.cd_mode == "cyclic", "cd_mode='cyclic': ROADMAP A2"),
            (self.presolve_samples != 0,
             "presolve_samples > 0 (§5.3 presolve): ROADMAP A2"),
            (self.stream_finalize == "legacy",
             "stream_finalize='legacy' (three-pass finalize): ROADMAP A3"),
            (self.record_history or self.metrics_every != 0,
             "record_history / metrics_every (sampled history): ROADMAP A3"),
            (self.checkpoint_every != 0,
             "checkpoint_every (checkpoint and resume): ROADMAP A4"),
            (self.fetch_retries != 0, "fetch_retries (fault layer): ROADMAP A4"),
            (self.screening, "screening: ROADMAP A5"),
        ]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(f"not ported yet: {what}")
        checks = [
            (self.algo == "scd", f"algo must be 'scd', got {self.algo!r}"),
            (self.cd_mode == "sync",
             f"cd_mode must be 'sync', got {self.cd_mode!r}"),
            (self.reduce == "bucketed",
             "solve_streaming requires reduce='bucketed' (the exact reduce "
             "must sort all candidates)"),
            (self.stream_finalize == "fused",
             f"stream_finalize must be 'fused', got {self.stream_finalize!r}"),
            (self.dtype == torch.float32,
             f"dtype must be torch.float32, got {self.dtype}"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    def replace(self, **kw) -> "SolverConfig":
        """Functional update: a copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)
