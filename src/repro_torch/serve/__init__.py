"""Serving layer: generation-based refresh and on-demand decision lookups.

The paper's production shape (§6: "deployed to production and called on
a daily basis") on top of the streaming solver:

    engine.RefreshEngine / WorkloadSpec / Generation: immutable published
        solves, warm-started refreshes, atomic pointer flips,
        preemption-safe through the solver's own checkpoint and resume;
    decisions.DecisionService: O(chunk) point and batched lookups against
        the live generation, bitwise-equal to full materialisation, with
        retrying chunk regeneration and a degraded (stale-flagged)
        fallback to the previous generation.

The reference's HTTP/RPC front (``serve/front.py``) is ROADMAP A7.
"""
from .decisions import DecisionService, LookupResult  # noqa: F401
from .engine import (  # noqa: F401
    Generation,
    RefreshEngine,
    WorkloadSpec,
    content_chunk_diff,
    synthetic_chunk_diff,
    synthetic_source,
)
