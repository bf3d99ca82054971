"""Serving layer: generation-based refresh and on-demand decision lookups.

The paper's production shape (§6: "deployed to production and called on
a daily basis") on top of the streaming solver:

    engine.RefreshEngine / WorkloadSpec / Generation: immutable published
        solves, warm-started refreshes, atomic pointer flips,
        preemption-safe through the solver's own checkpoint and resume;
    decisions.DecisionService: O(chunk) point and batched lookups against
        the live generation, bitwise-equal to full materialisation, with
        retrying chunk regeneration and a degraded (stale-flagged)
        fallback to the previous generation;
    front.Front / ReplicaServer: the HTTP/RPC request path, N replica
        processes each hosting a DecisionService with a LIVE-pointer
        watcher, round-robined behind a ThreadingHTTPServer front with
        aggregated /health and the cross-generation /diff endpoint
        (``launch/front.py`` spawns and drives them).
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
from .front import (  # noqa: F401
    Front,
    FrontRPCError,
    ReplicaClient,
    ReplicaServer,
    decision_diff,
)
