"""Solver core: config and instances, the §5.1 sparse and Alg-3 dense SCD
maps, the §5.2 bucketed and exact reduces, the §5.4 projection, the
resident single-device solve and the host-fed streaming driver."""
from .solver import SolveResult, dual_objective, solve  # noqa: F401
