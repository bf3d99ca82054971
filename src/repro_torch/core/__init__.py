"""Solver core: config, the §5.1 sparse SCD map, the §5.2 bucketed reduce,
the §5.4 projection and the host-fed streaming driver."""
