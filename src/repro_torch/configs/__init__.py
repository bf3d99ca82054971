"""Workload configurations: the paper's KP workloads (``paper_kp``) and the
architecture zoo's model configs, resolved by ``registry.get``."""
from . import registry  # noqa: F401
