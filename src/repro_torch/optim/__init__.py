"""The optimizer of the LM training path (``src/repro/optim``)."""
from .adamw import OptConfig, OptState, apply_updates, init_opt_state  # noqa: F401
