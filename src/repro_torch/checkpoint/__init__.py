"""Atomic checkpoints: the streaming resume state and pointer documents."""
from . import ckpt  # noqa: F401
