"""Synthetic data: LM token batches, KP shards and KP chunk sources."""
from .synth import kp_shard, lm_batch  # noqa: F401
