"""seamless-m4t-medium [audio]: enc-dec, 12+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206. Source: arXiv:2308.11596. The speech frontend is a
STUB per the assignment: input_specs() supplies precomputed frame
embeddings (B, F, d_model) to the encoder."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    kind="encdec",
    modality="audio",
    n_layers=12,            # decoder layers
    n_enc_layers=12,        # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
)
