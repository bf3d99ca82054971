"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternLM2-20B LLM backbone; InternViT frontend is a STUB
per the assignment (input_specs() supplies 1024 patch embeddings that are
prepended to the token embeddings). Source: arXiv:2404.16821."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    modality="vision",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    n_patches=1024,
)
