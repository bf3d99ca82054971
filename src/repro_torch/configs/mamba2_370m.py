"""mamba2-370m [ssm]: 48L d_model=1024, attn-free SSD blocks, vocab=50280,
ssm_state=128. Source: arXiv:2405.21060 (state-space duality). d_inner =
2*d_model = 2048, head_dim 64 -> 32 heads, groups=1, conv4."""
from repro_torch.models.config import MambaCfg, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    n_layers=48,
    d_model=1024,
    n_heads=32,          # SSD heads (d_inner / head_dim)
    n_kv_heads=32,
    d_ff=0,
    vocab=50280,
    pattern=("mamba",),
    ffn_pattern=("none",),
    mamba=MambaCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                   chunk=256),
    tie_embeddings=True,
)
