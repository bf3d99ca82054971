"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave, MoE every other
layer. Source: arXiv:2403.19887. Period-8 pattern x 4; the paper's SCD
router is first-class here (router="scd")."""
from repro_torch.models.config import MambaCfg, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=("attn",) + ("mamba",) * 7,
    ffn_pattern=("moe", "dense") * 4,
    moe=MoECfg(n_experts=16, topk=2, d_ff=14336, router="scd"),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                   chunk=256),
)
