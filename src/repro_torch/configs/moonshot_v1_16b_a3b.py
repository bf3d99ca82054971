"""moonshot-v1-16b-a3b [moe] (kimi/moonlight): 48L d_model=2048 16H
(GQA kv=16... spec: kv=16) d_ff=1408, MoE 64e top-6, vocab=163840.
Source: hf:moonshotai/Moonlight-16B-A3B. SCD router enabled."""
from repro_torch.models.config import MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    pattern=("attn",),
    ffn_pattern=("moe",),
    moe=MoECfg(n_experts=64, topk=6, d_ff=1408, router="scd"),
)
