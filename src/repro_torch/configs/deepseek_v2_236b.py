"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512
(rope_hd=64, nope_hd=128, v_hd=128, q_lora=1536), vocab=102400; layer 0
dense FFN 12288, layers 1..59 MoE with 2 shared + 160 routed experts
(top-6), expert d_ff=1536. Source: arXiv:2405.04434. Flagship SCD-router
integration (K=160 knapsacks, Q=6)."""
from repro_torch.models.config import MLACfg, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    first_dense_ff=12288,
    vocab=102400,
    use_mla=True,
    mla=MLACfg(kv_lora=512, q_lora=1536, rope_head_dim=64, nope_head_dim=128,
               v_head_dim=128),
    pattern=("attn",),
    ffn_pattern=("moe",),
    moe=MoECfg(n_experts=160, n_shared=2, topk=6, d_ff=1536, router="scd"),
)
