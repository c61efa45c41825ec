"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32 experts top-8, granite multipliers."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    body_pattern=("moe_attn",),
    norm="rmsnorm",
    mlp="swiglu",
    rope_style="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=6.0,
    moe=MoEConfig(
        n_experts=32,
        top_k=8,
        expert_d_ff=512,
        capacity_factor=1.25,
    ),
)
