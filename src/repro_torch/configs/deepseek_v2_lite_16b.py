"""DeepSeek-V2-Lite (16B total) [arXiv:2405.04434]: MLA kv_lora=512,
layer 0 dense (d_ff 10944), layers 1..26 MoE 64 routed top-6 + 2 shared.

160 routed experts are the full V2's; V2-Lite, this config, routes 64.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense layer-0 FFN
    vocab_size=102400,
    head_pattern=("mla_attn",),          # dense first layer
    body_pattern=("mla_moe_attn",),
    n_periods=26,
    norm="rmsnorm",
    mlp="swiglu",
    rope_style="rope",
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        expert_d_ff=1408,
        n_shared_experts=2,
        shared_d_ff=2816,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)
