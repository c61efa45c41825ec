"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B]: GQA kv=2, QKV bias."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    body_pattern=("attn",),
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_style="rope",
    rope_theta=1000000.0,
    tie_embeddings=True,
)
