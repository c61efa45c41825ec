"""Qwen2-VL-7B [arXiv:2409.12191]: M-RoPE; vision frontend is a STUB —
input_specs() provides precomputed patch+text embeddings."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    body_pattern=("attn",),
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_style="mrope",
    rope_theta=1000000.0,
    tie_embeddings=False,
)
