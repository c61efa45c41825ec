"""Gemma3-4B [hf:google/gemma-3-4b-pt]: 5:1 local:global, 262k vocab,
qk-norm. 34 layers = 5 periods x (5 local + 1 global) + 4 local tail."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    body_pattern=("local_attn",) * 5 + ("attn",),
    n_periods=5,
    tail_pattern=("local_attn",) * 4,
    local_window=1024,
    qk_norm=True,
    norm="rmsnorm",
    mlp="geglu",
    rope_style="rope",
    rope_theta=1000000.0,
    tie_embeddings=True,
    chunked_ce=512,
)
