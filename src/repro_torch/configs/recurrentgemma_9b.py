"""RecurrentGemma-9B [arXiv:2402.19427]: Griffin — RG-LRU + local attn,
pattern (recurrent, recurrent, attention); 38 = 12x3 + (r, r) tail; MQA."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    body_pattern=("rg_lru", "rg_lru", "local_attn"),
    n_periods=12,
    tail_pattern=("rg_lru", "rg_lru"),
    local_window=2048,
    lru_width=4096,
    conv1d_width=4,
    norm="rmsnorm",
    mlp="geglu",
    rope_style="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    chunked_ce=512,
)
