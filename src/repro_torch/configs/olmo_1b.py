"""OLMo-1B [arXiv:2402.00838]: dense, non-parametric LayerNorm, tied."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    body_pattern=("attn",),
    norm="nonparametric_ln",
    mlp="swiglu",
    rope_style="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
)
