"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small model."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    body_pattern=("attn",),
    norm="rmsnorm",
    mlp="swiglu",
    rope_style="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
)
