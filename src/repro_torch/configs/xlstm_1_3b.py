"""xLSTM-1.3B [arXiv:2405.04517]: xLSTM[7:1] — 7 mLSTM : 1 sLSTM per
period, 48 blocks, d_ff=0 (blocks are self-contained)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    body_pattern=("mlstm",) * 7 + ("slstm",),
    n_periods=6,
    conv1d_width=4,
    norm="rmsnorm",
    mlp="gelu",
    rope_style="none",
    tie_embeddings=True,
)
