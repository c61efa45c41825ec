"""Whisper-small [arXiv:2212.04356]: enc-dec; conv frontend is a STUB —
input_specs() provides precomputed frame embeddings (B, 1500, d_model)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,              # decoder layers; encoder separate below
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    body_pattern=("xattn",),
    n_encoder_layers=12,
    n_audio_frames=1500,
    norm="layernorm",
    mlp="gelu",
    rope_style="learned",
    tie_embeddings=True,
    max_seq=32768,            # assigned shapes exceed whisper's own 448
)
