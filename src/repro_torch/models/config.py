"""Model configuration of the LM zoo, a copy of ``repro/models/config.py``.

Every field of the reference is kept, so that a configuration crosses
between the packages field for field; the port serves every layer kind
below but "dense_attn", which no configuration uses.

A model is: [embedding / modality frontend stub] -> head layers (unrolled)
-> scanned pattern body (n_periods x period) -> tail layers (unrolled)
-> final norm -> logits.

Layer kinds:
  "attn"       full (causal) self-attention + MLP
  "local_attn" sliding-window self-attention + MLP
  "rg_lru"     Griffin recurrent block (conv1d + RG-LRU) + MLP
  "mlstm"      xLSTM matrix-memory block (self-contained, no MLP)
  "slstm"      xLSTM scalar-memory block (self-contained, no MLP)
  "moe_attn"   full attention + MoE feed-forward
  "dense_attn" full attention + dense MLP (used for MoE archs' dense head)
  "mla_attn"   DeepSeek-V2 latent attention + dense MLP
  "mla_moe_attn" DeepSeek-V2 latent attention + MoE feed-forward
  "enc_attn"   bidirectional self-attention + MLP (whisper's encoder)
  "xattn"      causal self-attention + cross-attention over the encoder
               output + MLP (whisper's decoder)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_dtype: str = "float32"
    # dispatch implementation:
    #   "scatter" — paper-faithful port of scatter/gather token routing
    #               (combine gathers across the expert-sharded buffer ->
    #               all-gather over "model"; the collective-bound baseline)
    #   "einsum"  — GShard/MaxText-style group-local one-hot dispatch;
    #               the only combine collective is a psum over "model"
    #               (beyond-paper optimization, §Perf)
    impl: str = "scatter"
    group_size: int = 256  # einsum impl: tokens per dispatch group


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | audio | hybrid | vlm | ssm | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # layer pattern: head (unrolled) + body (scanned n_periods times) + tail
    head_pattern: Tuple[str, ...] = ()
    body_pattern: Tuple[str, ...] = ("attn",)
    n_periods: int = 0  # 0 -> n_layers // len(body_pattern)
    tail_pattern: Tuple[str, ...] = ()

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    local_window: int = 1024
    rope_style: str = "rope"  # none | rope | mrope
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0

    # norms / mlp
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = True

    # multipliers (granite)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0  # 0 -> 1/sqrt(head_dim)
    logits_scaling: float = 1.0

    # recurrent details
    conv1d_width: int = 4
    lru_width: int = 0  # 0 -> d_model

    # moe / mla
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # encoder-decoder (whisper): encoder stack of n_encoder_layers "attn"
    # (bidirectional) blocks; decoder layers get cross-attention.
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # training
    max_seq: int = 4096
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots

    # implementation switches
    attn_impl: str = "reference"  # reference | pallas
    chunked_ce: int = 0  # >0: vocab-chunked cross-entropy block size
    # scan over body periods (small HLO, fast compile) vs python-unrolled
    # (large HLO; exact cost_analysis — XLA counts while bodies once, so
    # the dry-run roofline pass unrolls)
    scan_layers: bool = True
    # int8 KV cache with per-(token, head) scales: halves decode HBM
    # traffic on the cache read (beyond-paper optimization, §Perf)
    kv_quant: bool = False
    # skip (not just mask) the causal upper triangle in chunked
    # attention; False = paper-faithful mask-only baseline (§Perf)
    causal_skip: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_periods == 0:
            body = len(self.body_pattern)
            rest = self.n_layers - len(self.head_pattern) - len(self.tail_pattern)
            if rest % body != 0:
                raise ValueError(
                    f"{self.name}: {rest} pattern layers not divisible by "
                    f"period {body}; set head/tail_pattern explicitly"
                )
            object.__setattr__(self, "n_periods", rest // body)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        n_patterned = (
            len(self.head_pattern)
            + self.n_periods * len(self.body_pattern)
            + len(self.tail_pattern)
        )
        if n_patterned != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern covers {n_patterned} layers, "
                f"config says {self.n_layers}"
            )

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return (
            self.head_pattern
            + self.body_pattern * self.n_periods
            + self.tail_pattern
        )

    def scaled_down(self, **overrides) -> "ModelConfig":
        """A smoke-test sized variant of the same family (tests only)."""
        small = dict(
            n_layers=len(self.body_pattern)
            + len(self.head_pattern)
            + len(self.tail_pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_periods=1,
            local_window=16,
            max_seq=64,
            lru_width=64,
            n_encoder_layers=1 if self.n_encoder_layers else 0,
            n_audio_frames=8,
            chunked_ce=0,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                n_experts=4,
                top_k=2,
                expert_d_ff=32,
                shared_d_ff=32 if self.moe.n_shared_experts else 0,
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16,
            )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# Families whose published config has a sub-quadratic path for 500k decode.
SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def shapes_for(config: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The assigned shape set for an architecture (long_500k gated)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.family in SUBQUADRATIC_FAMILIES:
        shapes.append(LONG_500K)
    return tuple(shapes)
