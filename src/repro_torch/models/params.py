"""LM parameters carried across from the JAX package.

The reference's parameter tree (``repro.models.transformer.model_init``)
is nested dicts and lists of float32 arrays; its checkpoints
(``repro/checkpointing/manager.py``) store one ``step_<n>.npz`` with
every leaf under its slash-joined path (``embed/table``,
``body/0/mix/lru/lambda``, ``tail/1/mlp/wi``). :func:`lm_params` reads
either form into the port's tree. The mapping is the identity on paths
and shapes: the port keeps the reference's tree, body leaves with their
leading ``n_periods`` axis included (``models.transformer`` takes views
per period), and only the types change, by :func:`cast_params`. A flat
checkpoint holds no key for a node without leaves (``nonparametric_ln``
gives ``norm1``, ``norm2`` and ``final_norm`` as ``{}``), so it is read
into the structure of the configuration's tree
(``transformer.model_template``), as the reference's
``CheckpointManager.restore(template)`` reads one.

:func:`load_lm_golden` reads ``assets/recurrentgemma_small_golden.npz``
or ``assets/xlstm_small_golden.npz`` (``XLSTM_GOLDEN_PATH``): a small
RecurrentGemma or xLSTM (``scaled_down(dtype="float32")``) with the JAX
package's parameters, its prefill and decode logits and the tokens its
``SlotServer`` served (written by ``tests/test_torch_lm_golden.py
--write``). ``assets/lm_zoo_small_golden.npz`` (``LM_ZOO_GOLDEN_PATH``)
holds the same for the five small dense and MoE decoders, each under a
prefix of its arch's name (written by ``tests/test_torch_lm_zoo.py
--write``), and ``assets/lm_zoo_mla_mrope_small_golden.npz``
(``LM_MLA_MROPE_GOLDEN_PATH``) for the small DeepSeek-V2-Lite and
Qwen2-VL, the latter with a prefill from ``embeddings`` and (3, B, S)
positions whose rows differ (``LMGolden.embeddings``; written by
``tests/test_torch_mla.py --write``).

The MLA leaves (``wq``, ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``,
``wo``) cross like any other: the tree of ``model_template`` holds them.
So do whisper's: ``pos_embed/table``, the encoder's one tree of leaves
stacked over its layers (``encoder/attn/wq/w`` is ``(n_encoder_layers,
d, d)``), ``enc_norm``, and each decoder layer's ``norm_x`` and
``xattn``. LayerNorm biases (``.../bias``) stay float32, as the
reference reads them; the linear biases (``.../b``) take the compute
type, as the reference's ``linear`` casts them.

:func:`load_lm_train_golden` reads the training golden files: the five
small decoders' (``lm_train_small_golden.npz``, written by
``tests/test_torch_lm_train.py --write``), the small RecurrentGemma's
(``lm_train_recurrentgemma_small_golden.npz``, written by
``tests/test_torch_rg_lru_train.py --write``) and the small xLSTM's
(``lm_train_xlstm_small_golden.npz``, written by
``tests/test_torch_xlstm_train.py --write``) and the small
DeepSeek-V2-Lite's (``lm_train_deepseek_small_golden.npz``, written by
``tests/test_torch_deepseek_train.py --write``), and the small Qwen2-VL's
and whisper's (``lm_train_qwen2_vl_small_golden.npz`` and
``lm_train_whisper_small_golden.npz``, written by
``tests/test_torch_vl_train.py --write`` and
``tests/test_torch_whisper_train.py --write``), whose batches are their
family's: embeddings and (3, B, S) positions, or tokens and frames.

:func:`load_whisper_golden` reads ``assets/lm_zoo_whisper_small_golden.npz``
(``WHISPER_GOLDEN_PATH``, written by ``tests/test_torch_whisper.py
--write``): the small whisper (``scaled_down(dtype="float32")``) with the
JAX package's parameters, seeded frames and tokens, and the JAX outputs
of its encoder, prefill, three decode steps and a greedy decode.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.params import params_from_numpy
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.transformer import compute_dtype, model_template

ASSETS = Path(__file__).resolve().parents[1] / "assets"
LM_GOLDEN_PATH = ASSETS / "recurrentgemma_small_golden.npz"
XLSTM_GOLDEN_PATH = ASSETS / "xlstm_small_golden.npz"
LM_ZOO_GOLDEN_PATH = ASSETS / "lm_zoo_small_golden.npz"
LM_MLA_MROPE_GOLDEN_PATH = ASSETS / "lm_zoo_mla_mrope_small_golden.npz"
WHISPER_GOLDEN_PATH = ASSETS / "lm_zoo_whisper_small_golden.npz"
LM_TRAIN_GOLDEN_PATH = ASSETS / "lm_train_small_golden.npz"
RG_TRAIN_GOLDEN_PATH = ASSETS / "lm_train_recurrentgemma_small_golden.npz"
XLSTM_TRAIN_GOLDEN_PATH = ASSETS / "lm_train_xlstm_small_golden.npz"
DEEPSEEK_TRAIN_GOLDEN_PATH = ASSETS / "lm_train_deepseek_small_golden.npz"
VL_TRAIN_GOLDEN_PATH = ASSETS / "lm_train_qwen2_vl_small_golden.npz"
WHISPER_TRAIN_GOLDEN_PATH = ASSETS / "lm_train_whisper_small_golden.npz"

#: Ends of the leaf paths the reference reads in float32 whatever the
#: compute type: norm scales and biases, the RG-LRU ``lambda``, the MoE
#: router (a linear's bias ``b`` is not among them).
F32_LEAVES = ("scale", "bias", "lambda", "router/w")


def cast_params(tree, cfg: ModelConfig, device="cpu", path: str = ""):
    """Float32 leaves -> ``device``, in the compute type, except the
    leaves read in float32 (norm scales, ``lambda``)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, cfg, device, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_params(v, cfg, device, f"{path}/{i}")
                for i, v in enumerate(tree)]
    f32 = any(path.endswith("/" + end) for end in F32_LEAVES)
    dtype = torch.float32 if f32 else compute_dtype(cfg)
    return tree.to(device=device, dtype=dtype)


def restore(flat: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's tree of float32 CPU tensors from its leaves under
    slash-joined paths, in the structure of ``cfg``'s tree (empty nodes
    included); keys outside that tree are ignored, as the reference's
    ``restore`` ignores them."""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, f"{path}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{path}{i}/") for i, v in enumerate(node)]
        key = path[:-1]
        leaf = params_from_numpy(flat[key])
        if tuple(leaf.shape) != tuple(node.shape):
            raise ValueError(f"{key}: shape {tuple(leaf.shape)}, the "
                             f"configuration's is {tuple(node.shape)}")
        return leaf

    return build(model_template(cfg), "")


def lm_params(source, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The port's parameters from the reference's: a nested tree of
    numpy arrays, or a mapping of slash-joined paths to arrays (a
    ``step_<n>.npz`` as ``np.load`` gives it). They go to the card
    unless the caller asks for the CPU (``device="cpu"``)."""
    dev = resolve_device(device)
    if isinstance(source, Mapping) and source and all(
            isinstance(k, str) and "/" in k for k in source):
        return cast_params(restore(source, cfg), cfg, dev)
    return cast_params(params_from_numpy(source), cfg, dev)


def config_from_json(text: str) -> ModelConfig:
    """A ``ModelConfig`` from ``json.dumps(dataclasses.asdict(cfg))``."""
    fields = json.loads(text)
    for key, value in fields.items():
        if isinstance(value, list):
            fields[key] = tuple(value)
    if fields.get("moe") is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    if fields.get("mla") is not None:
        fields["mla"] = MLAConfig(**fields["mla"])
    return ModelConfig(**fields)


@dataclasses.dataclass
class LMGolden:
    config: ModelConfig
    params: Any  # the reference's tree of float32 CPU tensors
    prefill_tokens: np.ndarray  # (B, S)
    prefill_logits: np.ndarray  # (B, V), JAX
    cache_len: int
    cache_dtype: str  # of the caches behind the prefill and decode logits
    decode_tokens: np.ndarray  # (steps, B), fed one step at a time
    decode_logits: np.ndarray  # (steps, B, V), JAX, positions S, S+1, ...
    prompts: List[np.ndarray]  # the served requests
    max_new: int
    slots: int
    max_len: int
    served: List[List[int]]  # the JAX SlotServer's tokens per request
    # a prefill from embeddings: {"inputs" (B, S, d), "positions"
    # (3, B, S), "logits" (B, V), JAX, "cache_len"}; None where the file
    # holds none
    embeddings: Optional[Dict[str, np.ndarray]] = None


def load_lm_golden(path=LM_GOLDEN_PATH, prefix: str = "") -> LMGolden:
    """One small model of a golden file; ``prefix`` (``"olmo-1b/"``)
    picks an arch of ``lm_zoo_small_golden.npz``."""
    with np.load(path, allow_pickle=False) as z:
        g = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    flat = {k[len("params/"):]: g.pop(k) for k in list(g)
            if k.startswith("params/")}
    config = config_from_json(str(g["config"]))
    cuts = np.cumsum(g["serve/prompt_lengths"])[:-1]
    served = np.split(g["serve/tokens"], np.cumsum(g["serve/token_counts"])
                      [:-1])
    return LMGolden(
        config=config,
        params=restore(flat, config),
        prefill_tokens=g["prefill/tokens"],
        prefill_logits=g["prefill/logits"],
        cache_len=int(g["cache_len"]),
        cache_dtype=str(g.get("cache_dtype", "bfloat16")),
        decode_tokens=g["decode/tokens"],
        decode_logits=g["decode/logits"],
        prompts=np.split(g["serve/prompts"], cuts),
        max_new=int(g["serve/max_new"]), slots=int(g["serve/slots"]),
        max_len=int(g["serve/max_len"]),
        served=[[int(t) for t in s] for s in served],
        embeddings=({k[len("embeddings/"):]: v for k, v in g.items()
                     if k.startswith("embeddings/")} or None))


@dataclasses.dataclass
class WhisperGolden:
    config: ModelConfig
    params: Any  # the reference's tree of float32 CPU tensors
    frames: np.ndarray  # (B, n_audio_frames, d_model)
    enc_out: np.ndarray  # (B, n_audio_frames, d_model), JAX's run_encoder
    prefill_tokens: np.ndarray  # (B, S)
    prefill_logits: np.ndarray  # (B, V), JAX
    cache_len: int
    cache_dtype: str  # of the caches behind every logit here
    decode_tokens: np.ndarray  # (steps, B), fed one step at a time
    decode_logits: np.ndarray  # (steps, B, V), JAX, positions S, S+1, ...
    # (B, 1 + n) argmax of the prefill's logits, then of each of n decode
    # steps fed the previous argmax, after a fresh prefill
    greedy_tokens: np.ndarray


def load_whisper_golden(path=WHISPER_GOLDEN_PATH) -> WhisperGolden:
    with np.load(path, allow_pickle=False) as z:
        g = {k: z[k] for k in z.files}
    config = config_from_json(str(g["config"]))
    flat = {k[len("params/"):]: v for k, v in g.items()
            if k.startswith("params/")}
    return WhisperGolden(
        config=config, params=restore(flat, config), frames=g["frames"],
        enc_out=g["enc_out"], prefill_tokens=g["prefill/tokens"],
        prefill_logits=g["prefill/logits"], cache_len=int(g["cache_len"]),
        cache_dtype=str(g["cache_dtype"]), decode_tokens=g["decode/tokens"],
        decode_logits=g["decode/logits"], greedy_tokens=g["greedy/tokens"])


@dataclasses.dataclass
class LMTrainGolden:
    config: ModelConfig  # the training configuration (chunked_ce set)
    params: Any  # the reference's initial tree of float32 CPU tensors
    # (steps, B, S) int32: batch_at(0..steps-1) of the token pipeline, or
    # the drawn batches' where the golden holds embeddings or frames;
    # None for a batch of embeddings
    tokens: Optional[np.ndarray]
    labels: np.ndarray  # (steps, B, S) int32
    loss: float  # JAX loss_fn on the first batch
    ce: float
    aux: float
    grads: List[Any]  # each step's, trees of float32 CPU tensors
    params_after: Any  # after ``steps`` AdamW steps
    adamw: Dict[str, float]  # {"peak", "warmup", "steps"}: the schedule
    # the batches' other inputs, by family (None where absent): "vlm"
    # embeddings (steps, B, S, d_model) float32 and positions (steps, 3,
    # B, S) int32; "audio" frames (steps, B, n_audio_frames, d_model)
    # float32
    embeddings: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None
    frames: Optional[np.ndarray] = None

    def batch(self, i: int, device="cpu") -> Dict[str, Any]:
        """Step ``i``'s batch as ``model.loss`` takes it, on
        ``device``."""
        return {k: torch.as_tensor(getattr(self, k)[i], device=device)
                for k in ("tokens", "labels", "embeddings", "positions",
                          "frames") if getattr(self, k) is not None}


def load_lm_train_golden(arch: str, path=None) -> LMTrainGolden:
    """One small model of a training golden file: the five decoders of
    ``lm_train_small_golden.npz`` with their initial parameters from
    ``lm_zoo_small_golden.npz``, ``recurrentgemma-9b`` from
    ``lm_train_recurrentgemma_small_golden.npz`` with its initial
    parameters from ``recurrentgemma_small_golden.npz`` (the same JAX
    init: the training configuration differs only in ``chunked_ce`` and
    ``max_seq``, which make no parameter), or ``xlstm-1.3b`` from
    ``lm_train_xlstm_small_golden.npz`` with its initial parameters from
    ``xlstm_small_golden.npz`` (likewise: only ``max_seq`` differs), or
    ``deepseek-v2-lite-16b`` from ``lm_train_deepseek_small_golden.npz``
    with its initial parameters from ``lm_zoo_mla_mrope_small_golden.npz``
    (the same configuration), ``qwen2-vl-7b`` from
    ``lm_train_qwen2_vl_small_golden.npz`` with its initial parameters
    from the same file, or ``whisper-small`` from
    ``lm_train_whisper_small_golden.npz`` with its initial parameters from
    ``lm_zoo_whisper_small_golden.npz`` (the same configuration)."""
    if arch == "recurrentgemma-9b":
        path, init = path or RG_TRAIN_GOLDEN_PATH, (LM_GOLDEN_PATH, "")
    elif arch == "xlstm-1.3b":
        path, init = path or XLSTM_TRAIN_GOLDEN_PATH, (XLSTM_GOLDEN_PATH, "")
    elif arch == "deepseek-v2-lite-16b":
        path, init = path or DEEPSEEK_TRAIN_GOLDEN_PATH, (
            LM_MLA_MROPE_GOLDEN_PATH, f"{arch}/")
    elif arch == "qwen2-vl-7b":
        path, init = path or VL_TRAIN_GOLDEN_PATH, (
            LM_MLA_MROPE_GOLDEN_PATH, f"{arch}/")
    elif arch == "whisper-small":
        path, init = path or WHISPER_TRAIN_GOLDEN_PATH, None
    else:
        path, init = path or LM_TRAIN_GOLDEN_PATH, (LM_ZOO_GOLDEN_PATH,
                                                    f"{arch}/")
    prefix = f"{arch}/"
    with np.load(path, allow_pickle=False) as z:
        g = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
        adamw = {k: float(z[f"adamw/{k}"])
                 for k in ("peak", "warmup", "steps")}
    config = config_from_json(str(g["config"]))

    def tree(name):
        return restore({k[len(name) + 1:]: v for k, v in g.items()
                        if k.startswith(name + "/")}, config)

    params = (load_whisper_golden().params if init is None
              else load_lm_golden(*init).params)
    return LMTrainGolden(
        config=config, params=params, tokens=g.get("tokens"),
        labels=g["labels"], loss=float(g["loss"]), ce=float(g["ce"]),
        aux=float(g["aux"]),
        grads=[tree(f"grads/{i}") for i in range(len(g["labels"]))],
        params_after=tree("params_after"), adamw=adamw,
        embeddings=g.get("embeddings"), positions=g.get("positions"),
        frames=g.get("frames"))


def load_pipeline_golden(path=LM_TRAIN_GOLDEN_PATH) -> Dict[str, Any]:
    """The full-vocabulary batches of the training golden file:
    {"vocab", "seq", "batch", "steps" (list), "tokens" and "labels"
    (len(steps), B, S) int32}."""
    with np.load(path, allow_pickle=False) as z:
        g = {k[len("pipeline/"):]: z[k] for k in z.files
             if k.startswith("pipeline/")}
    return {"vocab": int(g["vocab"]), "seq": int(g["seq"]),
            "batch": int(g["batch"]), "steps": g["steps"].tolist(),
            "tokens": g["tokens"], "labels": g["labels"]}
