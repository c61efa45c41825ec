"""LM parameters carried across from the JAX package.

The reference's parameter tree (``repro.models.transformer.model_init``)
is nested dicts and lists of float32 arrays; its checkpoints
(``repro/checkpointing/manager.py``) store one ``step_<n>.npz`` with
every leaf under its slash-joined path (``embed/table``,
``body/0/mix/lru/lambda``, ``tail/1/mlp/wi``). :func:`lm_params` reads
either form into the port's tree. The mapping is the identity on paths
and shapes: the port keeps the reference's tree, body leaves with their
leading ``n_periods`` axis included (``models.transformer`` takes views
per period), and only the types change, by :func:`cast_params`.

:func:`load_lm_golden` reads ``assets/recurrentgemma_small_golden.npz``
or ``assets/xlstm_small_golden.npz`` (``XLSTM_GOLDEN_PATH``): a small
RecurrentGemma or xLSTM (``scaled_down(dtype="float32")``) with the JAX
package's parameters, its prefill and decode logits and the tokens its
``SlotServer`` served (written by ``tests/test_torch_lm_golden.py
--write``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.params import load_npz, params_from_numpy, unflatten
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.transformer import compute_dtype

ASSETS = Path(__file__).resolve().parents[1] / "assets"
LM_GOLDEN_PATH = ASSETS / "recurrentgemma_small_golden.npz"
XLSTM_GOLDEN_PATH = ASSETS / "xlstm_small_golden.npz"

#: Leaf names the reference reads in float32 whatever the compute type.
F32_LEAVES = ("scale", "lambda")


def cast_params(tree, cfg: ModelConfig, device="cpu", path: str = ""):
    """Float32 leaves -> ``device``, in the compute type, except the
    leaves read in float32 (norm scales, ``lambda``)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, cfg, device, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_params(v, cfg, device, f"{path}/{i}")
                for i, v in enumerate(tree)]
    name = path.rsplit("/", 1)[-1]
    dtype = torch.float32 if name in F32_LEAVES else compute_dtype(cfg)
    return tree.to(device=device, dtype=dtype)


def lm_params(source, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The port's parameters from the reference's: a nested tree of
    numpy arrays, or a mapping of slash-joined paths to arrays (a
    ``step_<n>.npz`` as ``np.load`` gives it). They go to the card
    unless the caller asks for the CPU (``device="cpu"``)."""
    dev = resolve_device(device)
    if isinstance(source, Mapping) and source and all(
            isinstance(k, str) and "/" in k for k in source):
        source = unflatten({k: np.asarray(v) for k, v in source.items()})
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


def load_lm_golden(path=LM_GOLDEN_PATH) -> LMGolden:
    with np.load(path, allow_pickle=False) as z:
        g = {k: z[k] for k in z.files if not k.startswith("params/")}
    cuts = np.cumsum(g["serve/prompt_lengths"])[:-1]
    served = np.split(g["serve/tokens"], np.cumsum(g["serve/token_counts"])
                      [:-1])
    return LMGolden(
        config=config_from_json(str(g["config"])),
        params=load_npz(path, prefix="params/"),
        prefill_tokens=g["prefill/tokens"],
        prefill_logits=g["prefill/logits"],
        cache_len=int(g["cache_len"]),
        cache_dtype=str(g.get("cache_dtype", "bfloat16")),
        decode_tokens=g["decode/tokens"],
        decode_logits=g["decode/logits"],
        prompts=np.split(g["serve/prompts"], cuts),
        max_new=int(g["serve/max_new"]), slots=int(g["serve/slots"]),
        max_len=int(g["serve/max_len"]),
        served=[[int(t) for t in s] for s in served])
