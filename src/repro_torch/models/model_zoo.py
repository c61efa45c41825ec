"""Public model API: ``repro/models/model_zoo.py`` in PyTorch.

A :class:`Model` bundles a configuration with the functions of
``transformer``: ``init`` (seeded, on the generator's device), ``loss``
(``transformer.loss_fn``: (total, {"ce", "aux"}), differentiable),
``prefill``, ``decode_step`` and ``init_cache``. Caches default to
bfloat16 whatever the compute type, as in the reference
(``Model.init_cache``); the Griffin state ``h`` is float32. Whisper
(an encoder-decoder) is driven through ``prefill(params, cache,
tokens=, frames=)`` and ``decode_step``, the API the reference serves
it by.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.common.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device="cuda") -> Dict:
        """Parameters drawn from a generator seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            return tfm.model_init(self.cfg, gen)

    def loss(self, params, batch):
        return tfm.loss_fn(params, self.cfg, batch)

    def prefill(self, params, cache, *, tokens=None, embeddings=None,
                positions=None, frames=None):
        return tfm.prefill(params, self.cfg, cache, tokens=tokens,
                           embeddings=embeddings, positions=positions,
                           frames=frames)

    def decode_step(self, params, tokens, pos, cache):
        return tfm.decode_step(params, self.cfg, tokens, pos, cache)

    def init_cache(self, batch: int, length: int, dtype=torch.bfloat16,
                   device="cuda"):
        return tfm.model_cache(self.cfg, batch, length, dtype,
                               resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
