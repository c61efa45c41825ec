"""Architecture registry of the port: ``get_config(name)``.

The names are the reference's (``repro/configs/__init__.py``). The port
serves the architectures of ``PORTED``; asking for another raises a
``KeyError`` that names the slice of ``ROADMAP.md`` that brings it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "olmo-1b",
    "smollm-135m",
    "qwen2.5-3b",
    "gemma3-4b",
    "whisper-small",
    "recurrentgemma-9b",
    "qwen2-vl-7b",
    "xlstm-1.3b",
    "deepseek-v2-lite-16b",
    "granite-moe-1b-a400m",
)

#: The architectures whose serving path the port runs.
PORTED = ("smollm-135m", "qwen2.5-3b", "olmo-1b", "gemma3-4b",
          "granite-moe-1b-a400m", "recurrentgemma-9b", "xlstm-1.3b",
          "deepseek-v2-lite-16b", "qwen2-vl-7b")

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {', '.join(ARCHS)}")
    if name not in PORTED:
        raise KeyError(f"arch '{name}' is not ported yet; it comes with "
                       f"the encoder-decoder slice (queue 1 item 6h of "
                       f"ROADMAP.md). Ported: {', '.join(PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
