"""Architecture registry of the port: ``get_config(name)``.

The names are the reference's (``repro/configs/__init__.py``), and the
port serves every one of them (``PORTED``); an unknown name raises a
``KeyError``.
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

#: The architectures whose serving path the port runs: all of them.
PORTED = ARCHS

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
