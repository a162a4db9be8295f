"""Architecture lookup for the two LM families the port runs (a subset of
``repro.configs``): ``get_config`` gives the published config,
``get_smoke_config`` its reduced same-family variant."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
