"""Architecture registry: ``--arch <id>`` resolution for the ten published
architectures of ``repro.configs``. ``get_config`` gives the published
config, ``get_smoke_config`` its reduced same-family variant,
``get_input_shape`` one of the four workload shapes. The config modules
import lazily, so importing this package stays cheap."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (INPUT_SHAPES, LONG_CONTEXT_WINDOW,
                                      FLConfig, InputShape, ModelConfig,
                                      MoEConfig, SSMConfig, TrainConfig)
from repro_torch.configs.paper_cnn import CNN_CONFIGS, CNNConfig

_ARCH_MODULES: Dict[str, str] = {
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
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


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
