"""Architecture/shape registry: ``get_config("<arch-id>")``, ``SHAPES``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, EncDecConfig, HybridConfig,
                                      MLAConfig, MoEConfig, ShapeConfig, SHAPES,
                                      SSMConfig, shape_applicable)

# Every architecture of the reference, each with its module here.
ARCH_IDS: List[str] = [
    "whisper-small", "pixtral-12b", "zamba2-2.7b", "phi3.5-moe-42b-a6.6b",
    "deepseek-v3-671b", "stablelm-12b", "qwen1.5-4b", "qwen1.5-110b",
    "gemma3-12b", "qwen1.5-0.5b", "mamba2-1.3b",
]

_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_0p5b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen1.5-110b": "repro_torch.configs.qwen15_110b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3",
}

PORTED_ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in PORTED_ARCH_IDS}


__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
    "EncDecConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "PORTED_ARCH_IDS",
    "get_config", "all_configs", "shape_applicable",
]
