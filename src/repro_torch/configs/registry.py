"""Architecture registry: --arch <id> -> (CONFIG, SMOKE)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen3-32b": "qwen3_32b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-7b": "qwen2_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-small": "whisper_small",
    "internvl2-26b": "internvl2_26b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    key = arch_id.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")


def get_config(arch_id: str) -> ArchConfig:
    return _mod(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _mod(arch_id).SMOKE
