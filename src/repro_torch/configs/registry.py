"""Architecture registry: --arch <id> -> (CONFIG, SMOKE)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# The port knows the architectures whose mixers it has; ROADMAP.md lists
# the order in which the reference's other nine arrive.
_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    key = arch_id.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported yet (see ROADMAP.md); "
                       f"known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")


def get_config(arch_id: str) -> ArchConfig:
    return _mod(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _mod(arch_id).SMOKE
