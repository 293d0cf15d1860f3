"""Config registry: `get_config("--arch id")` for every assigned
architecture (+ the paper-demo substrate)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "smollm-360m": "smollm_360m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-base": "whisper_base",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "syncode-demo": "syncode_demo",
}

ARCH_IDS = [k for k in _MODULES if k != "syncode-demo"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs():
    return {k: get_config(k) for k in _MODULES}
