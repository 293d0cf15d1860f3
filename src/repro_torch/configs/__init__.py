"""Config registry: `get_config("--arch id")` for every assigned
architecture (+ the paper-demo substrate)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "smollm-360m": "smollm_360m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "whisper-base": "whisper_base",
    "internlm2-1.8b": "internlm2_1_8b",
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
