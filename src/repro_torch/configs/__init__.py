"""Config registry: ``get_config(arch_id)`` for every assigned architecture."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ArchConfig,
    Layer,
    MambaCfg,
    MoECfg,
    ShapeCfg,
    SHAPES,
    XLSTMCfg,
    reduce_for_smoke,
)

# arch-id -> module name
_REGISTRY = {
    "qwen2-7b": "qwen2_7b",
    "gemma2-2b": "gemma2_2b",
    "gemma2-27b": "gemma2_27b",
    "granite-34b": "granite_34b",
    "xlstm-125m": "xlstm_125m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "pixtral-12b": "pixtral_12b",
    "musicgen-large": "musicgen_large",
    "jamba-v0.1-52b": "jamba_52b",
}


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_configs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.config()


__all__ = [
    "ArchConfig", "Layer", "MoECfg", "MambaCfg", "XLSTMCfg", "ShapeCfg",
    "SHAPES", "get_config", "list_configs", "reduce_for_smoke",
]
