"""Architecture configs (one module per arch, all ten of the reference's)
and the shape cells."""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig
from .shapes import SHAPES, ShapeSpec, runnable_cells

ARCHS = (
    "mamba2_2p7b",
    "gemma2_27b",
    "gemma3_4b",
    "phi4_mini_3p8b",
    "stablelm_12b",
    "recurrentgemma_9b",
    "granite_moe_1b",
    "deepseek_v2_236b",
    "phi3_vision_4p2b",
    "musicgen_large",
)

#: archs whose config and model path the port carries: every one
PORTED = ARCHS

_ALIAS = {
    "mamba2-2.7b": "mamba2_2p7b",
    "gemma2-27b": "gemma2_27b",
    "gemma3-4b": "gemma3_4b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "stablelm-12b": "stablelm_12b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "musicgen-large": "musicgen_large",
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.reduced() if reduced else mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


__all__ = [
    "ARCHS",
    "PORTED",
    "SHAPES",
    "ShapeSpec",
    "get_config",
    "all_configs",
    "runnable_cells",
]
