"""Architecture configs (one module per ported arch).

The reference lists ten archs; the port carries the configs whose
serving path it runs.  ``get_config`` on any other arch raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

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

#: archs whose config and model path the port carries
PORTED = ("granite_moe_1b", "phi4_mini_3p8b", "mamba2_2p7b", "recurrentgemma_9b")

#: the ROADMAP item that ports each other arch
UNPORTED = {
    "gemma2_27b": "ROADMAP A9 (sliding-window and softcap layers)",
    "gemma3_4b": "ROADMAP A9 (sliding-window layers, qk-norm, local rope base)",
    "stablelm_12b": "ROADMAP A9 (dense stacks beyond phi4-mini)",
    "deepseek_v2_236b": "ROADMAP A9 (MLA attention, shared experts)",
    "phi3_vision_4p2b": "ROADMAP A9 (patch-embedding frontend)",
    "musicgen_large": "ROADMAP A9 (codebook frontend)",
}

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
    if mod_name in UNPORTED:
        raise NotImplementedError(
            f"{mod_name} is not ported to the PyTorch package yet: {UNPORTED[mod_name]}"
        )
    if mod_name not in PORTED:
        raise ValueError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.reduced() if reduced else mod.CONFIG


__all__ = ["ARCHS", "PORTED", "get_config"]
