"""Architecture registry: one module per assigned architecture.

``get_config(arch)`` returns the full (paper-exact) config;
``get_smoke(arch)`` a reduced same-family config for CPU tests.  Both
are field for field the reference's (``repro/configs``), and the port
runs every architecture the reference lists, in its order.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES: Dict[str, str] = {
    "starcoder2-3b": "starcoder2_3b",
    "gemma2-9b": "gemma2_9b",
    "granite-8b": "granite_8b",
    "qwen2.5-14b": "qwen25_14b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "jamba-v0.1-52b": "jamba_52b",
    "pixtral-12b": "pixtral_12b",
    "whisper-small": "whisper_small",
    "mamba2-780m": "mamba2_780m",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["get_config", "get_smoke", "list_archs", "SHAPES",
           "ModelConfig", "ShapeConfig", "shape_applicable"]
