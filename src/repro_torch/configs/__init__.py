"""Architecture registry: one module per ported architecture.

``get_config(arch)`` returns the full (paper-exact) config;
``get_smoke(arch)`` a reduced same-family config for CPU tests.  Both
are field for field the reference's (``repro/configs``).  The port
covers the dense family so far; an architecture of another family
raises ``KeyError`` naming the ROADMAP.md item that brings it.
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
}

#: architectures of the reference not ported yet, and where they come
NOT_YET_PORTED: Dict[str, str] = {
    "granite-moe-1b-a400m": "ROADMAP.md Queue 1, item 1 (MoE)",
    "qwen3-moe-30b-a3b": "ROADMAP.md Queue 1, item 1 (MoE)",
    "jamba-v0.1-52b": "ROADMAP.md Queue 1, item 2 (SSD and the hybrid)",
    "mamba2-780m": "ROADMAP.md Queue 1, item 2 (SSD and the hybrid)",
    "pixtral-12b": "ROADMAP.md Queue 1, item 3 (image embeddings and "
                   "the encoder-decoder)",
    "whisper-small": "ROADMAP.md Queue 1, item 3 (image embeddings and "
                     "the encoder-decoder)",
}


def list_archs() -> List[str]:
    """The architectures the port runs."""
    return list(_MODULES)


def _module(arch: str):
    if arch in NOT_YET_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: "
                       f"{NOT_YET_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["get_config", "get_smoke", "list_archs", "SHAPES",
           "ModelConfig", "ShapeConfig", "shape_applicable",
           "NOT_YET_PORTED"]
