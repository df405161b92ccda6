"""Assigned-architecture configs (``--arch <id>``), copied from the JAX
package.

Every module exports CONFIG (exact assigned numbers, cited) and SMOKE
(reduced same-family variant for CPU tests).  The port runs the
``dense``, ``moe``, ``ssm`` and ``hybrid`` families so far
(``models/model.py``); ``vlm`` and ``audio`` raise.
"""

from __future__ import annotations

from .base import ArchConfig, InputShape, INPUT_SHAPES

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-34b": "granite_34b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "internvl2-1b": "internvl2_1b",
    "granite-20b": "granite_20b",
    "xlstm-125m": "xlstm_125m",
    "qwen2.5-14b": "qwen2_5_14b",
    "whisper-tiny": "whisper_tiny",
    "glm4-9b": "glm4_9b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCH_NAMES",
           "get_config"]
