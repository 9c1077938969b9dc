"""Architecture registry: the configs the port serves + reduced variants.

The port's counterpart of ``repro/configs/registry.py``.  ``ARCH_NAMES``
lists the reference's ten configs; ``PORTED`` the ones whose family the
port runs.  ``get`` / ``reduced`` of another name raise.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

__all__ = ["ARCH_NAMES", "PORTED", "get", "reduced"]

ARCH_NAMES = [
    "whisper_small",
    "starcoder2_15b",
    "qwen1_5_4b",
    "qwen3_14b",
    "llama3_405b",
    "falcon_mamba_7b",
    "olmoe_1b_7b",
    "granite_moe_3b_a800m",
    "recurrentgemma_9b",
    "llama3_2_vision_90b",
]

#: configs with a module in the port (their families run here)
PORTED = ("falcon_mamba_7b", "recurrentgemma_9b")


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_NAMES)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; the port serves "
            f"{', '.join(PORTED)} (see ROADMAP.md §1)")
    return importlib.import_module(f".{name}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).config()


def reduced(name: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    return _module(name).reduced()
