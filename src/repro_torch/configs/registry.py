"""Architecture registry of the port: --arch <id> resolves here.

Lists only the architectures the port runs; the reference registry
(``repro.configs.registry``) holds the full set.
"""
from __future__ import annotations

import importlib
from typing import List

from .base import ModelConfig, smoke_variant

ARCH_IDS: List[str] = ["llama3-8b"]

_MODULES = {i: __package__ + "." + i.replace("-", "_").replace(".", "_")
            for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))
