"""Architecture registry of the port: --arch <id> resolves here.

Lists only the architectures the port runs; the reference registry
(``repro.configs.registry``) holds the full set.
"""
from __future__ import annotations

import importlib
from typing import List

from .base import ModelConfig, smoke_variant

ARCH_IDS: List[str] = [
    "qwen3-moe-235b-a22b",
    "qwen3-moe-30b-a3b",
    "codeqwen1.5-7b",
    "qwen1.5-32b",
    "stablelm-1.6b",
    "llama3-8b",
    # paper's own evaluation models (Sec. IV)
    "gpt2-xl-offload",
    "bert-large-offload",
    "llama-65b-serve",
    "opt-66b-serve",
]

_MODULES = {i: __package__ + "." + i.replace("-", "_").replace(".", "_")
            for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))
