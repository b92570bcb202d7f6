"""Architecture registry of the port: --arch <id> resolves here.

The reference registry's architectures (``repro.configs.registry``), in
its order; ``ASSIGNED_ARCHS`` are its first ten.  ``PORT_ARCH_IDS``
are the port's own, which the reference does not hold.
"""
from __future__ import annotations

import importlib
from typing import List

from .base import ModelConfig, smoke_variant

ARCH_IDS: List[str] = [
    "llama-3.2-vision-11b",
    "jamba-1.5-large-398b",
    "qwen3-moe-235b-a22b",
    "qwen3-moe-30b-a3b",
    "codeqwen1.5-7b",
    "qwen1.5-32b",
    "stablelm-1.6b",
    "llama3-8b",
    "whisper-large-v3",
    "rwkv6-7b",
    # paper's own evaluation models (Sec. IV)
    "gpt2-xl-offload",
    "bert-large-offload",
    "llama-65b-serve",
    "opt-66b-serve",
]

# hybrid Mamba-2 / MoE serving on the continuous-batching engine
PORT_ARCH_IDS: List[str] = ["granite-4.0-h-small"]

_MODULES = {i: __package__ + "." + i.replace("-", "_").replace(".", "_")
            for i in ARCH_IDS + PORT_ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))


def assigned_cells(arch: str) -> List[str]:
    """Shape cells that are valid for this arch (the reference's skip
    list)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        cells.append("decode_32k")
    if cfg.subquadratic:
        cells.append("long_500k")
    return cells


ASSIGNED_ARCHS = ARCH_IDS[:10]
