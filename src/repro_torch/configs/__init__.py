from .base import LayerSpec, ModelConfig, smoke_variant
from .registry import ARCH_IDS, ASSIGNED_ARCHS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "ASSIGNED_ARCHS", "get_config", "get_smoke_config",
           "LayerSpec", "ModelConfig", "smoke_variant"]
