"""ZeRO-Offload training (counterpart of ``repro.offload``; the FlexGen
serving engine is not ported yet)."""
from .train_engine import (emit_step_traffic, OffloadConfig, StepTiming,
                           ZeroOffloadEngine)

__all__ = ["emit_step_traffic", "OffloadConfig", "StepTiming",
           "ZeroOffloadEngine"]
