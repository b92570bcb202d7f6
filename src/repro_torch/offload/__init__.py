"""Offloaded training and serving (counterpart of ``repro.offload``):
the ZeRO-Offload training engine and the FlexGen one-shot serving
engine."""
from .serve_engine import (FlexGenEngine, max_batch_for_capacity,
                           search_placement, ServeConfig, ServeStats)
from .train_engine import (emit_step_traffic, OffloadConfig, StepTiming,
                           ZeroOffloadEngine)

__all__ = ["emit_step_traffic", "FlexGenEngine", "max_batch_for_capacity",
           "OffloadConfig", "search_placement", "ServeConfig", "ServeStats",
           "StepTiming", "ZeroOffloadEngine"]
