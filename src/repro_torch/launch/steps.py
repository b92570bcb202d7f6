"""Step builders (counterpart of ``repro.launch.steps``; prefill only in
this slice — the train and serve steps belong to later slices)."""
from __future__ import annotations

from typing import Callable

from ..configs.base import ModelConfig
from ..models import lm


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, units=None):
        return lm.prefill(params, cfg, batch["tokens"], units=units)
    return prefill_step
