"""AdamW with mixed precision (counterpart of ``repro.optim``)."""
from .adam import AdamConfig, apply_update, init_state, init_state_shapes

__all__ = ["AdamConfig", "apply_update", "init_state", "init_state_shapes"]
