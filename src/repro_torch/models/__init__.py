"""Model blocks and the pattern language model (attention-only)."""
from . import lm, modules

__all__ = ["lm", "modules"]
