"""Model blocks and the pattern language model."""
from . import lm, modules

__all__ = ["lm", "modules"]
