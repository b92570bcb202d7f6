"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the device dispatch (``ops``)."""
from . import build, ops, ref

__all__ = ["build", "ops", "ref"]
