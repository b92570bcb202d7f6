"""Plain PyTorch references: fp32, no kernels, and nothing of the
program (``repro_torch``) or of the JAX package."""
