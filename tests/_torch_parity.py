"""Shared helpers for the PyTorch-port parity tests (not collected).

The same inputs, made with numpy, go through the JAX reference and the
port; values cross as numpy arrays.  bf16 crosses bit-exactly through an
int16 view (``repro_torch.models.lm.tensor_from_numpy``).
"""
import numpy as np
import torch

from repro_torch.models.lm import params_from_numpy, tensor_from_numpy

# the driver runs several test workers on one machine
torch.set_num_threads(2)

# the reference tests' tolerances
FP32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=3e-2, atol=3e-2)


def to_torch(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of the same dtype."""
    return tensor_from_numpy(np.asarray(a), "cpu")


def tree_to_torch(tree):
    """A JAX parameter tree as the port's CPU parameter tree."""
    import jax
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def to_numpy(x) -> np.ndarray:
    """Tensor or array as float32 numpy, for comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=FP32) -> None:
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), **tol)


def normal(rs: np.random.RandomState, shape, scale=1.0,
           dtype=np.float32) -> np.ndarray:
    return (rs.standard_normal(shape) * scale).astype(dtype)
