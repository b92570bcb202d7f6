"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

from typing import Sequence

import torch


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Sequence[int], aligned: bool = True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` and, unless ``aligned`` is False, 16-byte aligned (the
    kernels load 8 or 16 bytes at once)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor "
                         f"(got {getattr(t, 'device', type(t))}); CPU "
                         "tensors go through kernels.ops to the plain "
                         "version")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def lengths(kv_len, B: int, like: torch.Tensor) -> torch.Tensor:
    """kv_len (int, 0-d or (B,) tensor) as a contiguous (B,) int32 CUDA
    tensor on ``like``'s device."""
    t = torch.as_tensor(kv_len, device=like.device)
    if t.numel() == 1:
        t = t.reshape(1).expand(B)
    t = t.to(torch.int32).contiguous()
    require(t, "kv_len", torch.int32, (B,))
    return t


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
