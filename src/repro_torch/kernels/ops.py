"""Public entry points of the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its
plain version in ``ref.py`` (the counterpart of the reference's
``interpret`` mode off-TPU).  The choice follows the tensor's device
and nothing else: there is no fallback, so a CUDA input either launches
its kernel or raises.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import check_args as _flash_check
from .flash_attention import flash_attention as _flash_kernel
from .tiered_gather import paged_decode_attention as _paged_kernel


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    if _on_cuda(q):
        return _flash_kernel(q, k, v, causal=causal)
    _flash_check(k.shape[1], causal)
    return ref.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    if _on_cuda(q):
        return _decode_kernel(q, k_cache, v_cache, kv_len)
    return ref.decode_attention(q, k_cache, v_cache, kv_len)


def paged_decode_attention(q, k_pool, v_pool, block_tbl, kv_len, k_new,
                           v_new, *, block_tokens: int) -> torch.Tensor:
    if _on_cuda(q):
        return _paged_kernel(q, k_pool, v_pool, block_tbl, kv_len, k_new,
                             v_new, block_tokens=block_tokens)
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tbl, kv_len,
                                      k_new, v_new)
