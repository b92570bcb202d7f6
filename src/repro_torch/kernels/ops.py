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
from .fused_adam import fused_adam as _adam_kernel
from .tiered_gather import check_expert_range
from .tiered_gather import fused_expert_ffn as _expert_kernel
from .tiered_gather import fused_expert_ffn_partial as _expert_range_kernel
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


def fused_expert_ffn(x, w_gate, w_up, w_down, expert_ids,
                     expert_wts) -> torch.Tensor:
    if _on_cuda(x):
        return _expert_kernel(x, w_gate, w_up, w_down, expert_ids,
                              expert_wts)
    return ref.expert_ffn(x, w_gate, w_up, w_down, expert_ids, expert_wts)


def fused_expert_ffn_partial(x, w_gate, w_up, w_down, expert_ids,
                             expert_wts, e_lo: int, e_hi: int,
                             n_experts: int) -> torch.Tensor:
    """The expert FFN over the experts [e_lo, e_hi) of ``n_experts`` (an
    expert shard's stacks): the fp32 (B, D) partial."""
    check_expert_range(e_lo, e_hi, n_experts, w_gate)
    if _on_cuda(x):
        return _expert_range_kernel(x, w_gate, w_up, w_down, expert_ids,
                                    expert_wts, e_lo, e_hi, n_experts)
    return ref.expert_ffn_partial(x, w_gate, w_up, w_down, expert_ids,
                                  expert_wts, e_lo, e_hi, n_experts)


def fused_adam(master, m, v, g, *, lr, b1, b2, eps, wd, b1c, b2c):
    """One AdamW step over a parameter leaf: (master', m', v'), fp32."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, b1c=b1c, b2c=b2c)
    if _on_cuda(master):
        return _adam_kernel(master, m, v, g, **kw)
    return ref.fused_adam(master, m, v, g, **kw)
