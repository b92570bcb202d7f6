"""Public entry points of the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its
plain version in ``ref.py`` (the counterpart of the reference's
``interpret`` mode off-TPU).  The choice follows the tensor's device
and nothing else: there is no fallback, so a CUDA input either launches
its kernel or raises.  One exception: the MoE bucket scatter and
combine have no backward, so a call that autograd records (grad mode on
and a floating input that requires a gradient, as in training) takes
the plain version on CUDA too, and the bucket positions with the
scatter; the values are the kernels' bit for bit.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import check_args as _flash_check
from .flash_attention import flash_attention as _flash_kernel
from .fused_adam import fused_adam as _adam_kernel
from .moe_bucket import moe_bucket_combine as _combine_kernel
from .moe_bucket import moe_bucket_positions as _positions_kernel
from .moe_bucket import moe_bucket_scatter as _scatter_kernel
from .ssm_state_update import ssm_state_update as _ssm_kernel
from .tiered_gather import check_expert_range
from .tiered_gather import fused_expert_ffn as _expert_kernel
from .tiered_gather import fused_expert_ffn_partial as _expert_range_kernel
from .tiered_gather import paged_decode_attention as _paged_kernel


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _recorded(*ts: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


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


def moe_bucket_positions(topi, n_experts: int, xt) -> torch.Tensor:
    """Each (token, slot)'s position in its expert's bucket of its
    group: (G, T, k), int32 from the kernel, int64 from the plain
    version.  It takes the path ``moe_bucket_scatter`` of the tokens
    ``xt`` takes, whose kernel reads the kernel's positions; so a
    training step, which records ``xt``, launches no kernel."""
    if _on_cuda(topi) and not _recorded(xt):
        return _positions_kernel(topi, n_experts)
    return ref.moe_bucket_positions(topi, n_experts)


def moe_bucket_scatter(xt, topi, pos, n_experts: int,
                       capacity: int) -> torch.Tensor:
    """The kept slots' tokens in the expert-major buffer (E, G, C, D);
    the plain version where autograd records ``xt``."""
    if _on_cuda(xt) and not _recorded(xt):
        return _scatter_kernel(xt, topi, pos, n_experts, capacity)
    return ref.moe_bucket_scatter(xt, topi, pos, n_experts, capacity)


def moe_bucket_combine(expert_out, topi, topw, pos) -> torch.Tensor:
    """The slots' expert outputs weighted and added in slot order:
    (G, T, D); the plain version where autograd records ``expert_out``
    or ``topw``."""
    if _on_cuda(expert_out) and not _recorded(expert_out, topw):
        return _combine_kernel(expert_out, topi, topw, pos)
    return ref.moe_bucket_combine(expert_out, topi, topw, pos)


def ssm_state_update(state, slots, x, Bm, Cm, dt, A, D) -> torch.Tensor:
    """One Mamba-2 decode token per row over the state slots: each row's
    state ``state[slots[row]]`` (H, N, P) fp32 decayed by exp(dt A) and
    added dt B x^T, in place; returns y = C^T state + D x, (B, H, P)
    fp32."""
    if _on_cuda(state):
        return _ssm_kernel(state, slots, x, Bm, Cm, dt, A, D)
    return ref.ssm_state_update(state, slots, x, Bm, Cm, dt, A, D)
