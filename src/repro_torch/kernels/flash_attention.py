"""Causal blocked flash attention for prefill: the CUDA kernel
``csrc/flash_attention.cu`` and its wrapper.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_bh`` /
``_flash_kernel`` and its GQA wrapper ``flash_attention``).  The
reference prefill calls pure-JAX ``chunked_attention``; the port's
prefill (``models/lm.py``) calls this kernel on CUDA.

Bound on the H100: causal attention over ``L`` rows does about
``2 * L * (L + 1) * H * hd`` FLOP against ``(2 * L * H + 2 * L * KV) *
hd * 2`` bytes in and out.  At llama3-8b's 32 heads and 8 KV heads,
``L = 512`` (the main path's longest prompt) is bound by bytes (10.5 MB,
3.1 us at 3.35 TB/s, against 2.2 us of bf16 tensor-core work) and
``L = 2048`` by operations (34.4 GFLOP, 35 us at 989 TFLOP/s).

Design: FlashAttention-2 on the tensor cores (``mma.sync.m16n8k16``,
bf16 in, fp32 accumulate).  A block of 4 warps takes 64 query rows of
one (batch, head) and loops over 64-key tiles, stopping at the diagonal;
Q stays in registers, K and V arrive through a 2-stage ``cp.async``
ring in swizzled shared memory and reach the products by ``ldmatrix``
(``.trans`` for V).  The online softmax runs in fp32 on the score
accumulators, which become P's operand fragments in registers; P is
split into two bf16 terms (``hi + lo``) so that P V keeps P to 2^-17.
Causal query tiles launch heaviest first.  GQA reads KV head
``h // (H // KV)`` in place of the reference wrapper's repeat, and the
kernel masks ragged ``Sq``/``Sk`` itself.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._launch import require, stream_of


def check_args(Sk: int, causal: bool, block_k: int = 128) -> None:
    """The reference wrapper's one refusal: it pads Sk to block_k and
    can mask the pad only when causal."""
    if not causal and Sk % block_k:
        raise ValueError("non-causal flash requires Sk % block_k == 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_k: int = 128) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd): bf16 on CUDA.  Returns
    (B, Sq, H, hd).  As in the reference wrapper, non-causal attention
    with ``Sk % block_k != 0`` raises ValueError."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    check_args(Sk, causal, block_k)
    require(q, "q", torch.bfloat16, (B, Sq, H, hd))
    require(k, "k", torch.bfloat16, (B, Sk, KV, hd))
    require(v, "v", torch.bfloat16, (B, Sk, KV, hd))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = build.load("flash_attention").flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, int(causal), 1.0 / math.sqrt(hd), stream_of(q))
    build.check(rc, "flash_attention")
    build.count("flash_attention", B, Sq, Sk, H, KV, hd, int(causal))
    return out
