"""Causal blocked flash attention for prefill: the CUDA kernel
``csrc/flash_attention.cu`` and its wrapper.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_bh`` /
``_flash_kernel`` and its GQA wrapper ``flash_attention``).  The
reference prefill calls pure-JAX ``chunked_attention``; the port's
prefill (``models/lm.py``) calls this kernel on CUDA.

Bound on the H100: bytes at the main path's prompt lengths.  Causal
attention over ``L`` rows does about ``2 * L * (L + 1) * H * hd`` FLOP
against ``(2 * L * H + 2 * L * KV) * hd * 2`` bytes in and out; at
llama3-8b's 32 heads and 8 KV heads the bf16 peak (989 TFLOP/s) and the
memory rate (3.35 TB/s) give equal times near ``L = 737``, so prompts
of 512 are bound by bytes and longer ones by operations.

Design: one thread block per (32-row query tile, batch * head), a loop
over 32-row K/V tiles staged in shared memory that stops at the
diagonal, fp32 online softmax in registers; GQA reads KV head
``h // (H // KV)`` in place of the reference wrapper's repeat, and the
kernel masks ragged ``Sq``/``Sk`` itself.  Known weakness, left for a
later version: the products run on the fp32 FMA units, not the bf16
tensor cores.
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
    build.LAUNCHES["flash_attention"] += 1
    return out
