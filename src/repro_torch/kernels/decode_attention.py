"""GQA decode attention over contiguous per-sequence caches: the CUDA
kernel ``csrc/decode_attention.cu`` and its wrapper.

Replaces ``repro/kernels/decode_attention.py`` (``decode_attention`` /
``_decode_kernel``), the staged decode's attention
(``serving/engine.py::_paged_unit_fwd``).

Bound on the H100: device-memory bytes.  Each call must read the live
K/V rows once, ``2 * sum(kv_len) * KV * hd * 2`` bytes, and does about
one FMA per byte read.  Design: one thread block per (KV head,
sequence) serves that head's ``H // KV`` query heads, so every K/V row
is read once; a loop inside the block over the cached tokens replaces
the TPU grid's sequential kv axis and stops at ``kv_len``.  Known
weakness, left for a later version: only ``B * KV`` blocks (32 at
llama3-8b, batch 4) for the card's 132 SMs.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._launch import lengths, require, stream_of


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """q (B, H, hd); caches (B, S, KV, hd), bf16 on CUDA; kv_len int or
    (B,): positions >= kv_len are masked.  Returns (B, H, hd) bf16.

    Takes hd in {64, 128} and H // KV in {1, 2, 4, 8}; raises on any
    other input, and on CPU tensors (``kernels.ops`` routes those to
    ``ref.decode_attention``)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    require(q, "q", torch.bfloat16, (B, H, hd))
    require(k_cache, "k_cache", torch.bfloat16, (B, S, KV, hd))
    require(v_cache, "v_cache", torch.bfloat16, (B, S, KV, hd))
    lens = lengths(kv_len, B, q)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = build.load("decode_attention").decode_attention_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), B, H, KV, S, hd,
            1.0 / math.sqrt(hd), stream_of(q))
    build.check(rc, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out
