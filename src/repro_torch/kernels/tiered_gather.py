"""Paged decode attention straight over the KV pool: the CUDA kernel
``csrc/paged_decode_attention.cu`` and its wrapper.

Replaces ``repro/kernels/tiered_gather.py`` (``paged_decode_attention``
/ ``_paged_decode_kernel``), the fused decode's attention
(``serving/engine.py::_fused_unit_fwd``).  The reference module's other
kernel, ``fused_expert_ffn``, belongs to the MoE slice and is not
ported yet.

Bound on the H100: device-memory bytes, as for ``decode_attention``:
the live K/V rows of every sequence, read once through the block table,
plus the table itself.  Design: the same (KV head, sequence) thread
blocks; where the TPU kernel took the block table by scalar prefetch,
each block reads its own table row and offsets the pool pointer by
``tbl[b, j] * bt * KV * hd``, so no staging copy exists.  The step's
new token is folded in after the cached ones; pad table slots (block
0) are never read, and a ``kv_len = 0`` row attends to its new token
only.  Same weakness as ``decode_attention``: ``B * KV`` blocks.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._launch import lengths, require, stream_of


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tbl: torch.Tensor,
                           kv_len, k_new: torch.Tensor,
                           v_new: torch.Tensor, *,
                           block_tokens: int) -> torch.Tensor:
    """q (B, H, hd); pools (num_blocks, block_tokens, KV, hd);
    block_tbl (B, nb) int32 physical block ids in logical order;
    kv_len (B,) tokens cached; k_new/v_new (B, KV, hd).  bf16 on CUDA
    unless stated.  Returns (B, H, hd): attention over ``kv_len + 1``
    positions.  Table entries must name blocks of the pool."""
    B, H, hd = q.shape
    num_blocks, bt, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if bt != block_tokens:
        raise ValueError(f"pool block_tokens {bt} != {block_tokens}")
    nb = block_tbl.shape[1]
    require(q, "q", torch.bfloat16, (B, H, hd))
    require(k_pool, "k_pool", torch.bfloat16, (num_blocks, bt, KV, hd))
    require(v_pool, "v_pool", torch.bfloat16, (num_blocks, bt, KV, hd))
    require(block_tbl, "block_tbl", torch.int32, (B, nb))
    require(k_new, "k_new", torch.bfloat16, (B, KV, hd))
    require(v_new, "v_new", torch.bfloat16, (B, KV, hd))
    lens = lengths(kv_len, B, q)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = build.load("paged_decode_attention").paged_decode_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tbl.data_ptr(), lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), B, H, KV, nb, bt, hd,
            1.0 / math.sqrt(hd), stream_of(q))
    build.check(rc, "paged_decode_attention")
    build.LAUNCHES["paged_decode_attention"] += 1
    return out
