"""Operations and bytes of one call of each of the port's kernels,
counted from what the call's inputs need: each input byte read once,
each output byte written once, whatever the kernel reads again or
stages in scratch.  A multiply-add
is two operations."""
from __future__ import annotations

import math
from typing import Iterable, Tuple

BF16 = 2
F32 = 4


def fused_expert_ffn(distinct_experts: int, B: int, K: int, D: int,
                     F: int) -> Tuple[float, float]:
    """SwiGLU experts over B tokens routed top-K: three (D, F) products
    per (token, slot).  Bytes: gate, up and down weights of the
    *distinct* experts the ids name, x and the output, ids and weights."""
    flops = 2.0 * B * K * 3 * D * F
    nbytes = (distinct_experts * 3 * D * F * BF16 + 2 * B * D * BF16
              + B * K * (4 + F32))
    return flops, nbytes


def paged_decode_attention(kv_lens: Iterable[int], block_tokens: int,
                           H: int, KV: int, hd: int
                           ) -> Tuple[float, float]:
    """One query token a row over its ``kv_len`` cached tokens and the
    new one.  Bytes: K and V of the blocks each row's table names up to
    its ``kv_len``, the table's entries, q, the new K/V and the
    output."""
    flops = nbytes = 0.0
    for n in kv_lens:
        n = int(n)
        blocks = math.ceil(n / block_tokens)
        flops += 4.0 * H * hd * (n + 1)
        nbytes += (2 * blocks * block_tokens * KV * hd * BF16 + blocks * 4
                   + 2 * H * hd * BF16 + 2 * KV * hd * BF16 + 4)
    return flops, nbytes


def flash_attention(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                    causal: bool = True) -> Tuple[float, float]:
    """QK^T and PV over the (query, key) pairs the mask keeps (causal,
    queries aligned to the end of the keys).  Bytes: q, k, v, out."""
    if causal:
        off = Sk - Sq
        pairs = sum(min(Sk, off + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * B * H * hd * pairs
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * BF16
    return flops, nbytes

