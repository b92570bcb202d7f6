"""GQA decode attention over contiguous per-sequence caches: the CUDA
kernel ``csrc/decode_attention.cu`` and its wrapper.

Replaces ``repro/kernels/decode_attention.py`` (``decode_attention`` /
``_decode_kernel``), the staged decode's attention
(``serving/engine.py::_paged_unit_fwd``).

Bound on the H100: device-memory bytes.  Each call must read the live
K/V rows once, ``2 * sum(kv_len) * KV * hd * 2`` bytes, and does about
one FMA per byte read, so the card has to be kept busy with many bytes
in flight.  Design: split-KV ("flash-decoding"), two kernels behind one
C call, over the bodies the paged kernel shares.  Pass 1 spreads each
sequence over ``n_split`` blocks of ``T`` tokens (grid (KV, B,
n_split)); each block serves one KV head's ``H // KV`` query heads, so
every K/V row is read once, starts every K and V row of its split with
16-byte ``cp.async`` copies, and writes the heads' partial (m, l, acc)
to fp32 scratch that the wrapper allocates.  Pass 2 merges a row's
partials.  ``decode_split_plan`` picks ``T`` and ``n_split`` from the
shapes alone, so no host sync on the lengths is needed: a split past a
row's length reads nothing, and a ``kv_len <= 0`` row reads every
position masked, which gives the reference's uniform weights.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import build
from ._launch import (H100_SMS, lengths, require, sm_count, split_plan,
                      split_scratch, stream_of)

GRANULE = 16    # tokens: the plan's unit, as a pool block is the paged one's


def decode_split_plan(S: int, B: int, KV: int,
                      sms: int = H100_SMS) -> Tuple[int, int]:
    """(T, n_split) of pass 1 over (B, S) caches: the paged kernel's plan
    over ``ceil(S / GRANULE)`` granules of ``GRANULE`` tokens, the last
    split cut at S."""
    return split_plan(math.ceil(S / GRANULE), GRANULE, B, KV, sms)


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
    T, n_split = decode_split_plan(S, B, KV, sm_count(q.device.index))
    out = torch.empty_like(q)
    # scratch stays referenced until the launch is enqueued
    scratch, m_part, l_part, acc_part = split_scratch(B, H, n_split, hd, q)
    with torch.cuda.device(q.device):
        rc = build.load("decode_attention").decode_attention_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), m_part, l_part, acc_part, B, H,
            KV, S, hd, T, n_split, 1.0 / math.sqrt(hd), stream_of(q))
    build.check(rc, "decode_attention")
    build.count("decode_attention", B, S, H, KV, hd)
    return out
