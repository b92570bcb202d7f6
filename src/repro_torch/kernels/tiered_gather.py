"""The two kernels of the reference's ``tiered_gather`` module, each a
CUDA kernel with its wrapper.

``paged_decode_attention``: paged decode attention straight over the KV
pool (``csrc/paged_decode_attention.cu``).  Replaces
``repro/kernels/tiered_gather.py`` (``paged_decode_attention`` /
``_paged_decode_kernel``), the fused decode's attention
(``serving/engine.py::_fused_unit_fwd``).  Bound on the H100:
device-memory bytes: the live K/V rows of every sequence, read once
through the block table, plus the table itself.  Design: split-KV
("flash-decoding"), two kernels behind one C call.  Pass 1 spreads each
sequence over ``n_split`` blocks of ``T`` tokens (grid (KV, B,
n_split)); each block reads its own table entries, starts every K and V
row of its split with 16-byte ``cp.async`` copies, and writes its query
heads' partial (m, l, acc) to fp32 scratch that the wrapper allocates.
Pass 2 merges a row's partials and folds the step's new token in after
the cached ones.  ``split_plan`` picks ``T`` and ``n_split`` from the
table width, so no host sync on the lengths is needed; a split past a
row's length reads nothing, pad table slots (block 0) are never read,
and a ``kv_len = 0`` row attends to its new token only.

``fused_expert_ffn``: the top-k silu expert FFN read straight from the
stacked expert store (``csrc/fused_expert_ffn.cu``).  Replaces
``repro/kernels/tiered_gather.py`` (``fused_expert_ffn`` /
``_expert_ffn_kernel``), the fused decode's MoE sublayer.  Bound on the
H100: device-memory bytes, ``3 * D * F * 2`` per distinct routed expert
(9.4 MB at qwen3-moe-30b-a3b) against about ``6 * D * F`` FLOP per
(token, slot).  Design: where Pallas carried the sum over the K slots in
VMEM along a sequential grid axis, two passes behind one C call over an
expert range [e_lo, e_hi) (the whole kernel is [0, E)).  Pass 1 finds
the range's in-range (token, slot) pairs on the device (each block ranks
the B*K ids itself; nothing is read on the host) and walks them as a
compact list: its grid is sized by the slots the range expects,
``ceil(B*K * (e_hi - e_lo) / E)`` (with a margin for their spread),
times the F tiles times S splits of D (``_launch.expert_plan``), so that
a quarter of the experts still fills the SMs; the S splits of a tile run
as one cluster, and after a barrier over it the first adds the others'
fp32 partials of ``x Wg`` and ``x Wu`` to its own and stores
``h = silu(g) * u`` (silu after the sum).  Pass 2 (blocks over narrow D
tiles and tokens) stages ``wts * h`` for its token's in-range slots
alone and sums ``h Wd`` over them in slot order; threads own 8 columns
each and read weight rows with 16-byte loads.  One ``torch.empty`` holds
h and the partials (``_launch.expert_scratch``); its size tells the
kernel S.  Known weakness, left for a later version: each (token, slot)
reads its expert on its own, so an expert two tokens route to is read
twice (grouping the tokens by expert).  Over an expert shard
(``fused_expert_ffn_partial``) the call takes the shard's stacks and its
range; pass 2 stores an fp32 partial, so that the shards' partials meet
before the one rounding to bf16.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._launch import (expert_plan, expert_scratch, lengths, require,
                      sm_count, split_plan, split_scratch, stream_of)


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
    T, n_split = split_plan(nb, bt, B, KV, sm_count(q.device.index))
    out = torch.empty_like(q)
    # scratch stays referenced until the launch is enqueued
    scratch, m_part, l_part, acc_part = split_scratch(B, H, n_split, hd, q)
    with torch.cuda.device(q.device):
        rc = build.load("paged_decode_attention").paged_decode_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tbl.data_ptr(), lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), m_part, l_part, acc_part, B,
            H, KV, nb, bt, hd, T, n_split, 1.0 / math.sqrt(hd),
            stream_of(q))
    build.check(rc, "paged_decode_attention")
    build.count("paged_decode_attention", B, nb, bt, H, KV, hd)
    return out


def fused_expert_ffn(x: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor,
                     expert_ids: torch.Tensor,
                     expert_wts: torch.Tensor) -> torch.Tensor:
    """x (B, D); w_gate/w_up (E, D, F); w_down (E, F, D): bf16 on CUDA;
    expert_ids (B, K) routed experts (cast to int32), expert_wts (B, K)
    their weights (cast to fp32).  Returns (B, D) bf16:
    ``sum_k wts[b, k] * ffn_silu(x[b]; expert ids[b, k])``, accumulated
    in fp32.  Takes D and F multiples of 8; raises on any other input,
    and on CPU tensors (``kernels.ops`` routes those to
    ``ref.expert_ffn``).  An id outside [0, E) gives NaN for its token."""
    E = w_gate.shape[0]
    return _expert_launch(x, w_gate, w_up, w_down, expert_ids, expert_wts,
                          0, E, E, partial=False)


def check_expert_range(e_lo: int, e_hi: int, n_experts: int,
                       w_gate: torch.Tensor) -> None:
    """Raise unless 0 <= e_lo <= e_hi <= n_experts and the stack holds
    the e_hi - e_lo experts of the range."""
    if not 0 <= e_lo <= e_hi <= n_experts:
        raise ValueError(f"expert range [{e_lo}, {e_hi}) outside "
                         f"[0, {n_experts}]")
    if w_gate.shape[0] != e_hi - e_lo:
        raise ValueError(f"expert stack of {w_gate.shape[0]} experts for "
                         f"the range [{e_lo}, {e_hi})")


def fused_expert_ffn_partial(x: torch.Tensor, w_gate: torch.Tensor,
                             w_up: torch.Tensor, w_down: torch.Tensor,
                             expert_ids: torch.Tensor,
                             expert_wts: torch.Tensor, e_lo: int, e_hi: int,
                             n_experts: int) -> torch.Tensor:
    """``fused_expert_ffn`` over the experts [e_lo, e_hi) of
    ``n_experts``, an expert shard: the weights are the shard's
    (e_hi - e_lo, ...) stacks and ``expert_ids`` hold global ids.
    Returns the (B, D) fp32 partial sum over the slots routed into the
    range: a slot routed elsewhere reads nothing and adds 0, an id
    outside [0, n_experts) gives NaN for its token.  The shards'
    partials summed and rounded to bf16 once give the whole kernel's
    output up to the order of the fp32 sum."""
    check_expert_range(e_lo, e_hi, n_experts, w_gate)
    return _expert_launch(x, w_gate, w_up, w_down, expert_ids, expert_wts,
                          e_lo, e_hi, n_experts, partial=True)


def _expert_launch(x, w_gate, w_up, w_down, expert_ids, expert_wts,
                   e_lo: int, e_hi: int, E: int, partial: bool):
    B, D = x.shape
    Es, F = w_gate.shape[0], w_gate.shape[2]
    K = expert_ids.shape[1]
    require(x, "x", torch.bfloat16, (B, D))
    require(w_gate, "w_gate", torch.bfloat16, (Es, D, F))
    require(w_up, "w_up", torch.bfloat16, (Es, D, F))
    require(w_down, "w_down", torch.bfloat16, (Es, F, D))
    ids = expert_ids.to(torch.int32).contiguous()
    wts = expert_wts.to(torch.float32).contiguous()
    require(ids, "expert_ids", torch.int32, (B, K))
    require(wts, "expert_wts", torch.float32, (B, K))
    S, _ = expert_plan(B, K, D, F, E, e_lo, e_hi, sm_count(x.device.index))
    # scratch stays referenced until the launch is enqueued
    scratch, h, h_end = expert_scratch(B, K, F, S, x)
    out = torch.empty((B, D), dtype=torch.float32 if partial
                      else torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.load("fused_expert_ffn").fused_expert_ffn_bf16(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), ids.data_ptr(), wts.data_ptr(), h, h_end,
            out.data_ptr(), B, K, D, F, E, e_lo, e_hi, int(partial),
            stream_of(x))
    build.check(rc, "fused_expert_ffn")
    build.count("fused_expert_ffn", B, K, D, F, Es)
    return out
