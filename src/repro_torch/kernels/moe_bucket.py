"""The prefill MoE's dispatch and combine: the CUDA kernels
``csrc/moe_bucket.cu`` and their wrappers.

No TPU kernel is replaced: the reference's ``moe_fwd`` dispatches and
combines in plain JAX, and the port's plain versions
(``ref.moe_bucket_positions``, ``ref.moe_bucket_scatter``,
``ref.moe_bucket_combine``) are its lines.  On the card they ran as
some 130 PyTorch operations a layer (a one-hot ``cumsum``, a sort-based
``index_put_`` per slot, a permuting copy, a gather, multiply and add
per slot), so that a prefill was the host's enqueue of them; here they
are three launches and a memset a layer, every value the plain
version's bit for bit.  ``kernels.ops`` takes them for CUDA tensors
except where autograd records the tokens (positions and scatter) or the
combine's inputs (training): those take the plain versions, which have
the backward the kernels lack.

Bound on the H100: device-memory bytes (``csrc/moe_bucket.cu``):
the expert-major buffer's memset and its rows written and read once
each, about 0.6 GB and 0.17 ms at qwen3-moe-30b-a3b's longest prompt
(5003 tokens, one group).

Design: ``moe_bucket_positions`` ranks each group's T*k slots in one
block (warp ballots, per-expert counters in shared memory), so no
one-hot and no host sync; ``moe_bucket_scatter`` zeroes the (E, G, C,
D) buffer the expert products read and writes each kept slot's row of
``x`` into it, one block a token, 16-byte vectors;
``moe_bucket_combine`` reads each token's k rows of the expert outputs
in slot order and adds them with the plain version's rounding, one
product and one sum at a time.  Element types bf16 and fp32.
"""
from __future__ import annotations

import torch

from . import build
from ._launch import require, stream_of

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dtype(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype}, kernel takes "
                         f"{sorted(map(str, DTYPES))}")
    return DTYPES[t.dtype]


def _one_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError("the routing tensors and the rows must be on one "
                         "device")


def _row_width(D: int, t: torch.Tensor) -> None:
    if D % (16 // t.element_size()):
        raise ValueError(f"row width {D} is not a multiple of 16 bytes "
                         f"of {t.dtype}")


def moe_bucket_positions(topi: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """topi (G, T, k) int64 routed experts in [0, ``n_experts``).
    Returns (G, T, k) int32: each (token, slot)'s position in its
    expert's bucket of its group, in token-major order with the slot
    fastest.  Raises on any other input, and on CPU tensors
    (``kernels.ops`` routes those to ``ref.moe_bucket_positions``)."""
    G, T, k = topi.shape
    require(topi, "topi", torch.int64, (G, T, k), aligned=False)
    pos = torch.empty((G, T, k), dtype=torch.int32, device=topi.device)
    with torch.cuda.device(topi.device):
        rc = build.load("moe_bucket").moe_bucket_positions_i64(
            topi.data_ptr(), pos.data_ptr(), G, T * k, int(n_experts),
            stream_of(topi))
    build.check(rc, "moe_bucket_positions")
    build.count("moe_bucket_positions", G, T, k, int(n_experts))
    return pos


def moe_bucket_scatter(xt: torch.Tensor, topi: torch.Tensor,
                       pos: torch.Tensor, n_experts: int,
                       capacity: int) -> torch.Tensor:
    """xt (G, T, D) bf16 or fp32, D a multiple of 16 bytes; topi (G, T,
    k) int64; pos (G, T, k) int32 (``moe_bucket_positions``).  Returns
    the expert-major buffer (E, G, C, D) in ``xt.dtype``: row (e, g, p)
    holds the token of group g whose slot went to expert e at position
    p < C, every other row zero."""
    G, T, D = xt.shape
    k = topi.shape[-1]
    E, C = int(n_experts), int(capacity)
    dt = _dtype(xt, "xt")
    _row_width(D, xt)
    require(xt, "xt", xt.dtype, (G, T, D))
    require(topi, "topi", torch.int64, (G, T, k), aligned=False)
    require(pos, "pos", torch.int32, (G, T, k), aligned=False)
    _one_device(xt, topi, pos)
    buf = torch.empty((E, G, C, D), dtype=xt.dtype, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = build.load("moe_bucket").moe_bucket_scatter(
            xt.data_ptr(), topi.data_ptr(), pos.data_ptr(), buf.data_ptr(),
            G * T, T, k, D, G, C, E, dt, stream_of(xt))
    build.check(rc, "moe_bucket_scatter")
    build.count("moe_bucket_scatter", G, T, k, D, E, C)
    return buf


def moe_bucket_combine(expert_out: torch.Tensor, topi: torch.Tensor,
                       topw: torch.Tensor, pos: torch.Tensor
                       ) -> torch.Tensor:
    """expert_out (E, G, C, D) bf16 or fp32, the experts' outputs on the
    scatter's rows; topi (G, T, k) int64; topw (G, T, k) fp32 routing
    weights; pos (G, T, k) int32.  Returns (G, T, D) in
    ``expert_out.dtype``: the slots' rows weighted by ``topw`` (0 past
    capacity) and added in slot order, rounded as the plain version
    rounds."""
    E, G, C, D = expert_out.shape
    T, k = topi.shape[1], topi.shape[2]
    dt = _dtype(expert_out, "expert_out")
    _row_width(D, expert_out)
    require(expert_out, "expert_out", expert_out.dtype, (E, G, C, D))
    require(topi, "topi", torch.int64, (G, T, k), aligned=False)
    require(topw, "topw", torch.float32, (G, T, k), aligned=False)
    require(pos, "pos", torch.int32, (G, T, k), aligned=False)
    _one_device(expert_out, topi, topw, pos)
    out = torch.empty((G, T, D), dtype=expert_out.dtype,
                      device=expert_out.device)
    with torch.cuda.device(expert_out.device):
        rc = build.load("moe_bucket").moe_bucket_combine(
            expert_out.data_ptr(), topi.data_ptr(), topw.data_ptr(),
            pos.data_ptr(), out.data_ptr(), G * T, T, k, D, G, C, E, dt,
            stream_of(expert_out))
    build.check(rc, "moe_bucket_combine")
    build.count("moe_bucket_combine", G, T, k, D, E, C)
    return out
