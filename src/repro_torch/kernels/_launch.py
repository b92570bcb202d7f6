"""Argument checks and the launch plans shared by the kernel wrappers:
the split-KV decodes' and the expert FFN's."""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch

SPLIT_TOKENS = 64     # tokens a pass-1 block takes, when the grid is full
H100_SMS = 132
EXPERT_UP_COLS = 128  # F columns of an expert pass-1 block (csrc kUpCols)
EXPERT_MIN_ROWS = 128  # fewest D rows of an expert pass-1 split
EXPERT_MAX_SPLITS = 8  # its D splits run as one cluster: the portable size
EXPERT_BLOCKS_PER_SM = 2   # expected pass-1 blocks the plan aims at


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Sequence[int], aligned: bool = True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` and, unless ``aligned`` is False, 16-byte aligned (the
    kernels load 8 or 16 bytes at once)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor "
                         f"(got {getattr(t, 'device', type(t))}); CPU "
                         "tensors go through kernels.ops to the plain "
                         "version")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def lengths(kv_len, B: int, like: torch.Tensor) -> torch.Tensor:
    """kv_len (int, 0-d or (B,) tensor) as a contiguous (B,) int32 CUDA
    tensor on ``like``'s device."""
    t = torch.as_tensor(kv_len, device=like.device)
    if t.numel() == 1:
        t = t.reshape(1).expand(B)
    t = t.to(torch.int32).contiguous()
    require(t, "kv_len", torch.int32, (B,))
    return t


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_scratch(B: int, H: int, n_split: int, hd: int,
                  like: torch.Tensor
                  ) -> Tuple[torch.Tensor, int, int, int]:
    """fp32 scratch of a split-KV decode on ``like``'s device: one
    allocation holding the partials acc (B, H, n_split, hd), then m and
    l (B, H, n_split), acc first so that its rows stay 16-byte aligned.
    Returns the tensor, which the caller holds until the launch is
    enqueued, and the m, l and acc device pointers."""
    n = B * H * n_split
    scratch = torch.empty(n * (hd + 2), dtype=torch.float32,
                          device=like.device)
    acc = scratch.data_ptr()
    return scratch, acc + 4 * n * hd, acc + 4 * n * (hd + 1), acc


def split_plan(nb: int, block_tokens: int, B: int, KV: int,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(T, n_split) of a split-KV decode's pass 1 over ``nb`` blocks of
    ``block_tokens`` tokens per sequence (pool blocks for the paged
    kernel, 16-token granules for the contiguous one): ``T`` tokens a
    pass-1 block, a multiple of ``block_tokens`` (about
    ``SPLIT_TOKENS``, fewer blocks while the (KV, B, n_split) grid would
    have fewer than ``sms`` blocks), and ``n_split`` splits, which cover
    ``nb * block_tokens``."""
    per = max(1, SPLIT_TOKENS // block_tokens)   # blocks a split
    while per > 1 and B * KV * math.ceil(nb / per) < sms:
        per -= 1
    return per * block_tokens, math.ceil(nb / per)


def expert_plan(B: int, K: int, D: int, F: int, E: int, e_lo: int,
                e_hi: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(S, rows) of ``fused_expert_ffn``'s pass 1 over the experts
    [e_lo, e_hi) of ``E`` at batch ``B``, top-``K``, from the shapes
    alone (no host sync on the routed ids): ``S`` splits of D of
    ``rows`` rows each, a multiple of 8 (the last may be shorter, none
    empty), the fewest that give ``m * ceil(F / EXPERT_UP_COLS) * S``
    blocks for ``EXPERT_BLOCKS_PER_SM`` per SM, with ``m = ceil(B * K *
    (e_hi - e_lo) / E)`` the slots the range expects; at most
    ``EXPERT_MAX_SPLITS`` and, where D has them, ``EXPERT_MIN_ROWS``
    rows a split.  The kernel takes S from the size of the scratch
    (``expert_scratch``) and sizes its slot groups from m."""
    m = -(-B * K * (e_hi - e_lo) // E)
    tiles = -(-F // EXPERT_UP_COLS)
    want = -(-EXPERT_BLOCKS_PER_SM * sms // (m * tiles)) if m else 1
    S = max(1, min(want, EXPERT_MAX_SPLITS, D // EXPERT_MIN_ROWS))
    rows = -(-(-(-D // S)) // 8) * 8
    return -(-D // rows), rows


def expert_scratch(B: int, K: int, F: int, S: int,
                   like: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """fp32 scratch of the expert kernel on ``like``'s device: one
    allocation holding h (B*K, F), then the pass-1 partials (B*K, S - 1,
    2, F) of the D splits past the first, B*K * (2S - 1) * F floats.
    Returns the tensor, which the caller holds until the launch is
    enqueued, and its start and end pointers (the kernel reads S from
    their distance)."""
    scratch = torch.empty(B * K * (2 * S - 1) * F, dtype=torch.float32,
                          device=like.device)
    start = scratch.data_ptr()
    return scratch, start, start + 4 * scratch.numel()
