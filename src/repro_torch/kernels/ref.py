"""Plain PyTorch versions of the ported kernels (counterpart of
``repro.kernels.ref``).

They compute each kernel's function directly, in fp32, and are what the
kernels are held against: on the CPU, ``kernels.ops`` runs them in the
kernels' place; on the card, ``chip_smoke.py`` compares each kernel with
its plain version on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kf = k.repeat_interleave(rep, dim=2).float()
    vf = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _per_row(kv_len, B: int, device) -> torch.Tensor:
    """kv_len as a (B,) int64 tensor (accepts an int, a 0-d or (B,)
    tensor, or an array)."""
    t = torch.as_tensor(kv_len, device=device).to(torch.int64)
    return t.reshape(-1).expand(B) if t.numel() == 1 else t.reshape(B)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """GQA decode: q (B, H, hd); caches (B, S, KV, hd); kv_len scalar or
    (B,) (per-row, unlike the JAX oracle's broadcast).  Returns
    (B, H, hd)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    kf = k_cache.repeat_interleave(rep, dim=2).float()
    vf = v_cache.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(hd)
    lens = _per_row(kv_len, B, q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] \
        < lens[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vf).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tbl: torch.Tensor,
                           kv_len, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """Gather-then-compute version of the paged decode kernel.

    Stages the pool blocks named by ``block_tbl`` (B, nb) into a
    contiguous (B, nb*bt, KV, hd) cache, writes the new token at
    position ``kv_len``, and runs plain decode attention over
    ``kv_len + 1`` positions.
    """
    B = q.shape[0]
    bt, KV, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    nb = block_tbl.shape[1]
    idx = block_tbl.to(torch.int64).reshape(-1)
    lens = _per_row(kv_len, B, q.device)
    rows = torch.arange(B, device=q.device)

    def staged(pool, new):
        c = pool.index_select(0, idx).reshape(B, nb * bt, KV, hd)
        # one extra slot so a full table can still take the new token
        c = torch.cat([c, c.new_zeros(B, 1, KV, hd)], dim=1)
        c[rows, lens] = new.to(pool.dtype)
        return c

    return decode_attention(q, staged(k_pool, k_new),
                            staged(v_pool, v_new), lens + 1)
